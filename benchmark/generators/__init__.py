"""The generators of the benchmark's traffic: one module per kind of
traffic (`generator` in a workload file), each with a `Cell` that makes the
cell's inputs from the seed, sets up and warms up the program, drives its
entry through the window, and checks the window's outputs against the
plain reference."""
