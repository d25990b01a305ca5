"""The benchmark of dfnet_tpu_torch, the PyTorch/CUDA port (BENCHMARK.json;
run.py runs one cell). Nothing here imports JAX or the JAX package."""
