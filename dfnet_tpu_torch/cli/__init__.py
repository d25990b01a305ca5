"""Command-line entry points of the port: `python -m dfnet_tpu_torch.cli.nerf`,
`.feature` and `.dm` (stages 1, 2 and 3)."""
