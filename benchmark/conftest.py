"""pytest settings of the benchmark's own tests (python -m pytest benchmark)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips where there is none)")
