"""Repository-wide pytest settings: the marker of tests that need a GPU."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's CUDA kernels); "
        "skips without one",
    )
