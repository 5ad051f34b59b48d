def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card (CUDA kernels have no CPU mode); skips "
        "without one")
