def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card with nvcc; skipped on a host without one")
