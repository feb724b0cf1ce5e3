def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the hand-written "
        "kernels have no CPU mode); skips without a card")
