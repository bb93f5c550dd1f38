"""Tests of the benchmark. Those marked ``card`` need a CUDA device; each
decides inside the test, and skips here with its reason."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
