"""The benchmark's tests. ``card`` marks a test that needs a CUDA card; it
decides inside the test, and skips on a machine without one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
