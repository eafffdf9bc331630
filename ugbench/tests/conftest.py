"""The benchmark's own tests: ``python -m pytest ugbench/tests`` from the
repository's root.  Tests marked ``cuda`` skip without a card."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")
