"""CPU tests of the benchmark's own code; ``cuda`` tests skip without a card.

Run from the checkout's root: ``python -m pytest -q benchmark/tests``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
