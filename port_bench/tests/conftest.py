"""The benchmark's CPU tests. They import no JAX. A test that needs the card
is marked ``gpu`` and skips without one (decided inside the test)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
