# NOTE: XLA_FLAGS / device-count overrides are deliberately NOT set here —
# smoke tests and benches must see the host's single real device. Multi-device
# lowering tests spawn subprocesses that set XLA_FLAGS before importing jax.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running FL convergence tests "
        "(deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
