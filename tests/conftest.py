import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real single-device CPU; only launch/dryrun.py forces 512 host devices.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason without one")
