import os
import sys

import pytest

# `python -m pytest` from the repo root works without PYTHONPATH=src (the
# documented tier-1 command keeps working too — an existing entry wins).
_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration tests")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA Hopper card (the port's CUDA "
        "kernels); skips with a reason without one")
