"""The benchmark's own tests: CPU only, except those marked ``cuda``.

    python -m pytest perfbench/tests -q
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")
