"""Settings of the benchmark's own tests (``python -m pytest
portbench/tests``). Tests that need a card carry the ``gpu`` marker and
ask for the ``cuda_device`` fixture, which skips where there is none."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; run on the chip with "
        "`python -m pytest portbench/tests -m gpu`")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_bench(tmp_path):
    """A benchmark of the tiny cells (tests/tiny.py) under ``tmp_path``:
    (root, its portbench directory)."""
    from portbench.tests import tiny

    return tmp_path, tiny.write(tmp_path)
