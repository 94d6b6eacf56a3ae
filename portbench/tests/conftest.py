"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
tiny cells (``tiny.py``), and whether a card is present (decided here, in
a fixture, never while a module is imported)."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import tiny

    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
