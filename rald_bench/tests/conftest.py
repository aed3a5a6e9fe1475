"""Fixtures of the benchmark's own tests: the tiny CPU cells under
``tests/data`` (the product's widths, two blocks a model, four sampler
steps, a 32 x 8 x 2 cube, a few thousand queries), run through the
harness's own code with the card's look skipped."""
from __future__ import annotations

from pathlib import Path

import pytest
import torch

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="session", autouse=True)
def _threads():
    torch.set_num_threads(min(4, torch.get_num_threads()))


@pytest.fixture
def tiny_cell():
    from rald_bench import spec

    bench = spec.load_json(DATA / "bench.json")
    return lambda name: spec.cell(name, bench, DATA)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run `python -m pytest -m gpu rald_bench/tests` on the card)")
