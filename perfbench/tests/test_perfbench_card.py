"""Each cell on the card, one short run: ``python -m pytest perfbench/tests -m cuda``."""

import time

import pytest

from perfbench import harness

CELLS = ("lightgcn_gowalla.train", "lightgcn_gowalla.eval", "ngcf_gowalla.train", "ngcf_gowalla.serve")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    line = harness.run_cell(harness.ROOT, cell, 2**31 + 99, 1.0, False, card, time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
