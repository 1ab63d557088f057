"""The yardstick's byte and FLOP counts against shapes worked by hand."""

import pytest

from perfbench import counts
from perfbench.counts import lightgcn, ngcf


def test_spmm_bytes_reads_table_and_edges_once():
    # n = 10 nodes, d = 4: table 10*4*4 = 160 B in, 160 B out; 7 edges of
    # index and value, 56 B; 11 row offsets, 44 B
    assert counts.spmm_bytes(10, 7, 4) == 160 + 160 + 56 + 44


def test_k1_bytes_and_flops():
    # B 2, I 9, d 3: users 24 B, items 108 B, mask 2 * ceil(9/8) = 4 B, scores 72 B
    assert counts.k1_bytes(2, 9, 3) == 24 + 108 + 4 + 72
    assert counts.k1_flops(2, 9, 3) == 2 * 2 * 9 * 3


def test_topk_bytes():
    assert counts.topk_bytes(3, 100, 5) == 3 * 100 * 4 + 3 * 5 * 8


def test_bound_takes_the_larger_time():
    assert counts.bound_s(3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 495e12 * 2) == pytest.approx(2.0)


def test_lightgcn_flops():
    hyper = {"embed_size": 64, "n_layers": 3}
    assert lightgcn.propagate_flops(hyper, 1000, 50) == 3 * 2 * 1000 * 64
    # the SpMMs forward and back (one product a layer each way), the dot
    # products forward and twice back
    assert lightgcn.train_step_flops(hyper, 1000, 50, 8) == 2 * (3 * 2 * 1000 * 64) + 3 * (2 * 2 * 8 * 64)
    assert lightgcn.score_flops(hyper, 2, 10) == 2 * 2 * 10 * 64
    assert lightgcn.spmm_width(hyper) == 64


def test_ngcf_flops():
    hyper = {"embedding_size": 4, "layer_size": [4, 4]}
    # a layer: SpMM 2 * 5 * 4, two transforms 2 * 3 * 4 * 4 each
    layer = 2 * 5 * 4 + 2 * 2 * 3 * 4 * 4
    assert ngcf.propagate_flops(hyper, 5, 3) == 2 * layer
    # the SpMMs forward and back; the transforms and dot products forward
    # and twice back
    assert ngcf.train_step_flops(hyper, 5, 3, 2) == 2 * (2 * 2 * 5 * 4) + 3 * (2 * 2 * 2 * 3 * 4 * 4 + 2 * 2 * 2 * 12)
    assert ngcf.score_flops(hyper, 1, 7) == 2 * 7 * 12
    assert ngcf.spmm_width(hyper) == 4
    with pytest.raises(ValueError):
        ngcf.spmm_width({"embedding_size": 4, "layer_size": [8, 4]})
