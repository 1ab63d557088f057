"""``hstu_ml20m.eval_seq`` end to end on the CPU at a tiny size (the
attention by its plain version), judged by the reference under the real
limits; then with each of the calibration's faults planted in the program,
which the judge must catch; and the benchmark's reference beside the
tests' copy on one input."""

import json
import os
import time

import numpy as np
import pytest
import torch

from perfbench import harness, seqdata
from perfbench.reference import hstu as bench_ref
from perfbench.reference.common import Arith
from perfbench.tests.tiny import make_root

CELL = "hstu_ml20m.eval_seq"
SEED = 2**31 + 4097
TINY_DATA = {"num_users": 40, "num_items": 60, "num_interactions": 600, "min_per_user": 5, "median_per_user": 12,
             "max_per_user": 45, "popularity_offset": 5}
TINY_HYPER = {"item_embedding_dim": 8, "num_blocks": 2, "num_heads": 2, "dqk": 4, "dv": 4, "max_sequence_length": 16,
              "test_batch_size": 16, "topk": [5, 10, 20]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = make_root(str(tmp_path_factory.mktemp("bench_hstu")))
    cfg_path = os.path.join(path, "perfbench", "configs", "hstu_ml20m.json")
    with open(cfg_path) as fin:
        cfg = json.load(fin)
    cfg["data"].update(TINY_DATA)
    cfg["hyper"].update(TINY_HYPER)
    with open(cfg_path, "w") as fout:
        json.dump(cfg, fout)
    traffic_path = os.path.join(path, "perfbench", "traffic", "eval_seq.json")
    with open(traffic_path) as fin:
        traffic = json.load(fin)
    traffic.update(warm_calls=1, judged_users=24)  # a sample, as at full size
    with open(traffic_path, "w") as fout:
        json.dump(traffic, fout)
    return path


def run(root, seconds=0.2):
    return harness.run_cell(root, CELL, SEED, seconds, False, "cpu", time.perf_counter())


def test_the_cell_is_correct_on_the_cpu(root):
    line = run(root)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"topk_gap", "encode_gap", "metric_gap"}
    assert set(line["metrics"]) == {"setup_s", "eval_users_per_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values()) and line["attempted"] > 0


def _time_bias_dropped(monkeypatch):
    from neurec_tpu_torch.ops import hstu

    real = hstu.relative_bias
    monkeypatch.setattr(hstu, "relative_bias", lambda ts, w_p, w_t, N: real(ts, w_p, torch.zeros_like(w_t), N))


def _gate_ln_dropped(monkeypatch):
    from neurec_tpu_torch.ops import hstu

    real_attention, real_ln = hstu.attention, hstu.layer_norm
    marked = set()

    def attention(*args):
        out = real_attention(*args)
        marked.add(id(out))
        return out

    monkeypatch.setattr(hstu, "attention", attention)
    monkeypatch.setattr(hstu, "layer_norm", lambda x: x if id(x) in marked else real_ln(x))


def _half_layers(monkeypatch):
    from neurec_tpu_torch.models.sequential.hstu import HSTU

    real = HSTU.encode

    def encode(self, params, *args, **kwargs):
        return real(self, dict(params, blocks=params["blocks"][:len(params["blocks"]) // 2]), *args, **kwargs)
    monkeypatch.setattr(HSTU, "encode", encode)


@pytest.mark.parametrize("fault", [_time_bias_dropped, _gate_ln_dropped, _half_layers],
                         ids=["time_bias", "gate_ln", "half_layers"])
def test_a_planted_fault_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    line = run(root, seconds=0.05)
    assert not line["correct"], line["checks"]


def test_the_two_references_agree():
    import tests.hstu_reference as tests_ref

    hyper = dict(TINY_HYPER, temperature=0.05)
    w = bench_ref.make_weights(hyper, 0, 30, torch.Generator().manual_seed(4))
    split = seqdata.generate(dict(seed=3, num_users=6, num_items=30, num_interactions=90, min_per_user=5,
                                  median_per_user=12, max_per_user=28, popularity_exponent=1.0, popularity_offset=5,
                                  time_start=10 ** 9, time_end=10 ** 9 + 10 ** 8, gap_log_median=4.0,
                                  gap_log_sigma=2.5))
    seq, lengths, ts = (torch.from_numpy(a) for a in seqdata.histories(split, np.arange(6), 16))
    a = bench_ref.user_vectors(w, seq, lengths, ts, hyper, Arith("float64"))
    b = tests_ref.user_vectors(w, seq, lengths, ts, 2, 4, 4)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    negs = torch.randint(0, 30, (6, 16, 4), generator=torch.Generator().manual_seed(1))
    targets = torch.where(torch.arange(16)[None] < lengths[:, None], seq.roll(-1, 1), torch.full_like(seq, 30))
    la = bench_ref.loss(w, seq, targets, lengths, ts, negs, hyper, Arith("float64"))
    lb = tests_ref.loss(w, seq, targets, lengths, ts, negs, 2, 4, 4, 0.05)
    torch.testing.assert_close(la, lb, rtol=1e-12, atol=0)


def test_the_attention_bound_counts_real_positions_alone():
    """``hstu_attn_roofline``'s bytes: q, k, v and the output at the real
    positions only, so a batch's pad rows add nothing but their lengths
    and query times, and a layout that reads no pad row stays under 100%."""
    from perfbench.counts import hstu as counts_hstu

    hyper = {"item_embedding_dim": 50, "num_heads": 2, "dqk": 25, "dv": 25, "num_blocks": 8,
             "max_sequence_length": 200}
    fixed = 4.0 * (2 * 200 - 1 + 129) + 8.0 * 128
    assert counts_hstu.attn_bytes(hyper, []) == fixed
    one_row = 4.0 * 2 * (2 * 25 + 25) + 4.0 * 2 * 25 + 8.0
    assert counts_hstu.attn_bytes(hyper, [3, 0]) == fixed + 3 * one_row + 2 * (4.0 + 8.0)
    assert counts_hstu.attn_bytes(hyper, [250]) == counts_hstu.attn_bytes(hyper, [200])
    assert counts_hstu.attn_flops(hyper, [3, 0]) == 2.0 * 2 * 50 * 6


def test_the_control_and_each_fault_read_over_the_limits(root):
    """``calibrate_eval_seq``'s readings: the sound ones within the cell's
    limits, the TF32 control's and each fault's over one of them."""
    from perfbench.calibrate_eval_seq import readings

    cell = harness.load_cell(root, CELL)
    got = readings(harness.Context(root, cell, SEED, 0.05, False, torch.device("cpu"), time.perf_counter()))
    assert harness.is_correct(harness.judged(got["sound"], cell.limits)), got["sound"]
    for name in ("control",) + bench_ref.FAULTS:
        assert not harness.is_correct(harness.judged(got[name], cell.limits)), (name, got[name])
