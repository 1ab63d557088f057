"""Every cell of the manifest run end to end on the CPU at a small size
(the card's kernels by their plain versions), judged by its reference
under the real limits; then again with a fault planted under the timed
path, which the judge must catch."""

import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import make_root

CELLS = ("lightgcn_gowalla.train", "lightgcn_gowalla.eval", "ngcf_gowalla.train", "ngcf_gowalla.serve")
SEED = 2**31 + 4097  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


def run(root, cell, seconds=0.2):
    return harness.run_cell(root, cell, SEED, seconds, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu(root, cell):
    line = run(root, cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in harness.load_cell(root, cell).end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())


def _state_unchanged(monkeypatch):
    from neurec_tpu_torch.trainer import OptaxAdam

    real = OptaxAdam.step

    def step(self, closure=None):
        saved = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        real(self)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups for p in g["params"]), saved):
                p.copy_(s)
    monkeypatch.setattr(OptaxAdam, "step", step)


def _half_batch(monkeypatch):
    from neurec_tpu_torch.models.general.lightgcn import LightGCN
    from neurec_tpu_torch.models.general.ngcf import NGCF

    for cls in (LightGCN, NGCF):
        real = cls.loss

        def loss(self, params, batch, weights, real=real):
            half = weights.shape[0] // 2
            return real(self, params, batch, torch.cat([2 * weights[:half], 0 * weights[half:]]))
        monkeypatch.setattr(cls, "loss", loss)


def _altered_negative(monkeypatch):
    from neurec_tpu_torch.trainer import EpochDraws, Trainer

    real = Trainer.draw_epoch

    def draw_epoch(self, generator):
        d = real(self, generator)
        negs = d.negs.clone()
        negs[0, 0] = self._pos_flat[self._base(d.inst[0, :1])][0]  # the row's own positive
        return EpochDraws(d.inst, d.w, negs, d.seeds)
    monkeypatch.setattr(Trainer, "draw_epoch", draw_epoch)


def _altered_topk(monkeypatch, module):
    real = module.top_k

    def top_k(x, k):
        vals, ids = real(x, k)
        ids = ids.clone()
        ids[:, 0] = ids[:, -1]  # the first answer replaced by a repeat of the last
        return vals, ids
    monkeypatch.setattr(module, "top_k", top_k)


def _half_users(monkeypatch):
    from neurec_tpu_torch.eval import evaluator

    real = evaluator.all_metrics

    def all_metrics(hits, lens):
        m = real(hits, lens)
        half = m.shape[0] // 2
        return torch.cat([2 * m[:half], 0 * m[half:]])
    monkeypatch.setattr(evaluator, "all_metrics", all_metrics)


def _half_requests(monkeypatch):
    from neurec_tpu_torch import recommend

    real = recommend.top_k

    def top_k(x, k):
        vals, ids = real(x, k)
        half = ids.shape[0] // 2
        return vals, torch.cat([ids[:half], ids[:ids.shape[0] - half]])  # half the batch answered for the other
    monkeypatch.setattr(recommend, "top_k", top_k)


def _tiers(monkeypatch):
    from neurec_tpu_torch.eval import tiers
    _altered_topk(monkeypatch, tiers)


def _recommend(monkeypatch):
    from neurec_tpu_torch import recommend
    _altered_topk(monkeypatch, recommend)


FAULTS = [
    ("lightgcn_gowalla.train", _state_unchanged), ("lightgcn_gowalla.train", _half_batch),
    ("lightgcn_gowalla.train", _altered_negative),
    ("ngcf_gowalla.train", _state_unchanged), ("ngcf_gowalla.train", _half_batch),
    ("ngcf_gowalla.train", _altered_negative),
    ("lightgcn_gowalla.eval", _tiers), ("lightgcn_gowalla.eval", _half_users),
    ("ngcf_gowalla.serve", _recommend), ("ngcf_gowalla.serve", _half_requests),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=["%s-%s" % (c, f.__name__.strip("_")) for c, f in FAULTS])
def test_a_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    line = run(root, cell, seconds=0.05)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["lightgcn_gowalla.train", "ngcf_gowalla.train", "lightgcn_gowalla.eval",
                                  "ngcf_gowalla.serve"])
def test_the_tf32_control_is_not_correct(root, cell):
    """The control, the reference in TF32 put in the program's place,
    fails at least one of the cell's limits."""
    from perfbench.calibrate import readings

    cell_ = harness.load_cell(root, cell)
    ctx = harness.Context(root, cell_, SEED, 0.05, False, torch.device("cpu"), time.perf_counter())
    got = readings(ctx)
    assert harness.is_correct(harness.judged(got["sound"], cell_.limits))
    control = harness.judged(got["control"], {k: v for k, v in cell_.limits.items() if k in got["control"]})
    assert not harness.is_correct(control), control
    assert np.isfinite(list(got["control"].values())).all()
