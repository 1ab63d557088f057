"""The port's ``profiling.py`` against the JAX package's, on the CPU: the
``timer`` line, ``StepTimer.summary`` on the same totals, and the traces
``device_trace`` and ``Trainer(trace_dir=...)`` write (Chrome / Perfetto
JSON that parses, with the operators and the program's spans that ran,
and the spans' summary logged after the trace)."""

import json
import os

import numpy as np
import pytest
import torch

from neurec_tpu.profiling import StepTimer as JaxStepTimer
from neurec_tpu.profiling import timer as jax_timer
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.profiling import StepTimer, device_trace, timer
from neurec_tpu_torch.trainer import Trainer
from tests.test_torch_checkpoint import RecordingLogger


def test_timer_prints_the_reference_line(capsys):
    @timer
    def work(a, b=2):
        return a + b

    @jax_timer
    def work_jax(a, b=2):
        return a + b

    assert work(1, b=3) == 4 and work.__name__ == "work"
    assert work_jax(1, b=3) == 4
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2
    for line, name in zip(out, ("work", "work_jax")):
        head, secs = line.rsplit(" ", 1)
        assert head == "%s function cost:" % name and secs.endswith("s")
        assert float(secs[:-1]) >= 0.0


def test_step_timer_summary_equals_jax():
    ours, theirs = StepTimer(), JaxStepTimer()
    for t in (ours, theirs):
        t.totals.update({"train": 12.3456789, "eval": 0.0012, "a_very_long_phase_name_here": 3.0})
        t.counts.update({"train": 7, "eval": 3, "a_very_long_phase_name_here": 0})
    assert ours.summary() == theirs.summary()
    assert ours.summary().splitlines()[0].startswith("a_very_long_phase_name_here")
    with ours.phase("eval"):
        pass
    assert ours.counts["eval"] == 4 and ours.totals["eval"] >= 0.0012


def _events(path):
    with open(path) as fin:
        trace = json.load(fin)
    return trace["traceEvents"]


def test_device_trace_writes_a_trace_that_parses(tmp_path):
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir), device="cpu") as out:
        x = torch.randn(64, 64)
        torch.mm(x, x).sum()
    assert out.path is not None and os.path.dirname(out.path) == str(log_dir)
    assert out.path.endswith(".pt.trace.json") and os.listdir(log_dir) == [os.path.basename(out.path)]
    names = {e.get("name") for e in _events(out.path)}
    assert "aten::mm" in names


def test_device_trace_follows_the_device_rule(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with device_trace(str(tmp_path / "t")):
            pass


def test_trainer_trace_dir_writes_a_trace(tmp_path):
    ds = random_dataset(num_users=20, num_items=30, seed=1)
    trace_dir = str(tmp_path / "run_trace")
    conf = DictConfig({"recommender": "MF", "embedding_size": 4, "batch_size": 32, "epochs": 1, "verbose": 1,
                       "learner": "adam", "learning_rate": 0.05, "topk": [5], "metric": ["Recall"],
                       "trace_dir": trace_dir})
    model = get_model("MF")(ds, conf, device="cpu")
    logger = RecordingLogger()
    trainer = Trainer(model, ds, conf, logger=logger, device="cpu")
    values = [float(x) for x in trainer.train().split("\t")]
    assert len(values) == 1 and np.isfinite(values).all()
    assert logger.lines[-2] == "device trace written to %s" % trace_dir
    # then the program's spans by name, the store's summary
    summary = logger.lines[-1].splitlines()
    assert summary[0] == "spans (host time):"
    assert [line.split()[0] for line in summary[1:]] == ["neurec.draw.negatives", "neurec.draw.perm",
                                                         "neurec.draw.seeds", "neurec.draw_epoch",
                                                         "neurec.eval.read", "neurec.evaluate",
                                                         "neurec.program.eager", "neurec.run_epoch",
                                                         "neurec.steps.eager"]
    (name,) = os.listdir(trace_dir)
    names = {e.get("name") for e in _events(os.path.join(trace_dir, name))}
    # the epoch's optimizer steps and the evaluation's top-K ran inside it,
    # and the program's spans
    assert "aten::topk" in names and any("Optimizer.step" in str(n) for n in names)
    assert {"neurec.run_epoch", "neurec.evaluate"} <= names
