"""Checkpoint and resume in the port (``neurec_tpu_torch/checkpoint.py``),
on the CPU.

* Round trip: the params and every optimizer's state come back bit for
  bit, for Adam (MF), CFGAN's two optimizers, IRGAN's ``{}``, WRMF's
  ``None`` and SRGNN's decayed Adam (its ``step`` a CPU f32 tensor).
* Resume: a run checkpointed, stopped and resumed by a fresh trainer gives
  the uninterrupted run's losses, params and optimizer state bit for bit
  (MF pairwise 2 + 2 epochs as ``tests/test_checkpoint.py::
  test_resume_continues_training``, MultiVAE's dense_row epoch with its
  anneal step, CFGAN's and SRGNN's custom epochs).
* The manager: ``max_to_keep``, ``latest_epoch``, ``FileNotFoundError`` on
  an empty directory, no file left by a failed save, a checkpoint whose
  tensors were written on the card restored without one, a finished run
  that still evaluates, and the JAX package's ``attach_to_trainer`` start
  epochs and kept epochs over one scenario.
"""

import os
import zipfile

import pytest
import torch

from neurec_tpu_torch import checkpoint
from neurec_tpu_torch.bridge import param_leaves
from neurec_tpu_torch.checkpoint import CheckpointManager, attach_to_trainer
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.trainer import Trainer

EVAL = {"topk": [5], "metric": ["Recall", "NDCG"], "test_batch_size": 32}
CONFS = {
    "MF": dict(recommender="MF", embedding_size=8, reg_mf=0.01, learning_rate=0.05, batch_size=64,
               learner="adam", is_pairwise=True, loss_function="bpr"),
    "MultiVAE": dict(recommender="MultiVAE", p_dim=[8, 16], reg=0.01, total_anneal_steps=20, anneal_cap=0.2,
                     batch_size=16, learner="adam", learning_rate=0.01),
    "CFGAN": dict(recommender="CFGAN", hiddenLayer_G=[12], hiddenLayer_D=[6], batchSize_G=8, batchSize_D=8,
                  step_G=1, step_D=1, mode="userBased", reg_D=0.01),
    "IRGAN": dict(recommender="IRGAN", factors_num=4, d_reg=0.01, g_reg=0.01, lr=0.05, batch_size=16),
    "WRMF": dict(recommender="WRMF", embedding_size=8, alpha=10.0, reg_mf=0.1),
    "SRGNN": dict(recommender="SRGNN", hidden_size=8, max_seq_len=8, lr=0.01, lr_dc_step=1, batch_size=8),
}


class RecordingLogger:
    path = None

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)

    debug = warning = error = critical = info


def make_trainer(name, epochs, verbose=None):
    ds = random_dataset(num_users=30, num_items=40, min_per_user=4, max_per_user=12, seed=5)
    conf = DictConfig(dict(EVAL, **CONFS[name], epochs=epochs, verbose=verbose or epochs))
    model = get_model(name)(ds, conf, device="cpu")
    trainer = Trainer(model, ds, conf, logger=RecordingLogger(), seed=11, device="cpu")
    # (epoch, loss) of every epoch the trainer runs
    trainer.losses = []
    real = trainer.train_epoch

    def train_epoch(epoch, max_steps=None):
        out = real(epoch, max_steps)
        trainer.losses.append((epoch, float(out[2])))
        return out

    trainer.train_epoch = train_epoch
    return trainer


def optimizers(opt_state, prefix=()):
    """(path, optimizer) of every optimizer in the tree."""
    if isinstance(opt_state, torch.optim.Optimizer):
        yield prefix, opt_state
    elif isinstance(opt_state, dict):
        for k, v in opt_state.items():
            yield from optimizers(v, prefix + (k,))


def assert_same_state(a, b):
    """Params and optimizer states of trainers ``a`` and ``b`` bit-equal."""
    pa, pb = dict(param_leaves(a.params)), dict(param_leaves(b.params))
    assert set(pa) == set(pb)
    for path in pa:
        assert pa[path].dtype == pb[path].dtype and torch.equal(pa[path], pb[path]), path
    oa, ob = dict(optimizers(a.opt_state)), dict(optimizers(b.opt_state))
    assert set(oa) == set(ob)
    for path in oa:
        sa, sb = oa[path].state_dict(), ob[path].state_dict()
        assert sa["param_groups"] == sb["param_groups"], path
        assert set(sa["state"]) == set(sb["state"]), path
        for i, st in sa["state"].items():
            for key, val in st.items():
                other = sb["state"][i][key]
                if isinstance(val, torch.Tensor):
                    assert val.dtype == other.dtype and val.device == other.device, (path, i, key)
                    assert torch.equal(val, other), (path, i, key)
                else:
                    assert val == other, (path, i, key)
    return oa


@pytest.mark.parametrize("name", ["MF", "CFGAN", "IRGAN", "WRMF", "SRGNN"])
def test_round_trip_is_bit_equal(tmp_path, name):
    trainer = make_trainer(name, 1)
    trainer.initialize()
    trainer.params, trainer.opt_state, _ = trainer.train_epoch(1)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, trainer.params, trainer.opt_state)

    fresh = make_trainer(name, 1)
    fresh.initialize()
    params_obj, opt_obj = fresh.params, fresh.opt_state
    fresh.params, fresh.opt_state, epoch = mgr.restore(fresh.params, fresh.opt_state)
    assert epoch == 1
    # restored in place: the optimizers still step the trainer's own tensors
    assert fresh.params is params_obj and fresh.opt_state is opt_obj
    opts = assert_same_state(trainer, fresh)
    if name == "CFGAN":
        assert set(opts) == {("g",), ("d",)}
    elif name == "IRGAN":
        assert fresh.opt_state == {}
    elif name == "WRMF":
        assert fresh.opt_state is None
    else:
        (opt,) = opts.values()
        steps = {str(s["step"].device) + str(s["step"].dtype) for s in opt.state.values()}
        assert steps == {"cputorch.float32"}
        for p in [p for g in opt.param_groups for p in g["params"]]:
            assert opt.state[p]["step"].item() > 0


@pytest.mark.parametrize("name", ["MF", "MultiVAE", "CFGAN", "SRGNN"])
def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path, name):
    whole = make_trainer(name, 4, verbose=2)
    attach_to_trainer(whole, str(tmp_path / "whole"))
    result_whole = whole.train()

    first = make_trainer(name, 2, verbose=2)
    assert attach_to_trainer(first, str(tmp_path / "cut")) == 1
    first.train()
    assert first._ckpt.latest_epoch() == 2

    resumed = make_trainer(name, 4, verbose=2)
    assert attach_to_trainer(resumed, str(tmp_path / "cut")) == 3
    result_resumed = resumed.train()
    assert resumed.losses == whole.losses[2:] and [e for e, _ in resumed.losses] == [3, 4]
    assert result_resumed == result_whole
    assert_same_state(whole, resumed)
    assert resumed._ckpt.all_epochs() == whole._ckpt.all_epochs() == [2, 3, 4]


def test_max_to_keep_latest_and_empty_directory(tmp_path):
    trainer = make_trainer("MF", 1)
    trainer.initialize()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_epoch() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore(trainer.params, trainer.opt_state)
    for epoch in (1, 2, 5, 3):
        mgr.save(epoch, trainer.params, trainer.opt_state, extra={"note": torch.tensor([epoch])})
    assert mgr.all_epochs() == [3, 5] and mgr.latest_epoch() == 5
    assert sorted(os.listdir(mgr.directory)) == ["ckpt-3.pt", "ckpt-5.pt"]
    assert mgr.restore(trainer.params, trainer.opt_state, epoch=3)[2] == 3
    with pytest.raises(FileNotFoundError):
        mgr.restore(trainer.params, trainer.opt_state, epoch=1)
    # the file holds only what weights_only loads
    state = torch.load(mgr.path(5), weights_only=True)
    assert state["epoch"] == 5 and torch.equal(state["extra"]["note"], torch.tensor([5]))


def test_a_failed_save_leaves_no_file(tmp_path, monkeypatch):
    trainer = make_trainer("MF", 1)
    trainer.initialize()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, trainer.params, trainer.opt_state)
    real = torch.save

    def dies_half_way(obj, f):
        f.write(b"PK\x03\x04 half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", dies_half_way)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, trainer.params, trainer.opt_state)
    monkeypatch.setattr(checkpoint.torch, "save", real)
    assert os.listdir(mgr.directory) == ["ckpt-1.pt"] and mgr.latest_epoch() == 1


def test_a_checkpoint_written_on_the_card_restores_without_one(tmp_path):
    """The tensors' storage location rewritten to ``cuda:0``, as a save on
    the card would record it: a plain ``torch.load`` needs a card, the
    restore (``map_location``) reads it onto the CPU."""
    trainer = make_trainer("MF", 1)
    trainer.initialize()
    trainer.params, trainer.opt_state, _ = trainer.train_epoch(1)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, trainer.params, trainer.opt_state)
    path = mgr.path(1)
    zin = zipfile.ZipFile(path)
    entries = [(info, zin.read(info.filename)) for info in zin.infolist()]
    zin.close()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zout:
        for info, data in entries:
            if info.filename.endswith("data.pkl"):
                assert b"X\x03\x00\x00\x00cpu" in data
                data = data.replace(b"X\x03\x00\x00\x00cpu", b"X\x06\x00\x00\x00cuda:0")
            zout.writestr(info, data)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch.load(path, weights_only=True)
    fresh = make_trainer("MF", 1)
    fresh.initialize()
    fresh.params, fresh.opt_state, _ = mgr.restore(fresh.params, fresh.opt_state)
    assert_same_state(trainer, fresh)


def test_a_finished_run_still_evaluates(tmp_path):
    done = make_trainer("MF", 2, verbose=1)
    attach_to_trainer(done, str(tmp_path / "ck"))
    result = done.train()
    again = make_trainer("MF", 2, verbose=1)
    assert attach_to_trainer(again, str(tmp_path / "ck")) == 3
    assert again.train() == result
    assert again.losses == []
    assert "checkpoint already at final epoch 2; evaluating" in again.logger.lines
    assert again.logger.lines[-1] == "result:\t%s" % result


def test_a_mismatched_tree_is_refused(tmp_path):
    trainer = make_trainer("MF", 1)
    trainer.initialize()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, trainer.params, trainer.opt_state)
    other = make_trainer("CFGAN", 1)
    other.initialize()
    with pytest.raises(ValueError, match="params"):
        mgr.restore(other.params, other.opt_state)


def test_start_and_kept_epochs_match_the_jax_package(tmp_path):
    """One scenario in both packages: 2 epochs saving every epoch, then the
    same directory to 6 epochs saving every 2nd, then a third run on the
    finished directory. The start epochs and the epochs kept after each run
    (``max_to_keep`` 3) are the JAX package's."""
    from neurec_tpu.checkpoint import attach_to_trainer as jax_attach
    from neurec_tpu.data.dataset import Dataset as JaxDataset
    from neurec_tpu.models import get_model as jax_get_model
    from neurec_tpu.trainer import Trainer as JaxTrainer
    from tests.helpers import make_config, make_synthetic_dataset

    make_synthetic_dataset(tmp_path, num_users=30, num_items=40)
    props = {"embedding_size": 4, "batch_size": 128, "learner": "adam", "learning_rate": 0.05,
             "is_pairwise": "True", "loss_function": "bpr", "reg_mf": 0.0}
    runs = [(2, 1), (6, 2), (6, 2)]

    def jax_run(epochs, every):
        conf = make_config(tmp_path, recommender="MF", alg_props=dict(props, epochs=epochs, verbose=epochs))
        ds = JaxDataset(conf)
        tr = JaxTrainer(jax_get_model("MF")(ds, conf), ds, conf, logger=RecordingLogger())
        start = jax_attach(tr, str(tmp_path / "jax_ck"), every=every)
        tr.train()
        kept = list(tr._ckpt._mgr.all_steps())
        tr._ckpt.close()
        return start, sorted(kept)

    def port_run(epochs, every):
        trainer = make_trainer("MF", epochs)
        start = attach_to_trainer(trainer, str(tmp_path / "port_ck"), every=every)
        trainer.train()
        return start, trainer._ckpt.all_epochs()

    want = [jax_run(*r) for r in runs]
    got = [port_run(*r) for r in runs]
    assert got == want == [(1, [1, 2]), (3, [2, 4, 6]), (7, [2, 4, 6])]
