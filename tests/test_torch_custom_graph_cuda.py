"""The custom epochs' steps captured as CUDA graphs against the same steps
run eagerly, on a card. These tests need an NVIDIA GPU (CUDA graphs have no
CPU mode) and skip without one. The file imports neither jax nor
neurec_tpu:
    python -m pytest tests/test_torch_custom_graph_cuda.py -m cuda --noconftest -q

For SBPR, Caser, SASRec, SRGNN, JCA, CFGAN, IRGAN, GRU4Rec and GRU4RecPlus
at small widths, from one seed, ``Trainer(graphs=False)`` and the captured
epochs (``scan_unroll`` 1 and 3) must give the same epoch losses, params
and optimizer state over two epochs, bit for bit: the same kernels in the
same order on the same inputs. Where two eager runs differ too (a
backward that adds through atomics, as a gather's ``scatter_add`` does),
the captured run is held within ``ATOL`` of the eager one. A capture that
meets a host sync raises; ``graphs=False`` opens no graph.
"""

import os

import numpy as np
import pytest
import torch

from neurec_tpu_torch import step_graph
from neurec_tpu_torch.bridge import param_leaves
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.trainer import Trainer

pytestmark = pytest.mark.cuda

EVAL = {"topk": [5, 10], "metric": ["Recall", "NDCG"], "test_batch_size": 64}
CONFS = {
    "sbpr": dict(recommender="SBPR", embedding_size=16, batch_size=128, learning_rate=0.05),
    "caser": dict(recommender="Caser", factors_num=16, seq_L=3, seq_T=2, nv=2, nh=3, dropout=0.3, neg_samples=2,
                  l2_reg=0.01, lr=0.01, batch_size=64),
    "sasrec": dict(recommender="SASRec", hidden_units=16, max_len=8, num_blocks=2, num_heads=2, dropout_rate=0.3,
                   l2_emb=0.01, lr=0.01, batch_size=32),
    "srgnn": dict(recommender="SRGNN", hidden_size=16, max_seq_len=8, lr=0.01, lr_dc_step=1, batch_size=64),
    "jca": dict(recommender="JCA", hidden_neuron=16, reg=0.01, f_act="tanh", g_act="sigmoid", num_neg=2,
                batch_size=64),
    "cfgan": dict(recommender="CFGAN", hiddenLayer_G=[32], hiddenLayer_D=[16], batchSize_G=32, batchSize_D=32,
                  step_G=2, step_D=2, mode="itemBased", reg_D=0.01, epochs=4),
    "irgan": dict(recommender="IRGAN", factors_num=8, d_reg=0.01, g_reg=0.01, lr=0.05, batch_size=128),
    "gru4rec": dict(recommender="GRU4Rec", layers=[16], loss="top1", reg=0.01, lr=0.01, batch_size=16),
    "gru4recplus": dict(recommender="GRU4RecPlus", layers=[16], loss="bpr_max", bpr_reg=1.0, n_sample=32,
                        reg=0.01, lr=0.01, batch_size=16),
}
for _c in CONFS.values():
    _c.update(EVAL, learner="adam", learning_rate=_c.get("learning_rate", 0.01), epochs=_c.get("epochs", 2))
# two eager runs that differ (atomics) hold the captured run within this
ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class _Silent:
    path = None

    def info(self, msg):
        pass

    debug = warning = error = critical = info


def dataset(name, tmp_path):
    """A seeded dataset; SBPR's with a friendship file of 4 friends a user."""
    ds = random_dataset(num_users=300, num_items=400, min_per_user=4, max_per_user=24, seed=3)
    conf = dict(CONFS[name])
    if name == "sbpr":
        ds.userids = {u: u for u in range(ds.num_users)}
        rng = np.random.RandomState(0)
        path = os.path.join(str(tmp_path), "friends.uu")
        with open(path, "w") as f:
            f.write("".join("%d,%d\n" % (u, v) for u in range(ds.num_users)
                            for v in rng.choice(ds.num_users, 4, replace=False)))
        conf.update({"social_file": path, "data.convert.separator": ","})
    return ds, DictConfig(conf)


def trainer(name, tmp_path, graphs, unroll=1):
    ds, conf = dataset(name, tmp_path)
    model = get_model(conf["recommender"])(ds, conf, device="cuda")
    t = Trainer(model, ds, conf, seed=7, device="cuda", graphs=graphs, logger=_Silent())
    t.scan_unroll = unroll
    t.initialize()
    return t


def _opt_tensors(opt):
    opts = opt.values() if isinstance(opt, dict) else [opt]
    return [v for o in opts for p in o.state for v in o.state[p].values() if isinstance(v, torch.Tensor)]


def two_epochs(t):
    """Two epochs: the losses, then every param and optimizer tensor."""
    losses = []
    for epoch in (1, 2):
        t.params, t.opt_state, loss = t.train_epoch(epoch)
        losses.append(loss)
    torch.cuda.synchronize()
    return [torch.stack(losses)] + [p.detach().clone() for _, p in param_leaves(t.params)] + \
        [v.clone() for v in _opt_tensors(t.opt_state)]


def max_diff(a, b):
    assert len(a) == len(b)
    return max(float((x.float() - y.float()).abs().max()) if x.numel() else 0.0 for x, y in zip(a, b))


@pytest.mark.parametrize("name", sorted(CONFS))
@pytest.mark.parametrize("unroll", [1, 3])
def test_captured_epochs_equal_the_eager_ones(cuda, name, unroll, tmp_path):
    eager, control, captured = (trainer(name, tmp_path, g, unroll) for g in (False, False, True))
    assert not step_graph.captures(eager.device, eager.graphs, eager.mesh)
    assert step_graph.captures(captured.device, captured.graphs, captured.mesh)
    want, again, got = (two_epochs(t) for t in (eager, control, captured))
    assert torch.isfinite(want[0]).all()
    if max_diff(want, again) == 0.0:
        assert max_diff(want, got) == 0.0, (name, max_diff(want, got))
    else:
        assert max_diff(want, got) <= ATOL, (name, max_diff(want, again), max_diff(want, got))


def test_a_host_sync_in_a_custom_step_raises(cuda, tmp_path):
    """A step that reads a value on the host cannot be captured: the epoch
    raises, nothing falls back to eager steps."""
    t = trainer("sbpr", tmp_path, True)
    real = t.model.sbpr_loss

    def syncing(*args):
        loss = real(*args)
        float(loss.detach())  # a host read
        return loss

    t.model.sbpr_loss = syncing
    with pytest.raises(RuntimeError):
        t.train_epoch(1)


@pytest.mark.parametrize("name", ["sbpr", "irgan", "gru4rec"])
def test_graphs_false_runs_eagerly(cuda, name, tmp_path, monkeypatch):
    def no_graphs(device):
        raise AssertionError("graphs=False opened CUDA graphs")

    monkeypatch.setattr(step_graph, "_CudaGraphs", no_graphs)
    t = trainer(name, tmp_path, False)
    _, _, loss = t.train_epoch(1, max_steps=4)
    assert torch.isfinite(loss)
