"""The built-in epochs' steps captured as CUDA graphs against the same
steps run eagerly, on a card. These tests need an NVIDIA GPU (CUDA graphs
and the K2 kernel have no CPU mode) and skip without one. The file imports
neither jax nor neurec_tpu:
    python -m pytest tests/test_torch_step_graph_cuda.py -m cuda --noconftest -q

From one state and one epoch's draws, ``Trainer(graphs=False)`` and the
captured ``run_epoch`` (``scan_unroll`` 1 and 3) must give the same losses,
params and optimizer state bit for bit: the same kernels in the same order
on the same inputs. NGCF's node dropout sums its edges with
``index_add_``, whose atomics add in no fixed order, so there the two are
held within 1e-5 (1.4e-6 apart after 2 epochs on an H100). K2's launches
are counted per replayed step: 3 forward and 3 backward a LightGCN or NGCF
step.
"""

import copy

import pytest
import torch

from neurec_tpu_torch.bridge import param_leaves
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.ops import _build, graph
from neurec_tpu_torch.trainer import Trainer

pytestmark = pytest.mark.cuda

EVAL = {"topk": [5, 10], "metric": ["Recall", "NDCG"], "test_batch_size": 64}
CONFS = {
    "lightgcn": dict(recommender="LightGCN", embed_size=16, n_layers=3, reg=0.01, adj_type="pre"),
    "ngcf": dict(recommender="NGCF", embedding_size=16, layer_size=[16, 16, 16], reg=0.01, adj_type="norm",
                 mess_dropout_ratio=0.1, node_dropout_flag=False),
    "ngcf-node": dict(recommender="NGCF", embedding_size=16, layer_size=[16, 8], reg=0.01, adj_type="norm",
                      mess_dropout_ratio=0.1, node_dropout_flag=True, node_dropout_ratio=0.1),
    "mf": dict(recommender="MF", embedding_size=16, reg_mf=0.01, is_pairwise=False, loss_function="cross_entropy",
               num_neg=2),
    "fism": dict(recommender="FISM", embedding_size=16, alpha=0.5, is_pairwise=True, loss_function="bpr",
                 **{"lambda": 0.01, "gamma": 0.02}),
    "nais": dict(recommender="NAIS", embedding_size=16, weight_size=8, regs=[0.01, 0.02, 0.03], alpha=0.3,
                 beta=0.5, algorithm=1, activation=0, is_pairwise=False, loss_function="cross_entropy", num_neg=2),
    "deepicf": dict(recommender="DeepICF", embedding_size=16, weight_size=8, layers=[16, 8], batch_norm=True,
                    regs=[0.01, 0.02, 0.03], alpha=0.3, beta=0.5, num_neg=2),
    "neumf": dict(recommender="NeuMF", embedding_size=8, layers=[32, 16, 8], reg_mf=0.01, reg_mlp=0.02,
                  is_pairwise=False, loss_function="cross_entropy", num_neg=2),
    "mlp": dict(recommender="MLP", layers=[32, 16, 8], reg_mlp=0.01, is_pairwise=True, loss_function="bpr"),
    "apr": dict(recommender="APR", embedding_size=16, reg=0.01, reg_adv=1.0, adv="random", eps=0.5, adv_epoch=0),
    "convncf": dict(recommender="ConvNCF", embedding_size=16, net_channel=[4, 4, 4, 4], regs=[0.01, 0.02, 0.03],
                    lr_embed=0.05, lr_net=0.02, keep=0.8),
    "dmf": dict(recommender="DMF", layers=[32, 16], loss_function="cross_entropy", num_negatives=2),
    "spectralcf": dict(recommender="SpectralCF", embedding_size=16, num_layers=2, reg=0.01),
    "fpmc": dict(recommender="FPMC", embedding_size=16, reg_mf=0.01, is_pairwise=True, loss_function="bpr"),
    "fpmcplus": dict(recommender="FPMCplus", embedding_size=16, weight_size=8, high_order=3, reg_mf=0.01,
                     reg_w=0.01, is_pairwise=True, loss_function="BPR"),
    "fossil": dict(recommender="Fossil", embedding_size=16, alpha=0.5, regs=[0.01, 0.02, 0.03], high_order=2,
                   is_pairwise=False, num_neg=2, loss_function="cross_entropy"),
    "hrm": dict(recommender="HRM", embedding_size=16, reg_mf=0.01, high_order=2, pre_agg="avg",
                session_agg="max", num_neg=2),
    "npe": dict(recommender="NPE", embedding_size=16, reg=0.01, high_order=3, num_neg=2),
    "transrec": dict(recommender="TransRec", embedding_size=16, reg_mf=0.01, is_pairwise=True, loss_function="bpr"),
    "multidae": dict(recommender="MultiDAE", p_dim=[16, 32], reg=0.01, keep_prob=0.8),
    "multivae": dict(recommender="MultiVAE", p_dim=[16, 32], reg=0.01, total_anneal_steps=10, anneal_cap=0.5),
    "dae": dict(recommender="DAE", hidden_neuron=16, corruption_level=0.3, reg=0.01),
    "cdae": dict(recommender="CDAE", hidden_dim=16, num_neg=2, dropout=0.5, reg=0.01),
}
for _c in CONFS.values():
    _c.update(EVAL, batch_size=64, learner="adam", learning_rate=0.01)
CONFS["lightgcn"].update(batch_size=128)
CONFS["mlp"].update(learner="momentum", learning_rate=0.05)
CONFS["fossil"].update(learner="gd", learning_rate=0.05)
CONFS["npe"].update(learner="rmsprop")
# index_add_'s atomics: the same sums in another order
ATOL = {"ngcf-node": 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def trainers(name, monkeypatch):
    """An eager and a captured trainer of the same model from one seed."""
    if name in ("lightgcn", "ngcf", "ngcf-node"):  # the plan SpMM: K2 both ways
        monkeypatch.setattr(graph, "DENSE_LIMIT", 0)
    ds = random_dataset(num_users=300, num_items=400, min_per_user=4, max_per_user=24, seed=3)
    out = []
    for graphs in (False, True):
        model = get_model(CONFS[name]["recommender"])(ds, DictConfig(CONFS[name]), device="cuda")
        trainer = Trainer(model, ds, DictConfig(CONFS[name]), seed=7, device="cuda", graphs=graphs,
                          logger=_Silent())
        trainer.initialize()
        out.append(trainer)
    return out


class _Silent:
    path = None

    def info(self, msg):
        pass

    debug = warning = error = critical = info


def _state(trainer):
    params = {path: p.detach().clone() for path, p in param_leaves(trainer.params)}
    opt = copy.deepcopy(trainer.opt_state.state_dict()["state"])
    return params, opt


def _max_diff(a, b):
    return max(float((a[k].float() - b[k].float()).abs().max()) if a[k].numel() else 0.0 for k in a)


@pytest.mark.parametrize("name", sorted(CONFS))
@pytest.mark.parametrize("unroll", [1, 3])
def test_captured_epoch_equals_the_eager_one(cuda, name, unroll, monkeypatch):
    eager, captured = trainers(name, monkeypatch)
    captured.scan_unroll = unroll
    assert not eager._captures() and captured._captures()
    assert eager.steps >= 4
    atol = ATOL.get(name, 0.0)
    for epoch in (1, 2):
        draws = eager.draw_epoch(eager.epoch_generator(epoch))
        losses = []
        for t in (eager, captured):
            t.params, t.opt_state, loss = t.run_epoch(t.params, t.opt_state, *draws, epoch=epoch)
            losses.append(loss)
        torch.cuda.synchronize()
        assert torch.isfinite(losses[0])
        assert abs(float(losses[0]) - float(losses[1])) <= atol, (epoch, float(losses[0]), float(losses[1]))
        (pe, oe), (pc, oc) = _state(eager), _state(captured)
        assert _max_diff(pe, pc) <= atol, epoch
        for k in oe:
            for key, v in oe[k].items():
                if isinstance(v, torch.Tensor) and v.is_floating_point() and v.dim():
                    assert float((v - oc[k][key]).abs().max()) <= atol, (k, key)
                else:
                    assert float(v) == float(oc[k][key]), (k, key)


@pytest.mark.parametrize("name", ["lightgcn", "ngcf"])
def test_k2_launches_counted_per_replayed_step(cuda, name, monkeypatch):
    _, captured = trainers(name, monkeypatch)
    captured.scan_unroll = 4
    draws = captured.draw_epoch(captured.epoch_generator(1))
    steps = draws.inst.shape[0]
    _build.reset_launches()
    captured.run_epoch(captured.params, captured.opt_state, *draws, epoch=1)
    torch.cuda.synchronize()
    n_layers = captured.model.n_layers
    assert (_build.LAUNCHES["plan_spmm"], _build.LAUNCHES["plan_spmm_t"]) == (n_layers * steps, n_layers * steps)
    assert n_layers == 3


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A step that synchronises with the host cannot be captured: the
    epoch raises, nothing falls back to eager steps."""
    eager, captured = trainers("mf", monkeypatch)
    real = captured.model.loss

    def syncing(params, batch, weights):
        loss = real(params, batch, weights)
        float(loss)  # a host read
        return loss

    captured.model.loss = syncing
    draws = captured.draw_epoch(captured.epoch_generator(1))
    with pytest.raises(RuntimeError):
        captured.run_epoch(captured.params, captured.opt_state, *draws, epoch=1)
