"""The evaluation and the serving export as CUDA graphs kept across calls,
against the same programs run eagerly, on a card. These tests need an
NVIDIA GPU (CUDA graphs and the kernels have no CPU mode) and skip without
one. The file imports neither jax nor neurec_tpu:
    python -m pytest tests/test_torch_eval_graph_cuda.py -m cuda --noconftest -q

* Every registered model at small widths: the captured evaluation (its
  first call runs eagerly and captures, the next two replay) and
  ``graphs=False`` give the same metric string and the same recorded
  top-K ids, bit for bit, on the full catalogue and through a
  ``GroupedEvaluator``'s subsets; every model's programs capture.
* NAIS and DeepICF at their conf's widths, scored over their batches'
  train edges: captured == ``graphs=False`` == a second ``graphs=False``
  bit for bit over several batches, on the full catalogue and the
  sampled candidates, with one graph launch a batch and one prologue a
  warm call; their export likewise.
* Serving: captured ``batch_topk`` equals ``graphs=False``, ids and
  scores, and a second request of the same size replays the same program.
* An evaluation, 5 training steps (the optimizer updates the params in
  place), an evaluation: the second call replays its graphs, and equals an
  eager evaluation of the new params.
* A ``predict`` that reads the host raises at capture; nothing falls back.
* A warm replay of LightGCN's evaluation makes no host sync
  (``torch.cuda.set_sync_debug_mode("error")``), launches one graph a batch
  and one prologue, and counts K1 once a batch and K2 once a layer.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from neurec_tpu_torch import step_graph
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.eval import Evaluator
from neurec_tpu_torch.models import get_model, registered_models
from neurec_tpu_torch.ops import _build, graph
from neurec_tpu_torch.recommend import batch_topk
from neurec_tpu_torch.trainer import Trainer

pytestmark = pytest.mark.cuda

EVAL = {"topk": [5, 10], "metric": ["Precision", "Recall", "MAP", "NDCG", "MRR"], "test_batch_size": 64}
# each model at small widths (the card tests of the compiled training
# steps use the same), one per registered model
CONFS = {
    "lightgcn": dict(recommender="LightGCN", embed_size=16, n_layers=3, reg=0.01, adj_type="pre"),
    "ngcf": dict(recommender="NGCF", embedding_size=16, layer_size=[16, 16, 16], reg=0.01, adj_type="norm",
                 mess_dropout_ratio=0.1, node_dropout_flag=False),
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
    "wrmf": dict(recommender="WRMF", embedding_size=16, alpha=1.0, reg_mf=0.01),
    "pop": dict(recommender="Pop"),
    "itemknn": dict(recommender="ItemKNN", neighbor=8),
    "diffnet": dict(recommender="DiffNet", embedding_size=16, feature_dimension=6, user_feature_file="",
                    item_feature_file="", num_negatives=2),
}
CONFS = {c["recommender"]: dict(c, **EVAL) for c in CONFS.values()}
SOCIAL = ("SBPR", "DiffNet")
GROUPS = [6, 12, 100]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class _Silent:
    path = None

    def info(self, msg):
        pass

    debug = warning = error = critical = info


def trainer(name, tmp_path, **extra):
    """A trainer of model ``name`` on a seeded set (300 x 400; a social
    model's with a friendship file of 4 friends a user), initialized."""
    ds = random_dataset(num_users=300, num_items=400, min_per_user=4, max_per_user=24, seed=3)
    conf = dict(CONFS[name], **extra)
    if name in SOCIAL:
        ds.userids = {u: u for u in range(ds.num_users)}
        ds.itemids = {i: i for i in range(ds.num_items)}
        rng = np.random.RandomState(0)
        path = os.path.join(str(tmp_path), "friends.uu")
        with open(path, "w") as f:
            f.write("".join("%d,%d\n" % (u, v) for u in range(ds.num_users)
                            for v in rng.choice(ds.num_users, 4, replace=False)))
        conf.update({"social_file": path, "data.convert.separator": ","})
    model = get_model(name)(ds, DictConfig(conf), device="cuda")
    t = Trainer(model, ds, DictConfig(conf), seed=7, device="cuda", logger=_Silent())
    t.initialize()
    t.conf_values = conf
    return t


def recorded(ev, predict, params):
    """The metric string and the recorded ids of each of the evaluator's
    calls (one a group for a grouped evaluator)."""
    inner = getattr(ev.evaluator, "evaluator", ev.evaluator)
    inner.record_ids = True
    ids = []
    real = inner.evaluate_raw

    def raw(*args, **kwargs):
        out = real(*args, **kwargs)
        ids.append(inner.last_ids.cpu())
        return out

    inner.evaluate_raw = raw
    try:
        result = ev.evaluate(predict, params)
    finally:
        del inner.evaluate_raw
    torch.cuda.synchronize()
    return result, ids


@pytest.mark.parametrize("grouped", [False, True], ids=["catalogue", "groups"])
@pytest.mark.parametrize("name", registered_models())
def test_captured_evaluation_equals_the_eager_one(cuda, name, grouped, tmp_path):
    t = trainer(name, tmp_path)
    conf = DictConfig(dict(t.conf_values, group_view=GROUPS) if grouped else t.conf_values)
    eager, control = (Evaluator.from_dataset(t.dataset, conf, device="cuda", graphs=False) for _ in range(2))
    captured = Evaluator.from_dataset(t.dataset, conf, device="cuda")
    want, want_ids = recorded(eager, t.model.predict, t.params)
    again, again_ids = recorded(control, t.model.predict, t.params)
    assert (want, [i.tolist() for i in want_ids]) == (again, [i.tolist() for i in again_ids]), name
    for call in range(3):  # the eager call and the capture, then replays
        got, got_ids = recorded(captured, t.model.predict, t.params)
        assert got == want, (name, call)
        assert len(got_ids) == len(want_ids) and all(torch.equal(a, b) for a, b in zip(got_ids, want_ids))
    inner = getattr(captured.evaluator, "evaluator", captured.evaluator)
    assert all(k.program.capture and k.program._graphs is not None for k in inner._kept.values())


@pytest.mark.parametrize("name", ["MF", "LightGCN", "NeuMF", "CFGAN", "GRU4Rec", "NAIS", "DeepICF"])
def test_captured_serving_equals_the_eager_one(cuda, name, tmp_path):
    extra = {"mode": "itemBased"} if name == "CFGAN" else {}
    t = trainer(name, tmp_path, **extra)
    csr = t.dataset.train_matrix
    users = np.arange(0, t.model.num_users, 3, dtype=np.int32)
    for sel in (None, users):
        want = batch_topk(t.model, t.params, 10, users=sel, train_matrix=csr, batch_size=64, graphs=False)
        for _ in range(2):
            got = batch_topk(t.model, t.params, 10, users=sel, train_matrix=csr, batch_size=64)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


# NAIS's and DeepICF's conf widths (conf/NAIS.properties, conf/DeepICF.properties)
EDGE_CONFS = {
    "NAIS": dict(recommender="NAIS", embedding_size=16, weight_size=16, alpha=0.0, beta=0.5, algorithm=0,
                 activation=0, is_pairwise=False, loss_function="cross_entropy", num_neg=4),
    "DeepICF": dict(recommender="DeepICF", embedding_size=16, weight_size=16, layers=[64, 32, 16], batch_norm=True,
                    alpha=0.0, beta=0.5, algorithm=0, activation=0, num_neg=4),
}


@pytest.mark.parametrize("neg", [False, True], ids=["catalogue", "candidates"])
@pytest.mark.parametrize("name", sorted(EDGE_CONFS))
def test_edge_predict_captures_bit_equal(cuda, name, neg, monkeypatch):
    """NAIS and DeepICF at their conf's widths over 5 batches of skewed
    rows: the captured evaluation equals ``graphs=False`` (itself equal
    over two calls), each warm call one graph a batch and one prologue."""
    ds = random_dataset(num_users=300, num_items=500, min_per_user=2, max_per_user=60, seed=5)
    if neg:
        rng = np.random.RandomState(1)
        rows, cols = [], []
        for u in range(ds.num_users):
            seen = set(ds.train_matrix[u].indices) | set(ds.test_matrix[u].indices)
            free = [i for i in range(ds.num_items) if i not in seen]
            cols += list(rng.choice(free, 20, replace=False))
            rows += [u] * 20
        ds.negative_matrix = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=ds.train_matrix.shape)
    conf = DictConfig(dict(EDGE_CONFS[name], **EVAL))
    model = get_model(name)(ds, conf, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(3))
    with torch.no_grad():  # weights off their init, so the attention is not flat
        for leaf in (params["Q_set"], params["Q"], params["W"]):
            leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator(device="cuda").manual_seed(9),
                                   device="cuda") * 0.3)
    eager, control = (Evaluator.from_dataset(ds, conf, device="cuda", graphs=False) for _ in range(2))
    captured = Evaluator.from_dataset(ds, conf, device="cuda")

    def call(ev):  # the candidates protocol records no ids
        if neg:
            return ev.evaluate(model.predict, params), []
        return recorded(ev, model.predict, params)

    want, want_ids = call(eager)
    again, again_ids = call(control)
    assert want == again and all(torch.equal(a, b) for a, b in zip(want_ids, again_ids))
    replays = []
    real = step_graph._CudaGraphs.replay

    def replay(g):
        replays.append(g)
        real(g)

    monkeypatch.setattr(step_graph._CudaGraphs, "replay", staticmethod(replay))
    for turn in range(3):  # the eager call and the capture, then replays
        n = len(replays)
        got, got_ids = call(captured)
        assert got == want, (name, turn)
        assert all(torch.equal(a, b) for a, b in zip(got_ids, want_ids))
        (kept,) = captured.evaluator._kept.values()
        n_batches = kept.batches[0].shape[0]
        assert n_batches >= 2 and kept.program._graphs is not None
        if turn:
            assert len(replays) - n == n_batches + 1
    if not neg:
        csr = ds.train_matrix
        want = batch_topk(model, params, 10, train_matrix=csr, batch_size=64, graphs=False)
        for _ in range(2):
            got = batch_topk(model, params, 10, train_matrix=csr, batch_size=64)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


def test_evaluation_after_training_steps_replays_on_the_new_weights(cuda, tmp_path):
    for name in ("LightGCN", "MF"):
        t = trainer(name, tmp_path)
        before = t.evaluate()
        inner = t.evaluator.evaluator
        (kept,) = inner._kept.values()
        params_before = {k: v.detach().clone() for k, v in t.params.items()}
        t.params, t.opt_state, _ = t.train_epoch(1, max_steps=5)
        assert any(not torch.equal(params_before[k], v) for k, v in t.params.items())
        after = t.evaluate()
        (kept_after,) = inner._kept.values()
        assert kept_after is kept  # replayed, not captured anew
        eager = Evaluator.from_dataset(t.dataset, t.config, device="cuda", graphs=False)
        assert after == eager.evaluate(t.model.predict, t.params) and after != before, name


def test_a_host_read_in_predict_raises_at_capture(cuda, tmp_path):
    t = trainer("MF", tmp_path)

    def syncing_predict(params, users):
        float(users.sum())  # a host read
        return t.model.predict(params, users)

    with pytest.raises(RuntimeError):
        t.evaluator.evaluate(syncing_predict, t.params)
    with pytest.raises(RuntimeError):  # again: no eager program was left behind
        t.evaluator.evaluate(syncing_predict, t.params)
    eager = Evaluator.from_dataset(t.dataset, t.config, device="cuda", graphs=False)
    assert eager.evaluate(syncing_predict, t.params) == eager.evaluate(t.model.predict, t.params)


def test_a_warm_replay_reads_nothing_on_the_host(cuda, tmp_path, monkeypatch):
    monkeypatch.setattr(graph, "DENSE_LIMIT", 0)  # K2 in the prologue
    t = trainer("LightGCN", tmp_path)
    want = t.evaluate()
    inner = t.evaluator.evaluator
    (kept,) = inner._kept.values()
    n_batches = kept.batches[0].shape[0]
    replays = []
    real = step_graph._CudaGraphs.replay

    def replay(g):
        replays.append(g)
        real(g)

    monkeypatch.setattr(step_graph._CudaGraphs, "replay", staticmethod(replay))
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    _build.reset_launches()
    torch.cuda.synchronize()
    kept.args["params"] = t.params
    torch.cuda.set_sync_debug_mode("error")
    try:
        kept.program.run(n_batches)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        kept.args["params"] = None
    assert len(replays) == n_batches + 1
    assert kept.program.pool_bytes > 0
    assert _build.LAUNCHES["masked_scores"] == n_batches
    assert _build.LAUNCHES["plan_spmm"] == t.model.n_layers
    assert inner._mean(kept.total, kept.count).tolist() == inner.evaluate_raw(t.model.predict, t.params).tolist()
    assert t.evaluate() == want
