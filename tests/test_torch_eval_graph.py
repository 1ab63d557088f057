"""The evaluation and the serving export as programs kept across calls, on
the CPU.

On a CUDA device a call of the evaluator, or of ``batch_topk``, replays
CUDA graphs (``step_graph.KeptProgram``): a prologue once and a body a
batch that reads its batch at a device cursor. On the CPU the same
prologue and body run eagerly. Held here:

* on every tier that one device reaches (``bits`` factorized, hoisted,
  on ``predict``'s scores and on the dense hook's; ``pallas``; ``scatter``;
  the streamed ``bits``; the sampled candidates), on the full catalogue
  and on a subset, the cursor-indexed program against the Python-indexed
  loop it replaced (written here), bit for bit: the metric matrix and the
  recorded top-K ids;
* ``make_scatter_topk`` (one fill at flat offsets, no boolean index) and
  ``batch_topk`` (the same fill, its edge count padded to a power of two)
  against the JAX package's at small sizes: the same ids and scores;
* the evaluator's program cache, with a stub in place of the CUDA side
  (as ``tests/test_torch_step_graph.py`` stubs it): a new ``params`` dict,
  another value of ``NEUREC_SPMM_PACK`` / ``_DTYPE`` / ``_PALLAS``, a
  kernel wrapper replaced by its plain version and ``record_ids`` each
  capture anew and release the old program; an update in place does not;
  the programs are an LRU of 8 over batch sets; a kept program
  replays its prologue once and its body once a batch and adds the
  captured launches once a replay;
* the serving cache: a weak hold on the model (its death evicts and
  releases), an LRU of 8, a capture per request size, anew for new params;
* no model evaluates eagerly by declaration: NAIS and DeepICF, the last
  two, score over their batch's train edges at a capacity the caller
  gives (``predict_capacity``);
* every registered model's evaluation program, captured through the stub
  under a guard that raises on a host read (a sync op, a boolean index,
  ``.cpu()``, ``.numpy()``, host data copied in): the guard stays quiet,
  and the captured result equals the eager one, NAIS and DeepICF too.
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.data.synthetic import random_dataset as jax_random_dataset
from neurec_tpu.eval import tiers as jax_tiers
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.recommend import _batch_edges_from_csr as jax_batch_edges
from neurec_tpu.recommend import batch_topk as jax_batch_topk
from neurec_tpu_torch import recommend, step_graph
from neurec_tpu_torch.bridge import params_from_numpy
from neurec_tpu_torch.config import Config
from neurec_tpu_torch.data.dataset import Dataset
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.eval import evaluator as evaluator_mod
from neurec_tpu_torch.eval import tiers
from neurec_tpu_torch.eval.evaluator import GroupedEvaluator, UniEvaluator, candidate_metrics
from neurec_tpu_torch.models import get_model, registered_models
from neurec_tpu_torch.ops import _build, graph
from neurec_tpu_torch.ops import masked_scores as k1
from neurec_tpu_torch.ops.metrics import all_metrics, hit_matrix
from neurec_tpu_torch.recommend import batch_topk
from tests.helpers import make_config, make_synthetic_dataset
from tests.test_social_models import _make_social_file
from tests.port_props import props_for as _props_for

torch.set_float32_matmul_precision("highest")

EVAL = {"topk": [3, 10], "metric": ["Precision", "Recall", "MAP", "NDCG", "MRR"], "test_batch_size": 16}
CONFS = {
    "mf": dict(recommender="MF", embedding_size=8),
    "lightgcn": dict(recommender="LightGCN", embed_size=8, n_layers=2, adj_type="pre"),
    "neumf": dict(recommender="NeuMF", embedding_size=4, layers=[16, 8, 4]),
    "dmf": dict(recommender="DMF", layers=[16, 8]),
}
# tier -> (model, environment, expected plan name, protocol)
TIERS = {
    "bits": ("mf", {}, "bits", "catalogue"),
    "bits_hoisted": ("lightgcn", {}, "bits", "catalogue"),
    "bits_predict": ("neumf", {}, "bits", "catalogue"),
    "bits_dense": ("dmf", {}, "bits", "catalogue"),
    "pallas": ("mf", {"NEUREC_EVAL_PREMASK": "0"}, "pallas", "catalogue"),
    "pallas_propagated": ("lightgcn", {"NEUREC_EVAL_PREMASK": "0"}, "pallas", "catalogue"),
    "scatter": ("neumf", {"NEUREC_EVAL_PREMASK": "0"}, "scatter", "catalogue"),
    "scatter_dense": ("dmf", {"NEUREC_EVAL_PREMASK": "0"}, "scatter", "catalogue"),
    "stream": ("mf", {"NEUREC_EVAL_BITS_BUDGET": "1"}, "bits", "catalogue"),
    "stream_hoisted": ("lightgcn", {"NEUREC_EVAL_BITS_BUDGET": "1"}, "bits", "catalogue"),
    "stream_predict": ("neumf", {"NEUREC_EVAL_BITS_BUDGET": "1"}, "bits", "catalogue"),
    "candidates": ("mf", {}, "scatter", "candidates"),
    "candidates_dense": ("dmf", {}, "scatter", "candidates"),
}


def negatives(ds, n_neg=7, seed=3):
    """Each test user's sampled negatives: items in neither of its sets."""
    rng = np.random.RandomState(seed)
    train, test = ds.get_user_train_dict(), ds.get_user_test_dict()
    out = {}
    for u in test:
        seen = set(train.get(u, ())) | set(test[u])
        pool = [i for i in range(ds.num_items) if i not in seen]
        out[u] = list(rng.choice(pool, size=n_neg, replace=False))
    return out


def build(name, monkeypatch, neg=False, num_users=40, num_items=60):
    """The model ``name``, seeded params and an evaluator, on the CPU."""
    if name == "lightgcn":
        monkeypatch.setattr(graph, "DENSE_LIMIT", 0)  # the plan branch (K2's plain version)
    ds = random_dataset(num_users=num_users, num_items=num_items, seed=2)
    conf = DictConfig(dict(CONFS[name], **EVAL))
    model = get_model(conf["recommender"])(ds, conf, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(4))
    ev = UniEvaluator(ds.get_user_train_dict(), ds.get_user_test_dict(), negatives(ds) if neg else None,
                      metric=EVAL["metric"], top_k=EVAL["topk"], batch_size=EVAL["test_batch_size"],
                      num_items=ds.num_items, device="cpu")
    return model, params, ev, ds


@torch.no_grad()
def python_indexed(ev, predict_fn, params, test_users=None):
    """The evaluator's call as the Python loop over batch indices it was
    before its programs: batch ``j`` by ``users_b[j]``, the streamed
    edges by ``[j]``, out-of-place sums. Returns (metric matrix, ids)."""
    prog = ev._get_program(predict_fn)
    plan = prog.plan
    users = ev.test_users if test_users is None else np.asarray(test_users, dtype=np.int32)
    positions = np.asarray([ev._user_pos_index[int(u)] for u in users], dtype=np.int32)
    users_b, sel_b, valid_b = ev._make_batches(users, positions)
    K = min(ev.max_top, ev.num_items)
    total = torch.zeros((5, K), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.float32)
    dense_scores = prog.dense_fn(params).float() if prog.dense_fn is not None else None
    if ev.user_neg_test is not None:
        for users_j, sel, valid in zip(users_b, sel_b, valid_b):
            scores = dense_scores[users_j] if dense_scores is not None else predict_fn(params, users_j).float()
            m = candidate_metrics(scores, ev._cand_rows[sel], ev._n_pos[sel], K)
            total = total + torch.sum(m * valid[:, None, None], dim=0)
            count = count + torch.sum(valid)
        return ev._mean(total, count), None
    hoisted = None
    if prog.tables_fn is not None:
        u_table, item_table = prog.tables_fn(params)
        hoisted = (u_table.float(), item_table.float())
    if plan.stream:
        mask_data = ev._batch_edges(users_b, valid_b)
        pack = tiers.make_edge_pack(plan.pack_block, plan.bits_width)
    elif plan.bits:
        mask_data = ev._get_bits_table(plan.pack_block, plan.bits_width, None)
    ids = []
    for j, (users_j, sel, valid) in enumerate(zip(users_b, sel_b, valid_b)):
        if plan.stream:
            mask = pack(mask_data[0][j], mask_data[1][j], users_j.shape[0])
        else:
            mask = mask_data[sel] if plan.bits else ev._train_rows[users_j]
        if hoisted is not None:
            topk = prog.fact_topk(hoisted[0][users_j], hoisted[1], mask)
        elif plan.kind == "factorized":
            u_vecs, item_table = prog.factorized(params, users_j)
            topk = prog.fact_topk(u_vecs.float(), item_table.float(), mask)
        else:
            scores = dense_scores[users_j] if dense_scores is not None else predict_fn(params, users_j).float()
            topk = prog.pred_topk(scores, mask)
        ids.append(topk)
        hits = hit_matrix(topk, ev._test_rows[sel], ev._test_lens[sel])
        m = all_metrics(hits, ev._test_lens[sel])
        total = total + torch.sum(m * valid[:, None, None], dim=0)
        count = count + torch.sum(valid)
    return ev._mean(total, count), torch.cat(ids)


@pytest.mark.parametrize("subset", [False, True], ids=["catalogue", "subset"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_cursor_program_equals_the_python_loop(tier, subset, monkeypatch):
    name, env, plan_name, protocol = TIERS[tier]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    model, params, ev, _ = build(name, monkeypatch, neg=protocol == "candidates")
    prog = ev._get_program(model.predict)
    assert prog.plan.name == plan_name
    assert prog.plan.stream == tier.startswith("stream")
    assert (prog.tables_fn is not None) == tier.endswith("hoisted")
    assert (prog.dense_fn is not None) == tier.endswith("dense")
    users = ev.test_users[3:27] if subset else None
    want, want_ids = python_indexed(ev, model.predict, params, users)
    ev.record_ids = True
    for _ in range(2):  # a kept program's second call too
        got = ev.evaluate_raw(model.predict, params, users)
        assert got.dtype == np.float32 and np.array_equal(got, want), tier
        if want_ids is not None:
            assert torch.equal(ev.last_ids, want_ids)


# -- the boolean index gone: scatter tier and serving against the JAX package

@pytest.mark.parametrize("seed", range(4))
def test_scatter_topk_matches_jax(seed):
    rng = np.random.RandomState(seed)
    B, I, K = 6, 13, 5
    scores = rng.randint(0, 4, (B, I)).astype(np.float32)  # ties everywhere
    # train rows: real ids, pads (I), wrapping negatives, ids past the dump column
    rows = rng.randint(-(I + 1), I + 4, (B, 7)).astype(np.int32)
    rows[:, -2:] = I
    ids_j = np.asarray(jax_tiers.make_scatter_topk(K, I)(jnp.asarray(scores), jnp.asarray(rows)))
    ids = tiers.make_scatter_topk(K, I)(torch.from_numpy(scores), torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(ids, ids_j)


def mf_pair(num_users=30, num_items=25):
    """The MF model in both packages on one dataset, with params whose
    scores are exact in f32 (small multiples of 1/4), so both packages'
    products agree bit for bit and ties are common."""
    ds_j = jax_random_dataset(num_users=num_users, num_items=num_items, seed=6)
    ds = random_dataset(num_users=num_users, num_items=num_items, seed=6)
    conf = {"embedding_size": 4}
    model_j = jax_get_model("MF")(ds_j, JaxDictConfig(conf))
    model = get_model("MF")(ds, DictConfig(conf), device="cpu")
    rng = np.random.RandomState(1)
    params_np = {"user_emb": rng.randint(-2, 3, (num_users, 4)).astype(np.float32) / 4,
                 "item_emb": rng.randint(-2, 3, (num_items, 4)).astype(np.float32) / 4}
    return ds_j, ds, model_j, model, {k: jnp.asarray(v) for k, v in params_np.items()}, \
        params_from_numpy(params_np, "cpu")


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "open"])
@pytest.mark.parametrize("users,batch_size", [(None, 8), (None, 64), ("subset", 4), ("subset", 5)])
def test_batch_topk_matches_jax(users, batch_size, masked):
    ds_j, ds, model_j, model, params_j, params = mf_pair()
    sel = np.asarray([3, 0, 17, 17, 29, 8, 11, 2, 5, 21, 13], np.int32) if users else None
    ids_j, sc_j = jax_batch_topk(model_j, params_j, 7, users=sel, batch_size=batch_size,
                                 train_matrix=ds_j.train_matrix if masked else None)
    ids, sc = batch_topk(model, params, 7, users=sel, batch_size=batch_size,
                         train_matrix=ds.train_matrix if masked else None, device="cpu")
    np.testing.assert_array_equal(ids, np.asarray(ids_j))
    np.testing.assert_array_equal(sc, np.asarray(sc_j))


@pytest.mark.parametrize("batch_size", [3, 8, 30])
def test_edge_count_pads_to_a_power_of_two(batch_size):
    """The port's edge pairs are the JAX package's, padded further (slot
    == B) to a power of two of at least 8."""
    ds = random_dataset(num_users=30, num_items=25, seed=6)
    csr = ds.train_matrix.tocsr()
    n = 30
    n_batches = -(-n // batch_size)
    users_pad = np.zeros(n_batches * batch_size, np.int32)
    users_pad[:n] = np.arange(n)
    e_items, e_users = recommend._batch_edges_from_csr(csr, users_pad, n, n_batches, batch_size)
    e_items_j, e_users_j = jax_batch_edges(csr, users_pad, n, n_batches, batch_size)
    width, width_j = e_items.shape[1], e_items_j.shape[1]
    assert width >= max(width_j, 8) and width & (width - 1) == 0
    assert width < 2 * max(width_j, 8)
    np.testing.assert_array_equal(e_items[:, :width_j], e_items_j)
    np.testing.assert_array_equal(e_users[:, :width_j], e_users_j)
    assert (e_users[:, width_j:] == batch_size).all()


# -- the caches, with the CUDA side stubbed ---------------------------------

class StubGraphs:
    """``step_graph._CudaGraphs`` on the CPU: a capture keeps the function
    (and runs nothing: a CPU op would change the program's totals, where a
    captured kernel does not run), a replay runs it."""

    made = []

    def __init__(self, device, keep=False):
        self.captures, self.released = 0, False
        type(self).made.append(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def warm_up(self, fn):
        fn()

    def capture(self, fn, generators):
        self.captures += 1
        self.run_captured(fn)
        return fn

    def run_captured(self, fn):
        pass

    @staticmethod
    def replay(fn):
        fn()

    def release(self):
        self.released = True

    def reserved(self, empty=False):
        return 0


def on_card(device, graphs=True, mesh=None):
    """``step_graph.captures`` as on a card: wherever ``graphs`` is on."""
    return graphs


@pytest.fixture
def stubbed(monkeypatch):
    """The CUDA side stubbed; the evaluator and serving capture on the CPU
    where they would on a card."""
    StubGraphs.made = []
    monkeypatch.setattr(step_graph, "_CudaGraphs", StubGraphs)
    monkeypatch.setattr(step_graph, "captures", on_card)
    return StubGraphs.made


def test_kept_program_recaptures_when_what_it_holds_changes(stubbed, monkeypatch):
    model, params, ev, ds = build("lightgcn", monkeypatch)

    def fresh(p):
        """An eager evaluation of ``p`` by a new evaluator."""
        ev2 = UniEvaluator(ds.get_user_train_dict(), ds.get_user_test_dict(), metric=EVAL["metric"],
                           top_k=EVAL["topk"], batch_size=EVAL["test_batch_size"], num_items=ds.num_items,
                           device="cpu", graphs=False)
        return ev2.evaluate_raw(model.predict, p)

    def captures():
        assert all(s.released for s in stubbed[:-1])
        return len(stubbed)

    first = ev.evaluate_raw(model.predict, params)
    assert captures() == 1 and stubbed[0].captures == 2  # the prologue and the body
    assert np.array_equal(ev.evaluate_raw(model.predict, params), first) and captures() == 1
    with torch.no_grad():  # the optimizers' update: in place
        params["user_emb"].mul_(1.5)
    moved = ev.evaluate_raw(model.predict, params)
    assert captures() == 1 and np.array_equal(moved, fresh(params)) and not np.array_equal(moved, first)
    params = {k: v.clone() for k, v in params.items()}
    ev.evaluate_raw(model.predict, params)
    assert captures() == 2
    for n, (var, value) in enumerate([("NEUREC_SPMM_PACK", "2"), ("NEUREC_SPMM_DTYPE", "bf16"),
                                      ("NEUREC_SPMM_PALLAS", "0")]):
        monkeypatch.setenv(var, value)
        ev.evaluate_raw(model.predict, params)
        assert captures() == 3 + n
        ev.evaluate_raw(model.predict, params)
        assert captures() == 3 + n
    monkeypatch.setattr(k1, "masked_scores_bits", k1.masked_scores_bits_reference)
    ev.evaluate_raw(model.predict, params)
    assert captures() == 6
    ev.record_ids = True
    ev.evaluate_raw(model.predict, params)
    assert captures() == 7 and len(ev.kept) == 1


def test_kept_programs_are_an_lru_over_batch_sets(stubbed, monkeypatch):
    model, params, ev, _ = build("mf", monkeypatch)
    most = ev.kept.most
    assert most == 8
    subsets = [ev.test_users[i: i + 5] for i in range(most + 3)]
    for users in subsets:
        ev.evaluate_raw(model.predict, params, users)
    assert len(ev.kept) == most
    assert [s.released for s in stubbed] == [True] * 3 + [False] * most
    # the newest is replayed, not captured again
    ev.evaluate_raw(model.predict, params, subsets[-1])
    assert len(stubbed) == most + 3


def test_grouped_evaluation_keeps_a_program_a_group(stubbed, monkeypatch):
    model, params, ev, ds = build("mf", monkeypatch)
    grouped = GroupedEvaluator(ds.get_user_train_dict(), ds.get_user_test_dict(), metric=EVAL["metric"],
                               group_view=[6, 10, 100], top_k=EVAL["topk"], batch_size=8,
                               num_items=ds.num_items, device="cpu")
    first = grouped.evaluate(model.predict, params)
    n = len(stubbed)
    assert n == len(grouped.grouped_user) and grouped.evaluate(model.predict, params) == first
    assert len(stubbed) == n


def test_kept_program_replays_prologue_once_and_body_a_batch(monkeypatch):
    """The first call runs eagerly (the warm-up) and captures; each later
    call replays the prologue once and the body once a batch. Each call
    counts a kernel's launches once: the first by the wrappers, the later
    ones by the captured launches added once a replay."""
    events = []

    class Counting(StubGraphs):
        def capture(self, fn, generators):
            before = dict(_build.LAUNCHES)
            fn()  # the host code of a capture runs; its kernels do not
            assert _build.LAUNCHES != before
            return events[-1].replace("eager ", "")  # what the capture ran

        @staticmethod
        def replay(name):
            events.append(name)

    def prologue(params):
        _build.LAUNCHES["plan_spmm"] += 3
        events.append("eager prologue")

    def body(params):
        _build.LAUNCHES["masked_scores"] += 1
        events.append("eager body")

    monkeypatch.setattr(step_graph, "_CudaGraphs", Counting)
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    _build.reset_launches()
    program = step_graph.KeptProgram(prologue, body, torch.device("cpu"), capture=True)
    program.run(5)
    # the eager call, then the captures' host code
    assert events == ["eager prologue"] + ["eager body"] * 5 + ["eager prologue", "eager body"]
    assert (_build.LAUNCHES["plan_spmm"], _build.LAUNCHES["masked_scores"]) == (3, 5)
    events.clear()
    program.run(5)
    assert events == ["prologue"] + ["body"] * 5
    assert (_build.LAUNCHES["plan_spmm"], _build.LAUNCHES["masked_scores"]) == (6, 10)
    events.clear()
    program.run(2)
    assert events == ["prologue", "body", "body"]
    assert (_build.LAUNCHES["plan_spmm"], _build.LAUNCHES["masked_scores"]) == (9, 12)
    program.release()
    assert program.body is None


def test_a_failed_capture_raises_and_keeps_no_graph(monkeypatch):
    class Failing(StubGraphs):
        def capture(self, fn, generators):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(step_graph, "_CudaGraphs", Failing)
    Failing.made = []
    program = step_graph.KeptProgram(lambda params: None, lambda params: None, torch.device("cpu"), capture=True)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            program.run(3)
        assert program._graphs is None
    assert [g.released for g in Failing.made] == [True, True]


def test_serving_holds_its_model_weakly(monkeypatch):
    _, ds, _, model, _, params = mf_pair()
    batch_topk(model, params, 5, train_matrix=ds.train_matrix, device="cpu")
    batch_topk(model, params, 3, train_matrix=ds.train_matrix, device="cpu")
    mid = id(model)
    mine = [v for k, v in recommend.EXPORTS.items() if k[0] == mid]
    assert len(mine) == 2
    ref = weakref.ref(model)
    del model
    gc.collect()
    assert ref() is None  # the cache did not keep it alive
    assert not [k for k in recommend.EXPORTS if k[0] == mid] and all(e.body is None for e in mine)


def test_serving_cache_is_an_lru_of_8():
    _, ds, _, model, _, params = mf_pair()
    recommend.EXPORTS.release()
    exports = []
    for k in range(1, 11):
        batch_topk(model, params, k, device="cpu")
        exports.append(list(recommend.EXPORTS.values())[-1])
    assert len(recommend.EXPORTS) == recommend.EXPORTS.most == 8
    assert [e.body is None for e in exports] == [True] * 2 + [False] * 8


def test_serving_captures_once_a_request_size(stubbed):
    ds_j, ds, model_j, model, params_j, params = mf_pair()
    recommend.EXPORTS.release()
    a = np.arange(0, 12, dtype=np.int32)
    b = np.arange(12, 24, dtype=np.int32)
    e_a = recommend._batch_edges_from_csr(ds.train_matrix.tocsr(), a, 12, 3, 4)[0].shape[1]
    e_b = recommend._batch_edges_from_csr(ds.train_matrix.tocsr(), b, 12, 3, 4)[0].shape[1]
    assert e_a == e_b  # rounded to one power of two
    got_a = batch_topk(model, params, 6, users=a, batch_size=4, train_matrix=ds.train_matrix, device="cpu")
    got_b = batch_topk(model, params, 6, users=b, batch_size=4, train_matrix=ds.train_matrix, device="cpu")
    assert len(stubbed) == 1
    for users, got in ((a, got_a), (b, got_b)):
        want = jax_batch_topk(model_j, params_j, 6, users=users, batch_size=4, train_matrix=ds_j.train_matrix)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    with torch.no_grad():
        params["item_emb"].mul_(2.0)  # in place: replayed
    batch_topk(model, params, 6, users=a, batch_size=4, train_matrix=ds.train_matrix, device="cpu")
    assert len(stubbed) == 1
    batch_topk(model, {k: v.clone() for k, v in params.items()}, 6, users=a, batch_size=4,
               train_matrix=ds.train_matrix, device="cpu")
    assert len(stubbed) == 2 and stubbed[0].released


def test_the_eager_models_are_nais_and_deepicf():
    """None evaluates eagerly any more: the flag that declared it is gone,
    and the two that set it take their edge capacity from the caller."""
    assert [name for name in registered_models() if hasattr(get_model(name), "eval_graphs")] == []
    sized = [name for name in registered_models() if hasattr(get_model(name), "predict_capacity")]
    assert sized == ["DeepICF", "NAIS"]
    assert step_graph.captures(torch.device("cuda")) and not step_graph.captures(torch.device("cpu"))


# -- every model's program captured under a guard against host reads ------

class HostRead(RuntimeError):
    pass


# ops that read a device value on the host (or wait for the device) on a card
SYNC_OPS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select", "aten::unique_dim",
            "aten::_unique", "aten::_unique2", "aten::unique_consecutive", "aten::bincount",
            "aten::lift_fresh", "aten::equal", "aten::is_nonzero"}
INDEX_OPS = {"aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_"}


class NoHostReads(TorchDispatchMode):
    """Raises on an op that would read the host inside a CUDA-graph
    capture: a sync op, a boolean index, ``repeat_interleave`` or
    ``segment_reduce`` that size their output from the data, and (patched
    on ``torch.Tensor`` while active) ``.cpu()``, ``.numpy()``,
    ``.tolist()``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in SYNC_OPS:
            raise HostRead(name)
        if name in INDEX_OPS and any(i is not None and i.dtype in (torch.bool, torch.uint8) for i in args[1]):
            raise HostRead("%s with a boolean index" % name)
        if name == "aten::repeat_interleave" and isinstance(args[0], torch.Tensor) and kwargs.get(
                "output_size") is None and (len(args) < 2 or isinstance(args[1], torch.Tensor)):
            raise HostRead(name)
        if name == "aten::segment_reduce" and not kwargs.get("unsafe", False):
            raise HostRead(name)
        return func(*args, **kwargs)

    def __enter__(self):
        self._saved = {m: getattr(torch.Tensor, m) for m in ("cpu", "numpy", "tolist")}
        for m in self._saved:
            setattr(torch.Tensor, m, self._raiser(m))
        return super().__enter__()

    def __exit__(self, *exc):
        for m, fn in self._saved.items():
            setattr(torch.Tensor, m, fn)
        return super().__exit__(*exc)

    @staticmethod
    def _raiser(m):
        def read(*args, **kwargs):
            raise HostRead("Tensor.%s" % m)
        return read


class GuardedGraphs(StubGraphs):
    def run_captured(self, fn):
        with NoHostReads():
            fn()


def zoo_model(tmp_path, name):
    """The port's model ``name`` on the 60-user x 80-item synthetic set
    (the JAX zoo tests' properties), on the CPU."""
    make_synthetic_dataset(tmp_path, num_users=60, num_items=80)
    social = str(_make_social_file(tmp_path, num_users=60))
    make_config(tmp_path, recommender=name, alg_props=_props_for(name, social), test_batch_size=16)
    conf = Config(str(tmp_path / "NeuRec.properties"), cmd_args=["--data.cache.path=%s" % (tmp_path / "port")])
    ds = Dataset(conf)
    model = get_model(name)(ds, conf, device="cpu")
    return model, model.init_params(torch.Generator().manual_seed(0)), ds, conf


@pytest.mark.parametrize("name", registered_models())
def test_every_model_captures_without_a_host_read(name, tmp_path, monkeypatch):
    model, params, ds, conf = zoo_model(tmp_path, name)
    eager = evaluator_mod.Evaluator.from_dataset(ds, conf, device="cpu", graphs=False).evaluate(model.predict, params)
    GuardedGraphs.made = []
    monkeypatch.setattr(step_graph, "_CudaGraphs", GuardedGraphs)
    forced = evaluator_mod.Evaluator.from_dataset(ds, conf, device="cpu")
    monkeypatch.setattr(step_graph, "captures", on_card)
    # the first call runs eagerly, then captures: the guard runs the
    # captures' host code, and its CPU ops spoil that call's totals
    forced.evaluate(model.predict, params)
    assert forced.evaluate(model.predict, params) == eager  # replays
    assert forced.evaluate(model.predict, params) == eager
    assert len(GuardedGraphs.made) == 1
