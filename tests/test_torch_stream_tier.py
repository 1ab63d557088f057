"""The streamed bits tier (a bits table above ``NEUREC_EVAL_BITS_BUDGET``)
against the resident table and the JAX package's streamed tier, on the CPU.

The streamed pack is the table's layout packed per batch from the batch's
(item, slot) edges, so everything is exact: the same bits as the table's
rows over the catalogue (the table also sets its pad id's column, past
the catalogue, which no score reads), the same top-K ids, the same metric
strings, character for character (at the widths of
tests/test_eval_tiers.py:210: 48 users, 700 items, batch 16). Cases: a factorized model, a model with ``eval_tables``
(hoisted), a ``predict``-only model (the bits predict tier), a subset of
the users (grouped evaluation), and the JAX package's streamed string.
The edge tensors are sized by the batches' interactions, not U * L_max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.eval import tiers as jax_tiers
from neurec_tpu.eval.evaluator import UniEvaluator as JaxUniEvaluator
from neurec_tpu_torch.eval import tiers
from neurec_tpu_torch.eval.evaluator import UniEvaluator
from neurec_tpu_torch.ops.masked_scores import bits_expand


def fixture(seed=3, num_users=48, num_items=700, d=16):
    rng = np.random.RandomState(seed)
    train, test = {}, {}
    for u in range(num_users):
        items = rng.choice(num_items, size=rng.randint(6, 40), replace=False)
        n_test = max(1, len(items) // 5)
        train[u] = sorted(items[:-n_test].tolist())
        test[u] = sorted(items[-n_test:].tolist())
    train[num_users - 1] = list(range(0, num_items, 2))  # one heavy row
    params = {"u": rng.standard_normal((num_users, d)).astype(np.float32),
              "q": rng.standard_normal((num_items, d)).astype(np.float32)}
    return train, test, params


class TinyMF:
    def predict(self, p, users):
        return p["u"][users] @ p["q"].T

    def eval_embeddings(self, p, users):
        return p["u"][users], p["q"]


class TinyHoisted(TinyMF):
    def eval_tables(self, p):
        return p["u"] * 0.5, p["q"]

    def eval_embeddings(self, p, users):
        return p["u"][users] * 0.5, p["q"]

    def predict(self, p, users):
        return (p["u"][users] * 0.5) @ p["q"].T


class TinyPredict:
    def predict(self, p, users):
        return p["u"][users] @ p["q"].T


KW = dict(metric=["Recall", "NDCG", "Precision"], top_k=[10, 20], batch_size=16, num_items=700)


def both(monkeypatch, train, test, params, model, users=None):
    monkeypatch.delenv("NEUREC_EVAL_PREMASK", raising=False)
    monkeypatch.delenv("NEUREC_EVAL_BITS_BUDGET", raising=False)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ev_tab = UniEvaluator(train, test, device="cpu", **KW)
    want = ev_tab.evaluate(model.predict, tp, users)
    assert ev_tab._get_program(model.predict).plan.table
    monkeypatch.setattr(tiers, "BITS_TABLE_BUDGET", 0)
    ev_str = UniEvaluator(train, test, device="cpu", **KW)
    got = ev_str.evaluate(model.predict, tp, users)
    assert ev_str._get_program(model.predict).plan.stream
    assert ev_str._bits_tables == {}, "a streamed plan built the table"
    return ev_tab, ev_str, want, got


@pytest.mark.parametrize("kind", ["factorized", "hoisted", "predict"])
def test_streamed_equals_the_table(monkeypatch, kind):
    train, test, params = fixture()
    model = {"factorized": TinyMF, "hoisted": TinyHoisted, "predict": TinyPredict}[kind]()
    ev_tab, ev_str, want, got = both(monkeypatch, train, test, params, model)
    assert got == want
    plan = ev_str._get_program(model.predict).plan
    assert plan.hoist == (kind == "hoisted") and plan.kind == ("predict" if kind == "predict" else "factorized")
    # the packed planes of every batch are the table's rows over the catalogue
    table = ev_tab._get_bits_table(plan.pack_block, plan.bits_width)
    users_b, sel_b, valid_b = ev_str._default_batches
    e_items, e_slots = ev_str._edges[None]
    pack = tiers.make_edge_pack(plan.pack_block, plan.bits_width)
    for j in range(users_b.shape[0]):
        bits = pack(e_items[j], e_slots[j], users_b.shape[1])
        real = valid_b[j] > 0
        planes = bits_expand(bits, plan.bits_width)
        want = bits_expand(table[sel_b[j]], plan.bits_width)
        assert torch.equal(planes[real, :700], want[real, :700])
        # past the catalogue only the table's pad id (700) may be set: its
        # rows are padded with num_items, which packs into that column
        assert not planes[:, 701:].any() and not planes[:, 700].any()
        assert not bits[~real].any()  # pad slots pack no pair


def test_streamed_top_k_ids_equal_the_tables(monkeypatch):
    train, test, params = fixture(seed=5)
    model = TinyMF()
    ev_tab, ev_str, _, _ = both(monkeypatch, train, test, params, model)
    prog = ev_str._get_program(model.predict)
    plan = prog.plan
    table = ev_tab._get_bits_table(plan.pack_block, plan.bits_width)
    pack = tiers.make_edge_pack(plan.pack_block, plan.bits_width)
    users_b, sel_b, _ = ev_str._default_batches
    e_items, e_slots = ev_str._edges[None]
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    for j in range(users_b.shape[0]):
        u, q = model.eval_embeddings(tp, users_b[j])
        got = prog.fact_topk(u, q, pack(e_items[j], e_slots[j], users_b.shape[1]))
        assert torch.equal(got, prog.fact_topk(u, q, table[sel_b[j]]))


def test_streamed_subset_equals_the_table(monkeypatch):
    train, test, params = fixture(seed=4)
    subset = list(test)[::3]
    _, ev_str, want, got = both(monkeypatch, train, test, params, TinyMF(), subset)
    assert got == want
    assert np.asarray(subset, np.int32).tobytes() in ev_str._edges


def test_streamed_equals_the_jax_streamed_tier(monkeypatch):
    train, test, params = fixture(seed=6)
    monkeypatch.setattr(jax_tiers, "BITS_TABLE_BUDGET", 0)
    ev_j = JaxUniEvaluator(train, test, **KW)
    model = TinyMF()
    want = ev_j.evaluate(model.predict, {k: jnp.asarray(v) for k, v in params.items()})
    assert ev_j._get_steps(model.predict).plan.stream
    _, _, _, got = both(monkeypatch, train, test, params, model)
    np.testing.assert_allclose([float(x) for x in got.split("\t")], [float(x) for x in want.split("\t")],
                               atol=1e-6)


def test_streamed_edges_are_sized_by_the_batches(monkeypatch):
    train, test, params = fixture()
    _, ev_str, _, _ = both(monkeypatch, train, test, params, TinyMF())
    e_items, e_slots = ev_str._edges[None]
    B = ev_str._default_batches[0].shape[1]
    per_batch = [sum(len(train[int(u)]) for u, v in zip(ub, vb) if v > 0)
                 for ub, vb in zip(*(t.numpy() for t in ev_str._default_batches[::2]))]
    assert e_items.shape == e_slots.shape == (len(per_batch), max(per_batch) + (-max(per_batch)) % 8)
    assert int((e_slots < B).sum()) == sum(per_batch)
    nnz, l_max = sum(len(v) for v in train.values()), max(len(v) for v in train.values())
    assert e_items.numel() <= 4 * nnz < len(train) * l_max
