"""The edge-balanced schedule that K2 and K3 walk (``spmm_schedule``).

On small graphs (random, power-law with a hub row longer than several
spans, empty tiles, 1024-row tiles, chunks of 256 and 512) the schedule
must:

* list every real (non-zero) edge of the plan exactly once, each row's
  edges in plan order, under ``row_ptr``;
* cut them into spans of at most ``SPAN`` edges and ``SPAN`` rows, in
  order, each span one warp's work: every row written by exactly one span,
  except the rows cut into pieces, which start their spans and are listed
  in ``split``;
* not depend on the chunk, the tile or the padding: plans of one graph at
  chunk 256 and 512, or tile 256 and 1024, give the same schedule;
* give A @ x when summed along it in float64 as the kernels sum (each row
  in its span, a cut row's pieces in span order): equal to
  ``plan_spmm_reference`` and to the JAX package's ``plan_spmm`` (Pallas,
  interpret mode, as its own tests run it) within 1e-6 of the largest
  |value| (both references sum in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.ops import pallas_spmm as jax_spmm
from neurec_tpu_torch.ops import spmm

SPAN = spmm.SPAN


def _random_coo(seed, n_rows, n_src, nnz, empty_tail=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows - empty_tail, nnz).astype(np.int32)
    cols = rng.integers(0, n_src, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[: nnz // 20] = 0.0  # build padding is dropped
    return rows, cols, vals, n_rows, n_src


def _hub_coo(seed, n=1500, hub=7 * SPAN + 5):
    """Power-law row degrees and one hub row of ``hub`` edges (8 spans);
    values N(0, 1/degree), as a normalized adjacency scales a hub's."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.7, n), 3 * SPAN)
    deg[n // 2] = hub
    deg[n // 5] = 2 * SPAN  # a row of exactly two full pieces
    rows = np.repeat(np.arange(n), deg).astype(np.int32)
    cols = rng.integers(0, n, rows.size).astype(np.int32)
    vals = (rng.standard_normal(rows.size) / np.sqrt(deg[rows])).astype(np.float32)
    return rows, cols, vals, n, n


GRAPHS = {
    "random": lambda: _random_coo(0, 997, 773, 6000),
    "empty_tiles": lambda: _random_coo(1, 1400, 700, 3000, empty_tail=700),
    "no_edges": lambda: _random_coo(2, 300, 50, 0),
    "hub": lambda: _hub_coo(3),
    "hub_t": lambda: (lambda r, c, v, n, m: (c, r, v, n, m))(*_hub_coo(3)),
}
GEOMETRIES = [(256, 256), (256, 512), (1024, 256), (128, 64)]  # (tile_r, chunk)


def _plan(graph, tile_r, chunk):
    rows, cols, vals, n_rows, n_src = GRAPHS[graph]()
    return spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=tile_r, chunk=chunk).to("cpu"), n_src


def _numpy(sched):
    return {name: getattr(sched, name).numpy() for name in sched._fields}


def _plan_rows(plan):
    """Each plan position's global row."""
    chunk = plan.rows.shape[1]
    return (plan.chunk_tile.numpy().repeat(chunk) * plan.tile_r + plan.rows.numpy().reshape(-1)).astype(np.int64)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("tile_r,chunk", GEOMETRIES)
def test_every_real_edge_once_in_plan_order(graph, tile_r, chunk):
    plan, _ = _plan(graph, tile_r, chunk)
    s = _numpy(spmm.spmm_schedule(plan))
    vals = plan.vals.numpy().reshape(-1)
    np.testing.assert_array_equal(np.sort(s["perm"]), np.flatnonzero(vals != 0))
    np.testing.assert_array_equal(s["cols"], plan.cols.numpy().reshape(-1)[s["perm"]])
    rp = s["row_ptr"]
    assert rp.shape == (plan.n_rows + 1,) and rp[0] == 0 and rp[-1] == len(s["perm"])
    rows_of = _plan_rows(plan)[s["perm"]]
    np.testing.assert_array_equal(rows_of, np.repeat(np.arange(plan.n_rows), np.diff(rp)))
    for r in range(plan.n_rows):  # plan order: increasing positions within a row
        assert (np.diff(s["perm"][rp[r]:rp[r + 1]]) > 0).all()
    for name in ("perm", "cols", "row_ptr", "spans", "split"):
        assert s[name].dtype == np.int32, name


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("tile_r,chunk", GEOMETRIES)
def test_spans_bound_each_warps_work(graph, tile_r, chunk):
    plan, _ = _plan(graph, tile_r, chunk)
    s = _numpy(spmm.spmm_schedule(plan))
    spans, split, rp = s["spans"], s["split"], s["row_ptr"]
    e0, e1, r0, r1 = spans.T
    assert (e1 - e0 <= SPAN).all() and (r1 - r0 <= SPAN).all() and (r1 > r0).all()
    assert e0[0] == 0 and e1[-1] == len(s["perm"]) and (e0[1:] == e1[:-1]).all()  # in order, no gap
    cut = {}
    written = np.zeros(plan.n_rows, dtype=int)
    for i, (a, b, lo, hi) in enumerate(spans):
        for r in range(lo, hi):
            inside = rp[r] >= a and rp[r + 1] <= b
            if inside:
                written[r] += 1
            else:  # a piece of a cut row: only ever a span's first row
                assert r == lo and rp[r + 1] - rp[r] > SPAN
                cut.setdefault(r, []).append(i)
    assert (written[list(cut)] == 0).all() and (np.delete(written, list(cut)) == 1).all()
    assert sorted(cut) == split[:, 0].tolist()
    for row, s0, s1 in split:
        assert cut[row] == list(range(s0, s1))
        assert s1 - s0 == -(-(rp[row + 1] - rp[row]) // SPAN)
    if graph == "hub":
        assert (split[:, 2] - split[:, 1]).max() == 8


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_schedule_does_not_depend_on_chunk_or_tile(graph):
    plans = [_plan(graph, tile_r, chunk)[0] for tile_r, chunk in GEOMETRIES]
    want = _numpy(spmm.spmm_schedule(plans[0]))
    want_vals = plans[0].vals.numpy().reshape(-1)[want["perm"]]
    for plan in plans[1:]:
        got = _numpy(spmm.spmm_schedule(plan))
        for name in ("cols", "row_ptr", "spans", "split"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        np.testing.assert_array_equal(plan.vals.numpy().reshape(-1)[got["perm"]], want_vals)


def _schedule_sum(plan, x):
    """A @ x in float64 along the schedule, in the kernels' order: each row
    of a span summed in plan order, a cut row's pieces added in span order."""
    s = _numpy(spmm.spmm_schedule(plan))
    contrib = plan.vals.numpy().reshape(-1)[s["perm"]].astype(np.float64)[:, None] * x[s["cols"]]
    rp = s["row_ptr"]
    out = np.zeros((plan.n_rows, x.shape[1]))
    pieces = {}
    for i, (a, b, lo, hi) in enumerate(s["spans"]):
        for r in range(lo, hi):
            acc = np.zeros(x.shape[1])
            for e in range(max(rp[r], a), min(rp[r + 1], b)):
                acc = acc + contrib[e]
            if rp[r] < a or rp[r + 1] > b:
                pieces[i] = acc
            else:
                out[r] = acc
    for row, s0, s1 in s["split"]:
        acc = pieces[s0]
        for i in range(s0 + 1, s1):
            acc = acc + pieces[i]
        out[row] = acc
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("tile_r,chunk", GEOMETRIES)
def test_sum_along_the_schedule_is_the_plain_version(graph, tile_r, chunk):
    plan, n_src = _plan(graph, tile_r, chunk)
    x = np.random.default_rng(7).standard_normal((n_src, 8))
    want = spmm.plan_spmm_reference(plan, torch.from_numpy(x).float()).numpy()
    _close(_schedule_sum(plan, x.astype(np.float32).astype(np.float64)), want)


@pytest.mark.parametrize("graph", ["random", "empty_tiles", "hub"])
@pytest.mark.parametrize("chunk", [256, 512])
def test_sum_along_the_schedule_is_the_jax_kernel(graph, chunk):
    rows, cols, vals, n_rows, n_src = GRAPHS[graph]()
    x = np.random.default_rng(8).standard_normal((n_src, 8)).astype(np.float32)
    jplan = jax_spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=256, chunk=chunk)
    want = np.asarray(jax_spmm.plan_spmm(jplan, jnp.asarray(x), interpret=True))
    plan = spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=256, chunk=chunk).to("cpu")
    _close(_schedule_sum(plan, x.astype(np.float64)), want)


def test_schedule_is_built_once_and_kept_with_the_plan():
    plan, _ = _plan("hub", 256, 256)
    assert spmm.spmm_schedule(plan) is spmm.spmm_schedule(plan)
    assert "schedule" not in plan.to("cpu").cache  # a new placement builds its own
