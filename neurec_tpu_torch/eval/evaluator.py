"""Full-catalogue top-K ranking evaluation on one device.

Port of ``neurec_tpu/eval/evaluator.py`` (``UniEvaluator``,
``GroupedEvaluator`` and the ``Evaluator`` facade) for the full-catalogue
protocol:

    tables = model.eval_tables(params)          # once per call, if offered
    per batch of users:
        scores + train mask   -> kernel K1 (eval/tiers.py)
        top-K                 -> lowest item id first among ties
        metric sums (f32)     -> ops/metrics.py
    mean = float64(total) / count -> float32

The per-eval-user train masks are packed once per layout into a bit-plane
table (the default ``bits`` tier) and kept on the device. A table above
``NEUREC_EVAL_BITS_BUDGET`` streams instead (``plan.stream``,
``neurec_tpu/eval/evaluator.py:510-532``): each batch's train pairs, as
(item, slot in the batch) edges built on the host once per batch set and
sized by the batch's interactions, are packed on the device into the
table's exact layout (``tiers.make_edge_pack``), with no host sync inside
a batch; the ids and metrics are the table's.

The sampled-candidates protocol (per-user test negatives,
``neurec_tpu/eval/evaluator.py:198-210,633-674``): each test user's
candidates are their test positives, then their negatives, padded with the
``-inf`` column; the top-min(K, C) of ``predict``'s scores (or the rows of
``eval_dense_scores``) gathered at the candidates, the lowest candidate
column first among ties; a hit is a column below the user's positive
count.

``backend="native"`` (``eval_backend=native``,
``neurec_tpu/eval/evaluator.py:853-905``): each batch's scores come from
``predict`` on the device and are copied to the host as f32 with a ``-inf``
pad column; the train items are masked on the host (or the candidate
columns taken, on the sampled protocol), and the C++ thread pool
(``native/``) ranks them on ``num_thread`` threads and computes the
per-user metrics; the mean goes over users in f64. Where the library does
not build, the evaluator raises: the JAX package prints and falls back to
``device``, which would switch what ran.

On a mesh (``mesh=``, ``neurec_tpu/eval/evaluator.py:112-127,309-329,
410-505,760-790``) every rank holds every batch; the tiers that split
(``bits_dp``, ``pallas_dp``, ``item_shard_bits``, ``item_shard_rows``:
factorized models) score, mask and rank this rank's rows of each batch,
rows ``[r*B/n, (r+1)*B/n)`` over 'data' (B rounded up to a multiple of
the axis), and the item-sharded ones this rank's item block over 'model';
the top-K ids are all-gathered, so every rank computes the whole batch's
metric sums in the single run's order and returns the same string. The
item-sharded tier keeps, per rank, its own contiguous (n_test, I_m/8) bits
table, packed per block. ``item_shard`` (``eval_item_shard``: auto, on,
off, 1 or 0; ``NEUREC_EVAL_ITEM_SHARD`` overrides) picks the item-sharded
tiers as the JAX package does, and ``on`` where they cannot engage logs
so on the primary rank. The other tiers (``predict`` models, the sampled
candidates) run whole on every rank. ``backend="native"`` is
single-process only, as ``docs/parallelism.md`` says, and raises under a
group of more than one process.

A call is one program, as the JAX package's jitted ``full_catalog_all`` /
``candidate_all`` (``neurec_tpu/eval/evaluator.py:572-678``): a prologue
(the hoisted ``eval_tables`` / ``eval_dense_scores``, the totals zeroed)
and a body a batch that reads its batch at a device cursor
(``step_graph.at``): the mask, the score, the top-K, the hits, the metric
sums added in place, and with ``record_ids`` the batch's ids copied into a
static buffer. Nothing in them reads the host; ``_mean`` reads the totals
once at the end. A model whose ``predict`` takes an edge capacity (NAIS,
DeepICF: ``predict_capacity``, the most train pairs of the real users of
any batch of the set, rounded up to 8) gets it once a program, as a host
int. On a CUDA device (``step_graph.captures``: ``graphs``, no mesh of
more than one rank) the program is a ``step_graph.KeptProgram``: its first
call runs eagerly and captures the prologue and the body as CUDA graphs,
which every later call replays, prologue once and body once a batch, as
the JAX package keeps its jitted programs. Programs are kept in
``self.kept`` (a ``step_graph.KeptStore``, an LRU of 8, pools released on
eviction) per predict function and batch set (the default set or a cached
subset) and captured anew when a ``params`` leaf moves or changes shape
(``step_graph.signature``), when the batches or the tier's mask data are
rebuilt, or when ``NEUREC_SPMM_PACK`` / ``NEUREC_SPMM_DTYPE`` /
``NEUREC_SPMM_PALLAS`` or a kernel's wrapper change
(``step_graph.routes``). The optimizers update ``params`` in place, so an
evaluation after training steps replays its graphs on the new weights.
``graphs=False``, the CPU and a mesh of more than one rank (gloo stages
collectives through the host) run the same program eagerly.

While tracing is on (``profiling``), a device-backend call is the span
``neurec.evaluate`` (attribute ``captured``, the graphs a capture made),
with the program's capture or replay and ``neurec.eval.read`` (the
totals' read and the ids' clone) inside it.

Result strings: metric-major, ``("%.8f" % x).ljust(12)`` tab-joined.
"""

from __future__ import annotations

import functools
import logging
from collections import OrderedDict
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from neurec_tpu_torch import native, profiling, step_graph
from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.eval import tiers
from neurec_tpu_torch.eval.tiers import TierPlan, select_tier
from neurec_tpu_torch.ops import _build
from neurec_tpu_torch.ops.masked_scores import pack_train_bits
from neurec_tpu_torch.ops.metrics import METRIC_INDEX, METRIC_NAMES, all_metrics, hit_matrix
from neurec_tpu_torch.ops.topk import top_k
from neurec_tpu_torch.parallel.distributed import is_primary_host, process_count
from neurec_tpu_torch.parallel.mesh import Mesh, axis_size, slice_rows

PredictFn = Callable[[object, torch.Tensor], torch.Tensor]


class EvalProgram(NamedTuple):
    """The tier plan for one predict function and the functions it runs."""

    plan: TierPlan
    fact_topk: Optional[Callable]   # (u_vecs, item_table, mask) -> ids
    pred_topk: Optional[Callable]   # (scores, mask) -> ids
    tables_fn: Optional[Callable]   # eval_tables, hoisted out of the batches
    dense_fn: Optional[Callable]    # eval_dense_scores, for predict tiers
    factorized: Optional[Callable]  # eval_embeddings


_log = logging.getLogger("neurec_tpu_torch.eval")

NATIVE_SINGLE_PROCESS = (
    "the eval_backend=native host tier assumes fully-addressable score arrays and is single-process "
    "only - use the default device backend under more than one process")


def _item_shard_flag(item_shard) -> str:
    """``eval_item_shard`` as auto, on or off (1 / true and 0 / false
    accepted); anything else raises, as in the JAX package."""
    flag = {"1": "on", "true": "on", "0": "off", "false": "off"}.get(
        str(item_shard).lower(), str(item_shard).lower())
    if flag not in ("auto", "on", "off"):
        raise ValueError("eval_item_shard must be 'auto', 'on', 'off', 1 or 0, got %r" % (item_shard,))
    return flag


def _pad_rows(rows: List[List[int]], pad_value: int, min_len: int = 1):
    max_len = max(max((len(r) for r in rows), default=0), min_len)
    out = np.full((len(rows), max_len), pad_value, dtype=np.int32)
    lengths = np.zeros(len(rows), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        lengths[i] = len(r)
    return out, lengths


class UniEvaluator:
    """Evaluator for a flat (ungrouped) set of test users."""

    def __init__(
        self,
        user_train_dict: Dict[int, List[int]],
        user_test_dict: Dict[int, List[int]],
        user_neg_test: Optional[Dict[int, List[int]]] = None,
        metric: Optional[Sequence[str]] = None,
        top_k=50,
        batch_size: int = 1024,
        num_items: Optional[int] = None,
        device: DeviceLike = None,
        num_thread: int = 8,
        backend: str = "device",
        mesh: Optional[Mesh] = None,
        item_shard: str = "auto",
        graphs: bool = True,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        # each call's program as CUDA graphs kept across calls (step_graph.captures)
        self.graphs = graphs
        self._item_shard_flag = _item_shard_flag(item_shard)
        self.num_thread = int(num_thread)
        if backend not in ("device", "native"):
            raise ValueError("eval_backend must be 'device' or 'native', got %r" % (backend,))
        if backend == "native" and process_count() > 1:
            raise ValueError(NATIVE_SINGLE_PROCESS)
        if backend == "native":
            native.build()  # raises where g++ is missing or fails: no fallback
            print("NeuRec eval backend: native (C++ host thread pool)")
        self.backend = backend
        if metric is None:
            metric = list(METRIC_NAMES)
        elif isinstance(metric, str):
            metric = [metric]
        for m in metric:
            if m not in METRIC_INDEX:
                raise ValueError("There is no metric named '%s'!" % m)
        self.metrics = list(metric)
        self.metrics_num = len(self.metrics)
        self._metric_rows = np.asarray([METRIC_INDEX[m] for m in self.metrics])

        self.user_pos_train = user_train_dict
        self.user_pos_test = user_test_dict
        self.user_neg_test = user_neg_test
        self.batch_size = int(batch_size)

        self.max_top = top_k if isinstance(top_k, int) else max(top_k)
        if isinstance(top_k, int):
            self.top_show = np.arange(top_k) + 1
        else:
            self.top_show = np.sort(top_k)

        if num_items is None:
            num_items = 0
            for d in (user_train_dict, user_test_dict):
                for items in d.values():
                    if len(items):
                        num_items = max(num_items, max(items) + 1)
        self.num_items = int(num_items)

        self._num_mask_users = max(
            [u for u in user_train_dict] + [u for u in user_test_dict], default=-1
        ) + 1
        self._train_rows_table = None  # padded rows, legacy tiers only

        self.test_users = np.asarray(list(user_test_dict.keys()), dtype=np.int32)
        test_rows, test_lens = _pad_rows(
            [list(user_test_dict[u]) for u in self.test_users], self.num_items
        )
        self._test_rows = torch.from_numpy(test_rows).to(self.device)
        self._test_lens = torch.from_numpy(test_lens).to(self.device)

        self._cand_rows = self._n_pos = None
        self._cand_rows_host = self._n_pos_host = None
        if user_neg_test is not None:
            # candidates: the test positives first, then the negatives
            cand_rows, _ = _pad_rows(
                [list(user_test_dict[u]) + list(user_neg_test[u]) for u in self.test_users],
                self.num_items, min_len=self.max_top,
            )
            self._cand_rows = torch.from_numpy(cand_rows).long().to(self.device)
            self._n_pos = torch.from_numpy(test_lens).to(self.device)
            self._cand_rows_host, self._n_pos_host = cand_rows.astype(np.int64), test_lens

        self._user_pos_index = {int(u): i for i, u in enumerate(self.test_users)}
        self._programs: Dict[Tuple[int, int], EvalProgram] = {}
        self._default_batches = None
        # explicit-user-list (grouped eval) batch blocks, keyed by the ids
        self._subset_batch_cache: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._subset_cache_max = 32
        # packed train-mask bitmaps, keyed by (pack_block, width, item block) layout
        self._bits_tables: Dict[Tuple[int, int, Optional[int]], torch.Tensor] = {}
        # streamed tier: (edge items, edge slots) of each batch set, keyed as
        # the batch caches are (None: the default set)
        self._edges: "OrderedDict[Optional[bytes], tuple]" = OrderedDict()
        # with record_ids set, _run keeps the last call's top-K ids (one row
        # per slot of its batches) in last_ids
        self.record_ids = False
        self.last_ids: Optional[torch.Tensor] = None
        # the programs of the calls, keyed by (predict function, batch set)
        # (an LRU of 8, the graphs and pools of the evicted released)
        self.kept = step_graph.KeptStore(most=8)

    def _host_rows(self, users, min_len: int = 1, pad_to: Optional[int] = None) -> np.ndarray:
        """Padded sorted train rows for the given users, padded with
        ``num_items`` to the group's max length rounded to a power of two
        (``pad_to`` pins an exact width)."""
        rows = self.user_pos_train
        users = np.asarray(users)
        lens = [len(rows.get(int(u), ())) for u in users]
        if pad_to is None:
            L = max(max(lens, default=0), min_len)
            L = 1 << (L - 1).bit_length()
        else:
            L = pad_to
        out = np.full((len(users), L), self.num_items, dtype=np.int32)
        for r, u in enumerate(users):
            items = rows.get(int(u), ())
            if len(items):
                out[r, : len(items)] = np.sort(items)
        return out

    @property
    def _train_rows(self) -> torch.Tensor:
        """Lazy padded-to-max row table — legacy (premask off) tiers only."""
        if self._train_rows_table is None:
            self._train_rows_table = torch.from_numpy(
                self._host_rows(np.arange(self._num_mask_users))
            ).to(self.device)
        return self._train_rows_table

    def metrics_info(self) -> str:
        metrics_show = [
            "\t".join(("%s@" % m + str(k)).ljust(12) for k in self.top_show)
            for m in self.metrics
        ]
        return "metrics:\t%s" % "\t".join(metrics_show)

    def _premask_requested(self) -> bool:
        """NEUREC_EVAL_PREMASK gate for the bit-plane tiers (default on)."""
        import os

        return os.environ.get("NEUREC_EVAL_PREMASK", "auto") not in ("0", "off")

    def _item_shard_mode(self) -> str:
        """auto, on or off for the item-sharded tiers: ``NEUREC_EVAL_ITEM_SHARD``
        (1 / on, 0 / off) over the ``item_shard`` flag."""
        import os

        env = os.environ.get("NEUREC_EVAL_ITEM_SHARD", "").lower()
        if env in ("1", "on"):
            return "on"
        if env in ("0", "off"):
            return "off"
        return self._item_shard_flag

    def _get_bits_table(self, pack_block: int, width: int, part: Optional[int] = None) -> torch.Tensor:
        """(n_test, width/8) uint8 bit-plane-packed train masks of the test
        users, in test-user order; built on the device once per layout.
        With ``part``, only byte columns ``[part*pack_block/8,
        (part+1)*pack_block/8)``: item block ``part``'s own contiguous
        (n_test, pack_block/8) table (the item-sharded tier's)."""
        key = (int(pack_block), int(width), part)
        if key not in self._bits_tables:
            chunk = 4096
            n = len(self.test_users)
            L = max(
                max((len(self.user_pos_train.get(int(u), ())) for u in self.test_users), default=0),
                1,
            )
            L = 1 << (L - 1).bit_length()
            parts = []
            for lo in range(0, n, chunk):
                sel = self.test_users[lo : min(lo + chunk, n)]
                rows = torch.from_numpy(self._host_rows(sel, pad_to=L)).to(self.device)
                bits = pack_train_bits(rows, self.num_items, block_items=pack_block)
                short = width // 8 - bits.shape[1]
                if short:
                    bits = torch.nn.functional.pad(bits, (0, short))
                if part is not None:
                    bits = bits[:, part * pack_block // 8: (part + 1) * pack_block // 8]
                parts.append(bits)
            cols = width // 8 if part is None else pack_block // 8
            self._bits_tables[key] = (
                torch.cat(parts, dim=0).contiguous() if parts
                else torch.zeros((0, cols), dtype=torch.uint8, device=self.device)
            )
        return self._bits_tables[key]

    def _batch_edges(self, users_b: torch.Tensor, valid_b: torch.Tensor):
        """(edge_items, edge_slots), (n_batches, E_max) int64 each, on the
        device: batch j's train pairs as (item, slot of the user in the
        batch), padded with slot == B (dropped by the pack). E_max is the
        most pairs of any one batch, rounded up to 8: ~B * mean + max_row,
        not B * max_row."""
        users_np, valid_np = users_b.cpu().numpy(), valid_b.cpu().numpy()
        n_batches, B = users_np.shape
        rows = self.user_pos_train
        per_batch, e_max = [], 1
        for j in range(n_batches):
            its, slots = [], []
            for lb in range(B):
                items = rows.get(int(users_np[j, lb]), ()) if valid_np[j, lb] else ()
                if len(items):
                    its.append(np.asarray(items, dtype=np.int64))
                    slots.append(np.full(len(items), lb, dtype=np.int64))
            its = np.concatenate(its) if its else np.zeros(0, np.int64)
            slots = np.concatenate(slots) if slots else np.zeros(0, np.int64)
            per_batch.append((its, slots))
            e_max = max(e_max, len(its))
        e_max += (-e_max) % 8
        e_items = np.zeros((n_batches, e_max), np.int64)
        e_slots = np.full((n_batches, e_max), B, np.int64)
        for j, (its, slots) in enumerate(per_batch):
            e_items[j, : len(its)] = its
            e_slots[j, : len(slots)] = slots
        return torch.from_numpy(e_items).to(self.device), torch.from_numpy(e_slots).to(self.device)

    def _get_edges(self, key: Optional[bytes], batches) -> tuple:
        if key not in self._edges:
            self._edges[key] = self._batch_edges(batches[0], batches[2])
            while len(self._edges) > self._subset_cache_max + 1:
                self._edges.popitem(last=False)
        self._edges.move_to_end(key)
        return self._edges[key]

    def _select_plan(self, predict_fn: PredictFn) -> TierPlan:
        model = getattr(predict_fn, "__self__", None)
        factorized = getattr(model, "eval_embeddings", None) is not None
        return select_tier(
            factorized=factorized,
            has_tables=getattr(model, "eval_tables", None) is not None,
            # K1 runs on every device of the port (kernel on cuda, plain on cpu)
            pallas_ok=factorized,
            n_model=axis_size(self.mesh, "model"),
            has_data_axis=self.mesh is not None,
            mesh_size=1 if self.mesh is None else self.mesh.size,
            item_shard_mode=self._item_shard_mode(),
            num_items=self.num_items,
            batch_size=self.batch_size,
            n_test_users=len(self.test_users),
            premask=self._premask_requested(),
            neg_protocol=self.user_neg_test is not None,
        )

    def _make_program(self, predict_fn: PredictFn) -> EvalProgram:
        num_items = self.num_items
        K = min(self.max_top, num_items)
        model = getattr(predict_fn, "__self__", None)
        plan = self._select_plan(predict_fn)
        if self._item_shard_mode() == "on" and not plan.item_shard and self.user_neg_test is None:
            # an explicit request that cannot engage: say so
            if is_primary_host():
                _log.warning(
                    "eval_item_shard=on ignored: requires a mesh with 'data' and 'model' (>1) axes and a model "
                    "exposing eval_embeddings (factorized scores); falling back to the replicated evaluator path")

        dp_mesh = self.mesh if plan.dp else None
        fact_topk = pred_topk = None
        if plan.name == "item_shard_bits":
            fact_topk = tiers.make_item_shard_bits_topk(K, self.mesh, num_items, plan.pack_block,
                                                        self.mesh.shape["model"])
        elif plan.name == "item_shard_rows":
            fact_topk = tiers.make_item_shard_rows_topk(K, self.mesh, num_items)
        elif plan.name in ("bits", "bits_dp"):
            if plan.kind == "factorized" or plan.hoist:
                fact_topk = tiers.make_bits_topk(K, plan.bits_width, num_items, mesh=dp_mesh)
            if plan.kind == "predict":
                pred_topk = tiers.make_bits_predict_topk(K, plan.bits_width, num_items)
        elif plan.name in ("pallas", "pallas_dp"):
            fact_topk = tiers.make_pallas_topk(K, mesh=dp_mesh)
        else:
            pred_topk = tiers.make_scatter_topk(K, num_items)

        # user-independent tables (graph propagation) are computed once per
        # call instead of once per batch
        tables_fn = getattr(model, "eval_tables", None) if plan.hoist else None
        # models whose predict redoes full-catalogue work per batch expose
        # eval_dense_scores; engaged only when the caller passed model.predict
        is_model_predict = model is not None and getattr(
            predict_fn, "__func__", None
        ) is getattr(type(model), "predict", None)
        dense_fn = (
            getattr(model, "eval_dense_scores", None)
            if pred_topk is not None and is_model_predict
            else None
        )
        if dense_fn is not None and not callable(dense_fn):
            dense_fn = None
        return EvalProgram(
            plan=plan,
            fact_topk=fact_topk,
            pred_topk=pred_topk,
            tables_fn=tables_fn,
            dense_fn=dense_fn,
            factorized=getattr(model, "eval_embeddings", None),
        )

    @staticmethod
    def _program_key(predict_fn: PredictFn) -> Tuple[int, int]:
        # bound methods are re-created on every attribute access, so key on
        # (underlying function, instance)
        return (
            id(getattr(predict_fn, "__func__", predict_fn)),
            id(getattr(predict_fn, "__self__", None)),
        )

    def _get_program(self, predict_fn: PredictFn) -> EvalProgram:
        key = self._program_key(predict_fn)
        if key not in self._programs:
            self._programs[key] = self._make_program(predict_fn)
        return self._programs[key]

    def _make_batches(self, users: np.ndarray, positions: np.ndarray):
        B = min(self.batch_size, max(len(users), 1))
        # on a mesh, a multiple of the 'data' axis (each rank takes B / n rows)
        n_data = axis_size(self.mesh, "data")
        B = -(-B // n_data) * n_data
        n_batches = (len(users) + B - 1) // B
        n_pad = n_batches * B
        valid = np.zeros(n_pad, dtype=np.float32)
        valid[: len(users)] = 1.0
        sel = np.zeros(n_pad, dtype=np.int32)
        sel[: len(users)] = positions
        users_pad = np.zeros(n_pad, dtype=np.int32)
        users_pad[: len(users)] = users

        def put(a):
            return torch.from_numpy(a.reshape(n_batches, B)).to(self.device)

        return put(users_pad).long(), put(sel).long(), put(valid)

    # -- evaluation ---------------------------------------------------------
    def evaluate_raw(
        self,
        predict_fn: PredictFn,
        params,
        test_users: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """Mean per-user metric matrix, shape (metrics_num, len(top_show))."""
        if self.backend == "native":
            return self._evaluate_raw_native(predict_fn, params, test_users)
        with profiling.span("neurec.evaluate"):
            prog = self._get_program(predict_fn)
            plan = prog.plan
            mask_data = None
            if plan.bits and plan.table:
                part = self.mesh.coordinate["model"] if plan.item_shard else None
                mask_data = self._get_bits_table(plan.pack_block, plan.bits_width, part)
            ck = None
            if test_users is None:
                if self._default_batches is None:
                    self._default_batches = self._make_batches(
                        self.test_users, np.arange(len(self.test_users), dtype=np.int32)
                    )
                batches = self._default_batches
                n_users = len(self.test_users)
            else:
                users = np.asarray(list(test_users), dtype=np.int32)
                n_users = len(users)
                ck = users.tobytes()
                batches = self._subset_batch_cache.get(ck)
                if batches is None:
                    positions = np.asarray(
                        [self._user_pos_index[int(u)] for u in users], dtype=np.int32
                    )
                    batches = self._make_batches(users, positions)
                    self._subset_batch_cache[ck] = batches
                    while len(self._subset_batch_cache) > self._subset_cache_max:
                        self._subset_batch_cache.popitem(last=False)
                self._subset_batch_cache.move_to_end(ck)
            if n_users == 0:
                return np.zeros((self.metrics_num, len(self.top_show)), np.float32)
            if plan.stream:
                mask_data = self._get_edges(ck, batches)
            before = dict(_build.LAUNCHES)
            out = self._run(prog, predict_fn, params, batches, mask_data, ck)
            launches = {name: _build.LAUNCHES[name] - n for name, n in before.items()}
            self._note_call(predict_fn, self.test_users if test_users is None else users, batches, launches)
            return out

    @staticmethod
    def _note_call(predict_fn: PredictFn, users: np.ndarray, batches, launches: Dict[str, int]) -> None:
        """A model's ``on_evaluate(rows, launches)`` hook, where it has one,
        after a call: ``rows`` the host ids of the call's batch rows, the
        pad rows user 0 as ``_make_batches`` pads them; ``launches`` each
        kernel's launches over the call (the change of ``_build.LAUNCHES``:
        the wrappers' counts on an eager call or a capture, the captured
        launches on a replay). The kept program runs no Python on a replay,
        so what a model records of a call (HSTU's pair counts and fused
        layers) is recorded here, on the host. The model is found as
        ``predict_fn.__self__``: the hook fires for a bound method
        (``model.predict``), and not for a lambda or a partial around
        one, which records nothing."""
        hook = getattr(getattr(predict_fn, "__self__", None), "on_evaluate", None)
        if hook is not None:
            rows = np.zeros(batches[0].numel(), dtype=np.int64)
            rows[: len(users)] = users
            hook(rows, launches)

    def _mean(self, total: torch.Tensor, count: torch.Tensor) -> np.ndarray:
        mean = (
            total.cpu().numpy().astype(np.float64) / max(float(count), 1.0)
        ).astype(np.float32)  # (5, K)
        k_idx = np.minimum(self.top_show, self.num_items) - 1
        return mean[self._metric_rows][:, k_idx]

    @torch.no_grad()
    def _run(self, prog: EvalProgram, predict_fn, params, batches, mask_data, ck: Optional[bytes]):
        """One call: the kept program for (``predict_fn``, the batch set),
        made or captured anew where what it was made for changed, run over
        the batches; the mean of its totals."""
        capture = step_graph.captures(self.device, self.graphs, self.mesh)

        def holding():  # the batches and the mask data by identity: the program holds them
            return step_graph.signature(params), capture, self.record_ids, id(batches), id(mask_data)

        with self.kept.use((self._program_key(predict_fn), ck), holding,
                           lambda: self._make_kept(prog, predict_fn, batches, mask_data, capture)) as program:
            out = program.run(batches[0].shape[0], params)
        with profiling.span("neurec.eval.read"):
            if out["ids"] is not None:
                self.last_ids = out["ids"].reshape(-1, out["ids"].shape[2]).clone()
            return self._mean(out["total"], out["count"])

    def _make_kept(self, prog: EvalProgram, predict_fn, batches, mask_data, capture: bool) -> step_graph.KeptProgram:
        """The program of one call: a prologue (the totals and the cursor
        zeroed, the hoisted tables) and the protocol's body a batch."""
        users_b = batches[0]
        K = min(self.max_top, self.num_items)
        dev = self.device
        cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        total = torch.zeros((5, K), dtype=torch.float32, device=dev)
        count = torch.zeros((), dtype=torch.float32, device=dev)
        ids = None
        if self.record_ids and self.user_neg_test is None:
            ids = torch.zeros((users_b.shape[0], users_b.shape[1], K), dtype=torch.int64, device=dev)
        tables = {}

        def prologue(params):
            cursor.zero_()
            total.zero_()
            count.zero_()
            # user-independent tables (graph propagation) once a call, not a batch
            if prog.tables_fn is not None:
                u_table, item_table = prog.tables_fn(params)
                tables["hoisted"] = (u_table.float(), item_table.float())
            if prog.dense_fn is not None:
                tables["dense"] = prog.dense_fn(params).float()

        make = self._candidates_body if self.user_neg_test is not None else self._catalogue_body
        predict_fn = sized_predict(predict_fn, users_b, batches[2])
        body = make(prog, predict_fn, batches, mask_data, tables, cursor, total, count, ids)
        return step_graph.KeptProgram(prologue, body, dev, capture, dict(
            batches=batches, mask_data=mask_data, total=total, count=count, ids=ids))

    # The bodies hold what they read, not the evaluator: a kept program
    # that held it would make a reference cycle, and its pool would wait
    # for the garbage collector.
    def _candidates_body(self, prog, predict_fn, batches, mask_data, tables, cursor, total, count, ids):
        """The sampled-candidates protocol's batch at ``cursor``."""
        K = min(self.max_top, self.num_items)
        cand_rows, n_pos = self._cand_rows, self._n_pos

        def body(params):
            users, sel, valid = step_graph.at(cursor, *batches)
            dense_scores = tables.get("dense")
            scores = dense_scores[users] if dense_scores is not None else predict_fn(params, users).float()
            m = candidate_metrics(scores, cand_rows[sel], n_pos[sel], K)
            total.add_(torch.sum(m * valid[:, None, None], dim=0))
            count.add_(torch.sum(valid))
            cursor.add_(1)

        return body

    def _catalogue_body(self, prog, predict_fn, batches, mask_data, tables, cursor, total, count, ids):
        """The full-catalogue protocol's batch at ``cursor``: the tier's
        mask, the score, the top-K, the metric sums."""
        plan, mesh = prog.plan, self.mesh
        test_rows, test_lens = self._test_rows, self._test_lens
        train_rows = None if plan.bits else self._train_rows
        pack = None
        if plan.stream:  # the item-sharded tier packs its own block
            pack = (tiers.make_edge_pack(plan.pack_block, plan.pack_block) if plan.item_shard
                    else tiers.make_edge_pack(plan.pack_block, plan.bits_width))

        def body(params):
            users, sel, valid = step_graph.at(cursor, *batches)
            # the splitting tiers score this rank's rows; their top-K come back whole
            users_l, sel_l = (slice_rows(users, mesh), slice_rows(sel, mesh)) if plan.dp else (users, sel)
            if plan.stream:
                e_items, e_slots = step_graph.at(cursor, *mask_data)
                mask = pack(*_local_edges(mesh, plan, e_items, e_slots, users.shape[0]), users_l.shape[0])
            else:
                mask = mask_data[sel_l] if plan.bits else train_rows[users_l]
            hoisted, dense_scores = tables.get("hoisted"), tables.get("dense")
            if hoisted is not None:
                u_table, item_table = hoisted
                topk = prog.fact_topk(u_table[users_l], item_table, mask)
            elif plan.kind == "factorized":
                u_vecs, item_table = prog.factorized(params, users_l)
                topk = prog.fact_topk(u_vecs.float(), item_table.float(), mask)
            else:
                scores = dense_scores[users] if dense_scores is not None else predict_fn(params, users).float()
                topk = prog.pred_topk(scores, mask)
            hits = hit_matrix(topk, test_rows[sel], test_lens[sel])
            m = all_metrics(hits, test_lens[sel])  # (B, 5, K)
            total.add_(torch.sum(m * valid[:, None, None], dim=0))
            count.add_(torch.sum(valid))
            if ids is not None:
                ids.index_copy_(0, cursor, topk[None])
            cursor.add_(1)

        return body

    @torch.no_grad()
    def _evaluate_raw_native(
        self,
        predict_fn: PredictFn,
        params,
        test_users: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """The host backend (``neurec_tpu/eval/evaluator.py:853-905``): each
        batch's ``predict`` scores copied to the host as f32, a ``-inf`` pad
        column added, the train items masked (or the candidate columns
        taken), then ranked and scored on the C++ thread pool; the mean over
        users in f64."""
        users = self.test_users if test_users is None else np.asarray(list(test_users), dtype=np.int32)
        K = min(self.max_top, self.num_items)
        B = min(self.batch_size, max(len(users), 1))
        total = np.zeros((self.metrics_num, K), dtype=np.float64)
        count = 0
        for lo in range(0, len(users), B):
            batch = users[lo : lo + B]
            idx = torch.from_numpy(batch.astype(np.int64)).to(self.device)
            scores = sized_predict(predict_fn, batch[None])(params, idx).float().cpu().numpy()
            nb = scores.shape[0]
            ext = np.concatenate([scores, np.full((nb, 1), -np.inf, np.float32)], axis=1)
            if self.user_neg_test is not None:
                sel = [self._user_pos_index[int(u)] for u in batch]
                cscores = np.take_along_axis(ext, self._cand_rows_host[sel], axis=1)
                truth = [list(range(int(n))) for n in self._n_pos_host[sel]]
                per_user = native.eval_score_matrix(cscores, truth, self.metrics, K, n_threads=self.num_thread)
            else:
                for r, u in enumerate(batch):
                    items = self.user_pos_train.get(int(u), ())
                    if len(items):
                        ext[r, np.asarray(items, dtype=np.int64)] = -np.inf
                truth = [list(self.user_pos_test[int(u)]) for u in batch]
                per_user = native.eval_score_matrix(ext[:, : self.num_items], truth, self.metrics, K,
                                                    n_threads=self.num_thread)
            total += per_user.reshape(nb, self.metrics_num, K).sum(axis=0)
            count += nb
        mean = (total / max(count, 1)).astype(np.float32)
        k_idx = np.minimum(self.top_show, self.num_items) - 1
        return mean[:, k_idx]

    def evaluate(
        self,
        predict_fn: PredictFn,
        params,
        test_users: Optional[Sequence[int]] = None,
    ) -> str:
        result = self.evaluate_raw(predict_fn, params, test_users).reshape(-1)
        return "\t".join(("%.8f" % x).ljust(12) for x in result)


def sized_predict(predict_fn: PredictFn, users_b, valid_b=None) -> PredictFn:
    """``predict_fn`` with the edge capacity of the batches ``users_b``
    ((n_batches, B) ids, their real slots ``valid_b``; read on the host
    here) where it is the ``predict`` of a model that takes one
    (``predict_capacity``: NAIS, DeepICF), else ``predict_fn``."""
    model = getattr(predict_fn, "__self__", None)
    capacity = getattr(model, "predict_capacity", None)
    if capacity is None or getattr(predict_fn, "__func__", None) is not getattr(type(model), "predict", None):
        return predict_fn
    if isinstance(users_b, torch.Tensor):
        users_b, valid_b = users_b.cpu().numpy(), None if valid_b is None else valid_b.cpu().numpy()
    return functools.partial(predict_fn, capacity=capacity(users_b, valid_b))


def _local_edges(mesh: Optional[Mesh], plan: TierPlan, e_items: torch.Tensor, e_slots: torch.Tensor, B: int):
    """A streamed batch's (item, slot) edges as this rank packs them:
    slots of its rows of the batch (a splitting tier), items of its
    block (the item-sharded tier), each made local; the other edges
    get the dropped slot (the local row count)."""
    if not plan.dp:
        return e_items, e_slots
    k = B // axis_size(mesh, "data")
    lo = mesh.coordinate["data"] * k
    keep = (e_slots >= lo) & (e_slots < lo + k)
    if plan.item_shard:
        off = mesh.coordinate["model"] * plan.pack_block
        keep &= (e_items >= off) & (e_items < off + plan.pack_block)
        e_items = torch.where(keep, e_items - off, torch.zeros_like(e_items))
    return e_items, torch.where(keep, e_slots - lo, torch.full_like(e_slots, k))


def candidate_metrics(scores: torch.Tensor, cand_rows: torch.Tensor, n_pos: torch.Tensor, K: int) -> torch.Tensor:
    """(B, 5, K) metrics of the sampled-candidates protocol: ``scores``
    (B, I) with a ``-inf`` column appended, gathered at ``cand_rows`` (B, C)
    (pads point at that column), the top-min(K, C) columns, the lowest
    first among ties, a hit where a column is below ``n_pos``, the ranks
    past C empty."""
    B = scores.shape[0]
    ext = torch.cat([scores, torch.full((B, 1), float("-inf"), dtype=torch.float32, device=scores.device)], dim=1)
    cscores = torch.gather(ext, 1, cand_rows)
    Kc = min(K, cand_rows.shape[1])
    topk = top_k(cscores, Kc)[1]
    hits = (topk < n_pos[:, None]).to(torch.float32)
    if Kc < K:
        hits = torch.nn.functional.pad(hits, (0, K - Kc))
    return all_metrics(hits, n_pos)


class GroupedEvaluator:
    """Evaluate per user group bucketed by train-interaction count, with
    the reference's ``(lo,hi]:`` row labels; users above the last bound are
    discarded."""

    def __init__(
        self,
        user_train_dict,
        user_test_dict,
        user_neg_test=None,
        metric=None,
        group_view=None,
        top_k=50,
        batch_size=1024,
        num_items=None,
        device: DeviceLike = None,
        num_thread=8,
        backend="device",
        mesh: Optional[Mesh] = None,
        item_shard="auto",
        graphs: bool = True,
    ):
        if not isinstance(group_view, list):
            raise TypeError("The type of 'group_view' must be `list`!")
        self.evaluator = UniEvaluator(
            user_train_dict,
            user_test_dict,
            user_neg_test,
            metric=metric,
            top_k=top_k,
            batch_size=batch_size,
            num_items=num_items,
            device=device,
            num_thread=num_thread,
            backend=backend,
            mesh=mesh,
            item_shard=item_shard,
            graphs=graphs,
        )
        group_list = [0] + group_view
        group_info = [
            ("(%d,%d]:" % (g_l, g_h)).ljust(12)
            for g_l, g_h in zip(group_list[:-1], group_list[1:])
        ]
        all_test_user = list(user_test_dict.keys())
        num_interaction = [len(user_train_dict.get(u, ())) for u in all_test_user]
        group_idx = np.searchsorted(group_list[1:], num_interaction)
        self.grouped_user: "OrderedDict[str, List[int]]" = OrderedDict()
        for gi in range(len(group_info)):
            members = [u for u, g in zip(all_test_user, group_idx) if g == gi]
            if members:
                self.grouped_user[group_info[gi]] = members
        if not self.grouped_user:
            raise ValueError("The splitting of user groups is not suitable!")

    def metrics_info(self) -> str:
        return self.evaluator.metrics_info()

    def evaluate(self, predict_fn: PredictFn, params) -> str:
        result_to_show = ""
        for group, users in self.grouped_user.items():
            tmp_result = self.evaluator.evaluate(predict_fn, params, users)
            result_to_show = "%s\n%s\t%s" % (result_to_show, group, tmp_result)
        return result_to_show


class Evaluator:
    """Facade dispatching to UniEvaluator or GroupedEvaluator."""

    def __init__(
        self,
        user_train_dict,
        user_test_dict,
        user_neg_test=None,
        metric=None,
        group_view=None,
        top_k=50,
        batch_size=1024,
        num_items=None,
        device: DeviceLike = None,
        num_thread=8,
        backend="device",
        mesh: Optional[Mesh] = None,
        item_shard="auto",
        graphs: bool = True,
    ):
        kwargs = dict(
            metric=metric, top_k=top_k, batch_size=batch_size,
            num_items=num_items, device=device, num_thread=num_thread, backend=backend,
            mesh=mesh, item_shard=item_shard, graphs=graphs,
        )
        if group_view is not None:
            self.evaluator = GroupedEvaluator(
                user_train_dict, user_test_dict, user_neg_test,
                group_view=group_view, **kwargs,
            )
        else:
            self.evaluator = UniEvaluator(
                user_train_dict, user_test_dict, user_neg_test, **kwargs
            )

    @classmethod
    def from_dataset(cls, dataset, config, device: DeviceLike = None, mesh: Optional[Mesh] = None,
                     graphs: bool = True) -> "Evaluator":
        return cls(
            dataset.get_user_train_dict(),
            dataset.get_user_test_dict(),
            dataset.get_user_test_neg_dict(),
            metric=config.get("metric"),
            group_view=config.get("group_view"),
            top_k=config.get("topk", 50),
            batch_size=config.get("test_batch_size", 1024),
            num_items=dataset.num_items,
            device=device,
            num_thread=config.get("num_thread", 8),
            backend=config.get("eval_backend", "device"),
            mesh=mesh,
            item_shard=str(config.get("eval_item_shard", "auto")).lower(),
            graphs=graphs,
        )

    def metrics_info(self) -> str:
        return self.evaluator.metrics_info()

    def evaluate(self, predict_fn: PredictFn, params) -> str:
        return self.evaluator.evaluate(predict_fn, params)
