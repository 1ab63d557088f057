"""JCA — joint collaborative autoencoder (Zhu et al., WWW 2019).

Port of ``neurec_tpu/models/general/jca.py`` (model/general_recommender/
JCA.py:25-215):

* user AE: full interaction rows -> hidden (g_act) -> decoded rows (f_act);
* item AE: full interaction columns -> hidden scaled by a per-item factor
  -> decoded columns;
* the prediction averages both decoders; training takes it on a
  (user block x item block) sub-matrix, a pairwise hinge
  max(0, neg - pos + margin) of each positive cell against ``num_neg``
  negative cells drawn in the same row of the block, + reg/4 * sum of the
  squared weights and biases;
* one epoch walks the whole grid of random user blocks x item blocks
  (JCA.py:128-160), row block major; each step's negative columns come
  from a generator of its own, seeded from the epoch's table of seeds. On a
  CUDA device the steps are CUDA-graph replays (``grid_steps``).

The JAX package's documented deviation is kept: the negative columns are
drawn uniformly in the block (the reference draws without replacement
among the zeros), and a draw that hits a positive weighs 0.

On a mesh each grid step is split over 'data' as the JAX package's
(``jca.py:110``): a rank takes its rows of the row block, the column block
stays whole, the negative columns are drawn for the whole block and cut to
the rank's rows (``split_draw``), and the weight regulariser is counted
once (``whole_term``).

``predict`` runs the item decoder over the whole catalogue for every batch
(an (I, U) computation), in item chunks that keep only the batch's users'
columns. ``eval_dense_scores`` (every user's scores at once) is offered
only under the JAX package's budget (12 U I bytes <= 512 MB).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neurec_tpu_torch.data.padded import build_padded_positives, dense_rows
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, chunks, register
from neurec_tpu_torch.ops.activations import activation_function
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.parallel.mesh import split_draw, whole_term
from neurec_tpu_torch.step_graph import Steps, at, step_seeds, train_step

# elements of one (items, U) chunk of the item decoder in predict: 256 MB of f32
_TRANSIENT = 1 << 26


class GridDraws(NamedTuple):
    rows: torch.Tensor   # (nU, B) user ids of each row block, 0 on pad slots
    row_w: torch.Tensor  # (nU, B) 1 real / 0 pad
    cols: torch.Tensor   # (nI, B) item ids of each column block
    col_w: torch.Tensor  # (nI, B)
    seeds: torch.Tensor  # (nU * nI,) one per step, on the host


@register("JCA")
class JCA(Recommender):
    data_kind = "custom"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.hidden_neuron = int(config.get("hidden_neuron", 160))
        self.reg = float(config.get("reg", 0.001))
        self.f_act = activation_function(config.get("f_act", "sigmoid"))
        self.g_act = activation_function(config.get("g_act", "sigmoid"))
        self.margin = float(config.get("margin", 0.15))
        self.neg_sample_rate = int(config.get("num_neg", 1))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self._user_rows = torch.from_numpy(build_padded_positives(dataset.train_matrix).items).long().to(self.device)
        self._item_rows = torch.from_numpy(
            build_padded_positives(dataset.train_matrix.T.tocsr()).items).long().to(self.device)
        # dense-hoist budget: ~3 (U, I) f32 transients live at the hoist
        if 12 * self.num_users * self.num_items > 512 * 1024 * 1024:
            self.eval_dense_scores = None  # getattr -> absent

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        h, U, I = self.hidden_neuron, self.num_users, self.num_items
        shapes = {"UV": (I, h), "UW": (h, I), "Ub1": (1, h), "Ub2": (1, I), "IV": (U, h), "IW": (h, U),
                  "Ib1": (1, h), "Ib2": (1, U), "I_factor": (1, I)}
        return {k: init(generator, s).to(self.device) for k, s in shapes.items()}

    def _rows_dense(self, idx):
        return dense_rows(self._user_rows[idx], self.num_items)   # (B, I)

    def _cols_dense(self, idx):
        return dense_rows(self._item_rows[idx], self.num_users)   # (B, U)

    def _u_decode(self, params, r_u):
        h = self.g_act(r_u @ self.whole(params, "UV") + params["Ub1"])
        return self.f_act(h @ params["UW"] + params["Ub2"])        # (Bu, I)

    def _i_hidden(self, params, r_i_t, col_idx):
        factor = params["I_factor"][0][col_idx][:, None]           # (Bc, 1)
        return self.g_act((r_i_t @ self.whole(params, "IV") + params["Ib1"]) * factor)

    def _i_decode(self, params, r_i_t, col_idx):
        return self.f_act(self._i_hidden(params, r_i_t, col_idx) @ params["IW"] + params["Ib2"])  # (Bc, U)

    def _sub_decoder(self, params, row_idx, col_idx):
        r_u = self._rows_dense(row_idx)                            # (Bu, I)
        u_dec = self._u_decode(params, r_u)[:, col_idx]            # (Bu, Bc)
        i_dec = self._i_decode(params, self._cols_dense(col_idx), col_idx)[:, row_idx]  # (Bc, Bu)
        return (u_dec + i_dec.T) / 2.0, r_u[:, col_idx]

    def _neg_cols(self, generator, rows, B):
        """(rows, B, num_neg) negative columns of each cell of ``rows`` rows
        of a block B wide, uniform in the block; in a split step this rank's
        rows of the whole block's draw (``split_draw``)."""
        return split_draw(lambda s: torch.randint(0, B, s, generator=generator, device=generator.device),
                          (rows, B, self.neg_sample_rate))

    def step_loss(self, params, row_idx, row_w, col_idx, col_w, neg_cols):
        """One grid step's loss on the block (row_idx x col_idx)."""
        B = row_idx.shape[0]
        dec, r_sub = self._sub_decoder(params, row_idx, col_idx)
        w_cell = (row_w[:, None] * col_w[None, :]) * r_sub        # the positives
        flat = neg_cols.reshape(B, -1)
        neg_vals = dec.gather(1, flat).reshape(neg_cols.shape)     # (Bu, Bc, S)
        neg_is_pos = r_sub.gather(1, flat).reshape(neg_cols.shape)
        hinge = torch.clamp(neg_vals - dec[:, :, None] + self.margin, min=0.0)
        w = w_cell[:, :, None] * (1.0 - neg_is_pos) * col_w[neg_cols]
        # the reference's reg * 0.5 * l2_loss(...), l2_loss = sum 0.5 ||.||^2
        cost2 = whole_term(self.reg * 0.25 * sum(torch.sum(torch.square(self.whole(params, k)))
                                                 for k in ("UW", "UV", "IW", "IV", "Ib1", "Ib2", "Ub1", "Ub2")))
        return torch.sum(hinge * w) + cost2

    def draw_epoch(self, generator: torch.Generator) -> GridDraws:
        B, U, I = self.batch_size, self.num_users, self.num_items
        nU, nI = -(-U // B), -(-I // B)
        rperm = torch.randperm(nU * B, generator=generator, device=generator.device)
        cperm = torch.randperm(nI * B, generator=generator, device=generator.device)
        seeds = step_seeds(generator, nU * nI)
        return GridDraws(torch.where(rperm < U, rperm, 0).reshape(nU, B), (rperm < U).float().reshape(nU, B),
                         torch.where(cperm < I, cperm, 0).reshape(nI, B), (cperm < I).float().reshape(nI, B),
                         seeds)

    def grid_steps(self, params, opt_state, draws: GridDraws, max_steps=None, trainer=None) -> Steps:
        """The grid's steps (``step_graph.Steps``), every (row block, column
        block) pair, row block major: step ``s`` reads its two block indices
        at the cursor from an (nU * nI, 2) device table and draws its
        negative columns from its own generator, seeded with
        ``draws.seeds[s]``. With a ``trainer`` on a mesh each step's row
        block is split over 'data' (``Trainer.dp_split_for``)."""
        nU, nI = draws.rows.shape[0], draws.cols.shape[0]
        B = draws.rows.shape[1]
        dev = draws.rows.device
        n_run = nU * nI if max_steps is None else min(max_steps, nU * nI)
        blocks = torch.stack([torch.arange(nU, device=dev).repeat_interleave(nI),
                              torch.arange(nI, device=dev).repeat(nU)], dim=1)
        split = None if trainer is None else trainer.dp_split_for(B)

        def make(cursor, total, blocks, rows_d, row_w_d, cols_d, col_w_d):
            def step(gen):
                ri, ci = at(cursor, blocks).split(1)
                rows, row_w = rows_d.index_select(0, ri)[0], row_w_d.index_select(0, ri)[0]
                cols, col_w = cols_d.index_select(0, ci)[0], col_w_d.index_select(0, ci)[0]
                if split is not None:  # this rank's rows of the row block
                    rows, row_w = trainer.dp_constrain(rows, row_w)

                def loss():
                    neg_cols = self._neg_cols(gen, rows.shape[0], B)
                    return self.step_loss(params, rows, row_w, cols, col_w, neg_cols)

                train_step(loss, opt_state, cursor, total, trainer, split, params)
            return step

        return Steps(make, n_run, draws.seeds[:n_run], opt_state, split,
                     inputs=dict(blocks=blocks, rows_d=draws.rows, row_w_d=draws.row_w, cols_d=draws.cols,
                                 col_w_d=draws.col_w), reads=params)

    def run_epoch(self, params, opt_state, draws: GridDraws, max_steps=None, trainer=None):
        """The grid's steps (``grid_steps``): ``(params, opt_state, summed
        step losses)``; CUDA-graph replays where the trainer captures."""
        return params, opt_state, self.take_steps(trainer, self.grid_steps(params, opt_state, draws, max_steps,
                                                                           trainer))

    def build_epoch(self, trainer):
        def epoch(params, opt_state, generator, epoch, max_steps=None):
            return self.run_epoch(params, opt_state, self.draw_epoch(generator), max_steps, trainer=trainer)

        return epoch

    def loss(self, params, batch, weights):
        raise RuntimeError("JCA uses build_epoch (data_kind='custom')")

    def eval_dense_scores(self, params):
        """Every user's scores, for the evaluator's hoist (present only
        under the budget, see ``__init__``)."""
        return self.predict(params, torch.arange(self.num_users, device=self.device))

    def predict(self, params, users):
        u_dec = self._u_decode(params, self._rows_dense(users))   # (B, I)
        # the item decoder of every item, only the batch's users' columns kept
        iw, ib2 = params["IW"][:, users], params["Ib2"][:, users]
        step = max(1, _TRANSIENT // max(self.num_users, 1))
        i_dec = torch.cat([
            self.f_act(self._i_hidden(params, self._cols_dense(cols), cols) @ iw + ib2)
            for cols in (torch.arange(sl.start, sl.stop, device=users.device) for sl in chunks(self.num_items, step))
        ], dim=0)                                                  # (I, B)
        return (u_dec + i_dec.T) / 2.0
