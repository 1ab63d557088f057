"""IRGAN — minimax IR GAN for item recommendation (Wang et al., SIGIR 2017).

Port of ``neurec_tpu/models/general/irgan.py`` (model/general_recommender/
IRGAN.py:15-250):

* generator G and discriminator D are both MF-with-bias scorers; G may be
  warm-started from a ``[user_emb, item_emb, bias]`` pickle
  (``pretrain_file``, written by ``pretrain.save_pretrain("IRGAN", ...)``);
  D starts random;
* D pass: per user, |pos| negatives drawn from softmax(G logits / d_tau);
  pointwise sigmoid cross-entropy on the (pos, 1) / (neg, 0) pairs in
  shuffled batches, SGD at lr; pad slots weigh 0, and the reference's
  regularization quirk is kept (its scalar L2 term is broadcast over the
  unreduced batch loss, so the effective weight is the count of real
  instances times d_reg);
* G pass: per user in turn, 2 |pos| items drawn from the importance
  distribution pn = 0.8 softmax(G) + 0.2 uniform(pos); REINFORCE with the
  reward 2 (sigmoid(D) - 0.5) prob / pn, an SGD step per user;
* the evaluation uses G's factors (K1 at factors_num + 1, the bias folded in).

The D pass's negatives and permutation and a seed for each G step come
from the epoch's generator, a G step's samples from a generator of its
own: the same distributions as the JAX package's, not its draws. The
softmax samples invert each row's CDF at uniform draws (``categorical``),
a CDF summed in a fixed order, so that the draws do not depend on the
device's timing (``torch.multinomial`` sums a one-row CDF by a scan whose
order of addition does, on a CUDA device). Both passes update their
player's leaves in place (``_sgd_step``), and on a CUDA device their steps
are CUDA-graph replays (``d_steps``, ``g_steps``).

On a mesh the D pass's steps are split over 'data' as the JAX package's
(``irgan.py:133-134,228``): the negatives and the permutation drawn whole
on every rank, then a rank's rows of each batch; the quirk's factor is the
whole batch's weight count (``batch_sum``), its bracket the rank's rows,
and the SGD step takes the gradients summed over 'data'. The G pass, one
REINFORCE step a user in turn, runs whole on every rank, as in the JAX
package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neurec_tpu_torch.data.padded import build_padded_positives
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, chunks, register
from neurec_tpu_torch.parallel import tables
from neurec_tpu_torch.parallel.mesh import all_sum_many, batch_split, batch_sum
from neurec_tpu_torch.pretrain import as_tensor, try_load
from neurec_tpu_torch.step_graph import Steps, at, step_seeds

# users of one (users, I) softmax block of the D pass's negatives
_NEG_CHUNK = 2048
# items of one block of a CDF (``categorical``)
_CDF_BLOCK = 512


def categorical(generator: torch.Generator, logits: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, n) int64 draws of each row's softmax(logits), with
    replacement: the first item whose CDF exceeds ``u * total``, ``u``
    uniform from ``generator``. The CDF is summed in a fixed order, within
    blocks of ``_CDF_BLOCK`` items (a cumsum over the last dimension of
    many rows) and then over the blocks' totals (a sum over a dimension),
    so the same inputs give the same draws on every run."""
    p = torch.softmax(logits, dim=-1)
    rows, items = p.shape
    n_blocks = -(-items // _CDF_BLOCK)
    within = torch.cumsum(F.pad(p, (0, n_blocks * _CDF_BLOCK - items)).reshape(rows, n_blocks, _CDF_BLOCK), dim=-1)
    earlier = torch.ones(n_blocks, n_blocks, device=p.device).triu(1)  # block j before block k
    before = torch.sum(within[:, :, -1:] * earlier, dim=1)             # (rows, blocks)
    cdf = (within + before[:, :, None]).reshape(rows, -1)
    u = torch.rand((rows, n), generator=generator, device=p.device) * cdf[:, -1:]
    return torch.clamp(torch.searchsorted(cdf, u, right=True), max=items - 1)


@register("IRGAN")
class IRGAN(Recommender):
    data_kind = "custom"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.factors_num = int(config.get("factors_num", 20))
        self.lr = float(config.get("lr", 0.001))
        self.g_reg = float(config.get("g_reg", 0.0))
        self.d_reg = float(config.get("d_reg", 0.1 / 16))
        self.g_epoch = int(config.get("g_epoch", 1))
        self.d_epoch = int(config.get("d_epoch", 1))
        self.d_tau = float(config.get("d_tau", 0.2))
        self.pretrain_file = config.get("pretrain_file", "")
        self.sample_lambda = 0.2
        padded = build_padded_positives(dataset.train_matrix)
        self._rows = torch.from_numpy(padded.items).long().to(self.device)  # (U, L), pad = I
        self._lens = torch.from_numpy(padded.lengths).to(self.device)
        self._train_users = torch.nonzero(self._lens > 0)[:, 0]
        self.L = padded.items.shape[1]

    def init_opt_state(self, params):
        return {}  # both players take plain SGD steps in their passes

    def init_params(self, generator: torch.Generator):
        def mf_init():
            def uniform(shape):
                u = torch.rand(shape, generator=generator, device=generator.device)
                return ((2.0 * u - 1.0) * 0.05).to(self.device)

            return {"user_emb": uniform((self.num_users, self.factors_num)),
                    "item_emb": uniform((self.num_items, self.factors_num)),
                    "item_bias": torch.zeros((self.num_items,), device=self.device)}

        gen, dis = mf_init(), mf_init()
        loaded = try_load(self.pretrain_file)
        if loaded is not None:
            p = loaded[0]
            gen = {"user_emb": as_tensor(p[0], self.device), "item_emb": as_tensor(p[1], self.device),
                   "item_bias": as_tensor(p[2], self.device)}
        return {"gen": gen, "dis": dis}

    def _emb(self, mf, side, key, ids=None):
        """``mf[key]`` of the player ``side`` ("gen" or "dis", ``mf`` its
        tree): its rows at ``ids``, or the whole table where ``ids`` is None
        (``parallel/tables.py``)."""
        shard = self.shard((side, key))
        return tables.whole(mf[key], shard) if ids is None else tables.rows(mf[key], ids, shard)

    def _logits(self, gen, u):
        """The generator's scores of users ``u`` over the catalogue."""
        return self._emb(gen, "gen", "user_emb", u) @ self._emb(gen, "gen", "item_emb").T + gen["item_bias"]

    @staticmethod
    def _categorical(generator, logits, n):
        """(rows, n) draws of each row's softmax(logits), with replacement
        (``categorical``)."""
        return categorical(generator, logits, n)

    @staticmethod
    def _perm(generator, n):
        return torch.randperm(n, generator=generator, device=generator.device)

    def _sgd_step(self, tree, loss, split=None) -> None:
        """``p <- p - lr * grad(loss)`` for each leaf of ``tree``, in place
        (the leaves stay the same tensors, as a CUDA graph needs); in a
        split step the gradients summed over 'data' first."""
        grads = torch.autograd.grad(loss, list(tree.values()))
        if split is not None:
            grads = all_sum_many(grads, split.mesh, "data")
        with torch.no_grad():
            for p, g in zip(tree.values(), grads):
                p.sub_(self.lr * g)

    @staticmethod
    def _player(tree):
        """A player's leaves for its pass: copies that take gradients."""
        return {k: v.detach().clone().requires_grad_(True) for k, v in tree.items()}

    def d_steps(self, params, generator, max_steps=None, trainer=None):
        """The discriminator sub-epoch's steps (``step_graph.Steps``) and the
        discriminator's leaves they update in place (a fresh copy of the
        player, an input of the run that a kept run copies into its own
        buffers and back, ``Steps.updates``): the negatives (from G's
        softmax) and the permutation drawn from ``generator`` here, a
        step's pairs read at the cursor; a step draws nothing. With a
        ``trainer`` on a mesh each step is split over 'data'
        (``Trainer.dp_split_for``)."""
        users, L, I, B = self._train_users, self.L, self.num_items, self.batch_size
        nU = users.shape[0]
        with torch.no_grad():
            negs = torch.cat([self._categorical(generator, self._logits(params["gen"], users[sl]) / self.d_tau, L)
                              for sl in chunks(nU, _NEG_CHUNK)])                   # (nU, L)
        pos_rows = self._rows[users]
        slot_valid = (pos_rows < I).float()
        flat_users = torch.repeat_interleave(users, 2 * L)
        flat_items = torch.cat([torch.clamp(pos_rows, max=I - 1), negs], dim=1).reshape(-1)
        flat_labels = torch.cat([torch.ones((nU, L), device=users.device),
                                 torch.zeros((nU, L), device=users.device)], dim=1).reshape(-1)
        flat_w = torch.cat([slot_valid, slot_valid], dim=1).reshape(-1)
        N = flat_users.shape[0]
        steps = -(-N // B)
        perm = self._perm(generator, steps * B)
        idx = torch.where(perm < N, perm, 0).reshape(steps, B)
        # tail slots alias instance 0: they weigh 0
        tail_w = (perm < N).float().reshape(steps, B)
        dis = self._player(params["dis"])
        n_steps = steps if max_steps is None else min(steps, max_steps)
        split = None if trainer is None else trainer.dp_split_for(B)

        def make(cursor, total, idx, tail_w, flat_users, flat_items, flat_labels, flat_w, dis):
            def step(gen):
                bi, bw = at(cursor, idx, tail_w)
                if split is not None:  # this rank's rows of the step
                    bi, bw = trainer.dp_constrain(bi, bw)
                u, i, lbl, w = flat_users[bi], flat_items[bi], flat_labels[bi], flat_w[bi] * bw
                with batch_split(split):
                    loss = self._d_loss(dis, u, i, lbl, w)
                self._sgd_step(dis, loss, split)
                total.add_(loss.detach())
                cursor.add_(1)
            return step

        inputs = dict(idx=idx, tail_w=tail_w, flat_users=flat_users, flat_items=flat_items, flat_labels=flat_labels,
                      flat_w=flat_w, dis=dis)
        return Steps(make, n_steps, None, None, split, inputs=inputs, updates=("dis",), name="dis"), dis

    def d_pass(self, params, generator, max_steps=None, trainer=None):
        """One discriminator sub-epoch (``d_steps``); returns (params, mean
        step loss)."""
        steps, dis = self.d_steps(params, generator, max_steps, trainer)
        total = self.take_steps(trainer, steps)
        return dict(params, dis={k: v.detach() for k, v in dis.items()}), total / steps.n

    def _d_loss(self, dis, u, i, lbl, w):
        """The D pass's loss on the pairs (u, i) labelled ``lbl``, weighing ``w``."""
        logits = (torch.sum(self._emb(dis, "dis", "user_emb", u) * self._emb(dis, "dis", "item_emb", i), dim=-1)
                  + dis["item_bias"][i])
        ce = torch.clamp(logits, min=0.0) - logits * lbl + F.softplus(-torch.abs(logits))
        # the reference's quirk (IRGAN.py:103-107): the scalar d_reg * l2 is
        # broadcast over the (B,) loss and TF minimizes its sum; its factor
        # is the whole batch's weight count, its bracket a sum over rows
        reg = self.d_reg * batch_sum(torch.sum(w)) * 0.5 * (
            torch.sum(torch.square(self._emb(dis, "dis", "user_emb", u) * w[:, None]))
            + torch.sum(torch.square(self._emb(dis, "dis", "item_emb", i) * w[:, None]))
            + torch.sum(torch.square(dis["item_bias"][i] * w)))
        return torch.sum(ce * w) + reg

    def g_steps(self, params, generator, max_steps=None):
        """The generator sub-epoch's steps (``step_graph.Steps``), a
        REINFORCE step per train user in turn, and the generator's leaves
        they update in place (copied in and back by a kept run, as
        ``d_steps``' player; the discriminator's leaves are an input too):
        a seed a step drawn from ``generator`` here,
        a step's user read at the cursor (a (1,) index: no host read) and
        its samples drawn from its own generator."""
        users, I = self._train_users, self.num_items
        S = 2 * self.L
        gen = self._player(params["gen"])
        d = {k: v.detach() for k, v in params["dis"].items()}
        n_steps = users.shape[0] if max_steps is None else min(users.shape[0], max_steps)
        seeds = step_seeds(generator, users.shape[0])[:n_steps]
        slots = torch.arange(S, device=users.device, dtype=torch.float32)

        def make(cursor, total, gen, d, slots):
            def step(g):
                u = users.index_select(0, cursor)                                  # (1,)
                rows_u = self._rows.index_select(0, u)[0]                          # (L,)
                with torch.no_grad():
                    n_pos = torch.clamp(self._lens.index_select(0, u)[0].float(), min=1.0)
                    prob = torch.softmax(self._logits(gen, u)[0], dim=-1)
                    pn = torch.cat([(1.0 - self.sample_lambda) * prob, prob.new_zeros(1)])
                    pn = pn.index_add(0, rows_u, (self.sample_lambda / n_pos).expand(rows_u.shape[0]))[:I]
                    sample = self._categorical(g, torch.log(pn + 1e-24)[None, :], S)[0]
                    samp_w = (slots < 2.0 * n_pos).float()
                    d_logits = (torch.sum(self._emb(d, "dis", "user_emb", u) * self._emb(d, "dis", "item_emb", sample),
                                          dim=-1) + d["item_bias"][sample])
                    reward = 2.0 * (torch.sigmoid(d_logits) - 0.5) * prob[sample] / torch.clamp(pn[sample], min=1e-24)
                log_sm = torch.log_softmax(self._logits(gen, u)[0], dim=-1)
                gan = -torch.sum(log_sm[sample] * reward * samp_w) / torch.clamp(torch.sum(samp_w), min=1.0)
                reg = self.g_reg * 0.5 * (torch.sum(torch.square(self._emb(gen, "gen", "user_emb", u)))
                                          + torch.sum(torch.square(self._emb(gen, "gen", "item_emb", sample)
                                                                   * samp_w[:, None]))
                                          + torch.sum(torch.square(gen["item_bias"][sample] * samp_w)))
                loss = gan + reg
                self._sgd_step(gen, loss)
                total.add_(loss.detach())
                cursor.add_(1)
            return step

        return Steps(make, n_steps, seeds, inputs=dict(gen=gen, d=d, slots=slots), updates=("gen",),
                     name="gen"), gen

    def g_pass(self, params, generator, max_steps=None, trainer=None):
        """One generator sub-epoch (``g_steps``); returns (params, mean step
        loss). It runs whole on every rank of a mesh, as the JAX package's."""
        steps, gen = self.g_steps(params, generator, max_steps)
        total = self.take_steps(trainer, steps)
        return dict(params, gen={k: v.detach() for k, v in gen.items()}), total / steps.n

    def run_epoch(self, params, generator, max_steps=None, trainer=None):
        loss = torch.zeros((), device=self.device)
        for _ in range(self.d_epoch):
            params, loss = self.d_pass(params, generator, max_steps, trainer)
        for _ in range(self.g_epoch):
            params, loss = self.g_pass(params, generator, max_steps, trainer)
        return params, loss

    def build_epoch(self, trainer):
        def epoch(params, opt_state, generator, epoch, max_steps=None):
            params, loss = self.run_epoch(params, generator, max_steps, trainer)
            return params, opt_state, loss

        return epoch

    def loss(self, params, batch, weights):
        raise RuntimeError("IRGAN uses build_epoch (data_kind='custom')")

    def predict(self, params, users):
        return self._logits(params["gen"], users)

    def eval_embeddings(self, params, users):
        gen = params["gen"]
        return self._affine_eval(self._emb(gen, "gen", "user_emb", users), self._emb(gen, "gen", "item_emb"),
                                 gen["item_bias"])
