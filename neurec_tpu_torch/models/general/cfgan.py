"""CFGAN — conditional vector-wise GAN for CF (Chae et al., CIKM 2018).

Port of ``neurec_tpu/models/general/cfgan.py`` (model/general_recommender/
CFGAN.py:30-193):

* generator: a sigmoid dense stack, condition row -> full rating row;
  discriminator: a sigmoid dense stack over [condition; (masked) row] ->
  logit; both Glorot-uniform weights and zero biases;
* the ZR (zero-reconstruction) and PM (partial-masking) negative masks:
  Bernoulli(ZR_ratio / ZP_ratio) over each row's non-interacted entries,
  drawn each batch (the reference draws an exact count each round);
* an epoch is one round: ``step_D`` discriminator sub-epochs, then
  ``step_G`` generator sub-epochs, each over ``rows // B`` batches of a
  fresh permutation; the configured ``epochs`` count is divided by
  ``step_G`` as the reference's outer loop;
* userBased or itemBased (the transposed matrix) mode.

G and D have their own optimizers (``init_opt_state``: ``{"g", "d"}``,
Adam or SGD at lr_G / lr_D). The permutations and a seed a step come from
the epoch's generator, a step's masks from a generator of its own; on a
CUDA device each sub-epoch's steps are CUDA-graph replays
(``sub_epoch_steps``). ``eval_dense_scores`` exists only in itemBased mode,
where ``predict`` runs the generator over the whole catalogue for any
batch.

On a mesh every step of both sub-epochs is split over 'data' as the JAX
package's (``cfgan.py:130-131,148-150``): a rank takes its rows of the
permutation's batch (user rows, or item rows in itemBased mode), draws the
masks for the whole batch and keeps its rows (``split_draw``), takes its
share of each mean over rows (``split_mean``), counts the weight
regulariser once (``whole_term``), and sums the gradients of the player
that stepped over 'data' before its optimizer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.data.padded import build_padded_positives, dense_rows
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.general.ae_common import DenseRowMixin
from neurec_tpu_torch.ops.initializers import glorot_uniform
from neurec_tpu_torch.ops.losses import l2_loss
from neurec_tpu_torch.parallel.mesh import split_mean, whole_term
from neurec_tpu_torch.step_graph import Steps, at, step_seeds, train_step
from neurec_tpu_torch.trainer import OptaxAdam


def _dense_stack_init(generator, dims, device):
    return [{"w": glorot_uniform(generator, (d_in, d_out)).to(device), "b": torch.zeros((d_out,), device=device)}
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def _sigmoid_stack(layers, x):
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = torch.sigmoid(x)
    return x


def _leaves(tree):
    return [p for _, p in param_leaves(tree)]


@register("CFGAN")
class CFGAN(Recommender):
    data_kind = "custom"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.mode = config.get("mode", "itemBased")
        self.lr_G = float(config.get("lr_G", 0.0001))
        self.lr_D = float(config.get("lr_D", 0.0001))
        self.reg_G = float(config.get("reg_G", 0.001))
        self.reg_D = float(config.get("reg_D", 0.001))
        self.batchSize_G = int(config.get("batchSize_G", 128))
        self.batchSize_D = int(config.get("batchSize_D", 128))
        self.opt_G = config.get("opt_G", "adam")
        self.opt_D = config.get("opt_D", "adam")
        self.hiddenLayer_G = list(config.get("hiddenLayer_G", [300]))
        self.hiddenLayer_D = list(config.get("hiddenLayer_D", [250]))
        self.step_G = int(config.get("step_G", 5))
        self.step_D = int(config.get("step_D", 2))
        self.ZR_ratio = float(config.get("ZR_ratio", 0.4))
        self.ZP_ratio = float(config.get("ZP_ratio", 0.4))
        self.ZR_coefficient = float(config.get("ZR_coefficient", 0.1))
        matrix = dataset.train_matrix
        if self.mode == "itemBased":
            matrix = matrix.T.tocsr()
        self._n_rows, self._n_cols = matrix.shape
        self._rows_idx = torch.from_numpy(build_padded_positives(matrix).items).long().to(self.device)
        # the user-facing evaluation is always (users x items)
        self.epochs = int(self.epochs / self.step_G)
        if self.mode != "itemBased":
            # userBased predict runs the generator on the batch's own rows
            self.eval_dense_scores = None

    def _make_opt(self, name, lr, params):
        return OptaxAdam(_leaves(params), lr=lr) if name == "adam" else torch.optim.SGD(_leaves(params), lr=lr)

    def init_opt_state(self, params):
        return {"g": self._make_opt(self.opt_G, self.lr_G, params["gen"]),
                "d": self._make_opt(self.opt_D, self.lr_D, params["dis"])}

    def init_params(self, generator: torch.Generator):
        n = self._n_cols
        return {"gen": _dense_stack_init(generator, [n] + self.hiddenLayer_G + [n], self.device),
                "dis": _dense_stack_init(generator, [2 * n] + self.hiddenLayer_D + [1], self.device)}

    def _make_cond_rows(self, idx):
        return dense_rows(self._rows_idx[idx], self._n_cols)

    _bernoulli = staticmethod(DenseRowMixin._bernoulli)  # the masks' draws (the tests hand in JAX's)

    def _sample_mask(self, generator, cond, ratio):
        """Bernoulli(ratio) over the non-interacted entries, union the positives."""
        return torch.maximum(cond, self._bernoulli(generator, ratio, cond.shape).float() * (1.0 - cond))

    def _perm(self, generator, steps, B):
        """(steps, B) row ids: the head of a fresh permutation of the rows."""
        perm = torch.randperm(self._n_rows, generator=generator, device=generator.device)
        return perm[: steps * B].reshape(steps, B)

    @staticmethod
    def _bce(logits, target_ones: bool):
        return split_mean(torch.mean(F.softplus(-logits if target_ones else logits)))

    def d_loss(self, params, idx, generator):
        """The discriminator's loss on rows ``idx`` (a gradient to ``dis`` only)."""
        cond = self._make_cond_rows(idx)
        pm = self._sample_mask(generator, cond, self.ZP_ratio)
        with torch.no_grad():
            fake = _sigmoid_stack(self.whole_tree(params, "gen"), cond)
        dis = self.whole_tree(params, "dis")
        d_fake = _sigmoid_stack(dis, torch.cat([cond, fake * pm], 1))
        d_real = _sigmoid_stack(dis, torch.cat([cond, cond], 1))
        return self._bce(d_real, True) + self._bce(d_fake, False) + whole_term(self.reg_D * l2_loss(*_leaves(dis)))

    def g_loss(self, params, idx, generator):
        """The generator's loss on rows ``idx`` (a gradient to ``gen`` only)."""
        cond = self._make_cond_rows(idx)
        zr = self._sample_mask(generator, cond, self.ZR_ratio) - cond  # the negatives only
        pm = self._sample_mask(generator, cond, self.ZP_ratio)
        gen = self.whole_tree(params, "gen")
        fake = _sigmoid_stack(gen, cond)
        dis = map_params(torch.Tensor.detach, self.whole_tree(params, "dis"))
        adv = self._bce(_sigmoid_stack(dis, torch.cat([cond, fake * pm], 1)), True)
        zr_loss = split_mean(torch.mean(torch.sum(torch.square(fake) * zr, dim=1)))
        return adv + whole_term(self.reg_G * l2_loss(*_leaves(gen))) + self.ZR_coefficient * zr_loss

    def sub_epoch_steps(self, params, opt, generator, loss_name, side, B, max_steps=None, trainer=None) -> Steps:
        """One sub-epoch's steps (``step_graph.Steps``) of the loss method
        ``loss_name`` ("d_loss" or "g_loss"), whose gradient reaches
        ``params[side]`` only: the permutation and a seed a step drawn from
        ``generator`` here; a step reads its rows at the cursor and draws
        its masks from its own generator."""
        steps = max(self._n_rows // B, 1)
        n_run = steps if max_steps is None else min(steps, max_steps)
        perm = self._perm(generator, n_run, B)
        seeds = step_seeds(generator, steps)[:n_run]
        split = None if trainer is None else trainer.dp_split_for(B)

        def make(cursor, total, perm):
            def step(gen):
                idx = at(cursor, perm)
                if split is not None:  # this rank's rows of the step
                    idx = trainer.dp_constrain(idx)
                # the other player's leaves take no gradient of this loss
                train_step(lambda: getattr(self, loss_name)(params, idx, gen), opt, cursor, total, trainer,
                                split, params[side])
            return step

        return Steps(make, n_run, seeds, opt, split, inputs=dict(perm=perm), reads=params, name=side)

    def _sub_epochs(self, params, opt, generator, loss_name, side, B, n_reps, max_steps, trainer=None):
        """``n_reps`` sub-epochs (``sub_epoch_steps``), each one run of
        steps, CUDA-graph replays where the trainer captures: the last one's
        mean step loss."""
        loss = torch.zeros((), device=self.device)
        for _ in range(n_reps):
            steps = self.sub_epoch_steps(params, opt, generator, loss_name, side, B, max_steps, trainer)
            loss = self.take_steps(trainer, steps) / steps.n
        return loss

    def run_epoch(self, params, opt_state, generator, max_steps=None, trainer=None):
        """One round: step_D discriminator sub-epochs, then step_G
        generator ones; the loss is the last generator sub-epoch's mean.
        With a ``trainer`` on a mesh each step is split over 'data'
        (``Trainer.dp_split_for``)."""
        self._sub_epochs(params, opt_state["d"], generator, "d_loss", "dis", self.batchSize_D, self.step_D,
                         max_steps, trainer)
        g_loss = self._sub_epochs(params, opt_state["g"], generator, "g_loss", "gen", self.batchSize_G,
                                  self.step_G, max_steps, trainer)
        return params, opt_state, g_loss

    def build_epoch(self, trainer):
        def epoch(params, opt_state, generator, epoch, max_steps=None):
            return self.run_epoch(params, opt_state, generator, max_steps, trainer=trainer)

        return epoch

    def loss(self, params, batch, weights):
        raise RuntimeError("CFGAN uses build_epoch (data_kind='custom')")

    def _all_ratings_t(self, params):
        """(U, I) scores in itemBased mode: column u of G(every item row)."""
        cond = self._make_cond_rows(torch.arange(self._n_rows, device=self.device))
        return _sigmoid_stack(self.whole_tree(params, "gen"), cond).T

    def eval_dense_scores(self, params):
        """Every user's scores once per evaluation (itemBased only: see
        ``__init__``)."""
        return self._all_ratings_t(params)

    def predict(self, params, users):
        if self.mode == "itemBased":
            return self._all_ratings_t(params)[users]
        return _sigmoid_stack(self.whole_tree(params, "gen"), self._make_cond_rows(users))
