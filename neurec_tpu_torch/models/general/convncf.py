"""ConvNCF — outer-product CNN collaborative filtering (He et al., IJCAI 2018).

Port of ``neurec_tpu/models/general/convncf.py`` (model/general_recommender/
ConvNCF.py:45-150):

* the interaction map outer(p_u, q_i), a (d, d, 1) image in NHWC, runs
  through ``len(net_channel)`` stride-2 2x2 'SAME' tanh convolutions down
  to (1, 1), then dropout (``keep``) and a scalar dense head;
* BPR loss; regularization lambda * l2(the batch's embeddings) + gamma *
  l2(W, b) + lambda_weight * l2(every conv kernel and bias, W, b);
* two Adagrads with ``initial_accumulator_value=0.1`` (``make_optimizer``):
  ``lr_embed`` for ``embedding_P`` / ``embedding_Q``, ``lr_net`` for the rest;
* ``mf_pretrain``: a ``[P, Q]`` pickle (or a P pickle with a Q pickle in
  ``mlp_pretrain``, the reference's layout) warm-starts the embeddings.

The kernels keep the JAX layout, HWIO ``(2, 2, in, out)``. The map's side
is 2^len(net_channel) (checked), so every convolution sees an even side and
'SAME' pads nothing: each output pixel is its own 2x2 patch, and a layer is
one f32 matmul of the (N, H/2, W/2, 4 * in) patches by the kernel as a
(4 * in, out) matrix, in (kh, kw, in) order on both sides. Dropout draws
from ``batch["generator"]`` (none without one). ``predict`` runs over item
chunks of ``_PREDICT_CHUNK`` and user groups of at most ``_PAIRS`` pairs a
call: a pair's first layer alone is (d/2)^2 * channels floats.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, chunks, register
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss
from neurec_tpu_torch.parallel.mesh import split_draw, whole_term
from neurec_tpu_torch.pretrain import as_tensor, try_load
from neurec_tpu_torch.trainer import OptaxAdagrad

_PREDICT_CHUNK = 256
# (user, item) pairs through the CNN a call in predict: at d 64 and 32
# channels the first layer's output is 128 KB a pair, 1 GB a call
_PAIRS = 8192


def conv2x2_stride2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A stride-2 2x2 'SAME' convolution of an even-sided NHWC ``x`` with an
    HWIO kernel ``w``, plus ``b``: a matmul over the 2x2 patches."""
    N, H, W, C = x.shape
    patches = x.reshape(N, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(N, H // 2, W // 2, 4 * C)
    return patches @ w.reshape(4 * C, w.shape[-1]) + b


@register("ConvNCF")
class ConvNCF(Recommender):
    data_kind = "pairwise"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        regs = config.get("regs", [0.01, 0, 0])
        self.lambda_bilinear = float(regs[0])
        self.gamma_bilinear = float(regs[1])
        self.lambda_weight = float(regs[2])
        self.nc = list(config.get("net_channel", [32, 32, 32, 32, 32, 32]))
        self.lr_embed = float(config.get("lr_embed", 0.05))
        self.lr_net = float(config.get("lr_net", 0.05))
        self.keep = float(config.get("keep", 1.0))
        self.loss_function = config.get("loss_function", "BPR")
        self.embed_init_method = config.get("embed_init_method", "tnormal")
        self.weight_init_method = config.get("weight_init_method", "xavier_normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.mf_pretrain = config.get("mf_pretrain", "")
        self.mlp_pretrain = config.get("mlp_pretrain", "")
        if 2 ** len(self.nc) != self.embedding_size:
            raise ValueError(
                "ConvNCF needs len(net_channel) stride-2 convs to reduce the (%d, %d) map to 1x1 — got %d layers"
                % (self.embedding_size, self.embedding_size, len(self.nc)))

    def make_optimizer(self):
        """``params -> optimizer``: optax.multi_transform of two
        ``adagrad(lr, initial_accumulator_value=0.1)``, "embed" for the
        embedding tables, "net" for the rest (ConvNCF.py:138-150)."""
        def build(params):
            embed = [params["embedding_P"], params["embedding_Q"]]
            net = [p for path, p in param_leaves(params) if path[0] not in ("embedding_P", "embedding_Q")]
            return OptaxAdagrad([{"params": embed, "lr": self.lr_embed}, {"params": net, "lr": self.lr_net}],
                                lr=self.lr_net, initial_accumulator_value=0.1)
        return build

    def init_params(self, generator: torch.Generator):
        e_init = get_initializer(self.embed_init_method, self.stddev)
        w_init = get_initializer(self.weight_init_method, self.stddev)
        params = {
            "embedding_P": e_init(generator, (self.num_users, self.embedding_size)),
            "embedding_Q": e_init(generator, (self.num_items, self.embedding_size)),
            "conv": [],
            "W": w_init(generator, (self.nc[-1], 1)),
            "b": w_init(generator, (1,)),
        }
        for isz, osz in zip([1] + self.nc[:-1], self.nc):
            params["conv"].append({"w": w_init(generator, (2, 2, isz, osz)),
                                   "b": torch.full((osz,), 0.1, device=generator.device)})
        loaded = try_load(self.mf_pretrain)
        if loaded is not None:
            first = loaded[0]
            pq = None
            if isinstance(first, (list, tuple)) and len(first) >= 2:
                pq = first[0], first[1]  # [P, Q] single-file layout
            else:
                second = try_load(self.mlp_pretrain)
                if second is not None:
                    pq = first, second[0]
            if pq is not None:
                params["embedding_P"], params["embedding_Q"] = (as_tensor(a, self.device) for a in pq)
        return map_params(lambda t: t.to(self.device), params)

    def _cnn(self, params, images, generator=None, training=False):
        """(N, d, d, 1) outer-product maps -> (N,) scores."""
        x = images
        for layer in params["conv"]:
            x = torch.tanh(conv2x2_stride2(x, layer["w"], layer["b"]))
        x = x.reshape(x.shape[0], self.nc[-1])
        if training and generator is not None and self.keep < 1.0:
            mask = split_draw(lambda s: torch.rand(s, generator=generator, device=x.device), x.shape) < self.keep
            x = torch.where(mask, x / self.keep, torch.zeros_like(x))
        return (x @ params["W"] + params["b"])[:, 0]

    def _pair_scores(self, params, users, items, generator=None, training=False):
        p = self.rows(params, "embedding_P", users)
        q = self.rows(params, "embedding_Q", items)
        images = (p[:, :, None] * q[:, None, :])[..., None]
        return self._cnn(params, images, generator, training), p, q

    def loss(self, params, batch, weights):
        users, gen = batch["users"], batch.get("generator")
        y_pos, p, q1 = self._pair_scores(params, users, batch["pos_items"], gen, training=True)
        y_neg, _, q2 = self._pair_scores(params, users, batch["neg_items"], gen, training=True)
        w = weights[:, None]
        conv_reg = sum(l2_loss(c["w"], c["b"]) for c in params["conv"])
        head_reg = l2_loss(params["W"], params["b"])
        return (pairwise_loss(self.loss_function, y_pos - y_neg, weights=weights)
                + self.lambda_bilinear * l2_loss(p * w, q2 * w, q1 * w)
                + whole_term(self.gamma_bilinear * head_reg + self.lambda_weight * (conv_reg + head_reg)))

    def predict(self, params, users):
        """(B, num_items): the CNN over every (user, item) pair, by item chunk
        and user group."""
        P = self.rows(params, "embedding_P", users)
        Q = self.whole(params, "embedding_Q")
        d = self.embedding_size
        group = max(1, _PAIRS // _PREDICT_CHUNK)
        rows = []
        for ug in chunks(P.shape[0], group):
            p = P[ug]
            cols = []
            for sl in chunks(self.num_items, _PREDICT_CHUNK):
                q = Q[sl]
                images = (p[:, None, :, None] * q[None, :, None, :]).reshape(-1, d, d, 1)
                cols.append(self._cnn(params, images).reshape(p.shape[0], q.shape[0]))
            rows.append(torch.cat(cols, dim=1))
        return torch.cat(rows, dim=0)

