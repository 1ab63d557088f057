"""SpectralCF — spectral graph convolution CF (Zheng et al., RecSys 2018).

Port of ``neurec_tpu/models/general/spectralcf.py`` (model/general_recommender/
SpectralCF.py):

* graph: the dense bipartite A with self connections; L = I - D^-1 A; its
  eigendecomposition A_hat = U U^T + U Λ U^T, real part. It is built on the
  host with the JAX package's numpy calls on the same f32 input, so A_hat
  has the same bits in both packages;
* K layers: E <- act(A_hat E F_k), all layers concatenated;
* BPR on the propagated embeddings + reg * l2(propagated lookups).

A_hat is a dense (U + I)^2 matrix on the device, and ``A_hat @ h`` a plain
dense product (the JAX package leaves it to XLA, outside any Pallas
kernel). The eigendecomposition limits the model to small catalogues: more
than 20,000 nodes raise, as in the JAX package. The evaluator hoists the
propagation (``eval_tables``) and ranks through K1 at the concatenated
width (embedding_size * (num_layers + 1)).
"""

from __future__ import annotations

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.activations import activation_function
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss

MAX_NODES = 20000


def spectral_a_hat(train_matrix, num_users: int, num_items: int) -> np.ndarray:
    """(U + I, U + I) float32 A_hat, the JAX package's host arithmetic."""
    n = num_users + num_items
    graph = np.asarray(train_matrix.todense(), dtype=np.float32)
    A = np.zeros((n, n), dtype=np.float32)
    A[:num_users, num_users:] = graph
    A[num_users:, :num_users] = graph.T
    A += np.identity(n, dtype=np.float32)  # self connections
    D = A.sum(axis=1)
    L = np.identity(n, dtype=np.float32) - np.diag(np.power(D, -1.0)) @ A
    lam, U = np.linalg.eig(L)
    A_hat = U @ U.T + U @ np.diag(lam) @ U.T
    return np.real(A_hat).astype(np.float32)


@register("SpectralCF")
class SpectralCF(Recommender):
    data_kind = "pairwise"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 100))
        self.num_layers = int(config.get("num_layers", 2))
        self.activation = activation_function(config.get("activation", "sigmoid"))
        self.loss_function = config.get("loss_function", "BPR")
        self.reg = float(config.get("reg", 0.001))
        self.embed_init_method = config.get("embed_init_method", "xavier_normal")
        self.weight_init_method = config.get("weight_init_method", "xavier_normal")
        self.stddev = float(config.get("stddev", 0.01))
        n = self.num_users + self.num_items
        if n > MAX_NODES:
            raise ValueError(
                "SpectralCF requires a dense (U+I)^2 eigendecomposition; "
                "%d nodes is impractical (reference has the same limit)" % n
            )
        self._A_hat = torch.from_numpy(
            spectral_a_hat(dataset.train_matrix, self.num_users, self.num_items)).to(self.device)

    def init_params(self, generator: torch.Generator):
        e_init = get_initializer(self.embed_init_method, self.stddev)
        w_init = get_initializer(self.weight_init_method, self.stddev)
        d = self.embedding_size
        return {
            "user_emb": e_init(generator, (self.num_users, d)).to(self.device),
            "item_emb": e_init(generator, (self.num_items, d)).to(self.device),
            "filters": [w_init(generator, (d, d)).to(self.device) for _ in range(self.num_layers)],
        }

    def propagate(self, params):
        emb = torch.cat([self.whole(params, "user_emb"), self.whole(params, "item_emb")], dim=0)
        outs = [emb]
        h = emb
        for k in range(self.num_layers):
            h = self.activation((self._A_hat @ h) @ params["filters"][k])
            outs.append(h)
        all_emb = torch.cat(outs, dim=1)
        return all_emb[: self.num_users], all_emb[self.num_users:]

    def loss(self, params, batch, weights):
        u_table, i_table = self.propagate(params)
        u = u_table[batch["users"]]
        pi = i_table[batch["pos_items"]]
        ni = i_table[batch["neg_items"]]
        y = torch.sum(u * pi, dim=-1) - torch.sum(u * ni, dim=-1)
        w = weights[:, None]
        return pairwise_loss(self.loss_function, y, weights=weights) + self.reg * l2_loss(u * w, pi * w, ni * w)

    def predict(self, params, users):
        u_table, i_table = self.propagate(params)
        return u_table[users] @ i_table.T

    def eval_embeddings(self, params, users):
        u_table, i_table = self.propagate(params)
        return u_table[users], i_table

    def eval_tables(self, params):
        """User-independent tables, hoisted out of the eval batches."""
        return self.propagate(params)
