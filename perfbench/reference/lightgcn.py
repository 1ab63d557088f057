"""LightGCN in plain PyTorch (He et al., SIGIR 2020, arXiv:2002.02126).

E^{k+1} = Â E^k with Â = D^-1/2 A D^-1/2 over the user-item graph; the
final table is the mean of E^0 .. E^K; a score is a dot product of a user
row and an item row. BPR loss, as the configuration states it: the sum over
the batch of softplus(-(y_ui - y_uj)) times the instance weight, plus reg
times half the squared norm of the batch's layer-0 rows (user, positive,
negative), each scaled by the weight.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import Arith, Graph, bipartite_graph, spmm

ADJ_TYPE = "pre"


def make_weights(hyper: dict, num_users: int, num_items: int, generator: torch.Generator) -> dict:
    """Glorot-uniform user and item tables, U(-l, l) with l = sqrt(6 /
    (rows + width)), from one draw on the generator's device."""
    d = int(hyper["embed_size"])
    u = torch.rand(((num_users + num_items) * d,), generator=generator, device=generator.device)
    u = 2.0 * u - 1.0
    return {
        "user_emb": (u[: num_users * d].view(num_users, d) * math.sqrt(6.0 / (num_users + d))).contiguous(),
        "item_emb": (u[num_users * d:].view(num_items, d) * math.sqrt(6.0 / (num_items + d))).contiguous(),
    }


def graph(train, hyper: dict, device) -> Graph:
    return bipartite_graph(train, hyper.get("adj_type", ADJ_TYPE), device)


def propagate(weights: dict, g: Graph, hyper: dict, arith: Arith, masks=None):
    """(user table, item table) of the final embeddings."""
    h = torch.cat([weights["user_emb"], weights["item_emb"]]).to(arith.dtype)
    acc = h
    for _ in range(int(hyper["n_layers"])):
        h = spmm(g, h, arith)
        acc = acc + h
    final = acc / (int(hyper["n_layers"]) + 1)
    return final[: g.num_users], final[g.num_users:]


def loss(weights: dict, g: Graph, hyper: dict, batch: dict, arith: Arith, masks=None) -> torch.Tensor:
    users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["w"].to(arith.dtype)
    u_t, i_t = propagate(weights, g, hyper, arith)
    u = u_t[users]
    y = arith.dot(u, i_t[pos]) - arith.dot(u, i_t[neg])
    mf = torch.sum(F.softplus(-y) * w)
    rows = (weights["user_emb"][users], weights["item_emb"][pos], weights["item_emb"][neg])
    reg = sum(0.5 * torch.sum(arith.op(r.to(arith.dtype) * w[:, None]) ** 2) for r in rows)
    return mf + float(hyper["reg"]) * reg


def step_masks(hyper: dict, seed: int, n_nodes: int, device):
    """LightGCN draws nothing inside a step."""
    return None


def width(hyper: dict) -> int:
    """The width of a final user or item row (a score's dot product)."""
    return int(hyper["embed_size"])
