"""NGCF in plain PyTorch (Wang et al., SIGIR 2019, arXiv:1905.08108), the
``ngcf`` propagation of the authors' code as the configuration states it.

Â = D^-1 (A + I) over the user-item graph. Layer k, from h = E^k:
side = Â h; h' = leaky_relu(side W_gc + b_gc) + leaky_relu((h * side) W_bi
+ b_bi), slope 0.01; while training, message dropout keeps an entry with
probability 1 - ratio and scales it by 1 / (1 - ratio); the layer's output
is h' over its row's L2 norm (x * rsqrt(max(|x|^2, 1e-12))), and h' goes on
to the next layer. The final row is [E^0, out_1, .., out_K]. Node dropout
is off (the authors' default ``node_dropout_flag=0``). BPR loss as
LightGCN's, its L2 term over the batch's final rows.

The dropout masks of a training step are drawn as a step of the program
draws them: a generator on the device seeded with the step's seed, one
``torch.rand`` of (nodes, width) a layer, in layer order, an entry kept
where the draw is below 1 - ratio.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import Arith, Graph, bipartite_graph, spmm

ADJ_TYPE = "norm"
SLOPE = 0.01


def _widths(hyper: dict):
    return [int(hyper["embedding_size"])] + [int(w) for w in hyper["layer_size"]]


def make_weights(hyper: dict, num_users: int, num_items: int, generator: torch.Generator) -> dict:
    """Xavier-normal tables, transforms and biases (std sqrt(2 / (fan_in +
    fan_out)), a bias a (1, width) matrix), from one draw on the generator's
    device."""
    dims = _widths(hyper)
    shapes = [("user_emb", None, (num_users, dims[0])), ("item_emb", None, (num_items, dims[0]))]
    for k in range(len(dims) - 1):
        for name, shape in (("W_gc", (dims[k], dims[k + 1])), ("b_gc", (1, dims[k + 1])),
                            ("W_bi", (dims[k], dims[k + 1])), ("b_bi", (1, dims[k + 1]))):
            shapes.append((name, k, shape))
    z = torch.randn((sum(math.prod(s) for _, _, s in shapes),), generator=generator, device=generator.device)
    out, at = {}, 0
    for name, k, shape in shapes:
        n = math.prod(shape)
        leaf = (z[at:at + n].view(shape) * math.sqrt(2.0 / (shape[0] + shape[1]))).contiguous()
        at += n
        if k is None:
            out[name] = leaf
        else:
            out.setdefault(name, []).append(leaf)
    return out


def graph(train, hyper: dict, device) -> Graph:
    return bipartite_graph(train, hyper.get("adj_type", ADJ_TYPE), device)


def step_masks(hyper: dict, seed: int, n_nodes: int, device):
    """The message-dropout keep masks of a step drawn from ``seed``."""
    ratio = float(hyper.get("mess_dropout_ratio", 0.1))
    if ratio <= 0:
        return None
    g = torch.Generator(device=device).manual_seed(int(seed))
    return [torch.rand((n_nodes, w), generator=g, device=device) < 1.0 - ratio for w in _widths(hyper)[1:]]


def propagate(weights: dict, g: Graph, hyper: dict, arith: Arith, masks=None):
    """(user table, item table) of the concatenated layers; ``masks`` the
    dropout masks of a training step, None at inference."""
    keep = 1.0 - float(hyper.get("mess_dropout_ratio", 0.1))
    h = torch.cat([weights["user_emb"], weights["item_emb"]]).to(arith.dtype)
    outs = [h]
    for k in range(len(_widths(hyper)) - 1):
        side = spmm(g, h, arith)
        s = F.leaky_relu(arith.mm(side, weights["W_gc"][k]) + weights["b_gc"][k].to(arith.dtype), SLOPE)
        bi = F.leaky_relu(arith.mm(h * side, weights["W_bi"][k]) + weights["b_bi"][k].to(arith.dtype), SLOPE)
        h = s + bi
        if masks is not None:
            h = torch.where(masks[k], h / keep, torch.zeros_like(h))
        outs.append(h * torch.rsqrt(torch.clamp(torch.sum(h * h, dim=1, keepdim=True), min=1e-12)))
    final = torch.cat(outs, dim=1)
    return final[: g.num_users], final[g.num_users:]


def loss(weights: dict, g: Graph, hyper: dict, batch: dict, arith: Arith, masks=None) -> torch.Tensor:
    users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["w"].to(arith.dtype)
    u_t, i_t = propagate(weights, g, hyper, arith, masks)
    u, pi, ni = u_t[users], i_t[pos], i_t[neg]
    y = arith.dot(u, pi) - arith.dot(u, ni)
    mf = torch.sum(F.softplus(-y) * w)
    reg = sum(0.5 * torch.sum(arith.op(r * w[:, None]) ** 2) for r in (u, pi, ni))
    return mf + float(hyper["reg"]) * reg


def width(hyper: dict) -> int:
    return sum(_widths(hyper))
