"""LightGCN's model FLOPs (SpMM 2 nnz d a layer; a score a dot product of
the final width). The adjacency is fixed, so a layer's backward is one
product, A^T g; a dot product's backward is two."""


def propagate_flops(hyper: dict, nnz: int, n_nodes: int) -> float:
    """One propagation: K layers of the adjacency times a d-wide table."""
    return int(hyper["n_layers"]) * 2.0 * nnz * int(hyper["embed_size"])


def train_step_flops(hyper: dict, nnz: int, n_nodes: int, batch: int) -> float:
    """A training step: the propagation forward and its one backward
    product a layer; the batch's two dot products a row forward, and twice
    that backward."""
    return 2.0 * propagate_flops(hyper, nnz, n_nodes) + 3.0 * 2 * 2.0 * batch * int(hyper["embed_size"])


def score_flops(hyper: dict, users: int, items: int) -> float:
    """Full-catalogue scores of ``users`` users."""
    return 2.0 * users * items * int(hyper["embed_size"])


def spmm_width(hyper: dict) -> int:
    """The width of the table every SpMM call multiplies."""
    return int(hyper["embed_size"])
