"""NGCF's model FLOPs: a layer's SpMM (2 nnz d_in) and its two dense
transforms (2 n d_in d_out each); a score a dot product of the
concatenated width. The adjacency is fixed, so a SpMM's backward is one
product, A^T g; a transform's and a dot product's backward are two (the
input's gradient and the weight's)."""


def _dims(hyper: dict):
    return [int(hyper["embedding_size"])] + [int(w) for w in hyper["layer_size"]]


def spmm_flops(hyper: dict, nnz: int) -> float:
    dims = _dims(hyper)
    return sum(2.0 * nnz * dims[k] for k in range(len(dims) - 1))


def transform_flops(hyper: dict, n_nodes: int) -> float:
    dims = _dims(hyper)
    return sum(2 * 2.0 * n_nodes * dims[k] * dims[k + 1] for k in range(len(dims) - 1))


def propagate_flops(hyper: dict, nnz: int, n_nodes: int) -> float:
    return spmm_flops(hyper, nnz) + transform_flops(hyper, n_nodes)


def train_step_flops(hyper: dict, nnz: int, n_nodes: int, batch: int) -> float:
    """A training step: the SpMMs forward and one backward product each;
    the transforms and the batch's two dot products a row forward, and
    twice that backward."""
    return 2.0 * spmm_flops(hyper, nnz) + 3.0 * (transform_flops(hyper, n_nodes) + 2 * 2.0 * batch * sum(_dims(hyper)))


def score_flops(hyper: dict, users: int, items: int) -> float:
    return 2.0 * users * items * sum(_dims(hyper))


def spmm_width(hyper: dict) -> int:
    """The width of the table every SpMM call multiplies (one layer's
    input; the layers' widths are equal)."""
    dims = _dims(hyper)[:-1]
    if len(set(dims)) != 1:
        raise ValueError("SpMM widths differ by layer: %s" % dims)
    return dims[0]
