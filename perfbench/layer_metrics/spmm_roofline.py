"""K2's share of its roofline (``plan_spmm``, ``plan_spmm_t``): the table
read once, the product written once, each edge's index and value read
once, over the kernels' device time."""

from perfbench.layer_metrics.shares import family_share


def read(rec):
    return family_share(rec, "k2", "k2_launch_s")
