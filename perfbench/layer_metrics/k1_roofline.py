"""K1's share of its roofline (``masked_scores``): the larger of its
bytes (user rows, item table, mask bits read once, the float32 scores
written once) and its products at the TF32 peak, over its device time."""

from perfbench.layer_metrics.shares import family_share


def read(rec):
    return family_share(rec, "k1", "k1_launch_s")
