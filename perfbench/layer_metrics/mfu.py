"""The whole step's share of the card's peak: the configuration's model
FLOPs (``perfbench/counts``) of the units timed by the host over their
wall time and the dense TF32 peak."""

from perfbench.counts import TF32_FLOPS


def read(rec):
    t = rec["untraced"]
    return 100.0 * rec["flops_per_unit"] * t["units"] / (t["wall_s"] * TF32_FLOPS) if t["wall_s"] > 0 else None
