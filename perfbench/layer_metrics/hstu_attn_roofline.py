"""HSTU's attention kernel's share of its roofline
(``neurec::hstu_attn_fwd``): over the cell's batches, the least time each
call could take (``perfbench/counts/hstu.py``: q, k, v read once and the
output written once at the real positions alone, 2 h (dqk + dv)
operations a causal pair at the TF32 rate) over its time by CUDA events,
each batch's attention on its first layer's q, k and v."""


def read(rec):
    a = rec.get("hstu_attn")
    return 100.0 * a["bound_s"] / a["probe_s"] if a and a["probe_s"] > 0 else None
