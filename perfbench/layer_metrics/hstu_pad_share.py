"""The share of HSTU's attention pairs that no real pair needed: 100 (1 -
real_pairs / pairs) over the ``neurec.hstu.attn`` spans (one an evaluation
call: the (query, key) pairs its launches computed, and the causal pairs
of its users' real positions)."""

from perfbench.layer_metrics.program_spans import spans


def read(rec):
    found = [s for s in spans() if s.name == "neurec.hstu.attn"]
    pairs = sum(s.attrs.get("pairs", 0) for s in found)
    return 100.0 * (1.0 - sum(s.attrs.get("real_pairs", 0) for s in found) / pairs) if pairs else None
