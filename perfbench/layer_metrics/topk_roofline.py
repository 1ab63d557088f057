"""The top-K's share of its roofline (``ops/topk.py::top_k`` at the
cell's batch, items and K, on masked scores of the cell's own
``predict``): the scores read once, K values and ids a row written once,
over its time by CUDA events."""


def read(rec):
    s = rec.get("topk_probe_s")
    return 100.0 * rec["bounds"]["topk_s"] / s if s else None
