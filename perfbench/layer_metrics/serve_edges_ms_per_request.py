"""The serving job's host time building a request's consumed edges: the
host time of ``neurec.serve.edges`` (``_batch_edges_from_csr`` and the
padding) over the requests (``neurec.batch_topk`` spans)."""

from perfbench.layer_metrics.program_spans import per_call


def read(rec):
    return per_call("ms", "neurec.serve.edges", "neurec.batch_topk")
