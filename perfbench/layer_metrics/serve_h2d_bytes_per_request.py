"""Bytes a serving request copies from the host to the device: the
``h2d_bytes`` of each ``neurec.serve.h2d`` span (its users and padded
consumed edges, as the device buffers hold them), over the requests
(``neurec.batch_topk`` spans)."""

from perfbench.layer_metrics.program_spans import per_call


def read(rec):
    return per_call("h2d_bytes", "neurec.serve.h2d", "neurec.batch_topk")
