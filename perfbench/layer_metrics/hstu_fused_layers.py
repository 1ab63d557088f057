"""HSTU's (batch, layer) passes a call that ran the two fused layer
kernels (``csrc/hstu_layer.cu``): the ``fused_layers`` attribute of the
``neurec.hstu.attn`` spans (one an evaluation call, recorded on the host
by the model's ``on_evaluate`` hook from the launches of
``hstu_layer_in`` the evaluator counted over the call) over their
number. A program whose
span has no such attribute (one without the kernels) reads 0."""

from perfbench.layer_metrics.program_spans import per_call


def read(rec):
    return per_call("fused_layers", "neurec.hstu.attn")
