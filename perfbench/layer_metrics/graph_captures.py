"""CUDA graphs captured a call in the traced window: the ``captured``
attribute of the program's top spans of a call (``neurec.run_epoch``,
``neurec.evaluate``, ``neurec.batch_topk``; a cell makes one kind of
call) over their number. A warm program replays, so it reads 0; a change
that recaptures in steady state shows here."""

from perfbench.layer_metrics.program_spans import per_call

CALLS = ("neurec.run_epoch", "neurec.evaluate", "neurec.batch_topk")


def read(rec):
    return per_call("captured", CALLS)
