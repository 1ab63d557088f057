"""The sampler's share of a training step: the benchmark's span around
``Trainer.draw_epoch``, ended by a synchronize, over the epoch's steps
(epochs timed by the host, outside the profiler)."""


def read(rec):
    t = rec["untraced"]
    return 1e3 * t["draw_s"] / t["units"] if t.get("units") else None
