"""The model step's device time: the profiler's device operations that
start inside the ``run`` spans (``Trainer.run_epoch``: the kept graphs'
replays), over the steps traced."""


def read(rec):
    t = rec["traced"]
    return 1e3 * t["run_device_s"] / t["units"] if t.get("units") and t["run_device_s"] > 0 else None
