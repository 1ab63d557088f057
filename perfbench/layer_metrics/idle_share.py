"""The device's idle share: one minus the union of its operations'
intervals over the traced window."""


def read(rec):
    t = rec["traced"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] > 0 else None
