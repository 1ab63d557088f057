"""The serving job's host time a request: its wall time (requests timed
by the host, outside the profiler) less its device busy time (the traced
window's, a request)."""


def read(rec):
    t, tr = rec["untraced"], rec["traced"]
    if not t.get("units") or not tr.get("units"):
        return None
    return 1e3 * (t["wall_s"] / t["units"] - tr["busy_s"] / tr["units"])
