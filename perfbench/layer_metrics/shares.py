"""A kernel family's share of its roofline from a trace run's record: the
least time its launches could take (each launch's bound,
``perfbench/counts``) over their device time in the traced window;
nothing to read where the family did not run."""


def family_share(rec, family: str, bound_key: str):
    t = rec["traced"]
    n, busy = t["family_launches"].get(family, 0), t["family_s"].get(family, 0.0)
    if not n or busy <= 0:
        return None
    return 100.0 * n * rec["bounds"][bound_key] / busy
