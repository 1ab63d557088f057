"""The program's own spans (``neurec_tpu_torch.profiling``), as a trace
run leaves them in the process: the program records them while a
profiler runs, so the store holds the traced window's (each window the
launch check opened, every ratio normalised by counts from the same
spans). A program that keeps no span store reads as empty, and each
reader then finds nothing."""


def spans() -> list:
    """The closed spans in the program's store ([] where it has none)."""
    from neurec_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    return [s for s in read() if s.end_ns is not None] if callable(read) else []


def _named(found: list, names) -> list:
    names = (names,) if isinstance(names, str) else names
    return [s for s in found if s.name in names]


def per_call(key: str, names, calls=None):
    """The sum of ``key`` over the spans named in ``names`` (a name or a
    tuple of names), over the number of spans named in ``calls``
    (``names`` by default); ``key`` is an attribute, or ``"ms"``, a span's
    host milliseconds. None where there are no such calls."""
    found = spans()
    n = len(_named(found, names if calls is None else calls))
    if not n:
        return None
    return sum(1e3 * s.seconds if key == "ms" else s.attrs.get(key, 0) for s in _named(found, names)) / n
