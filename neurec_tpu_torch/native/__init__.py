"""ctypes bindings for the native host tier (port of ``neurec_tpu/native``).

``neurec_native.cpp`` in this directory is the port's own copy of the JAX
package's C++ source. It is built with g++ on first use (``build``), never at
import, into ``build/neurec_tpu_torch/`` beside the package (git-ignored),
as ``neurec_native-<hash>.so``: the hash covers the source and the flags, so
an edited source is rebuilt and an unchanged one reused. The compiler writes
a per-process temporary file that is renamed into place, so two processes
building at once never load half a library. A failed build raises; nothing
is written into the package's directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from neurec_tpu_torch.ops._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "neurec_native.cpp")
GXX = "g++"
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

METRIC_CODES = {"Precision": 1, "Recall": 2, "MAP": 3, "NDCG": 4, "MRR": 5}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as fin:
        digest.update(fin.read())
    return os.path.join(BUILD_DIR, "neurec_native-%s.so" % digest.hexdigest()[:16])


def build(force: bool = False) -> str:
    """Compile the library if it is missing (or ``force``); returns its path.
    Raises ``RuntimeError`` when the compiler is missing or fails."""
    out = library_path()
    if force or not os.path.isfile(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (out, os.getpid())
        try:
            proc = subprocess.run([GXX, *GXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("native host tier build failed (%s, exit %d):\n%s"
                                   % (GXX, proc.returncode, proc.stdout + proc.stderr))
            os.replace(tmp, out)
        except OSError as e:  # the compiler is missing
            raise RuntimeError("native host tier build failed: %s" % e) from e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.eval_score_matrix.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ]
            lib.batch_randint_choice.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_int),
            ]
            lib.arg_topk.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ]
            for fn in (lib.eval_score_matrix, lib.batch_randint_choice, lib.arg_topk):
                fn.restype = None
            _lib = lib
    return _lib


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _flat(lists: Sequence[Sequence[int]]):
    """CSR form of ``lists``: (flat int32 values, (n + 1,) int32 offsets)."""
    flat = np.concatenate([np.asarray(t, np.int32) for t in lists]) if lists else np.zeros(0, np.int32)
    offsets = np.zeros(len(lists) + 1, dtype=np.int32)
    np.cumsum([len(t) for t in lists], out=offsets[1:])
    return np.ascontiguousarray(flat, dtype=np.int32), offsets


def eval_score_matrix(
    scores: np.ndarray,
    truth_lists: Sequence[Sequence[int]],
    metrics: Sequence[str],
    top_k: int,
    n_threads: int = 8,
) -> np.ndarray:
    """(B, n_metrics * top_k) per-user cumulative metric vectors of the rows
    of ``scores`` ranked on ``n_threads`` threads (NaN last, the lowest
    index first among ties)."""
    lib = _load()
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    B, num_items = scores.shape
    flat, offsets = _flat(truth_lists)
    codes = np.asarray([METRIC_CODES[m] for m in metrics], dtype=np.int32)
    out = np.zeros((B, len(metrics) * top_k), dtype=np.float32)
    lib.eval_score_matrix(
        _fptr(scores), B, num_items, _iptr(flat), _iptr(offsets),
        _iptr(codes), len(metrics), top_k, n_threads, _fptr(out),
    )
    return out


def batch_randint_choice(
    high: int,
    counts: Sequence[int],
    exclusion: Sequence[Sequence[int]],
    seed: int = 0,
) -> List[np.ndarray]:
    """Per-user uniform draws in [0, high) excluding each exclusion set
    (``std::mt19937_64`` seeded with ``seed``).

    Validation mirrors the reference Cython sampler
    (util/cython/random_choice.pyx:24-82): a counts/exclusion length
    mismatch otherwise reads past the offsets array in the C++, and an
    exclusion covering [0, high) spins the rejection loop forever.
    """
    lib = _load()
    if len(counts) != len(exclusion):
        raise ValueError(
            "The shape of 'exclusion' is not compatible with the shape "
            "of 'size'!"
        )
    for e in exclusion:
        if high <= len(e):  # reference's conservative raw-length check
            raise ValueError(
                "The number of 'exclusion' is greater than 'high'."
            )
    counts_a = np.ascontiguousarray(counts, dtype=np.int32)
    flat, offsets = _flat(exclusion)
    out = np.zeros(int(counts_a.sum()), dtype=np.int32)
    lib.batch_randint_choice(
        high, _iptr(counts_a), len(counts_a), _iptr(flat), _iptr(offsets),
        seed, _iptr(out),
    )
    return list(np.split(out, np.cumsum(counts_a)[:-1]))


def arg_topk(scores: np.ndarray, k: int, n_threads: int = 8) -> np.ndarray:
    """(B, k) top-k indices per row, NaN last, ties broken by lower index;
    -1 past the row's length."""
    lib = _load()
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    B, num_items = scores.shape
    out = np.zeros((B, k), dtype=np.int32)
    lib.arg_topk(_fptr(scores), B, num_items, k, n_threads, _iptr(out))
    return out
