"""Kernel loader: builds ``csrc/*.cu`` with nvcc at first use, loads with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (``nvcc -shared``, no PyTorch headers, so a build takes seconds
rather than minutes), all sources at once in parallel, into
``build/neurec_tpu_torch/`` beside the package (git-ignored). A library's
file name carries a hash of its source, the headers under ``csrc/`` and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. Wrappers pass raw pointers and PyTorch's current stream; each C
entry point returns the launch's ``cudaGetLastError()`` code.

``LAUNCHES`` counts kernel launches per kernel: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels its
path went through. A CUDA graph's replay calls no wrapper: the graph runner
(``step_graph.py``) takes the counts' change while it captures
(``captured_launches``), puts the counts back (a capture runs nothing), and
adds that change once a replay (``add_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

from neurec_tpu_torch.device import DeviceLike, resolve_device

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "neurec_tpu_torch")

# kernel name -> source file under csrc/
SOURCES = {
    "masked_scores": "masked_scores.cu",
    "plan_spmm": "plan_spmm.cu",
    "plan_spmm_packed": "plan_spmm_packed.cu",
    "dma_rate": "dma_rate.cu",
}

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler=-fPIC",
]

# one count per kernel: the SpMM kernels' launches over a transposed plan
# (the backward of A @ x) apart from their forward ones, the probe's by mode
LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "masked_scores", "plan_spmm", "plan_spmm_t", "plan_spmm_packed", "plan_spmm_packed_t",
    "dma_rate_serial", "dma_rate_pipelined", "round_tf32", "fma_chain",
)}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph's capture: yields a dict that holds, at exit,
    each count's change during the capture, and puts the counts back as
    they were before it."""
    before = dict(LAUNCHES)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        delta.update({k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]})
        LAUNCHES.update(before)


def add_launches(delta: Dict[str, int]) -> None:
    """Add a captured graph's launches (``captured_launches``): one replay."""
    for name, n in delta.items():
        LAUNCHES[name] += n


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(name: str) -> str:
    """The library's path, named by a hash of its source, the flags and
    every header under ``csrc/`` (a source may include any of them)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [SOURCES[name]] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as fin:
            digest.update(fin.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, digest.hexdigest()[:16]))


def build_all() -> Dict[str, str]:
    """Compile every missing kernel library, one nvcc per source, all
    started together. Returns ``{name: nvcc output}`` for what was built
    (the ``-Xptxas=-v`` register and shared-memory report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in SOURCES:
        out = _library_path(name)
        if os.path.isfile(out):
            continue
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s:\n%s" % (name, text))
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        reports[name] = text
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return reports


def load(name: str, device: DeviceLike = None) -> Optional[ctypes.CDLL]:
    """The loaded library of kernel ``name``, built first if needed.

    ``device`` follows the port's rule (``None`` = cuda, raises without a
    CUDA device); for the CPU there is nothing to load and it returns None.
    """
    if resolve_device(device).type == "cpu":
        return None
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not os.path.isfile(path):
                build_all()
            lib = ctypes.CDLL(path)
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if code != 0:
        lib.neurec_error_string.restype = ctypes.c_char_p
        lib.neurec_error_string.argtypes = [ctypes.c_int]
        msg = lib.neurec_error_string(code).decode()
        raise RuntimeError("%s kernel launch failed: cuda error %d (%s)" % (what, code, msg))
