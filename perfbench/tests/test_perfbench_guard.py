"""Nothing a run loads may be JAX or the JAX package: the check every run
makes, and the harness's modules imported in a fresh process."""

import glob
import os
import subprocess
import sys

from perfbench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_names_are_compared_whole(monkeypatch):
    for name in ("neurec_tpu_torch", "neurec_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(harness.forbidden_modules()) & {"neurec_tpu_torch", "jaxtyping", "flaxen"}
    for name in ("jax", "neurec_tpu.ops.graph", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"jax", "neurec_tpu", "flax"} <= set(harness.forbidden_modules())


def test_the_harness_loads_no_jax():
    readers = sorted(glob.glob(os.path.join(BENCH, "layer_metrics", "*.py")))
    code = "\n".join([
        "import sys, importlib, importlib.util",
        "sys.path.insert(0, %r)" % os.path.dirname(BENCH),
        "from perfbench import harness, calibrate, program, tracing, counts, data",
        "from perfbench.jobs import train, eval, serve",
        "from perfbench.reference import common, lightgcn, ngcf",
        "from perfbench.counts import lightgcn as c1, ngcf as c2",
        "import neurec_tpu_torch.trainer, neurec_tpu_torch.recommend, neurec_tpu_torch.eval",
        "for p in %r:" % readers,
        "    s = importlib.util.spec_from_file_location('m', p); m = importlib.util.module_from_spec(s)",
        "    s.loader.exec_module(m)",
        "print(','.join(harness.forbidden_modules()))",
    ])
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
