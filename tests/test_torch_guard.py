"""The PyTorch port stands alone: no jax, nothing of neurec_tpu, and no
silent CPU fallback at its entry points."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "neurec_tpu_torch")

_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.MULTILINE)


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_importing_every_module_loads_neither_jax_nor_neurec_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import neurec_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(neurec_tpu_torch.__path__, 'neurec_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'neurec_tpu' or m.startswith('neurec_tpu.'))\n"
        "need = {'neurec_tpu_torch.' + m for m in ('trainer', 'run', 'logging', 'ops.losses',"
        " 'ops.initializers', 'ops.sampling', 'data.padded', 'models.general.mf',"
        " 'models.general.ngcf', 'pretrain', 'benchmarks.dma_rate', 'checkpoint', 'profiling', 'utils',"
        " 'data.iterator', 'ops.metrics_host', 'ops.fast_topk', 'native', 'benchmarks.topk_ab')}\n"
        "print(len(names), bad, sorted(need - set(names)))\n"
        "sys.exit(1 if bad or need - set(names) or len(names) < 26 else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_static_scan_has_no_jax_or_reference_imports(path):
    with open(path) as fin:
        modules = _IMPORT.findall(fin.read())
    bad = [m for m in modules
           if m.split(".")[0] == "jax" or m.split(".")[0] == "neurec_tpu"]
    assert not bad, "%s imports %s" % (path, bad)


def test_entry_points_raise_without_cuda(monkeypatch):
    from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
    from neurec_tpu_torch.eval import Evaluator
    from neurec_tpu_torch.models import get_model
    from neurec_tpu_torch.ops import _build
    from neurec_tpu_torch.recommend import batch_topk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = random_dataset(num_users=20, num_items=30, seed=0)
    conf = DictConfig({"embed_size": 4, "n_layers": 1})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("LightGCN")(ds, conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator.from_dataset(ds, conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _build.load("masked_scores")
    model = get_model("LightGCN")(ds, conf, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_topk(model, params, 5)
    # asked for the CPU, they run there
    items, _ = batch_topk(model, params, 5, users=np.arange(3), device="cpu")
    assert items.shape == (3, 5)
    assert _build.load("masked_scores", "cpu") is None


def _write_ui(path, seed=0, n_users=40, n_items=60):
    rng = np.random.RandomState(seed)
    lines = ["%d,%d" % (u, i) for u in range(n_users)
             for i in rng.choice(n_items, rng.randint(3, 12), replace=False)]
    path.write_text("\n".join(lines) + "\n")


def test_training_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    from neurec_tpu_torch import run
    from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
    from neurec_tpu_torch.models import get_model
    from neurec_tpu_torch.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)  # the run logger writes under ./log
    ds = random_dataset(num_users=20, num_items=30, seed=0)
    conf = DictConfig({"recommender": "MF", "embedding_size": 4, "batch_size": 16, "epochs": 1,
                       "topk": [5], "metric": ["Recall"]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("MF")(ds, conf)
    model = get_model("MF")(ds, conf, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, ds, conf)
    trainer = Trainer(model, ds, conf, device="cpu")
    assert len(trainer.train().split("\t")) == 1

    (tmp_path / "data").mkdir()
    _write_ui(tmp_path / "data" / "syn.rating")
    args = ["--recommender=MF", "--config_dir=%s" % os.path.join(REPO, "conf"),
            "--data.input.path=%s" % (tmp_path / "data"), "--data.cache.path=%s" % (tmp_path / "cache"),
            "--data.input.dataset=syn", "--data.column.format=UI", "--data.convert.separator=','",
            "--epochs=2", "--embedding_size=4", "--batch_size=64", "--topk=[5]", "--metric=[\"Recall\"]"]
    props = os.path.join(REPO, "NeuRec.properties")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(props, args)
    trainer, result = run.main(props, args, device="cpu")
    assert trainer.device.type == "cpu" and len(result.split("\t")) == 1
    assert list((tmp_path / "log" / "syn" / "MF").glob("*.log.metrics.jsonl"))
    # --ckpt_dir: a checkpoint each epoch, and the same command resumes
    ck = ["--ckpt_dir=%s" % (tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(props, args + ck)
    assert not (tmp_path / "ck").exists()
    trainer, result = run.main(props, args + ck, device="cpu")
    assert trainer._ckpt.all_epochs() == [1, 2] and trainer._start_epoch == 1
    longer = [a for a in args if not a.startswith("--epochs=")] + ["--epochs=3"]
    trainer, result = run.main(props, longer + ck, device="cpu")
    assert trainer._start_epoch == 3 and trainer._ckpt.all_epochs() == [1, 2, 3]
    assert len(result.split("\t")) == 1
