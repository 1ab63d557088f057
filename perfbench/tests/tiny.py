"""A benchmark root at a size a CPU test can hold: the real manifest's
cells over a small seeded rating file, with the real traffic mixes,
limits and readers cut to it. Each file is written as the real one is
found, so a run of it goes through every step the card's does."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# small enough for the CPU, large enough that every batch holds real rows
SIZES = {"users": 96, "items": 160, "min_per_user": 5, "max_per_user": 30}
HYPER = {"batch_size": 64, "test_batch_size": 32}
TRAFFIC = {"pool_requests": 6, "request_users": 40, "batch_size": 16, "checked_requests": 3}


def rating_file(path: str, seed: int = 0) -> None:
    rng = np.random.RandomState(seed)
    lines = []
    for u in range(SIZES["users"]):
        n = rng.randint(SIZES["min_per_user"], SIZES["max_per_user"] + 1)
        for i in rng.choice(SIZES["items"], n, replace=False):
            lines.append("%d,%d" % (u * 3 + 1, i * 7 + 2))  # raw ids with gaps, as a real file's
    with open(path, "w") as fout:
        fout.write("\n".join(lines) + "\n")


def make_root(path: str) -> str:
    """A benchmark root under ``path``: ``BENCHMARK.json`` and the
    ``perfbench`` data folders, the configurations over a tiny file."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fin:
        manifest = json.load(fin)
    os.makedirs(os.path.join(path, "dataset"), exist_ok=True)
    rating_file(os.path.join(path, "dataset", "tiny.rating"))
    for sub in ("configs", "traffic", "limits", "layer_metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(path, "perfbench", sub), dirs_exist_ok=True)
    for c in manifest["configs"]:
        p = os.path.join(path, c["file"])
        with open(p) as fin:
            cfg = json.load(fin)
        cfg["data"]["file"] = "dataset/tiny.rating"
        cfg["hyper"].update(HYPER)
        with open(p, "w") as fout:
            json.dump(cfg, fout)
    for name in os.listdir(os.path.join(path, "perfbench", "traffic")):
        p = os.path.join(path, "perfbench", "traffic", name)
        with open(p) as fin:
            t = json.load(fin)
        t.update({k: v for k, v in TRAFFIC.items() if k in t})
        with open(p, "w") as fout:
            json.dump(t, fout)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as fout:
        json.dump(manifest, fout)
    return path
