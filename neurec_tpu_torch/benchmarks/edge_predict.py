"""NAIS's and DeepICF's ``predict`` over one batch's train edges, kernel by
kernel, on the card.

    python -m neurec_tpu_torch.benchmarks.edge_predict [--batch 2048] [--seed 2024] [--out FILE]

On gowalla's split (``dataset/gowalla.rating``, ratio 0.8, as
``chip_smoke.py`` makes it) at each model's ``conf/*.properties`` widths
with weights drawn from the seed: the evaluator's batches of the test
users, the real users' train pairs of each batch and the capacity
``predict_capacity`` gives the batch set; then, on the batch with the most
pairs, one ``predict`` call's wall seconds (after two warm-up calls) and,
under ``torch.profiler``, its device ms and the kernels that take the
most of it (name, ms, launches). Prints one JSON object with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from neurec_tpu_torch.benchmarks.k1_widths import card

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA_ARGS = [
    "--config_dir=%s" % os.path.join(REPO, "conf"),
    "--data.input.path=%s" % os.path.join(REPO, "dataset"),
    "--data.cache.path=%s" % os.path.join(REPO, "dataset"),
    "--data.input.dataset=gowalla", "--data.column.format=UI", "--data.convert.separator=','",
    "--splitter=ratio", "--ratio=0.8", "--by_time=False", "--topk=[20]",
]
TOP_KERNELS = 8


def profile_batch(name: str, batch: int, seed: int, dataset=None):
    """The record of one model (above) and the dataset it loaded."""
    from torch.autograd import DeviceType

    from neurec_tpu_torch.config import Config
    from neurec_tpu_torch.data.dataset import Dataset
    from neurec_tpu_torch.eval import Evaluator
    from neurec_tpu_torch.models import get_model

    conf = Config(os.path.join(REPO, "NeuRec.properties"),
                  cmd_args=["--recommender=%s" % name, "--test_batch_size=%d" % batch] + DATA_ARGS)
    dataset = dataset or Dataset(conf)
    model = get_model(name)(dataset, conf)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    ev = Evaluator.from_dataset(dataset, conf).evaluator
    users_b, _, valid_b = ev._make_batches(ev.test_users, np.arange(len(ev.test_users)))
    edges = (model._lens_host[users_b.cpu().numpy()] * valid_b.cpu().numpy()).sum(axis=1)
    capacity = model.predict_capacity(users_b.cpu().numpy(), valid_b.cpu().numpy())
    users = users_b[int(edges.argmax())]

    def call():
        return model.predict(params, users, capacity=capacity)

    with torch.no_grad():
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return {"model": name, "batch": batch, "capacity": capacity, "real_edges_per_batch": edges.astype(int).tolist(),
            "wall_s": wall_s, "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "top_kernels": [{"name": e.key[:120], "ms": e.self_device_time_total / 1e3, "count": e.count}
                            for e in kernels[:TOP_KERNELS]]}, dataset


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("edge_predict profiles NAIS's and DeepICF's predict on a CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products, as the evaluation runs them
    records, dataset = [], None
    for name in ("NAIS", "DeepICF"):
        rec, dataset = profile_batch(name, args.batch, args.seed, dataset)
        records.append(rec)
    out = {"card": card(), "records": records}
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
