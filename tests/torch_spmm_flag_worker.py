"""A rank's case for ``tests/test_torch_spmm_pallas_flag.py``: the sharded
SpMM under ``NEUREC_SPMM_PALLAS``, run in a gloo world by
``torch_mesh_worker.run_world``. It lives in an importable module without
jax, as the world's cases must."""

import os
from typing import Optional

import numpy as np
import torch

from tests.torch_mesh_worker import make_trainer


def sharded_flag_case(mesh, flag: Optional[str], seed: int = 5) -> dict:
    """LightGCN's adjacency sharded over 'data' (with its block plans),
    ``spmm_sharded`` on seeded x and d/dx of sum((A @ x) * W) with
    ``NEUREC_SPMM_PALLAS`` set to ``flag`` (None: unset); the plan calls
    of the forward and the backward counted; the gradient summed over
    'data' as the trainer sums it."""
    from neurec_tpu_torch.ops import spmm as spmm_ops
    from neurec_tpu_torch.ops.graph import maybe_shard, spmm_sharded
    from neurec_tpu_torch.parallel.mesh import all_sum

    adj = make_trainer("LightGCN", None).model.adj
    sharded = maybe_shard(adj, mesh, "on")
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((adj.n_nodes, 8)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((adj.n_nodes, 8)).astype(np.float32))
    calls = []
    real = spmm_ops.plan_spmm

    def counting(plan, x_in):
        calls.append(plan.transposed)
        return real(plan, x_in)

    saved = os.environ.get("NEUREC_SPMM_PALLAS")
    spmm_ops.plan_spmm = counting
    try:
        if flag is None:
            os.environ.pop("NEUREC_SPMM_PALLAS", None)
        else:
            os.environ["NEUREC_SPMM_PALLAS"] = flag
        out = spmm_sharded(sharded, x)
        n, d = mesh.shape["data"], mesh.coordinate["data"]
        rows = slice(d * sharded.block, (d + 1) * sharded.block)
        (out[rows] * w[rows]).sum().backward()
    finally:
        spmm_ops.plan_spmm = real
        if saved is None:
            os.environ.pop("NEUREC_SPMM_PALLAS", None)
        else:
            os.environ["NEUREC_SPMM_PALLAS"] = saved
    return {"out": out.detach().numpy(), "grad": all_sum(x.grad, mesh, "data").numpy(), "calls": calls,
            "has_plans": sharded.plan is not None}
