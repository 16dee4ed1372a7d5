"""Mesh construction and sharding rules.

The reference's only parallelism is one LangGraph thread per room over HTTP
(reference: src/app/api/rooms/create/route.ts:16-26, SURVEY.md §2.5). Here
rooms are the leading axis of every state array and shard over the 'data'
mesh axis (environment data-parallelism); the learned policy's hidden layers
shard over 'model' (tensor parallelism). GSPMD/pjit inserts the collectives
(gradient psum over 'data', activation all-gather/reduce-scatter over
'model'), which XLA hands to NCCL on GPUs; across hosts the same program
runs under jax.distributed. The cards of one host are joined all to all,
so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from game_engine_tpu.core.state import GameState


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """('data', 'model') mesh over the first n_devices devices.

    model_parallel must divide n_devices; data = n_devices // model_parallel.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    assert n <= len(devs), f"requested {n} devices, have {len(devs)}"
    assert n % model_parallel == 0
    grid = np.array(devs[:n]).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, axis_names=("data", "model"))


def state_sharding(mesh: Mesh, state: GameState) -> GameState:
    """Shard every state array over rooms (axis 0) on 'data'."""
    def spec(x):
        return NamedSharding(mesh, P("data", *([None] * (x.ndim - 1))))

    return jax.tree_util.tree_map(lambda x: jax.device_put(x, spec(x)), state)


def params_sharding(mesh: Mesh, params: dict) -> dict:
    """Tensor-parallel policy params: alternate sharding the hidden dim —
    even layers split the output features, odd layers the input features
    (Megatron-style column/row split); heads and biases replicate."""
    out = {}
    for k, v in params.items():
        if k.startswith("w") and k[1:].isdigit() and v.ndim == 2:
            i = int(k[1:])
            spec = P(None, "model") if i % 2 == 0 else P("model", None)
        elif k.startswith("b") and k[1:].isdigit():
            i = int(k[1:])
            spec = P("model") if i % 2 == 0 else P(None)
        else:
            spec = P(*([None] * v.ndim))
        out[k] = jax.device_put(v, NamedSharding(mesh, spec))
    return out


def replicate(mesh: Mesh, tree):
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh, P(*([None] * getattr(x, "ndim", 0))))
        ),
        tree,
    )


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Multi-host initialization for meshes larger than one host.

    Call once per process before any jax op; afterwards jax.devices() spans
    every host and the same pjit programs shard within and across hosts
    (SURVEY.md §2.5 'distributed communication backend' row). With one
    process this is a no-op. Returns process count.
    """
    if num_processes is None or num_processes <= 1:
        return 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count()


def psum_metrics(metrics: dict, mesh: Mesh) -> dict:
    """Cross-chip metric reduction for logging (already handled inside jit
    by GSPMD for sharded reductions; this is for explicit host-side sums)."""
    return jax.tree_util.tree_map(lambda x: jax.device_get(x).sum(), metrics)
