"""Multi-chip scale-out — legs sharded over a device mesh.

The reference scales by running more ticker threads on more cores (one per
stream, src/base/msticker.c); its "cluster story" is N independent
processes.  The batched story (SURVEY.md §2.8/§7): call legs are **pure
data parallelism** — shard the batch dimension across chips with
``jax.sharding`` and let XLA insert collectives only where legs genuinely
interact (conference segment-sums whose groups span shards ride the ICI).
No hot-path collectives otherwise; control plane (RTP, adds/removes) stays
host-side.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

LEGS_AXIS = "legs"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (LEGS_AXIS,))


def leg_sharding(mesh: Mesh, batch: int):
    """Tree-mapper: shard leading dim over legs when it equals batch,
    replicate everything else (matrices, scalars, rng keys)."""
    shard = NamedSharding(mesh, P(LEGS_AXIS))
    repl = NamedSharding(mesh, P())

    def spec_of(x):
        if hasattr(x, "shape") and getattr(x, "ndim", 0) >= 1 and x.shape[0] == batch:
            return shard
        return repl
    return spec_of


def shard_tree(tree: Any, mesh: Mesh, batch: int) -> Any:
    spec = leg_sharding(mesh, batch)
    return jax.tree.map(lambda x: jax.device_put(x, spec(x)), tree)


def sharded_step(cg, mesh: Mesh):
    """jit the CompiledGraph.step with leg-sharded in/out shardings.

    Conference mixing across shards compiles to XLA collectives
    automatically — nothing in the graph code changes.
    """
    step = jax.jit(cg.step)

    def run(state, params, ext_in=None):
        state = shard_tree(state, mesh, cg.batch)
        params = shard_tree(params, mesh, cg.batch)
        if ext_in:
            ext_in = shard_tree(ext_in, mesh, cg.batch)
        return step(state, params, ext_in or {})
    return run
