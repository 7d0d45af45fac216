"""Device-mesh sharding of the simulation state.

Device-mesh replacement for the reference's process/thread parallelism
(SURVEY.md section 2.4): disorder realizations — rayon's ``par_iter_mut`` fan
-out in the reference (simulation/mod.rs:887-903) — become a sharded leading
batch axis of every state array, partitioned across chips with
``jax.sharding.NamedSharding``.  Realizations are independent between
measurements, so the fused sweep loop runs with **zero** cross-chip
communication; XLA inserts collectives only for host-bound reductions at
chunk boundaries.  A second optional mesh axis shards the systems
(replicas x temperatures) batch; the small cross-system gathers of the
overlap moves and parallel tempering ride XLA-inserted collectives over the
device interconnect.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "auto_mesh",
    "shard_state",
    "shard_runtime",
    "state_shardings",
]

_SCALAR_KEYS = ("counter", "warmup", "pt_parity")


def make_mesh(n_devices=None, axis_names=("disorder",), devices=None):
    """Build a mesh over the first ``n_devices`` devices (1D by default)."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[: int(n_devices)]
    if len(axis_names) == 1:
        return Mesh(np.array(devs), axis_names)
    # factor devices into a 2D grid: as many on the disorder axis as divide
    n = len(devs)
    d0 = int(np.floor(np.sqrt(n)))
    while n % d0:
        d0 -= 1
    return Mesh(np.array(devs).reshape(d0, n // d0), axis_names)


def auto_mesh(n_disorder):
    """Mesh over the wall-time-optimal device count for a disorder batch.

    The engine pads the disorder axis up to a multiple of the mesh's
    disorder extent (padded realizations compute but are dropped at host
    aggregation), so any device count works; wall time is set by
    ``rows = ceil(n_disorder / n_used)``.  The smallest device count that
    achieves the minimal ``rows`` is chosen — same wall time as using every
    device, minimal padding waste.  The reference fans any realization
    count over rayon workers (simulation/mod.rs:887-903); this is the
    fixed-shape SPMD equivalent.
    """
    devs = jax.devices()
    n = len(devs)
    if n <= 1 or n_disorder < 1:
        return None
    rows = -(-n_disorder // n)
    use = -(-n_disorder // rows)
    if use <= 1:
        return None
    return Mesh(np.array(devs[:use]), ("disorder",))


def state_shardings(mesh, state, shard_systems=False):
    """PartitionSpec tree for a SimState dict.

    Mesh axes used when present: ``disorder`` partitions the realization
    batch, ``systems`` (opt-in) the replica x temperature batch, and
    ``space`` the spin axis itself — contiguous row bands of the lattice
    (SURVEY.md section 5 "long-context analog"): the roll-based stencils and
    label propagation then compile to halo collective-permutes under XLA
    SPMD, no hand-written halo exchange needed.
    """
    names = mesh.axis_names
    dis = "disorder" if "disorder" in names else None
    sysx = "systems" if (shard_systems and "systems" in names) else None
    space = "space" if "space" in names else None

    def spec_for(key, v):
        if key in _SCALAR_KEYS:
            return NamedSharding(mesh, P())
        if key == "spins":
            return NamedSharding(mesh, P(dis, sysx, space))
        if key in ("pt_round_trips", "pt_trip_state"):
            return NamedSharding(mesh, P(dis, sysx))
        return NamedSharding(mesh, P(dis))

    return {k: spec_for(k, v) for k, v in state.items()}


def shard_state(state, mesh, shard_systems=False):
    """Place a SimState dict onto the mesh (disorder-major)."""
    specs = state_shardings(mesh, state, shard_systems)
    return {k: jax.device_put(v, specs[k]) for k, v in state.items()}


def shard_runtime(rt, mesh):
    """Shard the Runtime's per-disorder constants; replicate lattice tables."""
    names = mesh.axis_names
    dis = "disorder" if "disorder" in names else None
    space = "space" if "space" in names else None
    cspec = NamedSharding(mesh, P(dis, space, None))
    rspec = NamedSharding(mesh, P())
    rt.couplings = jax.device_put(rt.couplings, cspec)
    rt.coup_bwd = jax.device_put(rt.coup_bwd, cspec)
    rt.color_masks = jax.device_put(
        rt.color_masks, NamedSharding(mesh, P(None, space))
    )
    rt.temps = jax.device_put(rt.temps, rspec)
    return rt
