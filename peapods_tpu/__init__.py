"""peapods_tpu — JAX Monte Carlo engine for Ising spin systems.

A JAX/XLA rebuild of the capabilities of PeaBrane/peapods
(reference at /root/reference): Metropolis/Gibbs sweeps, Swendsen-Wang/Wolff
cluster updates, parallel tempering, replica-overlap cluster moves
(Houdayer/Joerg/CMR), and the full overlap/diagnostic observable set — with
the whole sweep+cluster+PT loop fused into one jitted scan on device and
disorder realizations sharded across a chip mesh.
"""

from . import _cache  # noqa: F401  (XLA compilation cache side effect)
from .models.ising import Ising
from .sweep import run_sweep

__version__ = "0.1.0"
__all__ = ["Ising", "run_sweep"]
