"""Single-spin-flip sweeps as vectorized multicolor (checkerboard) updates.

Data-parallel counterpart of the reference's sequential site sweeps
(``/root/reference/spin-sim/src/mcmc/sweep.rs:34-284``).  The acceptance rule
is identical — flip site ``i`` iff ``-s_i * h_i >= threshold(T, u)`` with

* Metropolis: ``threshold = (T/2) * ln(u)``        (sweep.rs:256)
* Gibbs:      ``threshold = (T/2) * ln(u/(1-u))``  (sweep.rs:279-282)

where ``h_i`` is the local field from all ``2 * n_neighbors`` bonds
(sweep.rs:8-19).  The difference is the site schedule: the reference visits
sites sequentially; here all sites of one color (an independent set of the
bond graph) update simultaneously, and one sweep makes one pass over every
color.  Trajectories differ from the reference, so parity is statistical
(Binder crossings / tau scaling), not bitwise.

**Lazy Metropolis (correctness-critical).**  Fully synchronous Metropolis on
an independent set is NOT ergodic: moves with ``dH <= 0`` are accepted with
probability exactly 1, and those deterministic lockstep flips create invariant
limit cycles (verified against exact 4-site transition matrices: the
eps=0 chain has a second unit-modulus eigenvalue and a biased reachable
stationary state).  We therefore scale every acceptance probability by
``1 - eps`` — still a valid Metropolis-Hastings acceptance (the ratio
``a(x,y)/a(y,x)`` is unchanged), which makes every per-site kernel strictly
lazy, restoring irreducibility and aperiodicity, with the exact Boltzmann
stationary distribution for any ``eps > 0``::

    p_flip = (1 - eps) * min(1, exp(2 * eng_change / T)),   flip iff u < p_flip

The ``(1-eps)`` factor must multiply *after* the min — ``min(1, (1-eps) r)``
is still 1 for strongly favorable moves (keeping the deterministic lockstep
cycles alive) and has ``a(x,y)/a(y,x) != r``, breaking detailed balance.
Gibbs probabilities are strictly inside (0, 1) already and need no laziness.

All functions operate on a single disorder realization with a batched systems
axis; the engine vmaps over disorder.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

__all__ = ["local_fields", "mc_sweep", "METROPOLIS_LAZINESS"]

# Acceptance-probability scale 1-eps for the lazy synchronous Metropolis
# kernel (see module docstring).  Any eps > 0 is exact; 1/16 gives a
# comfortable spectral gap on small lattices while costing ~6% of flips.
METROPOLIS_LAZINESS = 1.0 / 16.0


def local_fields(spins_f, geom, coup_fwd, coup_bwd):
    """Local field ``h_i`` for all sites of all systems, via rolls.

    Args:
        spins_f: ``f32 [n_systems, n_spins]`` spin values (+-1).
        geom: :class:`~peapods_tpu.ops.geometry.GridOps`.
        coup_fwd: ``f32 [n_spins, n_neighbors]`` forward couplings ``J[i, d]``.
        coup_bwd: ``f32 [n_spins, n_neighbors]`` backward couplings
            ``J[bwd[i, d], d]`` (couplings own forward bonds; reference
            sweep.rs:14-17).

    Returns:
        ``f32 [n_systems, n_spins]``.
    """
    h = jnp.zeros_like(spins_f)
    for d in range(geom.n_neighbors):
        h += geom.shift_fwd(spins_f, d) * coup_fwd[:, d]
        h += geom.shift_bwd(spins_f, d) * coup_bwd[:, d]
    return h


def mc_sweep(
    spins,
    coup_fwd,
    coup_bwd,
    geom,
    color_masks,
    sys_temps,
    key,
    *,
    gibbs: bool,
    uniforms=None,
):
    """One full multicolor sweep over all systems.

    Args:
        spins: ``int8 [n_systems, n_spins]``.
        color_masks: ``bool [n_colors, n_spins]``; colors form independent
            sets of the bond graph.
        sys_temps: ``f32 [n_systems]`` temperature of each *system* (resolved
            from the parallel-tempering permutation by the caller).
        key: per-(realization, sweep) PRNG key.
        gibbs: Gibbs threshold instead of Metropolis.
        uniforms: optional ``[n_colors, n_systems, n_spins]`` acceptance
            uniforms, used by the tests against the numpy reference sweep
            (``tests/reference_np.py``).

    Returns:
        Updated ``int8 [n_systems, n_spins]`` spins.
    """
    n_colors = color_masks.shape[0]
    half_t = (sys_temps * 0.5)[:, None]
    inv_half_t = (1.0 / (sys_temps * 0.5))[:, None]
    keep = np.float32(1.0 - METROPOLIS_LAZINESS)

    for c in range(n_colors):
        if uniforms is None:
            ck = jax.random.fold_in(key, c)
            u = jax.random.uniform(ck, spins.shape, dtype=jnp.float32)
        else:
            u = uniforms[c]  # [n_systems, n_spins], for kernel-equivalence tests
        s = spins.astype(jnp.float32)
        h = local_fields(s, geom, coup_fwd, coup_bwd)
        eng_change = -s * h
        if gibbs:
            flip = eng_change >= half_t * jnp.log(u / (1.0 - u))
        else:
            p = keep * jnp.exp(jnp.minimum(eng_change * inv_half_t, 0.0))
            flip = u < p
        flip &= color_masks[c][None, :]
        spins = jnp.where(flip, -spins, spins)
    return spins
