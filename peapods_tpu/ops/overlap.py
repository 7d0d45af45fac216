"""Replica-overlap cluster moves: Houdayer(N), Joerg, CMR.

Data-parallel counterpart of the reference's ``spin-sim/src/clusters/overlap.rs``.
The reference fans (temperature x replica-group) tasks out over rayon threads;
here every task is one element of a vmapped batch: replicas at each
temperature are shuffled on-device, grouped, their spin configurations
gathered into a ``[n_tasks, group_size, n_spins]`` tensor, transformed by one
of the three pure per-task kernels below, and scattered back (groups partition
the systems, so the scatter is disjoint).

Per-task rules (with T the task's temperature, J the couplings):

* **Houdayer(N)** (overlap.rs:146-339): active site iff the spin sum over the
  N grouped replicas is 0; deterministic bonds between adjacent active sites;
  flip the cluster in all N replicas.  Wolff seeds from 64 random probes of
  the active set; SW flips each non-singleton cluster with p=1/2.
* **Joerg** (overlap.rs:341-553): active iff sigma_i != tau_i; stochastic
  bonds on satisfied active edges with ``p = 1 - exp(-4 J s^a_i s^a_j / T)``;
  flip both replicas.
* **CMR** (overlap.rs:555-971): phase 1 builds *blue* bonds on doubly
  satisfied edges with ``p = 1 - r^2`` (``r = exp(-2|J|/T)``) and flips blue
  clusters jointly (Wolff: the random seed's cluster, always; SW: each
  non-singleton with p=1/2).  Phase 2 extends with *red* bonds on singly
  satisfied edges (evaluated post-flip; the classification is invariant under
  the joint blue flip, overlap.rs:564-569) with ``p = 1 - r``; grey = blue
  plus red clusters flip with k in {1..3} (Wolff) / {0..3} (SW, non-singleton)
  choosing which replica(s) flip.

Statistics (CSD, top-4, graph observations) are measured on the move's bond
graph — for CMR, on the *blue* graph (matching the reference's cmr_blue).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import cluster as cl

__all__ = [
    "build_tasks",
    "OverlapMoveOut",
    "houdayer_task",
    "jorg_task",
    "cmr_task",
    "houdayer_bonds",
    "houdayer_finish",
    "jorg_bonds",
    "jorg_finish",
    "cmr_blue_bonds",
    "cmr_mid",
    "cmr_finish",
]


def build_tasks(system_ids, key, group_size: int):
    """Shuffled per-temperature replica groups (overlap.rs:35-56).

    Args:
        system_ids: ``int32 [n_replicas, n_temps]`` PT permutation.
        group_size: replicas per task.

    Returns:
        ``int32 [n_temps, n_groups, group_size]`` system indices per task.
    """
    n_replicas, n_temps = system_ids.shape
    n_groups = n_replicas // group_size
    keys = jax.random.split(key, n_temps)
    shuffled = jax.vmap(jax.random.permutation)(keys, system_ids.T)
    return shuffled[:, : n_groups * group_size].reshape(
        n_temps, n_groups, group_size
    )


class OverlapMoveOut(NamedTuple):
    """Per-task outputs of one overlap move."""

    spins: jax.Array  # int8 [group_size, n_spins] post-move
    labels: jax.Array  # int32 [n_spins] final cluster ids (grey for CMR)
    blue_labels: jax.Array  # int32 [n_spins] CMR blue ids (== labels otherwise)
    counts: jax.Array  # int32 [n_spins] stats-graph component sizes
    csd: jax.Array  # int32 [n_spins + 1]
    obs: cl.GraphObservation


def _stats(active, labels, geom, with_winding, with_stats):
    """(counts, csd, obs) for the stats graph — or Nones when the caller
    collects nothing (cluster statistics are scatter-heavy and the move itself only needs labels; XLA does not reliably dead-code them
    through the engine's lax.cond event gating)."""
    if not with_stats:
        return None, None, None
    counts = cl.component_counts(labels)
    return (
        counts,
        cl.csd_histogram(counts),
        cl.graph_observation(active, counts, labels, geom, with_winding),
    )


def houdayer_bonds(tspins, key, geom):
    """Stage 1: deterministic bonds between balanced sites.

    Returns ``(bonds, aux)``; ``aux`` carries the active mask and the
    pre-split flip keys so :func:`houdayer_finish` draws exactly what the
    monolithic task would.
    """
    active = tspins.astype(jnp.int32).sum(0) == 0
    bonds = jnp.stack(
        [active & geom.shift_fwd(active, d) for d in range(geom.n_neighbors)],
        axis=-1,
    )
    k_seed, k_coin = jax.random.split(key)
    return bonds, (active, k_seed, k_coin)


def houdayer_finish(
    tspins, labels, bonds, aux, geom, *, wolff, update, with_winding,
    with_stats,
):
    """Stage 2: stats + cluster flip given the component labels."""
    active, k_seed, k_coin = aux
    counts, csd, obs = _stats(bonds, labels, geom, with_winding, with_stats)
    if wolff:
        seed, found = cl.find_seed(k_seed, active)
        flip = cl.wolff_flip_mask(labels, seed) & found
    else:
        flip = cl.cluster_coin_flip_mask(
            k_coin, labels, nonsingleton=cl.nonsingleton_mask(bonds, geom)
        )
    if update:
        tspins = jnp.where(flip[None, :], -tspins, tspins)
    return OverlapMoveOut(tspins, labels, labels, counts, csd, obs)


def houdayer_task(
    tspins, key, geom, *, wolff: bool, update: bool, with_winding: bool,
    with_stats: bool = True,
):
    """Houdayer(N) move on one (temperature, group) task.

    Args:
        tspins: ``int8 [group_size, n_spins]``.
        update: mutate spins (False = observe).
    """
    bonds, aux = houdayer_bonds(tspins, key, geom)
    labels = cl.connected_components(bonds, geom)
    return houdayer_finish(
        tspins, labels, bonds, aux, geom, wolff=wolff, update=update,
        with_winding=with_winding, with_stats=with_stats,
    )


def jorg_bonds(tspins, key, coup_fwd, temp, geom, u_bond=None):
    """Stage 1: stochastic pair bonds on satisfied unequal-overlap edges.

    ``u_bond`` injects the per-bond uniforms (kernel bitwise tests).
    """
    a, b = tspins[0], tspins[1]
    active = a != b
    k_bond, k_seed, k_coin = jax.random.split(key, 3)
    fk = cl.fk_bond_activation(
        a, coup_fwd, geom, temp, k_bond, factor=4.0, u=u_bond
    )
    active_pair = jnp.stack(
        [active & geom.shift_fwd(active, d) for d in range(geom.n_neighbors)],
        axis=-1,
    )
    return fk & active_pair, (active, k_seed, k_coin)


def jorg_finish(
    tspins, labels, bonds, aux, geom, *, wolff, update, with_winding,
    with_stats,
):
    active, k_seed, k_coin = aux
    counts, csd, obs = _stats(bonds, labels, geom, with_winding, with_stats)
    if wolff:
        seed, found = cl.find_seed(k_seed, active)
        flip = cl.wolff_flip_mask(labels, seed) & found
    else:
        flip = cl.cluster_coin_flip_mask(
            k_coin, labels, nonsingleton=cl.nonsingleton_mask(bonds, geom)
        )
    if update:
        tspins = jnp.where(flip[None, :], -tspins, tspins)
    return OverlapMoveOut(tspins, labels, labels, counts, csd, obs)


def jorg_task(
    tspins,
    key,
    coup_fwd,
    temp,
    geom,
    *,
    wolff: bool,
    update: bool,
    with_winding: bool,
    with_stats: bool = True,
):
    """Joerg stochastic overlap move on one pair task (``group_size == 2``)."""
    bonds, aux = jorg_bonds(tspins, key, coup_fwd, temp, geom)
    labels = cl.connected_components(bonds, geom)
    return jorg_finish(
        tspins, labels, bonds, aux, geom, wolff=wolff, update=update,
        with_winding=with_winding, with_stats=with_stats,
    )


def _cmr_satisfied(a, b, coup_fwd, geom):
    """(a_satisfied, b_satisfied) per forward bond."""
    af = a.astype(jnp.float32)
    bf = b.astype(jnp.float32)
    a_sat = jnp.stack(
        [af * geom.shift_fwd(af, d) * coup_fwd[:, d] > 0.0 for d in range(geom.n_neighbors)],
        axis=-1,
    )
    b_sat = jnp.stack(
        [bf * geom.shift_fwd(bf, d) * coup_fwd[:, d] > 0.0 for d in range(geom.n_neighbors)],
        axis=-1,
    )
    return a_sat, b_sat


def cmr_blue_bonds(tspins, key, coup_fwd, temp, geom, u_blue=None):
    """CMR stage 1: blue bonds on doubly-satisfied edges, p = 1 - r^2.

    ``u_blue`` injects the per-bond uniforms (kernel bitwise tests).
    """
    a, b = tspins[0], tspins[1]
    k_blue, k_red, k_seed, k_bcoin, k_gcoin = jax.random.split(key, 5)
    r = jnp.exp(-2.0 * jnp.abs(coup_fwd) / temp)
    a_sat, b_sat = _cmr_satisfied(a, b, coup_fwd, geom)
    if u_blue is None:
        u_blue = jax.random.uniform(k_blue, coup_fwd.shape, dtype=jnp.float32)
    blue = a_sat & b_sat & (u_blue < 1.0 - r * r)
    return blue, (r, k_red, k_seed, k_bcoin, k_gcoin)


def cmr_mid(
    tspins, blue_labels, blue, aux, coup_fwd, geom, *, wolff, update,
    with_winding, with_stats, u_red=None,
):
    """CMR stage 2: blue stats + joint blue flip + red-bond extension.

    Returns ``(tspins, grey_bonds, carry)`` where ``carry`` feeds
    :func:`cmr_finish` after the grey component labeling.
    """
    r, k_red, k_seed, k_bcoin, k_gcoin = aux
    a, b = tspins[0], tspins[1]
    blue_counts, csd, obs = _stats(blue, blue_labels, geom, with_winding,
                                   with_stats)
    seed = jax.random.randint(k_seed, (), 0, a.shape[0])
    if wolff:
        blue_flip = cl.wolff_flip_mask(blue_labels, seed)
    else:
        blue_flip = cl.cluster_coin_flip_mask(
            k_bcoin, blue_labels, nonsingleton=cl.nonsingleton_mask(blue, geom)
        )
    if update:
        a = jnp.where(blue_flip, -a, a)
        b = jnp.where(blue_flip, -b, b)

    # red bonds on singly-satisfied edges (post-flip), p = 1 - r
    a_sat, b_sat = _cmr_satisfied(a, b, coup_fwd, geom)
    if u_red is None:
        u_red = jax.random.uniform(k_red, coup_fwd.shape, dtype=jnp.float32)
    red = (a_sat != b_sat) & (u_red < 1.0 - r)
    tspins = jnp.stack([a, b])
    return tspins, blue | red, (seed, k_gcoin, blue_counts, csd, obs)


def cmr_finish(tspins, grey_labels, grey_bonds, blue_labels, carry, geom, *,
               wolff, update):
    """CMR stage 3: grey flips with k in {1..3} (Wolff) / {0..3} (SW)."""
    seed, k_gcoin, blue_counts, csd, obs = carry
    a, b = tspins[0], tspins[1]
    if wolff:
        k = jax.random.randint(k_gcoin, (), 1, 4)
        in_grey = cl.wolff_flip_mask(grey_labels, seed)
        flip_a = in_grey & ((k & 1) != 0)
        flip_b = in_grey & ((k & 2) != 0)
    else:
        # one k in {0..3} per grey cluster (overlap.rs:822-842)
        k = (cl.cluster_uniform(k_gcoin, grey_labels) * 4.0).astype(jnp.int32)
        nonsingleton = cl.nonsingleton_mask(grey_bonds, geom)
        flip_a = nonsingleton & ((k & 1) != 0)
        flip_b = nonsingleton & ((k & 2) != 0)
    if update:
        a = jnp.where(flip_a, -a, a)
        b = jnp.where(flip_b, -b, b)
    tspins = jnp.stack([a, b])
    return OverlapMoveOut(tspins, grey_labels, blue_labels, blue_counts, csd,
                          obs)


def cmr_task(
    tspins,
    key,
    coup_fwd,
    temp,
    geom,
    *,
    wolff: bool,
    update: bool,
    with_winding: bool,
    with_stats: bool = True,
):
    """CMR two-phase (blue -> grey) move on one pair task."""
    blue, aux = cmr_blue_bonds(tspins, key, coup_fwd, temp, geom)
    blue_labels = cl.connected_components(blue, geom)
    tspins, grey_bonds, carry = cmr_mid(
        tspins, blue_labels, blue, aux, coup_fwd, geom, wolff=wolff,
        update=update, with_winding=with_winding, with_stats=with_stats,
    )
    grey_labels = cl.connected_components(grey_bonds, geom)
    return cmr_finish(
        tspins, grey_labels, grey_bonds, blue_labels, carry, geom,
        wolff=wolff, update=update,
    )
