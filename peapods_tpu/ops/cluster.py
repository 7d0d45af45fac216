"""Cluster machinery: bond activation, connected components, flips, graph stats.

Data-parallel counterpart of the reference union-find / DFS cluster layer
(``/root/reference/spin-sim/src/clusters/utils.rs`` and ``clusters/fk.rs``).

Design (SURVEY.md section 7): the sequential union-find becomes a fixed-point
**min-label propagation** connected-components kernel — iterate

    label[i] <- min(label[i], min over active-bond neighbors of their label)

inside a ``lax.while_loop`` until convergence (check amortized over blocks of
rounds).  Labels converge to the minimum site index of each component, so
every site of a component carries the same id (the role of the reference's
flattened union-find parent array).  Neighbor access is roll-based
(:mod:`peapods_tpu.ops.geometry`).

Cluster-level randomness (SW coin flips, CMR's k in {0..3}) comes from
hashing the cluster label with a per-call salt (:func:`cluster_uniform`):
all sites of a cluster see the same draw, clusters see i.i.d. draws — the
gather-free counter-based form of "one coin per union-find root"
(fk.rs:153-162).

All functions here operate on a single bond graph (one system / one replica
pair); callers ``vmap`` over systems, tasks, and disorder realizations.

FK bond rule (fk.rs:74,113): a forward bond (i, d) with interaction
``w = s_i * s_j * J[i,d] > 0`` activates with ``p = 1 - exp(-2 w / T)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "banded_supports",
    "connected_components",
    "connected_components_banded",
    "component_counts",
    "csd_histogram",
    "top4_sizes",
    "find_seed",
    "cluster_uniform",
    "cluster_coin_flip_mask",
    "nonsingleton_mask",
    "wolff_flip_mask",
    "fk_bond_activation",
    "GraphObservation",
    "graph_observation",
    "winding_flags",
]

_NO_WINDING = (jnp.array(False), jnp.array(False))


def _seg_cummin(vals, flags, axis):
    """Segmented prefix-min along ``axis``: the min restarts wherever
    ``flags`` is True (the element starts a new segment)."""

    def op(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, jnp.minimum(av, bv)), af | bf

    out, _ = jax.lax.associative_scan(op, (vals, flags), axis=axis)
    return out


def _axis_scan_accel(labels, active_fwd, geom):
    """Long-range label propagation along pure-axis bond directions.

    One plain round moves labels a single site; a segmented min-scan moves
    them across an entire run of contiguous active bonds in ``log L``
    stages.  For each unit-vector offset the labels are scanned forward and
    backward along that grid axis, with segment breaks wherever the
    connecting bond is inactive.  The periodic wrap bond is left to the
    plain rounds (the scan is linear), which the fixed-point loop still
    performs.
    """
    lg = geom.to_grid(labels)
    base = lg.ndim - geom.n_dims
    for d, off in enumerate(geom.offsets):
        nz = [a for a, o in enumerate(off) if o != 0]
        if len(nz) != 1 or abs(off[nz[0]]) != 1:
            continue  # diagonal offsets keep the roll-based rounds only
        ax = base + nz[0]
        bond = geom.to_grid(active_fwd[:, d])
        if off[nz[0]] == 1:
            fwd_bond = bond  # bond between i and i+1 sits at index i
        else:
            # offset -e_a: the bond at i connects i and i-1
            fwd_bond = jnp.roll(bond, -1, axis=ax)
        flags_f = ~jnp.roll(fwd_bond, 1, axis=ax)
        lg = _seg_cummin(lg, flags_f, ax)
        flags_r = jnp.flip(~fwd_bond, axis=ax)
        lg = jnp.flip(
            _seg_cummin(jnp.flip(lg, axis=ax), flags_r, ax), axis=ax
        )
    return geom.to_flat(lg)


def connected_components(active_fwd, geom):
    """Labels of the bond graph's connected components.

    Min-label propagation to a fixed point: each round takes the minimum
    label over active-bond neighbors (cheap fused rolls); the convergence
    check runs once per 16-round block so its scalar reduction does not
    serialize the pipeline.  Converges in O(component diameter) rounds.
    ``PEAPODS_CC_SCAN=1`` swaps the block for a segmented-min-scan body
    (:func:`_axis_scan_accel`) — correct (union-find-oracle-tested), kept
    for comparison; see the in-function comment.

    Every step is monotone non-increasing and only moves labels across
    genuine bonds, so the unique fixed point (stable under the plain round
    alone) is the exact component labeling.

    Args:
        active_fwd: ``bool [n_spins, n_neighbors]`` — forward-bond activation
            (``active_fwd[i, d]`` is the bond from ``i`` to ``fwd(i, d)``).
        geom: :class:`~peapods_tpu.ops.geometry.GridOps`.

    Returns:
        ``int32 [n_spins]`` labels; ``label[i]`` is the minimum site index of
        ``i``'s component.
    """
    import os

    n_spins = geom.n_spins
    big = jnp.int32(n_spins)
    # Segmented axis scans (opt-in, PEAPODS_CC_SCAN=1): validated against a
    # union-find oracle; the associative_scan lowering (odd/even splits +
    # flips) costs more work per round than a plain block, so plain
    # 16-round blocks are the default.
    use_scans = os.environ.get("PEAPODS_CC_SCAN") == "1"
    # active_bwd[i, d]: the bond arriving at i from its backward neighbor.
    active_bwd = [geom.shift_bwd(active_fwd[:, d], d) for d in range(geom.n_neighbors)]
    init = jnp.arange(n_spins, dtype=jnp.int32)

    def propagate(labels):
        new = labels
        for d in range(geom.n_neighbors):
            lf = jnp.where(active_fwd[:, d], geom.shift_fwd(labels, d), big)
            lb = jnp.where(active_bwd[d], geom.shift_bwd(labels, d), big)
            new = jnp.minimum(new, jnp.minimum(lf, lb))
        # Pointer jump: label values are site indices with label[j] <= j,
        # so jumping stays within the component and halves chain depths.
        return new[new]

    def cond(carry):
        _, changed = carry
        return changed

    def body(carry):
        labels, _ = carry
        if use_scans:
            new = propagate(labels)
            new = _axis_scan_accel(new, active_fwd, geom)
            new = propagate(new)
        else:
            new = labels
            for _ in range(16):
                new = propagate(new)
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.array(True)))
    return labels


def banded_supports(geom) -> bool:
    """The banded CC handles every offset whose dim-0 component is in
    {-1, 0, 1} — true for all built-in geometries (square, triangular,
    cubic, BCC, FCC): one halo row per side covers every seam read."""
    return all(abs(o[0]) <= 1 for o in geom.offsets)


def connected_components_banded(active_fwd, geom, *, axis="space",
                                sync_axes=None):
    """Exact CC labels on a lattice band-sharded along dim 0 (SPMD body —
    call under ``jax.shard_map`` with dim 0 split over mesh axis ``axis``).

    The reference never shards one lattice (its union-find is sequential,
    clusters/utils.rs); under this framework's ``space`` mesh the plain
    :func:`connected_components` is correct but lets GSPMD insert a halo
    collective-permute for BOTH roll directions of EVERY offset in EVERY
    propagation round (~4.n_neighbors collectives per 16-round check block).
    This version keeps the fixed point local and exchanges exactly two halo
    label rows per OUTER round:

        outer round:  ppermute the band-edge label rows (2 collectives)
                      -> local min-label fixed point with the halo rows
                         held constant (seam reads use the halos)
                      -> psum'd converged? (labels everywhere unchanged
                         by a pass that started from fresh halos)

    Every step is the plain propagation step evaluated on true bonds with
    labels that were valid at an earlier time, so updates stay monotone
    non-increasing and bounded by the true component minima — the outer
    fixed point is exactly the unsharded labeling, bitwise (label values
    are GLOBAL site indices; ``n_shards == 1`` degenerates to the plain
    function).  Stale halos only delay propagation: a component spanning k
    shards converges in <= k+1 outer rounds.

    Args:
        active_fwd: ``bool [B, n_local, n_neighbors]`` — this shard's row
            band of forward-bond activations, flat local site axis.
        geom: :class:`~peapods_tpu.ops.geometry.GridOps` of the GLOBAL
            lattice (``geom.shape[0]`` must divide by the mesh axis size).
        axis: mesh axis name the lattice's dim 0 is split over.
        sync_axes: axis name(s) for the outer-loop convergence reduction.
            MUST cover every axis of the enclosing mesh when it has more
            than ``axis`` (e.g. ``("disorder", "space")``): independent
            lattice rings otherwise disagree on outer-loop trip counts and
            their collective-permutes deadlock the SPMD executor (observed
            on the CPU backend's all-device rendezvous).  Converged rings
            just idle through the extra rounds — labels are at their fixed
            point, so nothing changes.  Defaults to ``axis``.

    Returns:
        ``int32 [B, n_local]`` global min-site-index component labels.
    """
    shape = geom.shape
    rest = shape[1:]
    rest_n = int(np.prod(rest, dtype=np.int64)) if rest else 1
    n_batch, n_local, n_nb = active_fwd.shape
    hl = n_local // rest_n
    ns = shape[0] // hl
    idx = jax.lax.axis_index(axis).astype(jnp.int32)
    big = jnp.int32(geom.n_spins)
    nxt_perm = [((j + 1) % ns, j) for j in range(ns)]  # receive next's row 0
    prv_perm = [((j - 1) % ns, j) for j in range(ns)]  # receive prev's last

    band = (hl,) + tuple(rest)

    def broll(x, shifts):
        """Local circular shift of a band grid ``[B, b0, *rest]`` (b0 is hl
        for fields, 1 for halo rows — the modulo drops no-op axes either
        way; dim-0 crossings are the callers' seam overwrites)."""
        axes, sh = [], []
        for a, s in enumerate(shifts):
            if s % x.shape[1 + a] != 0:
                axes.append(1 + a)
                sh.append(s)
        return jnp.roll(x, sh, axis=tuple(axes)) if axes else x

    def read_fwd(x, d, hx_next, hx_prev):
        """``y[i] = x[i + offsets[d]]`` on the band, seam rows from halos."""
        o = geom.offsets[d]
        y = broll(x, [-oi for oi in o])
        if o[0] == 0:
            return y
        orest = [-oi for oi in o[1:]]
        if o[0] == 1:
            return jnp.concatenate(
                [y[:, : hl - 1], broll(hx_next, [0] + orest)], axis=1
            )
        return jnp.concatenate(
            [broll(hx_prev, [0] + orest), y[:, 1:]], axis=1
        )

    def read_bwd(x, d, hx_next, hx_prev):
        """``y[i] = x[i - offsets[d]]`` on the band, seam rows from halos."""
        o = geom.offsets[d]
        y = broll(x, list(o))
        if o[0] == 0:
            return y
        orest = [0] + list(o[1:])
        if o[0] == 1:
            return jnp.concatenate(
                [broll(hx_prev, orest), y[:, 1:]], axis=1
            )
        return jnp.concatenate(
            [y[:, : hl - 1], broll(hx_next, orest)], axis=1
        )

    def halos(xg):
        return (
            jax.lax.ppermute(xg[:, :1], axis, nxt_perm),
            jax.lax.ppermute(xg[:, hl - 1 : hl], axis, prv_perm),
        )

    # Bond masks are CC-constant: one halo exchange for all directions.
    ag = active_fwd.reshape((n_batch,) + band + (n_nb,))
    am_next, am_prev = halos(ag)
    af = [ag[..., d] for d in range(n_nb)]
    ab = [
        read_bwd(af[d], d, am_next[..., d], am_prev[..., d])
        for d in range(n_nb)
    ]

    init = (
        jnp.arange(n_local, dtype=jnp.int32) + idx * jnp.int32(hl * rest_n)
    ).reshape((1,) + band)
    init = jnp.broadcast_to(init, (n_batch,) + band)

    def propagate(lab, hl_next, hl_prev):
        new = lab
        for d in range(n_nb):
            lf = jnp.where(af[d], read_fwd(lab, d, hl_next, hl_prev), big)
            lb = jnp.where(ab[d], read_bwd(lab, d, hl_next, hl_prev), big)
            new = jnp.minimum(new, jnp.minimum(lf, lb))
        return new

    def outer_body(carry):
        lab, _ = carry
        hl_next, hl_prev = halos(lab)

        def inner_body(c):
            l, _ = c
            new = l
            for _ in range(16):
                new = propagate(new, hl_next, hl_prev)
            return new, jnp.any(new != l)

        new, _ = jax.lax.while_loop(
            lambda c: c[1], inner_body, (lab, jnp.array(True))
        )
        changed = (
            jax.lax.psum(
                jnp.any(new != lab).astype(jnp.int32),
                axis if sync_axes is None else sync_axes,
            )
            > 0
        )
        return new, changed

    labels, _ = jax.lax.while_loop(
        lambda c: c[1], outer_body, (init, jnp.array(True))
    )
    return labels.reshape(n_batch, n_local)


def _hist_matmul(values, weights, n_bins):
    """Exact dense histogram via a two-level one-hot matmul.

    ``out[v] = sum(weights[values == v])`` for ``v < n_bins`` — the same
    integers the scatter-add form (``zeros.at[values].add(weights)``)
    produces, as a contraction instead of a serialized scatter.  The value
    splits into ``hi = v // 128`` and ``lo = v % 128``; two int8 one-hot
    factors contract over the update axis into an exact int32
    ``[hi_bins, 128]`` grid (int8 x int8 -> int32: no floating point, so no
    reduced-precision matmul mode can touch it), which flattens to the
    dense histogram.  Weights must be 0/1 (they fold into the int8 hi
    factor)."""
    lo_n = 128
    hi_n = -(-n_bins // lo_n)
    v = values.astype(jnp.int32)
    hi_oh = (
        v[:, None] // lo_n == jnp.arange(hi_n, dtype=jnp.int32)[None, :]
    ).astype(jnp.int8)
    if weights is not None:
        hi_oh = hi_oh * weights.astype(jnp.int8)[:, None]
    lo_oh = (
        v[:, None] % lo_n == jnp.arange(lo_n, dtype=jnp.int32)[None, :]
    ).astype(jnp.int8)
    grid = jax.lax.dot_general(
        hi_oh, lo_oh, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return grid.reshape(hi_n * lo_n)[:n_bins]


def component_counts(labels):
    """``int32 [n_spins]``: ``counts[x]`` = size of the component labeled x (0 elsewhere)."""
    n = labels.shape[0]
    return _hist_matmul(labels, None, n)


def csd_histogram(counts):
    """Cluster-size histogram ``hist[s] = #clusters of size s``; ``int32 [n_spins+1]``.

    Matches the reference's ``uf_histogram`` (clusters/utils.rs:297-303).
    """
    n = counts.shape[0]
    return _hist_matmul(counts, counts > 0, n + 1)


def top4_sizes(counts):
    """Four largest component sizes, descending (clusters/utils.rs:305-315)."""
    top, _ = jax.lax.top_k(counts, 4)
    return top


def find_seed(key, eligible, n_probes: int = 64):
    """Probabilistic seed search: 64 random probes (clusters/utils.rs:107-119).

    Returns ``(seed_index, found)``; when not found the caller must mask the
    move off (the reference returns ``None`` and skips the task).
    """
    n = eligible.shape[0]
    probes = jax.random.randint(key, (n_probes,), 0, n)
    hits = eligible[probes]
    first = jnp.argmax(hits)  # first True (argmax returns lowest index of max)
    return probes[first], hits.any()


def cluster_uniform(key, labels):
    """One i.i.d. uniform per cluster, constant across the cluster's sites.

    The reference draws one coin per union-find root (fk.rs:153-162); here
    the cluster identity (its min-site-index label) is hashed together with a
    per-call salt — a gather-free counter-based equivalent: distinct clusters
    get independent draws, every site of a cluster sees the same draw, and
    different calls/sweeps are decorrelated by the salt.  The hash is a
    murmur3-style avalanche of (label, salt) down to a 24-bit uniform.
    """
    salt = jax.random.randint(
        key, (2,), -(2**31), 2**31 - 1, dtype=jnp.int32
    ).astype(jnp.uint32)
    x = labels.astype(jnp.uint32) ^ salt[0]
    x = (x ^ (x >> 16)) * jnp.uint32(0x85EBCA6B)
    x = (x ^ (x >> 13)) * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16) ^ salt[1]
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> jnp.uint32(8)).astype(jnp.float32) * np.float32(1.0 / (1 << 24))


def nonsingleton_mask(active_fwd, geom):
    """Sites whose component has size > 1 == sites with any incident bond."""
    incident = active_fwd.any(-1)
    for d in range(geom.n_neighbors):
        incident |= geom.shift_bwd(active_fwd[:, d], d)
    return incident


def cluster_coin_flip_mask(key, labels, *, prob=0.5, nonsingleton=None):
    """SW-style per-cluster coin: flip each cluster with probability ``prob``.

    ``nonsingleton`` (a site mask from :func:`nonsingleton_mask`) restricts
    flips to clusters of size > 1 — the overlap-move convention
    (clusters/overlap.rs:296-309); FK/SW flips singletons too (fk.rs:153-162).
    """
    flip = cluster_uniform(key, labels) < prob
    if nonsingleton is not None:
        flip &= nonsingleton
    return flip


def wolff_flip_mask(labels, seed):
    """Mask of the component containing ``seed``."""
    return labels == labels[seed]


def fk_bond_activation(spins, coup_fwd, geom, temp, key, *, factor=2.0,
                       u=None):
    """FK forward-bond activation for one system (fk.rs:74,106-114).

    ``factor`` is the exponent multiplier: 2 for FK, 4 for the Joerg move's
    pair bonds (overlap.rs:424-436).  ``u`` injects the per-bond uniforms
    (bitwise tests against a reference); default draws them from ``key``.
    Returns ``bool [n_spins, n_neighbors]``.
    """
    s = spins.astype(jnp.float32)
    inter = jnp.stack(
        [s * geom.shift_fwd(s, d) * coup_fwd[:, d] for d in range(geom.n_neighbors)],
        axis=-1,
    )
    p = 1.0 - jnp.exp(-factor * inter / temp)
    if u is None:
        u = jax.random.uniform(key, inter.shape, dtype=jnp.float32)
    return (inter > 0.0) & (u < p)


class GraphObservation(NamedTuple):
    """Per-graph observation slot (clusters/utils.rs:317-325)."""

    top4: jax.Array  # int32 [4]
    active_bonds: jax.Array  # int32 scalar
    winding_x: jax.Array  # bool scalar
    winding_y: jax.Array  # bool scalar
    large_components: jax.Array  # int32 scalar


def graph_observation(active_fwd, counts, labels, geom, with_winding):
    """Graph observables for one bond graph (clusters/utils.rs:334-368).

    ``with_winding`` must be a static bool (canonical 2D lattices only).
    """
    n_spins = counts.shape[0]
    threshold = jnp.int32(-(-n_spins * 5 // 100))  # ceil(0.05 * n)
    if with_winding:
        wx, wy = winding_flags(active_fwd, labels, geom)
    else:
        wx, wy = _NO_WINDING
    return GraphObservation(
        top4=top4_sizes(counts),
        active_bonds=active_fwd.sum().astype(jnp.int32),
        winding_x=wx,
        winding_y=wy,
        large_components=(counts >= threshold).sum().astype(jnp.int32),
    )


def winding_flags(active_fwd, labels, geom):
    """Detect components wrapping the torus along each of the two axes.

    Data-parallel replacement of the reference's displacement-tracking union-find
    (``WindingUf``, clusters/utils.rs:371-455).  We BFS-settle an *unwrapped*
    displacement potential ``d[i]`` from each component's root (its min-label
    site) along active bonds; a component winds along axis ``a`` iff some
    active bond violates the potential, i.e. ``d[j] - d[i] != offset`` in that
    axis (any violation is a nonzero multiple of the lattice extent, exactly
    the noncontractible-cycle criterion).

    Returns:
        ``(winding_x, winding_y)`` bool scalars: does *any* component wind?
    """
    n_spins = geom.n_spins
    n_nb = geom.n_neighbors
    offsets = geom.offsets  # static python ints
    active_bwd = [geom.shift_bwd(active_fwd[:, d], d) for d in range(n_nb)]
    site_idx = jnp.arange(n_spins, dtype=jnp.int32)

    settled0 = labels == site_idx
    disp0 = jnp.zeros((2, n_spins), dtype=jnp.int32)  # sites last for rolls

    def cond(carry):
        settled, _ = carry
        return ~settled.all()

    def round_(carry):
        settled, disp = carry
        new_settled = settled
        new_disp = disp
        for d in range(n_nb):
            off = jnp.array(offsets[d], jnp.int32)[:, None]
            ok = active_fwd[:, d] & geom.shift_fwd(settled, d) & ~new_settled
            cand = geom.shift_fwd(disp, d) - off
            new_disp = jnp.where(ok[None, :], cand, new_disp)
            new_settled |= ok
            ok = active_bwd[d] & geom.shift_bwd(settled, d) & ~new_settled
            cand = geom.shift_bwd(disp, d) + off
            new_disp = jnp.where(ok[None, :], cand, new_disp)
            new_settled |= ok
        return new_settled, new_disp

    def body(carry):
        # 16 settle rounds per convergence check: the `.all()` scalar
        # reduction forces a pipeline sync, and the BFS depth is the
        # component's CHEMICAL diameter (~L^1.13 at 2D T_c — hundreds of
        # rounds at 256^2), so per-round checks would dominate full
        # observe mode.  Rounds past the settle
        # point are no-ops (every `ok` requires ~settled), so the final
        # (settled, disp) is bitwise the per-round-check fixed point.
        for _ in range(16):
            carry = round_(carry)
        return carry

    _, disp = jax.lax.while_loop(cond, body, (settled0, disp0))

    wx = jnp.array(False)
    wy = jnp.array(False)
    for d in range(n_nb):
        off = offsets[d]
        viol_x = geom.shift_fwd(disp[0], d) - disp[0] - off[0]
        viol_y = geom.shift_fwd(disp[1], d) - disp[1] - off[1]
        wx |= (active_fwd[:, d] & (viol_x != 0)).any()
        wy |= (active_fwd[:, d] & (viol_y != 0)).any()
    return wx, wy
