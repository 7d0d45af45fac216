"""Plain numpy references for the device ops, independent of the engine code.

Neighbors come from explicit index arithmetic on ``lattice.offsets`` (no
rolls, no ``Lattice.fwd``), so a wrong shift direction, seam wrap or colour
mask in :mod:`peapods_tpu.ops` shows up as a mismatch.  Used by the CPU tests
(``tests/test_reference_np.py``) and by ``chip_smoke.py`` on the GPU.

The sweep reference applies the same lazy Metropolis / Gibbs rule as
:func:`peapods_tpu.ops.sweep.mc_sweep`, colour by colour, in float32 with
the same field summation order.  It also reports each site's distance from
the flip threshold: a device's ``exp``/``log`` may differ from numpy's in
the last ulp, so a site that sits on the threshold may legitimately decide
differently (``sweep_mismatches``).
"""

from __future__ import annotations

import numpy as np

# |u - p| window for Metropolis and |dE - (T/2) log(u/(1-u))| window for
# Gibbs within which a device and numpy may round to different decisions.
METROPOLIS_TIE = 1e-6
GIBBS_TIE = 1e-5

# (name, shape, offsets); offsets None = hypercubic.  Every geometry family
# the engine serves: hypercubic, triangular, BCC, FCC and custom offsets.
GEOMETRIES = [
    ("square_8x8", (8, 8), None),
    ("square_16x128", (16, 128), None),
    ("square_8x32", (8, 32), None),
    ("triangular_8x16", (8, 16), [[1, 0], [0, 1], [1, -1]]),
    ("triangular_16x128", (16, 128), [[1, 0], [0, 1], [1, -1]]),
    ("cubic_4", (4, 4, 4), None),
    ("cubic_8x8x16", (8, 8, 16), None),
    ("bcc", (4, 4, 4), [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1]]),
    ("fcc", (4, 4, 4), [[1, 1, 0], [1, 0, 1], [0, 1, 1],
                        [1, -1, 0], [1, 0, -1], [0, 1, -1]]),
    ("nnn_square", (8, 16), [[1, 0], [0, 1], [1, 1], [1, -1]]),
    ("stride2", (8, 16), [[2, 0], [0, 1]]),
    ("cubic_diag", (8, 8, 8), [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]]),
    ("knight", (8, 16), [[1, 2], [2, 1]]),
]


def neighbor_tables(shape, offsets):
    """``(fwd, bwd)`` int64 ``[n_spins, n_nb]`` by explicit index arithmetic:
    ``fwd[i, d]`` is the row-major index of ``coords(i) + offsets[d]`` taken
    modulo the extents."""
    shape = np.asarray(shape, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.int64)
    coords = np.empty((n, len(shape)), dtype=np.int64)
    rem = idx.copy()
    for a in range(len(shape) - 1, -1, -1):
        coords[:, a] = rem % shape[a]
        rem //= shape[a]

    def flat(c):
        c = c % shape
        out = np.zeros(c.shape[:-1], dtype=np.int64)
        for a in range(len(shape)):
            out = out * shape[a] + c[..., a]
        return out

    fwd = flat(coords[:, None, :] + offsets[None, :, :])
    bwd = flat(coords[:, None, :] - offsets[None, :, :])
    return fwd, bwd


def local_fields(spins_f, coup, fwd, bwd):
    """``h[s, i] = sum_d J[i,d] s[fwd(i,d)] + J[bwd(i,d),d] s[bwd(i,d)]`` in
    float32, in the device's summation order (direction by direction, the
    forward term before the backward one)."""
    h = np.zeros_like(spins_f)
    for d in range(fwd.shape[1]):
        h += spins_f[:, fwd[:, d]] * coup[:, d]
        h += spins_f[:, bwd[:, d]] * coup[bwd[:, d], d]
    return h


def sweep_color(spins, coup, fwd, bwd, color_mask, temps, u, gibbs,
                laziness=1.0 / 16.0):
    """One colour pass of the lazy Metropolis / Gibbs rule.

    Args:
        spins: int8 ``[n_systems, n_spins]``.
        coup: float32 ``[n_spins, n_nb]`` forward couplings.
        color_mask: bool ``[n_spins]``.
        temps: float32 ``[n_systems]``.
        u: float32 ``[n_systems, n_spins]`` acceptance uniforms.

    Returns:
        ``(new_spins, tie)``: ``tie`` marks the colour's sites whose
        decision lies within the rounding window of the threshold.
    """
    f32 = np.float32
    s = spins.astype(f32)
    coup = np.asarray(coup, f32)
    u = np.asarray(u, f32)
    temps = np.asarray(temps, f32)
    d_e = -s * local_fields(s, coup, fwd, bwd)
    if gibbs:
        half_t = (temps * f32(0.5))[:, None]
        with np.errstate(divide="ignore"):  # u == 0 gives -inf: always flip
            thr = half_t * np.log(u / (f32(1.0) - u))
        flip = d_e >= thr
        tie = np.abs(d_e - thr) <= GIBBS_TIE
    else:
        inv_half_t = (f32(1.0) / (temps * f32(0.5)))[:, None]
        p = f32(1.0 - laziness) * np.exp(np.minimum(d_e * inv_half_t, f32(0)))
        flip = u < p
        tie = np.abs(u - p) <= METROPOLIS_TIE
    flip &= color_mask[None, :]
    tie &= color_mask[None, :]
    return np.where(flip, -spins, spins).astype(np.int8), tie


def mc_sweep(spins, coup, fwd, bwd, color_masks, temps, uniforms, gibbs):
    """All colours in order; returns ``(spins, tie)`` with ``tie`` the union
    of every colour's threshold-window sites."""
    tie = np.zeros(spins.shape, bool)
    for c in range(color_masks.shape[0]):
        spins, t = sweep_color(
            spins, coup, fwd, bwd, color_masks[c], temps, uniforms[c], gibbs
        )
        tie |= t
    return spins, tie


def sweep_mismatches(got, want, tie):
    """``(n_tie_mismatches, n_hard_mismatches)``: sites where the device
    decided differently inside / outside the rounding window."""
    diff = np.asarray(got) != np.asarray(want)
    return int((diff & tie).sum()), int((diff & ~tie).sum())


def energies_and_mags(spins, coup, fwd):
    """float64 ``(e, |e| scale, m)`` per system: ``e`` the mean forward-bond
    energy per spin (the engine's positive-sum convention), the scale
    ``sum |J| / n`` that bounds any summation-order error, and the integer
    magnetization sum."""
    s = spins.astype(np.float64)
    coup = np.asarray(coup, np.float64)
    n = s.shape[-1]
    e = np.zeros(s.shape[0])
    for d in range(fwd.shape[1]):
        e += (s * s[:, fwd[:, d]] * coup[:, d]).sum(-1)
    scale = np.abs(coup).sum() / n
    return e / n, scale, spins.astype(np.int64).sum(-1)


def overlap_dots(spins, system_ids, fwd):
    """int64 spin and link overlap sums per (pair, temperature) for replica
    pairs (2p, 2p+1): ``sum_i q_i`` and ``sum_{i,d} q_i q_fwd(i,d)`` with
    ``q = s^a s^b``."""
    a = spins[system_ids[0::2]].astype(np.int64)
    b = spins[system_ids[1::2]].astype(np.int64)
    q = a * b
    link = np.zeros(q.shape[:-1], np.int64)
    for d in range(fwd.shape[1]):
        link += (q * q[..., fwd[:, d]]).sum(-1)
    return q.sum(-1), link


def union_find_labels(active, fwd):
    """Min-site-index component labels of a forward-bond graph (the native
    union-find when built, else a python one with union-to-min)."""
    from peapods_tpu.utils import native

    active = np.asarray(active, bool)
    labels = native.union_find_labels(active, np.asarray(fwd, np.int32))
    if labels is not None:
        return labels
    n = active.shape[0]
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, d in zip(*np.nonzero(active)):
        a, b = find(i), find(int(fwd[i, d]))
        if a != b:
            parent[max(a, b)] = min(a, b)
    return np.array([find(i) for i in range(n)])
