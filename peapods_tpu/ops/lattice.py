"""Periodic Bravais lattice with precomputed neighbor tables and site coloring.

Counterpart of the reference lattice geometry
(``/root/reference/spin-sim/src/geometry/lattice.rs:9-109`` and
``geometry/offsets.rs:4-20``).  The reference precomputes flat forward/backward
neighbor index tables used by sequential site loops; here the same tables are
built host-side (numpy, optionally accelerated by the native C++ helper) and
uploaded once as ``int32`` device arrays that drive vectorized gathers.

One genuinely new piece relative to the reference is the *site coloring*: the
reference sweeps sites sequentially (typewriter order), which cannot map to a
data-parallel device.  We partition sites into independent sets (colors) such
that no two neighbors share a color; a sweep is one full pass updating each
color in turn.  This changes the RNG trajectory but not the stationary
distribution; equivalence with the reference is established statistically
(Binder crossings, tau scaling), per SURVEY.md section 7.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Lattice", "hypercubic_offsets", "GEOMETRY_OFFSETS"]

# Named geometries, mirroring python/peapods/spin_models.py:5-10 in the reference.
GEOMETRY_OFFSETS = {
    "triangular": [[1, 0], [0, 1], [1, -1]],
    "tri": [[1, 0], [0, 1], [1, -1]],
    "fcc": [[1, 1, 0], [1, 0, 1], [0, 1, 1], [1, -1, 0], [1, 0, -1], [0, 1, -1]],
    "bcc": [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1]],
}


def hypercubic_offsets(n_dims: int) -> list[list[int]]:
    """Unit vectors along each axis (reference: geometry/offsets.rs:4-8)."""
    return [[1 if d == i else 0 for d in range(n_dims)] for i in range(n_dims)]


class Lattice:
    """Periodic lattice: neighbor tables, strides, and a greedy site coloring.

    Sites are indexed in row-major (C) order.  Couplings elsewhere are stored
    as ``[n_spins, n_neighbors]`` where element ``[i, d]`` is the coupling on
    the *forward* bond from site ``i`` in direction ``d`` (reference layout).

    Attributes:
        shape: lattice extents.
        strides: row-major strides.
        n_spins: total sites.
        n_dims: number of dimensions.
        n_neighbors: forward directions per site.
        fwd: ``int32 [n_spins, n_neighbors]`` forward neighbor indices.
        bwd: ``int32 [n_spins, n_neighbors]`` backward neighbor indices.
        offsets: ``int [n_neighbors, n_dims]`` displacement vectors.
        colors: ``int32 [n_spins]`` greedy proper coloring of the bond graph.
        n_colors: number of colors.
        canonical_square_shape: ``(h, w)`` when constructed as a plain 2D
            hypercubic lattice (enables winding observables & fast paths),
            else ``None`` (reference: lattice.rs:31-37).
    """

    def __init__(self, shape, offsets=None, *, canonical: bool | None = None):
        shape = [int(s) for s in shape]
        n_dims = len(shape)
        if offsets is None:
            offsets = hypercubic_offsets(n_dims)
            if canonical is None:
                canonical = True
        elif canonical is None:
            canonical = False

        offsets = [[int(x) for x in off] for off in offsets]
        for idx, off in enumerate(offsets):
            if len(off) != n_dims:
                raise ValueError(
                    f"offset {idx} has length {len(off)}, expected {n_dims}"
                )

        self.shape = tuple(shape)
        self.n_dims = n_dims
        self.n_neighbors = len(offsets)
        self.n_spins = int(np.prod(shape)) if shape else 1
        self.offsets = np.asarray(offsets, dtype=np.int64)

        strides = np.ones(n_dims, dtype=np.int64)
        for d in range(n_dims - 2, -1, -1):
            strides[d] = strides[d + 1] * shape[d + 1]
        self.strides = strides

        self.canonical_square_shape = (
            (shape[0], shape[1]) if (canonical and n_dims == 2) else None
        )

        self.fwd, self.bwd = self._build_neighbor_tables()
        self.colors, self.n_colors = self._color_sites()

    # -- construction helpers -------------------------------------------------

    def _build_neighbor_tables(self):
        """Vectorized equivalent of lattice.rs:63-81 (rem_euclid wraparound)."""
        from ..utils import native

        tables = native.build_neighbor_tables(self.shape, self.offsets)
        if tables is not None:
            return tables
        shape = np.asarray(self.shape, dtype=np.int64)
        idx = np.arange(self.n_spins, dtype=np.int64)
        # coords[i, dim]
        coords = (idx[:, None] // self.strides[None, :]) % shape[None, :]

        def table(sign):
            # [n_spins, n_neighbors, n_dims]
            c = coords[:, None, :] + sign * self.offsets[None, :, :]
            c %= shape[None, None, :]  # numpy % matches rem_euclid for ints
            flat = (c * self.strides[None, None, :]).sum(-1)
            return flat.astype(np.int32)

        return table(1), table(-1)

    def _color_sites(self):
        """Greedy proper coloring of the bond graph.

        Adjacency = union of forward and backward neighbors.  Sites joined by
        any bond never share a color, so all sites of one color can be updated
        simultaneously (the heat-bath factorizes).  Self-bonds (offsets that
        wrap onto the same site, e.g. extent-1 axes) are ignored: a site can
        always be updated alone.
        """
        n = self.n_spins
        # Fast path: hypercubic with all-even extents -> 2-color checkerboard.
        if self._is_hypercubic() and all(s % 2 == 0 for s in self.shape):
            coords_sum = self._coords().sum(axis=1)
            return (coords_sum % 2).astype(np.int32), 2

        from ..utils import native

        colored = native.greedy_color(self.fwd, self.bwd)
        if colored is not None:
            colors, n_colors = colored
            return colors, n_colors

        neighbors = np.concatenate([self.fwd, self.bwd], axis=1)
        colors = np.full(n, -1, dtype=np.int32)
        for i in range(n):
            used = set()
            for j in neighbors[i]:
                j = int(j)
                if j != i and colors[j] >= 0:
                    used.add(int(colors[j]))
            c = 0
            while c in used:
                c += 1
            colors[i] = c
        return colors, int(colors.max()) + 1 if n else 1

    def _is_hypercubic(self):
        hc = np.asarray(hypercubic_offsets(self.n_dims), dtype=np.int64)
        return self.offsets.shape == hc.shape and np.array_equal(self.offsets, hc)

    def _coords(self):
        shape = np.asarray(self.shape, dtype=np.int64)
        idx = np.arange(self.n_spins, dtype=np.int64)
        return (idx[:, None] // self.strides[None, :]) % shape[None, :]

    # -- queries --------------------------------------------------------------

    def neighbor_fwd(self, i: int, d: int) -> int:
        return int(self.fwd[i, d])

    def neighbor_bwd(self, i: int, d: int) -> int:
        return int(self.bwd[i, d])

    def color_masks(self) -> np.ndarray:
        """``bool [n_colors, n_spins]`` one mask per color."""
        return self.colors[None, :] == np.arange(self.n_colors)[:, None]
