"""Roll-based neighbor access: the device-side lattice addressing scheme.

The reference addresses neighbors through precomputed flat index tables
(``geometry/lattice.rs:63-108``) because its site loops are sequential.  On a
device, a random-access gather of ``n_systems * n_spins * n_neighbors``
elements per sweep would move an index table as large as the spins — but on a
periodic Bravais lattice the neighbor map in direction ``d`` is a *circular
shift* by the offset vector, so every neighbor "gather" lowers to ``jnp.roll``
(slice + concatenate), which XLA fuses into the surrounding elementwise work.

``GridOps`` carries the static lattice shape and offsets and converts between
the flat site axis used by the engine state and the N-D grid used for shifts.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

__all__ = ["GridOps"]


class GridOps:
    """Shift-based neighbor addressing for arrays with a flat site last axis."""

    def __init__(self, shape, offsets):
        self.shape = tuple(int(s) for s in shape)
        self.offsets = tuple(tuple(int(x) for x in off) for off in offsets)
        self.n_dims = len(self.shape)
        self.n_neighbors = len(self.offsets)
        self.n_spins = math.prod(self.shape)

    @classmethod
    def from_lattice(cls, lattice):
        return cls(lattice.shape, lattice.offsets)

    def to_grid(self, x):
        return x.reshape(x.shape[:-1] + self.shape)

    def to_flat(self, xg):
        return xg.reshape(xg.shape[: xg.ndim - self.n_dims] + (self.n_spins,))

    def _roll(self, x, shifts):
        xg = self.to_grid(x)
        axes = []
        sh = []
        base = xg.ndim - self.n_dims
        for a, s in enumerate(shifts):
            if s % self.shape[a] != 0:
                axes.append(base + a)
                sh.append(s)
        if not axes:
            return x
        return self.to_flat(jnp.roll(xg, sh, axis=tuple(axes)))

    def shift_fwd(self, x, d: int):
        """``y[i] = x[fwd(i, d)]`` — value at the forward neighbor."""
        return self._roll(x, [-o for o in self.offsets[d]])

    def shift_bwd(self, x, d: int):
        """``y[i] = x[bwd(i, d)]``."""
        return self._roll(x, list(self.offsets[d]))

    def neighbor_sum_fwd(self, x):
        """``sum_d x[fwd(i, d)]`` over all directions."""
        out = self.shift_fwd(x, 0)
        for d in range(1, self.n_neighbors):
            out = out + self.shift_fwd(x, d)
        return out
