"""Batched device->host fetch for pytrees.

Every device->host transfer pays a fixed round-trip latency, so fetching a
results accumulator leaf-by-leaf (``np.asarray`` per array) pays it once
per leaf.  ``fetch_pytree`` packs every leaf into two flat blobs ON DEVICE
(one jitted concatenate) and ships them with two transfers, then restores
shapes/dtypes host-side.

Packers are cached per tree structure so the jit cache is hit across
``sample()`` calls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fetch_pytree"]

_packers: dict = {}


def _structure_key(leaves, treedef):
    return (treedef, tuple((l.shape, str(l.dtype)) for l in leaves))


def fetch_pytree(tree):
    """Materialize a pytree of device arrays as numpy with two transfers."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if not leaves or not any(isinstance(l, jax.Array) for l in leaves):
        return tree
    key = _structure_key(leaves, treedef)
    if key not in _packers:
        idx_i = [
            i
            for i, l in enumerate(leaves)
            if jnp.issubdtype(l.dtype, jnp.integer)
            or jnp.issubdtype(l.dtype, jnp.bool_)
        ]
        idx_f = [i for i in range(len(leaves)) if i not in set(idx_i)]

        def pack(ls):
            bi = (
                jnp.concatenate(
                    [ls[i].ravel().astype(jnp.int32) for i in idx_i]
                )
                if idx_i
                else jnp.zeros((0,), jnp.int32)
            )
            bf = (
                jnp.concatenate(
                    [ls[i].ravel().astype(jnp.float32) for i in idx_f]
                )
                if idx_f
                else jnp.zeros((0,), jnp.float32)
            )
            return bi, bf

        _packers[key] = (jax.jit(pack), idx_i, idx_f)
    packer, idx_i, idx_f = _packers[key]
    bi, bf = packer(leaves)
    bi = np.asarray(bi)
    bf = np.asarray(bf)

    out = [None] * len(leaves)
    off = 0
    for i in idx_i:
        n = int(np.prod(leaves[i].shape)) if leaves[i].shape else 1
        out[i] = (
            bi[off : off + n]
            .astype(np.dtype(str(leaves[i].dtype)))
            .reshape(leaves[i].shape)
        )
        off += n
    off = 0
    for i in idx_f:
        n = int(np.prod(leaves[i].shape)) if leaves[i].shape else 1
        out[i] = (
            bf[off : off + n]
            .astype(np.dtype(str(leaves[i].dtype)))
            .reshape(leaves[i].shape)
        )
        off += n
    return jax.tree_util.tree_unflatten(treedef, out)
