"""Cluster machinery tests: CC vs union-find oracle, CSD, winding.

Mirrors the reference's hand-drawn-fixture style for union-find and winding
(clusters/utils.rs:457-782) with a python union-find as the oracle.
"""

import jax.numpy as jnp
import numpy as np

from peapods_tpu.ops import cluster as cl
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice


def uf_labels(lat, active):
    """Python union-find oracle with union-to-min (labels = min site index)."""
    parent = list(range(lat.n_spins))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(lat.n_spins):
        for d in range(lat.n_neighbors):
            if active[i, d]:
                a, b = find(i), find(int(lat.fwd[i, d]))
                if a != b:
                    parent[max(a, b)] = min(a, b)
    return np.array([find(i) for i in range(lat.n_spins)])


def test_connected_components_matches_union_find():
    rng = np.random.default_rng(0)
    for shape, offsets in [([6, 6], None), ([4, 4], [[1, 0], [0, 1], [1, -1]]), ([3, 4, 5], None)]:
        lat = Lattice(shape, offsets)
        for p in (0.1, 0.4, 0.7):
            active = rng.random((lat.n_spins, lat.n_neighbors)) < p
            labels = np.asarray(
                cl.connected_components(
                    jnp.asarray(active), GridOps.from_lattice(lat)
                )
            )
            np.testing.assert_array_equal(labels, uf_labels(lat, active))


def test_connected_components_scan_body_matches_union_find(monkeypatch):
    """Opt-in segmented-scan body (PEAPODS_CC_SCAN=1): same labels."""
    monkeypatch.setenv("PEAPODS_CC_SCAN", "1")
    rng = np.random.default_rng(7)
    for shape, offsets in [
        ([8, 8], None),
        ([6, 6], [[1, 0], [0, 1], [1, -1]]),
        ([4, 6, 4], None),
    ]:
        lat = Lattice(shape, offsets)
        for p in (0.3, 0.6, 0.9):
            active = rng.random((lat.n_spins, lat.n_neighbors)) < p
            labels = np.asarray(
                cl.connected_components(
                    jnp.asarray(active), GridOps.from_lattice(lat)
                )
            )
            np.testing.assert_array_equal(labels, uf_labels(lat, active))


def test_counts_histogram_top4():
    lat = Lattice([6, 6])
    rng = np.random.default_rng(1)
    active = rng.random((lat.n_spins, 2)) < 0.4
    labels = cl.connected_components(jnp.asarray(active), GridOps.from_lattice(lat))
    counts = cl.component_counts(labels)
    hist = np.asarray(cl.csd_histogram(counts))
    # total sites accounted for
    assert (np.arange(lat.n_spins + 1) * hist).sum() == lat.n_spins
    top4 = np.asarray(cl.top4_sizes(counts))
    c = np.asarray(counts)
    np.testing.assert_array_equal(top4, np.sort(c)[::-1][:4])


def _winding(lat, active):
    act = jnp.asarray(active)
    geom = GridOps.from_lattice(lat)
    labels = cl.connected_components(act, geom)
    wx, wy = cl.winding_flags(act, labels, geom)
    return bool(wx), bool(wy)


def test_winding_full_lattice_wraps_both():
    lat = Lattice([4, 4])
    assert _winding(lat, np.ones((16, 2), bool)) == (True, True)


def test_winding_single_column_wraps_x_only():
    lat = Lattice([4, 4])
    act = np.zeros((16, 2), bool)
    act[[0, 4, 8, 12], 0] = True  # vertical ring through column 0
    assert _winding(lat, act) == (True, False)


def test_winding_seam_crossing_path_does_not_wind():
    # Path 12-0-4-8 crosses the periodic seam once but has no cycle: the
    # seam-vs-cycle discrimination from clusters/utils.rs:371-455.
    lat = Lattice([4, 4])
    act = np.zeros((16, 2), bool)
    act[[0, 4, 12], 0] = True  # bonds 0-4, 4-8, 12-0
    assert _winding(lat, act) == (False, False)


def test_winding_empty_graph():
    lat = Lattice([4, 4])
    assert _winding(lat, np.zeros((16, 2), bool)) == (False, False)


def test_find_seed_masks_off_when_no_eligible_site():
    import jax

    key = jax.random.PRNGKey(0)
    seed, found = cl.find_seed(key, jnp.zeros(32, bool))
    assert not bool(found)
    seed, found = cl.find_seed(key, jnp.ones(32, bool))
    assert bool(found)


def test_connected_components_banded_matches_unsharded():
    """Banded CC (space-mesh shard_map body: local fixed point + two halo
    label rows per outer round) is bitwise the plain labeling on every
    geometry, including hl=1 bands (BCC on 8 shards) where every row is a
    seam row."""
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from jax.sharding import PartitionSpec as P

    from peapods_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)
    cases = [
        ([16, 16], None, 4),
        ([8, 8], [[1, 0], [0, 1], [1, -1]], 4),
        ([8, 8, 8], None, 2),
        ([8, 8, 8], [[1, 1, 0], [1, 0, 1], [0, 1, 1],
                     [1, -1, 0], [1, 0, -1], [0, 1, -1]], 4),
        ([8, 8, 8], [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1]], 8),
    ]
    for shape, offsets, ns in cases:
        lat = Lattice(shape, offsets)
        geom = GridOps.from_lattice(lat)
        assert cl.banded_supports(geom)
        mesh = make_mesh(ns, ("space",))
        call = jax.shard_map(
            lambda a: cl.connected_components_banded(a, geom, axis="space"),
            mesh=mesh, in_specs=P(None, "space", None),
            out_specs=P(None, "space"), check_vma=False,
        )
        if ns <= 4:
            # disorder x space: independent lattice rings per disorder row
            # MUST sync the outer loop over the whole mesh, or differing
            # trip counts deadlock the collective rendezvous (sync_axes).
            mesh2 = make_mesh(2 * ns, ("disorder", "space"))
            call2 = jax.shard_map(
                lambda a: cl.connected_components_banded(
                    a, geom, axis="space", sync_axes=("disorder", "space"),
                ),
                mesh=mesh2, in_specs=P("disorder", "space", None),
                out_specs=P("disorder", "space"), check_vma=False,
            )
            active2 = jnp.asarray(
                rng.random((4, lat.n_spins, lat.n_neighbors)) < 0.5
            )
            ref2 = jax.vmap(lambda a: cl.connected_components(a, geom))(
                active2
            )
            np.testing.assert_array_equal(
                np.asarray(call2(active2)), np.asarray(ref2),
                err_msg=f"shape={shape} disorder-x-space ns={ns}",
            )
        for p in (0.15, 0.5, 0.9):
            active = jnp.asarray(
                rng.random((3, lat.n_spins, lat.n_neighbors)) < p
            )
            ref = jax.vmap(lambda a: cl.connected_components(a, geom))(
                active
            )
            np.testing.assert_array_equal(
                np.asarray(call(active)), np.asarray(ref),
                err_msg=f"shape={shape} ns={ns} p={p}",
            )


def test_hist_matmul_matches_scatter_edges():
    """The one-hot matmul histogram equals the scatter-add form on edge shapes: bin
    counts not a lane multiple (n=64, n=100), values hitting the last bin
    (counts == n), empty input weights, and the all-one-component case."""
    import jax.numpy as jnp

    from peapods_tpu.ops import cluster as cl

    rng = np.random.default_rng(3)
    for n in (64, 100, 300):
        labs = np.minimum(
            rng.integers(0, n, n), rng.integers(0, n, n)
        ).astype(np.int32)
        counts = np.asarray(cl.component_counts(jnp.asarray(labs)))
        ref = np.zeros(n, np.int32)
        np.add.at(ref, labs, 1)
        np.testing.assert_array_equal(counts, ref)
        hist = np.asarray(cl.csd_histogram(jnp.asarray(counts)))
        ref_h = np.zeros(n + 1, np.int32)
        np.add.at(ref_h, counts, (counts > 0).astype(np.int32))
        np.testing.assert_array_equal(hist, ref_h)
    # one component spanning everything: counts[0] == n -> top bin n
    labs = np.zeros(128, np.int32)
    counts = np.asarray(cl.component_counts(jnp.asarray(labs)))
    assert counts[0] == 128 and counts[1:].sum() == 0
    hist = np.asarray(cl.csd_histogram(jnp.asarray(counts)))
    assert hist[128] == 1 and hist.sum() == 1
