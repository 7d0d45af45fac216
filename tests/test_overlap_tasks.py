"""Overlap move plumbing: task building and flip-mask properties."""

import jax
import jax.numpy as jnp
import numpy as np

from peapods_tpu.ops import cluster as cl
from peapods_tpu.ops import overlap as ov
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice


def test_build_tasks_partitions_each_temperature():
    """Tasks at temp t must be a permutation of that temp's systems
    (overlap.rs:35-56)."""
    n_replicas, n_temps = 4, 3
    sid = jnp.arange(n_replicas * n_temps, dtype=jnp.int32).reshape(
        n_replicas, n_temps
    )
    for g in (2, 4):
        tasks = np.asarray(ov.build_tasks(sid, jax.random.PRNGKey(0), g))
        assert tasks.shape == (n_temps, n_replicas // g, g)
        for t in range(n_temps):
            assert set(tasks[t].ravel()) == set(np.asarray(sid[:, t]))


def test_houdayer_active_set_and_joint_flip():
    """Flipping a Houdayer cluster preserves the site overlap q_i of every
    grouped pair and the per-replica energies in expectation is covered by
    the equilibrium oracles; here: flips only touch active sites and apply
    to all group members jointly."""
    lat = Lattice([4, 4])
    geom = GridOps.from_lattice(lat)
    rng = np.random.default_rng(0)
    tspins = jnp.asarray(rng.choice([-1, 1], size=(2, 16)).astype(np.int8))
    out = ov.houdayer_task(
        tspins, jax.random.PRNGKey(1), geom,
        wolff=True, update=True, with_winding=False,
    )
    active = np.asarray(tspins).sum(0) == 0
    changed = (np.asarray(out.spins) != np.asarray(tspins)).any(0)
    assert not (changed & ~active).any()  # only active sites flip
    # joint flip: both replicas changed at exactly the same sites
    ch0 = np.asarray(out.spins[0]) != np.asarray(tspins[0])
    ch1 = np.asarray(out.spins[1]) != np.asarray(tspins[1])
    np.testing.assert_array_equal(ch0, ch1)
    # q_i invariant under joint flips
    np.testing.assert_array_equal(
        np.asarray(out.spins[0] * out.spins[1]),
        np.asarray(tspins[0] * tspins[1]),
    )


def test_cmr_joint_flip_preserves_singly_satisfied_class():
    """A joint (both-replica) flip of any site set preserves each edge's
    singly-satisfied classification (a_sat XOR b_sat), the invariant the CMR
    red phase relies on (overlap.rs:564-569): when exactly one endpoint
    flips, a_sat and b_sat both toggle, so their XOR is unchanged."""
    lat = Lattice([4, 4])
    geom = GridOps.from_lattice(lat)
    rng = np.random.default_rng(3)
    coup = jnp.asarray(rng.choice([-1.0, 1.0], size=(16, 2)).astype(np.float32))

    def sat_class(a, b):
        af = a.astype(np.float32)
        bf = b.astype(np.float32)
        out = []
        for d in range(2):
            ja = af * af[np.asarray(lat.fwd[:, d])] * np.asarray(coup[:, d]) > 0
            jb = bf * bf[np.asarray(lat.fwd[:, d])] * np.asarray(coup[:, d]) > 0
            out.append(ja.astype(int) + jb.astype(int))
        return np.stack(out)

    tspins = jnp.asarray(rng.choice([-1, 1], size=(2, 16)).astype(np.int8))
    out = ov.cmr_task(
        tspins, jax.random.PRNGKey(7), coup, jnp.float32(1.0), geom,
        wolff=True, update=True, with_winding=False,
    )
    a, b = np.asarray(tspins[0]), np.asarray(tspins[1])
    flip = rng.random(16) < 0.5
    a2 = np.where(flip, -a, a)
    b2 = np.where(flip, -b, b)
    np.testing.assert_array_equal(sat_class(a, b) == 1, sat_class(a2, b2) == 1)
    # and the task output is a valid +-1 configuration
    assert set(np.unique(np.asarray(out.spins))) <= {-1, 1}


def test_cluster_coin_is_constant_per_cluster():
    lat = Lattice([6, 6])
    geom = GridOps.from_lattice(lat)
    rng = np.random.default_rng(5)
    active = jnp.asarray(rng.random((36, 2)) < 0.5)
    labels = cl.connected_components(active, geom)
    flip = np.asarray(
        cl.cluster_coin_flip_mask(jax.random.PRNGKey(2), labels)
    )
    lab = np.asarray(labels)
    for root in np.unique(lab):
        members = flip[lab == root]
        assert members.all() or not members.any()
