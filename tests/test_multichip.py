"""Multi-chip sharding validation on the virtual CPU device mesh."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent.parent))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_matches_unsharded_trajectory():
    """Disorder sharding must not change results (bitwise pytree equality)."""
    from peapods_tpu.engine.simulation import IsingSimulation
    from peapods_tpu.parallel.mesh import make_mesh

    temps = np.array([1.0, 2.0], dtype=np.float32)
    rng = np.random.default_rng(1)
    coup = (2 * rng.integers(0, 2, size=(8, 4, 4, 2)) - 1).astype(np.float32)

    kwargs = dict(
        pt_interval=1,
        overlap_cluster_update_interval=2,
        warmup_ratio=0.25,
    )
    sharded = IsingSimulation([4, 4], coup, temps, 2, None, 3,
                              mesh=make_mesh(8))
    r_sh = sharded.sample(16, "metropolis", **kwargs)
    plain = IsingSimulation([4, 4], coup, temps, 2, None, 3, mesh=None)
    r_pl = plain.sample(16, "metropolis", **kwargs)

    np.testing.assert_allclose(r_sh["mags2"], r_pl["mags2"], rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(sharded.state["spins"]), np.asarray(plain.state["spins"])
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_non_divisible_disorder_padded_onto_mesh():
    """n_disorder=9 on 8 devices: auto padding must keep results identical
    to an unsharded run (padded realizations are dropped at aggregation)."""
    from peapods_tpu.engine.simulation import IsingSimulation
    from peapods_tpu.parallel.mesh import auto_mesh

    temps = np.array([1.2, 2.4], dtype=np.float32)
    rng = np.random.default_rng(7)
    coup = (2 * rng.integers(0, 2, size=(9, 4, 4, 2)) - 1).astype(np.float32)

    mesh = auto_mesh(9)
    assert mesh is not None
    dsize = mesh.shape["disorder"]
    assert dsize > 1

    sharded = IsingSimulation([4, 4], coup, temps, 2, None, 3, mesh=mesh)
    assert sharded.n_padded % dsize == 0 and sharded.n_realizations == 9
    r_sh = sharded.sample(12, "metropolis", pt_interval=1,
                          overlap_cluster_update_interval=2, warmup_ratio=0.25)
    plain = IsingSimulation([4, 4], coup, temps, 2, None, 3, mesh=None)
    r_pl = plain.sample(12, "metropolis", pt_interval=1,
                        overlap_cluster_update_interval=2, warmup_ratio=0.25)

    np.testing.assert_array_equal(r_sh["mags2"], r_pl["mags2"])
    np.testing.assert_array_equal(
        r_sh["per_sample_overlap_histogram"], r_pl["per_sample_overlap_histogram"]
    )
    pt_sh = r_sh["per_disorder"]["parallel_tempering"]["edge_attempts"]
    pt_pl = r_pl["per_disorder"]["parallel_tempering"]["edge_attempts"]
    assert pt_sh.shape == (9, 1)
    np.testing.assert_array_equal(pt_sh, pt_pl)
    np.testing.assert_array_equal(
        np.asarray(sharded.state["spins"])[:9], np.asarray(plain.state["spins"])
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_spatial_decomposition_matches_unsharded():
    """Row-band 'space' sharding (SURVEY section 5 long-context analog): the
    roll stencils and the SW label propagation cross shard boundaries via
    XLA-inserted halo collectives; results must stay bitwise identical."""
    from peapods_tpu.engine.simulation import IsingSimulation
    from peapods_tpu.parallel.mesh import make_mesh

    temps = np.array([2.269185], dtype=np.float32)
    coup = np.ones((16, 16, 2), np.float32)
    kwargs = dict(cluster_update_interval=1, cluster_mode="sw",
                  collect_cluster_stats=True, warmup_ratio=0)

    mesh = make_mesh(4, ("space",))
    spatial = IsingSimulation([16, 16], coup, temps, 1, None, 11, mesh=mesh)
    r_sp = spatial.sample(6, "metropolis", **kwargs)
    plain = IsingSimulation([16, 16], coup, temps, 1, None, 11, mesh=None)
    r_pl = plain.sample(6, "metropolis", **kwargs)

    np.testing.assert_array_equal(
        np.asarray(spatial.state["spins"]), np.asarray(plain.state["spins"])
    )
    np.testing.assert_array_equal(r_sp["mags2"], r_pl["mags2"])
    np.testing.assert_array_equal(
        np.asarray(r_sp["fk_csd"]), np.asarray(r_pl["fk_csd"])
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_disorder_by_space_mesh():
    """2D disorder x space mesh: both batch and lattice partitioned."""
    from peapods_tpu.engine.simulation import IsingSimulation
    from peapods_tpu.parallel.mesh import make_mesh

    temps = np.array([2.0, 2.6], dtype=np.float32)
    rng = np.random.default_rng(5)
    coup = (2 * rng.integers(0, 2, size=(2, 8, 8, 2)) - 1).astype(np.float32)
    mesh = make_mesh(8, ("disorder", "space"))
    assert dict(mesh.shape) == {"disorder": 2, "space": 4}
    sim = IsingSimulation([8, 8], coup, temps, 2, None, 3, mesh=mesh)
    r = sim.sample(4, "metropolis", pt_interval=1,
                   overlap_cluster_update_interval=2, warmup_ratio=0)
    plain = IsingSimulation([8, 8], coup, temps, 2, None, 3, mesh=None)
    r_pl = plain.sample(4, "metropolis", pt_interval=1,
                        overlap_cluster_update_interval=2, warmup_ratio=0)
    np.testing.assert_array_equal(r["mags2"], r_pl["mags2"])
    np.testing.assert_array_equal(
        np.asarray(sim.state["spins"]), np.asarray(plain.state["spins"])
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_space_mesh_rejects_indivisible_extent():
    from peapods_tpu.engine.simulation import IsingSimulation
    from peapods_tpu.parallel.mesh import make_mesh

    coup = np.ones((6, 8, 2), np.float32)
    with pytest.raises(ValueError, match="space"):
        IsingSimulation([6, 8], coup, np.array([2.0], np.float32), 1, None,
                        1, mesh=make_mesh(4, ("space",)))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_multidevice_binder_physics_oracle():
    """Physics on the mesh, not just mechanics: 8 independent realizations
    sharded over 8 devices must reproduce the universal 2D Ising torus
    Binder value (~0.611) at exact T_c."""
    from peapods_tpu import Ising

    model = Ising((8, 8), temperatures=np.array([2.269185]), n_disorder=8,
                  seed=17)
    assert model._sim.mesh is not None
    assert model._sim.mesh.devices.size == 8
    model.sample(1600, cluster_update_interval=2, cluster_mode="sw",
                 warmup_ratio=0.25)
    binder = float(model.binder_cumulant[0])
    assert abs(binder - 0.6107) < 0.06, binder

