"""Device ops against the plain numpy references of ``tests/reference_np.py``.

The sweep, the energy/magnetization/overlap measurements and connected
components are each compared with an implementation that builds neighbors by
explicit index arithmetic, on every geometry family the engine serves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import reference_np as ref
from peapods_tpu.ops import cluster as cl
from peapods_tpu.ops.energy import energies_and_mags
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice
from peapods_tpu.ops.measure import overlap_dots
from peapods_tpu.ops.sweep import mc_sweep

GEOMS = {name: (shape, offs) for name, shape, offs in ref.GEOMETRIES}


def _setup(name, n_sys, seed, gaussian=False):
    shape, offs = GEOMS[name]
    lat = Lattice(list(shape), offs)
    fwd, bwd = ref.neighbor_tables(shape, lat.offsets)
    rng = np.random.default_rng(seed)
    if gaussian:
        coup = rng.standard_normal((lat.n_spins, lat.n_neighbors))
    else:
        coup = rng.choice([-1.0, 1.0], size=(lat.n_spins, lat.n_neighbors))
    coup = coup.astype(np.float32)
    spins = rng.choice([-1, 1], size=(n_sys, lat.n_spins)).astype(np.int8)
    return lat, fwd, bwd, rng, coup, spins


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name", list(GEOMS))
def test_mc_sweep_matches_numpy_reference(name, gibbs):
    """Two chained sweeps under shared uniforms: every flip decision equals
    the reference's outside the f32 rounding window of the threshold."""
    lat, fwd, bwd, rng, coup, spins = _setup(name, 4, 5, gaussian=gibbs)
    masks = lat.color_masks()
    # the colouring must be a proper one for synchronous colour updates
    for c in range(lat.n_colors):
        for d in range(lat.n_neighbors):
            clash = masks[c] & masks[c][fwd[:, d]] & (fwd[:, d] != np.arange(
                lat.n_spins))
            assert not clash.any(), (name, c, d)
    temps = np.linspace(0.8, 6.0, 4).astype(np.float32)
    geom = GridOps.from_lattice(lat)
    coup_bwd = coup[lat.bwd, np.arange(lat.n_neighbors)[None, :]]
    sweep = jax.jit(
        lambda s, u: mc_sweep(
            s, jnp.asarray(coup), jnp.asarray(coup_bwd), geom,
            jnp.asarray(masks), jnp.asarray(temps), jax.random.PRNGKey(0),
            gibbs=gibbs, uniforms=u,
        )
    )
    for _ in range(2):
        u = rng.random((lat.n_colors,) + spins.shape, dtype=np.float32)
        got = np.asarray(sweep(jnp.asarray(spins), jnp.asarray(u)))
        want, tie = ref.mc_sweep(spins, coup, fwd, bwd, masks, temps, u, gibbs)
        n_tie, n_hard = ref.sweep_mismatches(got, want, tie)
        assert n_hard == 0, (name, n_hard, n_tie)
        assert (got != spins).any()  # the sweep did flip something
        spins = want


@pytest.mark.parametrize("name", list(GEOMS))
def test_energy_mag_overlap_match_numpy_reference(name):
    lat, fwd, _, rng, coup, spins = _setup(name, 6, 9, gaussian=True)
    geom = GridOps.from_lattice(lat)
    e, m = energies_and_mags(jnp.asarray(spins), jnp.asarray(coup), geom)
    e_ref, scale, m_ref = ref.energies_and_mags(spins, coup, fwd)
    np.testing.assert_allclose(np.asarray(e), e_ref, rtol=0, atol=1e-6 * scale)
    np.testing.assert_array_equal(np.asarray(m), m_ref)
    sid = rng.permutation(6).reshape(2, 3).astype(np.int32)  # [R, T]
    dot_s, dot_l = overlap_dots(jnp.asarray(spins), jnp.asarray(sid), geom)
    q_ref, ql_ref = ref.overlap_dots(spins, sid, fwd)
    np.testing.assert_array_equal(np.asarray(dot_s), q_ref)
    np.testing.assert_array_equal(np.asarray(dot_l), ql_ref)


@pytest.mark.parametrize("density", [0.2, 0.5, 0.8])
@pytest.mark.parametrize(
    "name", ["square_8x32", "triangular_8x16", "cubic_4", "fcc", "knight"]
)
def test_connected_components_match_union_find(name, density):
    lat, fwd, _, rng, _, _ = _setup(name, 1, 11)
    active = rng.random((lat.n_spins, lat.n_neighbors)) < density
    labels = cl.connected_components(
        jnp.asarray(active), GridOps.from_lattice(lat)
    )
    np.testing.assert_array_equal(
        np.asarray(labels), ref.union_find_labels(active, fwd)
    )
