"""Exact-enumeration equilibrium oracles for every update kernel.

The reference validates dynamics against statistical-physics ground truth
(SURVEY.md section 4); here small systems are enumerated exactly, which also
guards the ergodicity of the synchronous (lazy) Metropolis kernel — the
unscaled synchronous kernel is provably biased (see ops/sweep.py docstring).
"""

import numpy as np
import pytest

from peapods_tpu import Ising

N1D = 12


def exact_ring_correlation(temps, n):
    t = np.tanh(1.0 / temps)
    return (t + t ** (n - 1)) / (1 + t**n)


def enumerate_2x2x4():
    """4x4 ferromagnet exact enumeration: returns (E, M) over all states."""
    n = 16
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    idx = np.arange(16).reshape(4, 4)
    bi, bj = [], []
    for i in range(4):
        for j in range(4):
            bi += [idx[i, j], idx[i, j]]
            bj += [idx[(i + 1) % 4, j], idx[i, (j + 1) % 4]]
    E = (states[:, bi] * states[:, bj]).sum(1).astype(np.float64)
    M = states.sum(1).astype(np.float64)
    return E, M


def exact_em(E, M, T, n=16):
    w = np.exp(E / T - E.max() / T)
    z = w.sum()
    return (E * w).sum() / z / n, ((M / n) ** 2 * w).sum() / z


@pytest.mark.parametrize("mode", ["metropolis", "gibbs"])
def test_1d_ring_energy(mode):
    temps = np.array([1.0, 2.0], dtype=np.float32)
    exact = exact_ring_correlation(temps.astype(np.float64), N1D)
    m = Ising((N1D,), temperatures=temps, seed=1)
    m.sample(4000, sweep_mode=mode, warmup_ratio=0.25)
    np.testing.assert_allclose(m.energies_avg, exact, atol=0.05)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(cluster_update_interval=1, cluster_mode="sw"),
        dict(cluster_update_interval=1, cluster_mode="wolff"),
    ],
    ids=["metropolis", "sw", "wolff"],
)
def test_2d_4x4_exact(kw):
    E, M = enumerate_2x2x4()
    T = 2.3
    e_ex, m2_ex = exact_em(E, M, T)
    m = Ising((4, 4), temperatures=np.array([T], dtype=np.float32), seed=11)
    m.sample(8000, warmup_ratio=0.25, **kw)
    assert abs(m.energies_avg[0] - e_ex) < 0.05
    assert abs(m.mags2[0] - m2_ex) < 0.06


def test_pt_each_temperature_reaches_equilibrium():
    E, M = enumerate_2x2x4()
    temps = np.array([2.0, 3.0], dtype=np.float32)
    m = Ising((4, 4), temperatures=temps, n_replicas=2, seed=13)
    m.sample(8000, pt_interval=1, warmup_ratio=0.25)
    for i, T in enumerate(temps):
        e_ex, _ = exact_em(E, M, float(T))
        assert abs(m.energies_avg[i] - e_ex) < 0.05


@pytest.mark.parametrize(
    "build,cmode",
    [
        ("houdayer", "wolff"),
        ("houdayer", "sw"),
        ("jorg", "wolff"),
        ("jorg", "sw"),
        ("cmr", "wolff"),
        ("cmr", "sw"),
    ],
)
def test_overlap_moves_preserve_equilibrium(build, cmode):
    """Spin-glass q2 oracle: <q^2> = sum_ij <s_i s_j>^2 / N^2 exactly."""
    shape = (4, 4)
    n = 16
    rng = np.random.default_rng(42)
    coup = (2 * rng.integers(0, 2, size=shape + (2,)) - 1).astype(np.float32)
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1).astype(
        np.float64
    )
    idx = np.arange(16).reshape(4, 4)
    E = np.zeros(2**n)
    for i in range(4):
        for j in range(4):
            E += coup[i, j, 0] * states[:, idx[i, j]] * states[:, idx[(i + 1) % 4, j]]
            E += coup[i, j, 1] * states[:, idx[i, j]] * states[:, idx[i, (j + 1) % 4]]
    T = 1.5
    w = np.exp(E / T - E.max() / T)
    w /= w.sum()
    e_exact = (E * w).sum() / n
    C = (states.T * w) @ states
    q2_exact = (C**2).sum() / n**2

    m = Ising(shape, couplings=coup, temperatures=np.array([T], dtype=np.float32),
              n_replicas=2, seed=23)
    m.sample(
        10000,
        warmup_ratio=0.25,
        overlap_cluster_update_interval=1,
        overlap_cluster_build_mode=build,
        overlap_cluster_mode=cmode,
    )
    assert abs(m.energies_avg[0] - e_exact) < 0.05, (build, cmode)
    assert abs(m.overlap2[0] - q2_exact) < 0.05, (build, cmode)


def _enumerate_lattice(shape, geometry):
    """Exact (E, M) over all states of a tiny named-geometry ferromagnet,
    built from the Lattice's own forward-neighbor tables so wrap-induced
    double bonds (extent-2 dims under diagonal offsets) are mirrored
    exactly."""
    from peapods_tpu.ops.lattice import GEOMETRY_OFFSETS, Lattice

    return _enumerate_offsets(shape, GEOMETRY_OFFSETS[geometry])


def _enumerate_offsets(shape, offsets):
    from peapods_tpu.ops.lattice import Lattice

    lat = Lattice(list(shape), offsets)
    n = lat.n_spins
    assert n <= 16
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    bi = np.repeat(np.arange(n), lat.n_neighbors)
    bj = lat.fwd.reshape(-1)
    E = (states[:, bi] * states[:, bj]).sum(1).astype(np.float64)
    M = states.sum(1).astype(np.float64)
    return E, M, n


@pytest.mark.parametrize(
    "geometry,kw",
    [
        ("bcc", {}),
        ("bcc", dict(cluster_update_interval=1, cluster_mode="sw")),
        ("fcc", {}),
    ],
    ids=["bcc-metropolis", "bcc-sw", "fcc-metropolis"],
)
def test_diagonal_geometry_exact(geometry, kw):
    """2x2x4 BCC / FCC ferromagnet vs full enumeration — pins the diagonal
    offset geometry semantics (neighbor tables, wrap double-bonds) that the
    Binder crossings only test statistically.  The sweep's flip rule on
    these geometries is pinned against the numpy reference under shared
    uniforms in tests/test_reference_np.py."""
    E, M, n = _enumerate_lattice((2, 2, 4), geometry)
    T = 4.0 if geometry == "bcc" else 5.0
    e_ex, m2_ex = exact_em(E, M, T, n=n)
    m = Ising((2, 2, 4), geometry=geometry,
              temperatures=np.array([T], dtype=np.float32), seed=11)
    m.sample(8000, warmup_ratio=0.25, **kw)
    assert abs(m.energies_avg[0] - e_ex) < 0.05
    assert abs(m.mags2[0] - m2_ex) < 0.06


@pytest.mark.parametrize(
    "kw",
    [{}, dict(cluster_update_interval=1, cluster_mode="sw")],
    ids=["metropolis", "sw"],
)
def test_custom_offsets_exact(kw):
    """2x8 next-nearest-neighbor square ferromagnet vs full enumeration —
    pins custom-offset neighbor semantics (incl. the extent-2 wrap double
    bonds of the diagonal directions); the flip rule on custom offset
    tables is pinned against the numpy reference in
    tests/test_reference_np.py."""
    offs = [[1, 0], [0, 1], [1, 1], [1, -1]]
    E, M, n = _enumerate_offsets((2, 8), offs)
    T = 5.0
    e_ex, m2_ex = exact_em(E, M, T, n=n)
    m = Ising((2, 8), neighbor_offsets=offs,
              temperatures=np.array([T], dtype=np.float32), seed=17)
    m.sample(8000, warmup_ratio=0.25, **kw)
    assert abs(m.energies_avg[0] - e_ex) < 0.05
    assert abs(m.mags2[0] - m2_ex) < 0.06
