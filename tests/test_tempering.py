"""Parallel tempering unit tests (reference: mcmc/tempering.rs:104-138 +
realization.rs round-trip state machine)."""

import jax
import jax.numpy as jnp
import numpy as np

from peapods_tpu.ops import tempering as pt


def _forced_ladder(first_parity, energies):
    """Run one full-ladder event; huge energy gaps force every acceptance."""
    n_temps = 5
    temps = jnp.asarray([0.5, 0.8, 1.2, 2.0, 4.0], jnp.float32)
    sid = jnp.arange(n_temps, dtype=jnp.int32)[None, :]
    out = pt.pt_full_ladder(
        jnp.asarray(energies, jnp.float32),
        sid,
        temps,
        jax.random.PRNGKey(0),
        64,
        jnp.int32(first_parity),
        jnp.zeros(4, jnp.int32),
        jnp.zeros(4, jnp.int32),
        jnp.zeros(n_temps, jnp.int32),
        pt.init_trip_state(sid, hot_slot=4),
        4,  # hot
        0,  # cold
    )
    return [np.asarray(x) for x in out]


def test_full_ladder_even_then_odd_parity():
    # energies make delta large and positive for every edge -> all swaps accept
    sid, att, acc, _, _ = _forced_ladder(0, [0.0, 100.0, 200.0, 300.0, 400.0])
    # parity 0: swap (0,1),(2,3) -> [1,0,3,2,4]; parity 1 on the result:
    # swap (1,2),(3,4) -> [1,3,0,4,2]
    np.testing.assert_array_equal(sid[0], [1, 3, 0, 4, 2])
    np.testing.assert_array_equal(att, [1, 1, 1, 1])
    np.testing.assert_array_equal(acc, [1, 1, 1, 1])


def test_full_ladder_odd_first_parity():
    sid, att, acc, _, _ = _forced_ladder(1, [0.0, 100.0, 200.0, 300.0, 400.0])
    # parity 1 first: swap (1,2),(3,4) -> [0,2,1,4,3]; then parity 0:
    # swap (0,1),(2,3) -> [2,0,4,1,3]
    np.testing.assert_array_equal(sid[0], [2, 0, 4, 1, 3])


def test_rejected_swaps_leave_permutation_alone():
    # delta large negative -> all rejected
    sid, att, acc, _, _ = _forced_ladder(0, [0.0, -100.0, -200.0, -300.0, -400.0])
    np.testing.assert_array_equal(sid[0], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(att, [1, 1, 1, 1])
    np.testing.assert_array_equal(acc, [0, 0, 0, 0])


def test_round_trip_state_machine():
    """hot -> cold -> hot counts one round trip (realization.rs:285-302)."""
    temps = jnp.asarray([1.0, 2.0], jnp.float32)
    sid = jnp.asarray([[0, 1]], jnp.int32)
    ts = pt.init_trip_state(sid, hot_slot=1)
    np.testing.assert_array_equal(np.asarray(ts), [0, 1])  # system 1 starts hot

    rt = jnp.zeros(2, jnp.int32)
    # forced swap: energy gap favorable
    e = jnp.asarray([0.0, 100.0], jnp.float32)
    sid, att, acc, rt, ts = pt.pt_full_ladder(
        e, sid, temps, jax.random.PRNGKey(1), 4, jnp.int32(0),
        jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32), rt, ts, 1, 0,
    )
    # system 1 moved to cold: trip_state 1 -> 2; system 0 to hot: 0 -> 1
    np.testing.assert_array_equal(np.asarray(ts), [1, 2])
    # swap back (energies by system stay the same, now delta reversed ->
    # forced the other way)
    e2 = jnp.asarray([100.0, 0.0], jnp.float32)
    sid, att, acc, rt, ts = pt.pt_full_ladder(
        e2, sid, temps, jax.random.PRNGKey(2), 4, jnp.int32(0),
        jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32), rt, ts, 1, 0,
    )
    # system 1 returns hot with trip_state 2 -> round trip counted
    assert np.asarray(rt)[1] == 1
