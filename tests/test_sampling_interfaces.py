"""Python interface behavior tests.

Covers the same API contracts as the reference's pytest suite
(``/root/reference/tests/test_sampling_interfaces.py``): seed discipline,
observe-mode shapes and non-mutation, PT diagnostic accumulation across
`sample` calls, validation-before-mutation, autocorrelation backend
agreement, and CLI/TOML option propagation — organized around a shared
small-glass model factory.
"""

import numpy as np
import pytest

from peapods_tpu import Ising
from peapods_tpu.cli import _load_sweep_config, build_parser
from peapods_tpu.sweep import (
    _flatten_per_disorder_arrays,
    _run_child_seed,
    _run_seed_words,
)


def small_glass(seed, temps=(1.0, 2.0), n_replicas=2, **kw):
    return Ising(
        (4, 4),
        couplings="bimodal",
        temperatures=np.array(temps, dtype=np.float32),
        n_replicas=n_replicas,
        seed=seed,
        **kw,
    )


class TestSeedDiscipline:
    def test_seed_fixes_couplings_and_initial_spins(self):
        a, b = small_glass(41), small_glass(41)
        np.testing.assert_array_equal(a.couplings, b.couplings)
        np.testing.assert_array_equal(a._sim.get_spins(), b._sim.get_spins())

    def test_reset_replays_and_seeded_reset_is_one_off(self):
        model = small_glass(41)
        initial = model._sim.get_spins().copy()

        model.sample(2, warmup_ratio=0)
        model.reset()
        np.testing.assert_array_equal(model._sim.get_spins(), initial)

        model.reset(seed=99)
        seeded = model._sim.get_spins().copy()
        model.reset(seed=99)
        np.testing.assert_array_equal(model._sim.get_spins(), seeded)
        # a bare reset afterwards returns to the constructor stream
        model.reset()
        np.testing.assert_array_equal(model._sim.get_spins(), initial)

    def test_same_seed_same_trajectory(self):
        a, b = small_glass(51), small_glass(51)
        for m in (a, b):
            m.sample(5, pt_interval=1, warmup_ratio=0)
        np.testing.assert_array_equal(a._sim.get_spins(), b._sim.get_spins())

    def test_disorder_zero_stable_as_disorder_count_grows(self):
        one = Ising((4, 4), couplings="gaussian", n_disorder=1, seed=7)
        many = Ising((4, 4), couplings="gaussian", n_disorder=3, seed=7)
        np.testing.assert_array_equal(one.couplings, many.couplings[0])


class TestObserveMode:
    def test_fk_observe_shapes_and_noncanonical_winding_omission(self):
        # explicit neighbor_offsets -> not a canonical square lattice, so the
        # winding observables must be absent
        model = Ising(
            (4, 4),
            temperatures=np.array([1.5, 2.5]),
            n_disorder=2,
            neighbor_offsets=[[1, 0], [0, 1]],
            seed=5,
        )
        result = model.sample(
            2,
            cluster_update_interval=1,
            cluster_mode="sw",
            cluster_action="observe",
            warmup_ratio=0,
        )
        fk = result["per_disorder"]["cluster_observations"]["fk"]
        assert fk["observation_count"].shape == (2, 2)
        assert fk["observation_count"].dtype == np.uint64
        assert fk["cluster_size_counts"].shape == (2, 2, 17)
        assert fk["top_four_component_fractions"].shape == (2, 2, 4)
        assert "winding_x" not in fk

    def test_observe_mutates_nothing(self):
        # Stronger than the reference's twin-run oracle (mod.rs:941-1177):
        # with counter-based RNG streams an observe run's trajectory is
        # bitwise identical to a run with no observer at all.
        plain = small_glass(77)
        plain.sample(4, warmup_ratio=0)
        expected = plain._sim.get_spins()

        fk_obs = small_glass(77)
        fk_obs.sample(
            4,
            cluster_update_interval=1,
            cluster_mode="sw",
            cluster_action="observe",
            warmup_ratio=0,
        )
        np.testing.assert_array_equal(fk_obs._sim.get_spins(), expected)

        ov_obs = small_glass(77)
        ov_obs.sample(
            4,
            overlap_cluster_update_interval=1,
            overlap_cluster_build_mode="houdayer",
            overlap_cluster_mode="sw",
            overlap_cluster_action="observe",
            warmup_ratio=0,
        )
        np.testing.assert_array_equal(ov_obs._sim.get_spins(), expected)

    def test_observe_mutates_nothing_fused_path(self):
        """Observer invariance through the 3D measurement + PT path: PT must
        reuse the measured energies on observe-mode overlap sweeps
        (regression: recomputing them used a different f32 sum order and
        could flip a threshold-marginal swap)."""

        def glass(seed):
            return Ising(
                (8, 8, 8),
                couplings="bimodal",
                temperatures=np.array([1.0, 2.0], dtype=np.float32),
                n_replicas=2,
                seed=seed,
            )

        plain = glass(91)
        plain.sample(4, pt_interval=1, warmup_ratio=0)
        expected = plain._sim.get_spins()
        sid_expected = np.asarray(plain._sim.state["system_ids"])

        obs = glass(91)
        obs.sample(
            4,
            pt_interval=1,
            overlap_cluster_update_interval=2,
            overlap_cluster_build_mode="houdayer",
            overlap_cluster_mode="sw",
            overlap_cluster_action="observe",
            warmup_ratio=0,
        )
        np.testing.assert_array_equal(obs._sim.get_spins(), expected)
        np.testing.assert_array_equal(
            np.asarray(obs._sim.state["system_ids"]), sid_expected
        )

    def test_fk_observe_mutates_nothing_fused_path(self):
        """FK-observe counterpart: an observe-only FK phase leaves spins
        untouched between sweep and measurement, so PT sees the measured
        energies and the FK-observer run stays bitwise identical to an
        observer-free run (same mechanism as the overlap-observer case)."""

        def glass(seed):
            return Ising(
                (8, 8, 8),
                couplings="bimodal",
                temperatures=np.array([1.0, 2.0], dtype=np.float32),
                n_replicas=2,
                seed=seed,
            )

        plain = glass(57)
        plain.sample(4, pt_interval=1, warmup_ratio=0)
        expected = plain._sim.get_spins()
        sid_expected = np.asarray(plain._sim.state["system_ids"])

        obs = glass(57)
        obs.sample(
            4,
            pt_interval=1,
            cluster_update_interval=2,
            cluster_mode="sw",
            cluster_action="observe",
            warmup_ratio=0,
        )
        prog = [p for p in obs._sim._programs.values()
                if p.cfg.cluster_update is not None][0]
        assert prog.observe_fk and prog.describe_plan() == "sweep=jnp, cc=jnp"
        np.testing.assert_array_equal(obs._sim.get_spins(), expected)
        np.testing.assert_array_equal(
            np.asarray(obs._sim.state["system_ids"]), sid_expected
        )

    @pytest.mark.parametrize("build_mode", ["houdayer", "jorg"])
    def test_sw_overlap_observers(self, build_mode):
        model = small_glass(31, temps=(1.5,))
        result = model.sample(
            1,
            overlap_cluster_update_interval=1,
            overlap_cluster_build_mode=build_mode,
            overlap_cluster_mode="sw",
            overlap_cluster_action="observe",
            warmup_ratio=0,
        )
        observed = result["per_disorder"]["cluster_observations"][build_mode]
        assert observed["observation_count"].tolist() == [[1]]


class TestParallelTemperingDiagnostics:
    def test_cmr_observe_and_full_ladder_counters(self):
        model = small_glass(11, temps=(1.0, 2.0, 4.0))
        result = model.sample(
            2,
            overlap_cluster_update_interval=1,
            overlap_cluster_build_mode="cmr",
            overlap_cluster_mode="sw",
            overlap_cluster_action="observe",
            pt_interval=1,
            pt_schedule="full_ladder",
            warmup_ratio=0,
        )
        cmr = result["per_disorder"]["cluster_observations"]["cmr_blue"]
        pt = result["per_disorder"]["parallel_tempering"]
        assert cmr["observation_count"].shape == (1, 3)
        assert np.all(cmr["observation_count"] == 2)
        # full ladder: every edge attempted once per replica per event
        assert pt["edge_attempts"].shape == (1, 2)
        assert np.all(pt["edge_attempts"] == 4)
        assert pt["round_trips"].shape == (1, 2, 3)

        # counters accumulate across consecutive sample() calls...
        cont = model.sample(
            1, pt_interval=1, pt_schedule="full_ladder", warmup_ratio=0
        )
        assert np.all(cont["per_disorder"]["parallel_tempering"]["edge_attempts"] == 6)

        # ...and reset() zeroes them
        model.reset()
        fresh = model.sample(
            1, pt_interval=1, pt_schedule="full_ladder", warmup_ratio=0
        )
        assert np.all(
            fresh["per_disorder"]["parallel_tempering"]["edge_attempts"] == 2
        )


class TestValidation:
    def test_unsupported_observe_fails_before_mutation(self):
        model = Ising((4, 4), temperatures=np.array([2.0]), seed=13)
        before = model._sim.get_spins().copy()
        with pytest.raises(ValueError, match="requires cluster_mode='sw'"):
            model.sample(
                1,
                cluster_update_interval=1,
                cluster_mode="wolff",
                cluster_action="observe",
                warmup_ratio=0,
            )
        np.testing.assert_array_equal(model._sim.get_spins(), before)

    def test_bad_autocorrelation_args_fail_before_sampling(self):
        model = Ising((4, 4), temperatures=np.array([1.0, 2.0]), seed=43)
        before = model._sim.get_spins().copy()
        with pytest.raises(ValueError, match="must be 'ring' or 'fft'"):
            model.sample(4, autocorrelation_backend="other", warmup_ratio=0)
        with pytest.raises(ValueError, match="requires autocorrelation_max_lag"):
            model.sample(4, autocorrelation_backend="fft", warmup_ratio=0)
        np.testing.assert_array_equal(model._sim.get_spins(), before)

    def test_overlap_requires_enough_replicas(self):
        model = Ising((4, 4), temperatures=np.array([1.0]), n_replicas=2, seed=3)
        with pytest.raises(ValueError, match="n_replicas >= max group_size"):
            model.sample(
                1,
                overlap_cluster_update_interval=1,
                overlap_cluster_build_mode="houd4",
                warmup_ratio=0,
            )


class TestAutocorrelationBackends:
    def test_default_is_ring_and_fft_agrees(self):
        def taus(backend):
            model = small_glass(37)
            kw = dict(autocorrelation_max_lag=8, warmup_ratio=0, sequential=True)
            if backend is not None:
                kw["autocorrelation_backend"] = backend
            r = model.sample(64, **kw)
            return r["mags2_tau"], r["overlap2_tau"]

        default_m, default_q = taus(None)
        ring_m, _ = taus("ring")
        fft_m, fft_q = taus("fft")
        np.testing.assert_array_equal(default_m, ring_m)
        np.testing.assert_allclose(fft_m, default_m, rtol=0, atol=1e-9)
        np.testing.assert_allclose(fft_q, default_q, rtol=0, atol=1e-9)


class TestCliAndSweepPlumbing:
    def test_cli_and_toml_option_propagation(self, tmp_path):
        argv = (
            "simulate --shape 4 4 --temp-min 1 --temp-max 2 --n-sweeps 2 "
            "--seed 17 --cluster-action observe --pt-schedule full_ladder "
            "--overlap-cluster-action observe --autocorrelation-max-lag 8 "
            "--autocorrelation-backend fft"
        ).split()
        args = build_parser().parse_args(argv)
        assert (args.seed, args.cluster_action) == (17, "observe")
        assert args.pt_schedule == "full_ladder"
        assert args.overlap_cluster_action == "observe"
        assert args.autocorrelation_backend == "fft"

        config = tmp_path / "sweep.toml"
        config.write_text(
            "\n".join(
                [
                    "[sampling]",
                    "seed = 23",
                    "[cluster]",
                    'action = "observe"',
                    "[parallel_tempering]",
                    'schedule = "full_ladder"',
                    "[overlap_cluster]",
                    'action = "observe"',
                    "[diagnostics.autocorrelation]",
                    "max_lag = 8",
                    'backend = "fft"',
                ]
            )
        )
        loaded = _load_sweep_config(config)
        assert loaded["seed"] == 23
        assert loaded["cluster_action"] == "observe"
        assert loaded["pt_schedule"] == "full_ladder"
        assert loaded["overlap_cluster_action"] == "observe"
        assert loaded["autocorrelation_max_lag"] == 8
        assert loaded["autocorrelation_backend"] == "fft"

    def test_child_seeds_stable_and_distinct(self):
        words = _run_seed_words(29)
        seed = _run_child_seed(words, "bimodal", (4, 8))
        assert seed == _run_child_seed(_run_seed_words(29), "bimodal", (4, 8))
        assert seed != _run_child_seed(words, "gaussian", (4, 8))
        assert seed != _run_child_seed(words, "bimodal", (8, 4))

    def test_per_disorder_npz_flattening_roundtrip(self, tmp_path):
        per_disorder = {
            "cluster_observations": {
                "fk": {"observation_count": np.ones((1, 2), dtype=np.uint64)}
            },
            "parallel_tempering": {
                "edge_attempts": np.ones((1, 1), dtype=np.uint64),
                "edge_acceptances": np.zeros((1, 1), dtype=np.uint64),
                "round_trips": np.zeros((1, 2, 2), dtype=np.uint64),
            },
        }
        flat = _flatten_per_disorder_arrays(per_disorder, prefix="4x4")
        path = tmp_path / "result.npz"
        np.savez(path, **flat)
        with np.load(path, allow_pickle=False) as saved:
            assert (
                "4x4_per_disorder_cluster_observations_fk_observation_count"
                in saved
            )
            assert "4x4_per_disorder_pt_edge_attempts" in saved
            assert all(saved[k].dtype != object for k in saved.files)
