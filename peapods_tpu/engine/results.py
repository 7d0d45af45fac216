"""Host-side result accumulation and marshalling into the public dict.

Counterpart of the reference's ``SweepResult`` assembly and disorder
aggregation (``/root/reference/spin-sim/src/statistics/results.rs:56-286``,
``simulation/mod.rs:799-939``) and the PyO3 marshalling layer
(``/root/reference/src/lib.rs:337-617``), whose key names, dtypes, and
presence conditions are reproduced exactly.

The device loop emits per-sweep ``f32`` record tensors and per-chunk integer/
float accumulators; this module reduces them in ``float64``/``uint64`` on the
host (the reference accumulates all statistics in f64 Rust-side), applies the
disorder aggregation semantics (means averaged, histograms summed, per-sample
histograms retained when ``n_disorder > 1``), and assembles the dict.
"""

from __future__ import annotations

import numpy as np

from .loop import N_REC, OBS_KINDS, REC, SERIES
from ..utils.autocorr import AutocorrStream, clamp_max_lag

__all__ = ["HostAccum"]


def _zero_obs_host(d, t, nb):
    return {
        "count": np.zeros((d, t), np.uint64),
        "csd": np.zeros((d, t, nb), np.uint64),
        "top4_frac": np.zeros((d, t, 4), np.float64),
        "bond_frac": np.zeros((d, t), np.float64),
        "winding": np.zeros((d, t, 4), np.uint64),
        "large": np.zeros((d, t), np.float64),
    }


class HostAccum:
    """Accumulates chunk outputs; ``finalize()`` builds the results dict."""

    def __init__(self, program, n_sweeps, warmup_sweeps, n_real=None):
        rt = program.rt
        self.program = program
        self.rt = rt
        self.n_sweeps = int(n_sweeps)
        self.warmup = int(warmup_sweeps)
        self.n_meas = self.n_sweeps - self.warmup
        # The device batch may carry mesh-padding realizations past n_real;
        # every disorder-leading array is sliced to the real count at ingest
        # so aggregation only ever sees genuine samples.
        self.d_real = int(n_real) if n_real is not None else rt.n_disorder
        d, t, nb = self.d_real, rt.n_temps, rt.n_spins + 1

        self.sweeps_seen = 0
        self.rec_sums = np.zeros((d, N_REC, t), np.float64)
        self.n_recorded = 0

        cfg = program.cfg
        self.ac = None
        self.ac_q = None
        if cfg.autocorrelation_max_lag is not None:
            lag = clamp_max_lag(cfg.autocorrelation_max_lag, self.n_meas)
            self.ac = AutocorrStream(lag, d * t, cfg.autocorrelation_backend)
            if program.has_pairs:
                self.ac_q = AutocorrStream(lag, d * t, cfg.autocorrelation_backend)

        self.equil = None
        if cfg.equilibration_diagnostic:
            ckpts = []
            p = 128
            while p < self.n_sweeps:
                ckpts.append(p)
                p *= 2
            if not ckpts or ckpts[-1] != self.n_sweeps:
                ckpts.append(self.n_sweeps)
            # snaps are drained from the on-device checkpoint slots
            # (engine/loop.py ac_equil_block) at the end of sample()
            self.equil = {
                "checkpoints": ckpts,
                "snaps": [],  # (count, e_avg [d,t], ql_avg [d,t])
            }

        self.q_hist = np.zeros((d, t, nb), np.uint64) if program.has_pairs else None
        self.ql_at_q = np.zeros((d, t, nb), np.float64) if program.has_pairs else None
        self.ql2_at_q = np.zeros((d, t, nb), np.float64) if program.has_pairs else None
        self.fk_csd = np.zeros((d, t, nb), np.uint64) if program.collect_fk else None
        self.fk_obs = _zero_obs_host(d, t, nb) if program.observe_fk else None
        if program.collect_overlap:
            m = program.n_modes
            self.overlap_csd = np.zeros((d, m, t, nb), np.uint64)
            self.top4_sum = np.zeros((d, m, t, 4), np.float64)
            self.top4_n = np.zeros((d, m), np.uint64)
        else:
            self.overlap_csd = self.top4_sum = self.top4_n = None
        self.ov_obs = {
            kind: _zero_obs_host(d, t, nb) for kind in program.obs_kinds_used
        }
        self.snapshots = []  # list of dicts

    # ------------------------------------------------------------- ingest

    def add_series(self, block: np.ndarray) -> None:
        """``block``: f32 ``[n_new, n_disorder, N_SERIES, n_temps]``.

        Only produced (and only needed) when autocorrelation or the
        equilibration diagnostic is enabled; all other statistics accumulate
        on device.
        """
        block = np.asarray(block)[:, : self.d_real]
        n_new = block.shape[0]
        start = self.sweeps_seen

        # recorded (post-warmup) slice feeds the FFT autocorrelation series
        # (the ring backend and the equilibration diagnostic accumulate on
        # device; see drain_device_acc)
        lo = max(0, self.warmup - start)
        if lo < n_new:
            n_rec = n_new - lo
            if self.ac is not None and self.ac.backend == "fft":
                self.ac.push_block(
                    block[lo:, :, SERIES["m2_ac"], :].reshape(n_rec, -1)
                )
            if self.ac_q is not None and self.ac_q.backend == "fft":
                self.ac_q.push_block(
                    block[lo:, :, SERIES["q2_ac"], :].reshape(n_rec, -1)
                )

        self.sweeps_seen += n_new

    def drain_device_acc(self, acc) -> None:
        """Fold the run's device accumulators into the f64/u64 host state.

        The whole accumulator pytree is fetched in two batched transfers
        first (utils/fetch.py) — every transfer pays a fixed round-trip
        latency, which leaf-by-leaf ``np.asarray`` would pay per leaf.
        """
        from ..utils.fetch import fetch_pytree

        acc = fetch_pytree(acc)
        get = lambda x: np.asarray(x)[: self.d_real]
        # f32 histogram floats live as (chunk residue, Kahan total) pairs —
        # the chunk residue is zero after the runner-level fold, but both
        # are summed for robustness (engine/loop.py fold_float_hists).
        tot = acc.get("kahan_tot", {})

        def fget(path, leaf):
            chunk = np.asarray(leaf)[: self.d_real].astype(np.float64)
            if path in tot:
                chunk = chunk + np.asarray(tot[path])[: self.d_real]
            return chunk

        self.rec_sums += get(acc["rec_sums"]).astype(np.float64)
        self.n_recorded += int(np.asarray(acc["n_recorded"]))
        if self.q_hist is not None:
            self.q_hist += get(acc["q_hist"]).astype(np.uint64)
            self.ql_at_q += fget("ql_at_q", acc["ql_at_q"])
            self.ql2_at_q += fget("ql2_at_q", acc["ql2_at_q"])
        if self.fk_csd is not None:
            self.fk_csd += get(acc["fk_csd"]).astype(np.uint64)
        if self.fk_obs is not None:
            self._obs_drain(self.fk_obs, acc["fk_obs"], "fk_obs", tot)
        if self.overlap_csd is not None:
            self.overlap_csd += get(acc["overlap_csd"]).astype(np.uint64)
            self.top4_sum += fget("top4_sum", acc["top4_sum"])
            self.top4_n += get(acc["top4_n"]).astype(np.uint64)
        for kind in self.ov_obs:
            self._obs_drain(
                self.ov_obs[kind], acc[f"ov_obs_{kind}"], f"ov_obs_{kind}", tot
            )

        if "ac_sum_prod" in acc and self.ac is not None:
            # device autocorrelation ring: inject the lagged-product sums
            # into the host stream (clamped to its max_lag); the normalize
            # step is unchanged (statistics/autocorrelation.rs:165-186)
            r, t = self.d_real, self.rt.n_temps
            lagp1 = self.ac.max_lag + 1
            sp = np.asarray(acc["ac_sum_prod"], np.float64)[:lagp1, :r]
            so = np.asarray(acc["ac_sum"], np.float64)[:r]
            so2 = np.asarray(acc["ac_sum2"], np.float64)[:r]
            count = int(np.asarray(acc["ac_count"]))

            def inject(stream, ci):
                stream._sum_prod = np.ascontiguousarray(
                    sp[:, :, ci].reshape(lagp1, r * t)
                )
                stream.sum_o = np.ascontiguousarray(
                    so[:, ci].reshape(r * t)
                )
                stream.sum_o2 = np.ascontiguousarray(
                    so2[:, ci].reshape(r * t)
                )
                stream.n_recorded = count

            inject(self.ac, 0)
            if self.ac_q is not None:
                inject(self.ac_q, 1)

        if "eq_ckpt" in acc and self.equil is not None:
            ck = np.asarray(acc["eq_ckpt"], np.float64)[:, : self.d_real]
            sums = np.asarray(acc["eq_sum"], np.float64)[: self.d_real]
            for c in self.equil["checkpoints"]:
                if c == self.n_sweeps:
                    e_avg = sums[:, 0] / self.n_sweeps
                    ql_avg = sums[:, 1] / self.n_sweeps
                else:
                    j = c.bit_length() - 8  # c == 128 * 2**j
                    e_avg = ck[j, :, 0]
                    ql_avg = ck[j, :, 1]
                self.equil["snaps"].append((c, e_avg, ql_avg))

    def _obs_drain(self, host, dev, prefix, tot):
        r = self.d_real

        def fget(field):
            chunk = np.asarray(dev[field])[:r].astype(np.float64)
            path = f"{prefix}/{field}"
            if path in tot:
                chunk = chunk + np.asarray(tot[path])[:r]
            return chunk

        host["count"] += np.asarray(dev["count"])[:r].astype(np.uint64)
        host["csd"] += np.asarray(dev["csd"])[:r].astype(np.uint64)
        host["top4_frac"] += fget("top4_frac")
        host["bond_frac"] += fget("bond_frac")
        host["winding"] += np.asarray(dev["winding"])[:r].astype(np.uint64)
        host["large"] += fget("large")

    def add_snapshot(self, sweep_id, mode_idx, snap, is_cmr) -> None:
        """Record a realization-0 cluster snapshot (mod.rs:682-714)."""
        labels, blue, pair_spins, pair_sids = snap
        entry = {
            "sweep_id": int(sweep_id),
            "mode_idx": int(mode_idx),
            "cluster_ids": np.asarray(labels)[0].astype(np.uint32),
            "spins": np.asarray(pair_spins)[0].astype(np.int8),
            "system_ids": np.asarray(pair_sids)[0].astype(np.uint64),
        }
        if is_cmr:
            entry["blue_ids"] = np.asarray(blue)[0].astype(np.uint32)
        self.snapshots.append(entry)

    # ----------------------------------------------------------- finalize

    def finalize(self, state) -> dict:
        """Build the public results dict (src/lib.rs:337-617 key-for-key)."""
        rt = self.rt
        prog = self.program
        cfg = prog.cfg
        d, t = self.d_real, rt.n_temps
        n_rec = max(self.n_recorded, 0)
        result = {}

        def disorder_mean(x):
            return x.mean(0)

        # mean over (recorded sweeps x replicas), then disorder (results.rs:166-259)
        denom_r = max(n_rec * rt.n_replicas, 1)
        per_d = lambda row: self.rec_sums[:, REC[row], :] / denom_r
        if n_rec == 0:
            nan = np.full((d, t), np.nan)
            per_d = lambda row: nan
        result["mags"] = disorder_mean(per_d("m_sum"))
        result["mags2"] = disorder_mean(per_d("m2_sum"))
        result["mags4"] = disorder_mean(per_d("m4_sum"))
        result["energies"] = disorder_mean(per_d("e_sum"))
        result["energies2"] = disorder_mean(per_d("e2_sum"))

        if prog.has_pairs:
            denom_p = max(n_rec * rt.n_pairs, 1)
            per_p = lambda row: self.rec_sums[:, REC[row], :] / denom_p
            if n_rec == 0:
                per_p = lambda row: np.full((d, t), np.nan)
            result["overlap"] = disorder_mean(per_p("q_sum"))
            result["overlap2"] = disorder_mean(per_p("q2_sum"))
            result["overlap4"] = disorder_mean(per_p("q4_sum"))
            result["link_overlap"] = disorder_mean(per_p("ql_sum"))
            result["link_overlap2"] = disorder_mean(per_p("ql2_sum"))
            result["link_overlap4"] = disorder_mean(per_p("ql4_sum"))

            hist_sum = self.q_hist.sum(0)  # aggregated over disorder
            result["overlap_histogram"] = [hist_sum[i] for i in range(t)]
            result["ql_at_q_sum"] = self.ql_at_q.sum(0)
            result["ql2_at_q_sum"] = self.ql2_at_q.sum(0)
            if d > 1:
                result["per_sample_overlap_histogram"] = self.q_hist.copy()
                result["per_sample_ql_at_q_sum"] = self.ql_at_q.copy()
                result["per_sample_ql2_at_q_sum"] = self.ql2_at_q.copy()

        per_disorder = {}
        cluster_observations = {}
        obs_sets = []
        if self.fk_obs is not None:
            obs_sets.append(("fk", self.fk_obs))
        for kind in OBS_KINDS:
            if kind in self.ov_obs:
                name = "cmr_blue" if kind == "cmr" else kind
                obs_sets.append((name, self.ov_obs[kind]))
        for name, obs in obs_sets:
            # skip the kind unless every realization observed something
            # (src/lib.rs:446-452: summaries.len() == n_realizations)
            if not (obs["count"].sum(1) > 0).all():
                continue
            cnt = obs["count"].astype(np.float64)
            safe = np.maximum(cnt, 1.0)
            graph = {
                "observation_count": obs["count"].copy(),
                "cluster_size_counts": obs["csd"].copy(),
                "top_four_component_fractions": np.where(
                    cnt[..., None] > 0, obs["top4_frac"] / safe[..., None], 0.0
                ),
                "active_bond_density": np.where(
                    cnt > 0, obs["bond_frac"] / safe, 0.0
                ),
                "large_component_count": np.where(cnt > 0, obs["large"] / safe, 0.0),
            }
            if prog.with_winding:
                w = obs["winding"].astype(np.float64)
                for wname, k in [
                    ("winding_x", 0),
                    ("winding_y", 1),
                    ("winding_either", 2),
                    ("winding_both", 3),
                ]:
                    graph[wname] = np.where(cnt > 0, w[..., k] / safe, 0.0)
            cluster_observations[name] = graph
        if cluster_observations:
            per_disorder["cluster_observations"] = cluster_observations

        if cfg.pt_interval is not None:
            per_disorder["parallel_tempering"] = {
                "edge_attempts": np.asarray(state["pt_edge_attempts"])[:d].astype(
                    np.uint64
                ),
                "edge_acceptances": np.asarray(state["pt_edge_acceptances"])[
                    :d
                ].astype(np.uint64),
                "round_trips": np.asarray(state["pt_round_trips"])[:d]
                .astype(np.uint64)
                .reshape(d, rt.n_replicas, t),
            }
        if per_disorder:
            result["per_disorder"] = per_disorder

        if self.fk_csd is not None and self.fk_csd.sum() > 0:
            agg = self.fk_csd.sum(0)
            result["fk_csd"] = [agg[i] for i in range(t)]

        if self.overlap_csd is not None and self.overlap_csd.sum() > 0:
            agg = self.overlap_csd.sum(0)
            result["overlap_csd"] = [
                [agg[m, i] for i in range(t)] for m in range(prog.n_modes)
            ]

        if self.top4_n is not None and self.top4_n.sum() > 0:
            # per-realization average then disorder mean (mod.rs:799-823,
            # results.rs:261-267)
            tops = []
            for m in range(prog.n_modes):
                counts = self.top4_n[:, m].astype(np.float64)
                if counts.sum() == 0:
                    tops.append(np.zeros((0, 4), np.float64))
                    continue
                denom = np.maximum(counts * rt.n_pairs, 1.0)[:, None, None]
                tops.append((self.top4_sum[:, m] / denom).mean(0))
            result["top_cluster_sizes"] = tops

        if self.ac is not None:
            taus = self.ac.taus().reshape(d, t)
            result["mags2_tau"] = taus.mean(0)
        if self.ac_q is not None:
            taus = self.ac_q.taus().reshape(d, t)
            result["overlap2_tau"] = taus.mean(0)

        if self.equil is not None and self.equil["snaps"]:
            snaps = self.equil["snaps"]
            result["equil_sweeps"] = np.array([s[0] for s in snaps], np.uint64)
            result["equil_energy_avg"] = np.stack([s[1].mean(0) for s in snaps])
            result["equil_link_overlap_avg"] = np.stack(
                [s[2].mean(0) for s in snaps]
            )

        if self.snapshots:
            result["cluster_snapshots"] = self.snapshots

        return result
