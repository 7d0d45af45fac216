"""The fused sweep loop: one jitted ``lax.scan`` over sweeps.

Counterpart of the reference hot loop
(``/root/reference/spin-sim/src/simulation/mod.rs:177-858``).  Each scan step
performs, in reference order:

1. multicolor Metropolis/Gibbs pass over all systems,
2. optional FK cluster update (``lax.cond`` on the interval) with CSD /
   graph-observation collection,
3. energy + magnetization recompute from spins (single source of truth),
4. measurement: per-temperature records emitted as scan outputs, overlap
   histograms scatter-added into carried accumulators,
5. optional overlap cluster move (``lax.switch`` over the round-robin mode),
6. optional parallel tempering (single random edge / full ladder).

Everything is batched over disorder realizations (leading axis, ``vmap``) —
the reference's rayon fan-out (mod.rs:887-903) becomes a device batch axis
that ``jax.sharding`` can partition across chips.  Per-sweep scalars
(magnetization moments, energies, overlap moments, autocorrelation series,
equilibration series) are emitted as scan outputs and reduced host-side in
float64; histogram-shaped statistics are carried as on-device accumulators
that the driver drains after every chunk.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cluster as cl
from ..ops import overlap as ov
from ..ops import tempering as pt
from ..ops.energy import energies as compute_energies
from ..ops.energy import energies_and_mags
from ..ops.geometry import GridOps
from ..ops.lattice import Lattice
from ..ops.measure import overlap_dots, per_slot_values, slot_temps_for_systems
from ..ops.sweep import mc_sweep
from ..utils.profiling import phase_scope
from .config import SimConfig

__all__ = ["Runtime", "LoopProgram", "REC", "N_REC", "OBS_KINDS"]

# Row layout of the per-sweep record tensor emitted by the scan.
REC = {
    name: i
    for i, name in enumerate(
        [
            "m_sum",  # sum over replicas of m per temp
            "m2_sum",
            "m4_sum",
            "e_sum",
            "e2_sum",
            "q_sum",  # sum over pairs of q per temp
            "q2_sum",
            "q4_sum",
            "ql_sum",
            "ql2_sum",
            "ql4_sum",
            "m2_ac",  # replica-averaged m^2 (autocorrelation series)
            "q2_ac",  # pair-averaged q^2
            "diag_e",  # replica-averaged energy (equilibration series)
            "diag_ql",  # pair-averaged link overlap
        ]
    )
}
N_REC = len(REC)

OBS_KINDS = ("houdayer", "jorg", "cmr")  # overlap observation accumulator kinds

# Per-sweep series emitted as scan outputs (only when autocorrelation or the
# equilibration diagnostic is configured); everything else accumulates on
# device so a sample() call needs no mid-run host synchronization.
SERIES = {"m2_ac": 0, "q2_ac": 1, "diag_e": 2, "diag_ql": 3}
N_SERIES = len(SERIES)

_PH_SWEEP, _PH_FK, _PH_OVERLAP, _PH_PT = range(1, 5)

# Device-side equilibration checkpoint slots: sweeps 128*2^k
# (equilibration.rs:17-59); 24 slots reach ~1e9 sweeps.  The final
# checkpoint (sweep n_sweeps) is derived host-side from the running sums.
N_EQ_SLOTS = 24


def _kahan_add(total, comp, value):
    """Compensated f32 accumulation: near-f64 running sums while every
    device array stays 32-bit (no global ``jax_enable_x64``)."""
    y = value - comp
    t = total + y
    comp = (t - total) - y
    return t, comp


# f32 histogram-shaped accumulators that scatter-add per sweep.  They stay
# plain f32 within one chunk (<= chunk_len small adds per bin) and are folded
# into a Kahan-compensated running total at every chunk boundary, so
# full-budget runs (tens of thousands of recorded sweeps into hot bins) keep
# near-f64 conditional sums without per-sweep dense traffic.
_F32_HIST_KEYS = ("ql_at_q", "ql2_at_q", "top4_sum")
_F32_OBS_FIELDS = ("top4_frac", "bond_frac", "large")


def _float_hist_paths(acc):
    """Paths (as tuples) of every chunk-local f32 accumulator leaf."""
    paths = [(k,) for k in _F32_HIST_KEYS if k in acc]
    for k in acc:
        if k == "fk_obs" or k.startswith("ov_obs_"):
            paths.extend((k, f) for f in _F32_OBS_FIELDS)
    return paths


@dataclass
class Runtime:
    """Device-resident constants for one model instance."""

    lattice: Lattice
    geom: GridOps
    n_replicas: int
    n_temps: int
    n_disorder: int
    temps_np: np.ndarray  # f32 [n_temps]
    color_masks: jax.Array  # bool [n_colors, n_spins]
    temps: jax.Array  # f32 [n_temps]
    couplings: jax.Array  # f32 [n_disorder, n_spins, n_nb]
    coup_bwd: jax.Array  # f32 [n_disorder, n_spins, n_nb] (J[bwd[i,d], d])
    mesh: object | None = None  # jax.sharding.Mesh

    @classmethod
    def build(cls, lattice, couplings_nd, temps, n_replicas, mesh=None):
        """couplings_nd: f32 [n_disorder, n_spins, n_neighbors] (numpy)."""
        coup = jnp.asarray(couplings_nd, dtype=jnp.float32)
        n_nb = lattice.n_neighbors
        coup_bwd = coup[:, lattice.bwd, np.arange(n_nb)[None, :]]
        return cls(
            lattice=lattice,
            geom=GridOps.from_lattice(lattice),
            n_replicas=int(n_replicas),
            n_temps=int(len(temps)),
            n_disorder=int(coup.shape[0]),
            temps_np=np.asarray(temps, dtype=np.float32),
            color_masks=jnp.asarray(lattice.color_masks()),
            temps=jnp.asarray(temps, dtype=jnp.float32),
            couplings=coup,
            coup_bwd=coup_bwd,
            mesh=mesh,
        )

    @property
    def n_spins(self):
        return self.lattice.n_spins

    @property
    def n_systems(self):
        return self.n_replicas * self.n_temps

    @property
    def n_pairs(self):
        return self.n_replicas // 2

    @property
    def hot_slot(self):
        return int(np.argmax(self.temps_np))

    @property
    def cold_slot(self):
        return int(np.argmin(self.temps_np))


def _zero_obs(n_disorder, n_temps, n_bins):
    """Graph-observation accumulator (mod.rs:17-55), disorder-batched."""
    return {
        "count": jnp.zeros((n_disorder, n_temps), jnp.int32),
        "csd": jnp.zeros((n_disorder, n_temps, n_bins), jnp.int32),
        "top4_frac": jnp.zeros((n_disorder, n_temps, 4), jnp.float32),
        "bond_frac": jnp.zeros((n_disorder, n_temps), jnp.float32),
        "winding": jnp.zeros((n_disorder, n_temps, 4), jnp.int32),
        "large": jnp.zeros((n_disorder, n_temps), jnp.float32),
    }


def _sum_slots_obs(obs, csd_t, n_slots, n_spins, n_neighbors):
    """Reduce per-slot GraphObservations [n_temps, n_slots] to per-temp sums.

    Returns the presummed dict consumed by :func:`_obs_add`; fractions are
    normalized at accumulation time so chunk-level f32 sums stay small.
    """
    wx = obs.winding_x
    wy = obs.winding_y
    winding = jnp.stack([wx, wy, wx | wy, wx & wy], axis=-1).astype(jnp.int32)
    return {
        "count": jnp.full((csd_t.shape[0],), n_slots, jnp.int32),
        "csd": csd_t,
        "top4_frac": obs.top4.astype(jnp.float32).sum(1) / n_spins,
        "bond_frac": obs.active_bonds.astype(jnp.float32).sum(1)
        / (n_spins * n_neighbors),
        "winding": winding.sum(1),
        "large": obs.large_components.astype(jnp.float32).sum(1),
    }


def _obs_add(acc, delta, gate_i32):
    gate_f = gate_i32.astype(jnp.float32)
    return {
        "count": acc["count"] + gate_i32 * delta["count"],
        "csd": acc["csd"] + gate_i32 * delta["csd"],
        "top4_frac": acc["top4_frac"] + gate_f * delta["top4_frac"],
        "bond_frac": acc["bond_frac"] + gate_f * delta["bond_frac"],
        "winding": acc["winding"] + gate_i32 * delta["winding"],
        "large": acc["large"] + gate_f * delta["large"],
    }


class LoopProgram:
    """Compiled sweep-loop program for one (Runtime, SimConfig) pair."""

    def __init__(self, rt: Runtime, cfg: SimConfig):
        import os

        self.rt = rt
        self.cfg = cfg
        c = cfg.cluster_update
        h = cfg.overlap_cluster
        self.collect_fk = c is not None and (c.collect_stats or c.action == "observe")
        self.observe_fk = c is not None and c.action == "observe"
        self.has_pairs = rt.n_pairs > 0
        self.collect_overlap = (
            h is not None
            and (h.collect_stats or h.action == "observe")
            and self.has_pairs
        )
        self.observe_overlap = h is not None and h.action == "observe"
        self.n_modes = len(h.modes) if h is not None else 0
        self.obs_kinds_used = (
            tuple(sorted({m.kind for m in h.modes}))
            if (h and self.observe_overlap)
            else ()
        )
        self.with_winding = rt.lattice.canonical_square_shape is not None
        # Autocorrelation ring + equilibration checkpoints accumulate ON
        # DEVICE (scan-carry ring of the last max_lag values + Kahan lagged
        # sums; running means snapshotted at the 128*2^k sweeps) — the
        # reference's bounded-memory in-core accumulators
        # (statistics/autocorrelation.rs:77-101, equilibration.rs:17-59).
        # Only the FFT backend still needs the raw per-sweep series
        # host-side (it retains the full series by definition).
        self.ac_device = (
            cfg.autocorrelation_max_lag is not None
            and cfg.autocorrelation_backend == "ring"
        )
        self.equil_device = cfg.equilibration_diagnostic
        self.emit_series = (
            cfg.autocorrelation_max_lag is not None
            and cfg.autocorrelation_backend == "fft"
        )
        self.need_series_vals = (
            self.emit_series or self.ac_device or self.equil_device
        )
        # Banded CC under a 'space' mesh: the graphs themselves are split
        # across devices, and the plain CC under GSPMD pays a halo
        # collective per roll per propagation round.
        # connected_components_banded keeps the fixed point local and
        # exchanges two halo label rows per outer round (bitwise the
        # unsharded labeling; tests/test_cluster.py).  PEAPODS_CC_BAND=0
        # reverts to the XLA-partitioned plain CC.
        self.cc_band = (
            rt.mesh is not None
            and "space" in rt.mesh.axis_names
            and (c is not None or h is not None)
            and cl.banded_supports(rt.geom)
            # whole-row bands only: shard_map splits dim 0 of the grid, and
            # connected_components_banded reshapes each shard to full rows —
            # non-divisible extents must keep the GSPMD path (which
            # tolerates uneven sharding) rather than fail at trace time.
            and rt.lattice.shape[0] % rt.mesh.shape["space"] == 0
            and os.environ.get("PEAPODS_CC_BAND") != "0"
        )
        self._cc_band_b = (
            int(
                np.prod(
                    [
                        rt.mesh.shape[a]
                        for a in ("disorder", "systems")
                        if a in rt.mesh.axis_names
                    ],
                    dtype=np.int64,
                )
            )
            if self.cc_band
            else 1
        )
        from ..utils.log import log_once

        if (
            rt.mesh is not None
            and "space" in rt.mesh.axis_names
            and not self.cc_band
            and (c is not None or h is not None)
        ):
            log_once(
                "space-sharded mesh: cluster labeling uses the plain CC path "
                "(banded CC disabled or geometry unsupported)"
            )
        self._chunk_cache = {}
        self._snap_fn = None
        log_once(f"engine plan: {self.describe_plan()}")

    def describe_plan(self) -> str:
        """One-line summary of the path and mesh choices this program made
        (the user-facing answer to "which path did my run take?")."""
        rt = self.rt
        parts = ["sweep=jnp"]
        if self.cfg.cluster_update is not None or self.cfg.overlap_cluster:
            parts.append("cc=jnp-banded" if self.cc_band else "cc=jnp")
        if rt.mesh is not None and rt.mesh.devices.size > 1:
            parts.append(
                "mesh=" + "x".join(
                    f"{n}:{s}" for n, s in rt.mesh.shape.items()
                )
            )
        return ", ".join(parts)

    # ------------------------------------------------------------------ acc

    def init_accumulators(self):
        rt = self.rt
        n_bins = rt.n_spins + 1
        d, t = rt.n_disorder, rt.n_temps
        acc = {
            "rec_sums": jnp.zeros((d, N_REC, t), jnp.float32),
            "rec_comp": jnp.zeros((d, N_REC, t), jnp.float32),
            "n_recorded": jnp.int32(0),
        }
        if self.has_pairs:
            acc["q_hist"] = jnp.zeros((d, t, n_bins), jnp.int32)
            acc["ql_at_q"] = jnp.zeros((d, t, n_bins), jnp.float32)
            acc["ql2_at_q"] = jnp.zeros((d, t, n_bins), jnp.float32)
        if self.collect_fk:
            acc["fk_csd"] = jnp.zeros((d, t, n_bins), jnp.int32)
        if self.observe_fk:
            acc["fk_obs"] = _zero_obs(d, t, n_bins)
        if self.collect_overlap:
            acc["overlap_csd"] = jnp.zeros((d, self.n_modes, t, n_bins), jnp.int32)
            acc["top4_sum"] = jnp.zeros((d, self.n_modes, t, 4), jnp.float32)
            acc["top4_n"] = jnp.zeros((d, self.n_modes), jnp.int32)
        for kind in self.obs_kinds_used:
            acc[f"ov_obs_{kind}"] = _zero_obs(d, t, n_bins)
        if self.ac_device:
            lag = int(self.cfg.autocorrelation_max_lag)
            c = 2 if self.has_pairs else 1
            acc["ac_ring"] = jnp.zeros((lag, d, c, t), jnp.float32)
            acc["ac_sum_prod"] = jnp.zeros((lag + 1, d, c, t), jnp.float32)
            acc["ac_sum_prod_c"] = jnp.zeros((lag + 1, d, c, t), jnp.float32)
            acc["ac_sum"] = jnp.zeros((d, c, t), jnp.float32)
            acc["ac_sum_c"] = jnp.zeros((d, c, t), jnp.float32)
            acc["ac_sum2"] = jnp.zeros((d, c, t), jnp.float32)
            acc["ac_sum2_c"] = jnp.zeros((d, c, t), jnp.float32)
            acc["ac_count"] = jnp.int32(0)
        if self.equil_device:
            acc["eq_sum"] = jnp.zeros((d, 2, t), jnp.float32)
            acc["eq_sum_c"] = jnp.zeros((d, 2, t), jnp.float32)
            acc["eq_ckpt"] = jnp.zeros((N_EQ_SLOTS, d, 2, t), jnp.float32)
        self._float_paths = _float_hist_paths(acc)
        if self._float_paths:
            # distinct arrays per slot — donation rejects aliased buffers
            acc["kahan_tot"] = {
                "/".join(p): jnp.zeros_like(self._leaf(acc, p))
                for p in self._float_paths
            }
            acc["kahan_comp"] = {
                "/".join(p): jnp.zeros_like(self._leaf(acc, p))
                for p in self._float_paths
            }
        return acc

    @staticmethod
    def _leaf(acc, path):
        return acc[path[0]] if len(path) == 1 else acc[path[0]][path[1]]

    def fold_float_hists(self, acc):
        """Fold chunk-local f32 scatter sums into the Kahan totals and zero
        the chunk parts; runs inside every chunk/snapshot runner."""
        if not getattr(self, "_float_paths", None):
            return acc
        acc = dict(acc)
        tot = dict(acc["kahan_tot"])
        comp = dict(acc["kahan_comp"])
        for p in self._float_paths:
            name = "/".join(p)
            leaf = self._leaf(acc, p)
            tot[name], comp[name] = _kahan_add(tot[name], comp[name], leaf)
            zero = jnp.zeros_like(leaf)
            if len(p) == 1:
                acc[p[0]] = zero
            else:
                acc[p[0]] = dict(acc[p[0]])
                acc[p[0]][p[1]] = zero
        acc["kahan_tot"] = tot
        acc["kahan_comp"] = comp
        return acc

    def ac_equil_block(self, acc, series_vals, xs, warmup):
        """Fold a block of per-sweep series values into the on-device
        autocorrelation ring and equilibration accumulators.

        Args:
            acc: accumulator dict (returned updated).
            series_vals: f32 ``[n, d, N_SERIES, T]`` UNGATED per-sweep values
                (rows: m2_ac, q2_ac, diag_e, diag_ql).
            xs: ``int32 [n]`` absolute sweep indices (-1 sentinels).
            warmup: traced scalar warmup sweep count.

        The ring advances only on recorded (post-warmup) sweeps, matching
        the host :class:`AutocorrStream`; the equilibration sums consume
        every active sweep (mod.rs:511,531) and snapshot the running mean at
        sweeps 128*2^k.
        """
        if not (self.ac_device or self.equil_device):
            return acc
        acc = dict(acc)
        n = series_vals.shape[0]
        c = 2 if self.has_pairs else 1

        def body(i, a):
            a = dict(a)
            x = xs[i]
            active = x >= 0
            if self.ac_device:
                rec = active & (x >= warmup)
                g = rec.astype(jnp.float32)
                v = jax.lax.dynamic_slice_in_dim(
                    series_vals, i, 1, 0
                )[0, :, :c, :]  # [d, c, T]
                ring = a["ac_ring"]
                lag = ring.shape[0]
                lagged = jnp.concatenate([v[None], ring], axis=0)
                # pairs (t, t - delta) exist iff delta <= #previously
                # recorded values
                ok = (
                    (jnp.arange(lag + 1) <= a["ac_count"]).astype(jnp.float32)
                    * g
                )
                a["ac_sum_prod"], a["ac_sum_prod_c"] = _kahan_add(
                    a["ac_sum_prod"], a["ac_sum_prod_c"],
                    v[None] * lagged * ok[:, None, None, None],
                )
                a["ac_sum"], a["ac_sum_c"] = _kahan_add(
                    a["ac_sum"], a["ac_sum_c"], v * g
                )
                a["ac_sum2"], a["ac_sum2_c"] = _kahan_add(
                    a["ac_sum2"], a["ac_sum2_c"], v * v * g
                )
                a["ac_ring"] = jnp.where(
                    g > 0, jnp.concatenate([v[None], ring[:-1]], axis=0), ring
                )
                a["ac_count"] = a["ac_count"] + rec.astype(jnp.int32)
            if self.equil_device:
                dv = jax.lax.dynamic_slice_in_dim(
                    series_vals, i, 1, 0
                )[0, :, 2:4, :]  # [d, 2, T] (diag_e, diag_ql)
                af = active.astype(jnp.float32)
                a["eq_sum"], a["eq_sum_c"] = _kahan_add(
                    a["eq_sum"], a["eq_sum_c"], dv * af
                )
                count = x + 1
                is_ck = active & (count >= 128) & ((count & (count - 1)) == 0)
                slot = jnp.clip(
                    jnp.round(
                        jnp.log2(jnp.maximum(count, 1).astype(jnp.float32))
                    ).astype(jnp.int32)
                    - 7,
                    0,
                    N_EQ_SLOTS - 1,
                )
                avg = a["eq_sum"] / jnp.maximum(count, 1).astype(jnp.float32)
                a["eq_ckpt"] = a["eq_ckpt"].at[slot].set(
                    jnp.where(is_ck, avg, a["eq_ckpt"][slot])
                )
            return a

        return jax.lax.fori_loop(0, n, body, acc)

    # --------------------------------------------------------------- phases

    def _sweep_phase(self, spins, sid, key, coup, coup_bwd):
        rt = self.rt
        sys_temps = slot_temps_for_systems(sid, rt.temps)
        skey = jax.random.fold_in(key, _PH_SWEEP)
        gibbs = self.cfg.sweep_mode == "gibbs"
        return mc_sweep(
            spins,
            coup,
            coup_bwd,
            rt.geom,
            rt.color_masks,
            sys_temps,
            skey,
            gibbs=gibbs,
        )

    def _cc_many(self, active_flat):
        """Connected components over a flat graph batch.

        ``active_flat``: ``bool [B, n_spins, n_nb]`` (disorder-major when a
        mesh shards disorder).  Under a ``space`` mesh the banded CC runs
        inside ``shard_map``; otherwise one vmapped fixed point labels the
        whole batch.
        """
        rt = self.rt
        mesh = rt.mesh
        if self.cc_band and active_flat.shape[0] % self._cc_band_b == 0:
            from jax.sharding import PartitionSpec as P

            batch = tuple(
                a for a in ("disorder", "systems") if a in mesh.axis_names
            )
            call = jax.shard_map(
                lambda a: cl.connected_components_banded(
                    a, rt.geom, axis="space",
                    sync_axes=tuple(mesh.axis_names),
                ),
                mesh=mesh,
                in_specs=P(batch if batch else None, "space", None),
                out_specs=P(batch if batch else None, "space"),
                check_vma=False,
            )
            return call(active_flat)
        if self.cc_band:
            # The plan string advertises cc=jnp-banded; make the per-call
            # fallback (batch not divisible over the disorder/systems axes,
            # e.g. odd overlap-task counts) visible rather than silent.
            from ..utils.log import log_once

            log_once(
                "banded CC: graph batch of "
                f"{active_flat.shape[0]} does not divide the mesh batch "
                f"factor {self._cc_band_b}; this call uses the plain CC"
            )
        return jax.vmap(lambda a: cl.connected_components(a, rt.geom))(
            active_flat
        )

    def _fk_phase_batched(self, spins, sid, keys):
        """FK update over the full ``[n_disorder, n_systems]`` batch.

        Bond activation and the post-CC work stay vmapped per disorder; the
        CC fixed point runs ONCE over the flattened graph batch through
        :meth:`_cc_many` (the reference runs per-graph union-find inside its
        rayon fan-out, clusters/fk.rs:28-171 — here the batch is the
        parallelism axis).  Returns ``(spins, csd_t, obs_delta)`` with
        leading disorder axes.
        """
        rt = self.rt
        cfgc = self.cfg.cluster_update
        wolff = cfgc.mode == "wolff"
        update = cfgc.action == "update"
        d = spins.shape[0]

        def bonds_per_disorder(spins_d, sid_d, key_d, coup_d):
            sys_temps = slot_temps_for_systems(sid_d, rt.temps)
            ks2 = jax.random.split(
                jax.random.fold_in(key_d, _PH_FK), rt.n_systems
            )

            def one(s, temp, k):
                kb, kf = jax.random.split(k)
                return cl.fk_bond_activation(s, coup_d, rt.geom, temp, kb), kf

            return jax.vmap(one)(spins_d, sys_temps, ks2)

        active, keys_flip = jax.vmap(bonds_per_disorder)(
            spins, sid, keys, rt.couplings
        )
        labels = self._cc_many(
            active.reshape(
                d * rt.n_systems, rt.n_spins, rt.lattice.n_neighbors
            )
        ).reshape(d, rt.n_systems, rt.n_spins)

        def finish_per_disorder(spins_d, active_d, labels_d, keys_d, sid_d):
            def one(s, act, lab, k):
                counts = (
                    cl.component_counts(lab)
                    if (self.collect_fk or self.observe_fk)
                    else None
                )
                if wolff:
                    seed = jax.random.randint(k, (), 0, rt.n_spins)
                    flip = cl.wolff_flip_mask(lab, seed)
                else:
                    flip = cl.cluster_coin_flip_mask(k, lab)
                new_s = jnp.where(flip, -s, s) if update else s
                csd = cl.csd_histogram(counts) if self.collect_fk else None
                obs = (
                    cl.graph_observation(
                        act, counts, lab, rt.geom, self.with_winding
                    )
                    if self.observe_fk
                    else None
                )
                return new_s, csd, obs

            new_spins, csd_sys, obs_sys = jax.vmap(one)(
                spins_d, active_d, labels_d, keys_d
            )
            csd_t = None
            obs_delta = None
            if self.collect_fk:
                # per-slot -> per-temp (mod.rs:471-477)
                csd_t = csd_sys[sid_d].sum(0)
            if self.observe_fk:
                # reorder per-system fields to [n_temps, n_replicas]
                slot = lambda x: jnp.swapaxes(x[sid_d], 0, 1)
                obs_slot = cl.GraphObservation(
                    top4=slot(obs_sys.top4),
                    active_bonds=slot(obs_sys.active_bonds),
                    winding_x=slot(obs_sys.winding_x),
                    winding_y=slot(obs_sys.winding_y),
                    large_components=slot(obs_sys.large_components),
                )
                obs_delta = _sum_slots_obs(
                    obs_slot, csd_t, rt.n_replicas, rt.n_spins,
                    rt.lattice.n_neighbors,
                )
            return new_spins, csd_t, obs_delta

        return jax.vmap(finish_per_disorder)(
            spins, active, labels, keys_flip, sid
        )

    def _run_tasks_batched(self, mode, tspins, tkeys, with_snapshot):
        """Run one overlap mode over the FULL task batch, with the CC fixed
        points hoisted through :meth:`_cc_many` (one batched labeling per CC
        round instead of one per task — the reference's per-task union-find
        over rayon, clusters/overlap.rs:64-144, becomes one batch).

        ``tspins``: int8 ``[n_disorder, n_tasks, group_size, n_spins]``
        (tasks temp-major); ``tkeys``: ``[n_disorder, n_tasks]`` keys.
        Returns :class:`OverlapMoveOut` with leading ``[n_disorder,
        n_tasks]`` axes.
        """
        rt = self.rt
        h = self.cfg.overlap_cluster
        wolff = h.cluster_mode == "wolff"
        update = h.action == "update"
        winding = self.with_winding and self.observe_overlap
        with_stats = self.collect_overlap or self.observe_overlap
        g = mode.group_size
        n_groups = rt.n_replicas // g
        d, n_tasks = tspins.shape[:2]
        task_temps = jnp.repeat(rt.temps, n_groups)  # [n_tasks]
        flat = lambda x: x.reshape((d * n_tasks,) + x.shape[2:])
        unflat = lambda x: x.reshape((d, n_tasks) + x.shape[1:])

        if mode.kind == "houdayer":
            bonds, aux = jax.vmap(jax.vmap(
                lambda ts, k: ov.houdayer_bonds(ts, k, rt.geom)
            ))(tspins, tkeys)
            labels = unflat(self._cc_many(flat(bonds)))
            out = jax.vmap(jax.vmap(
                lambda ts, lab, bo, au: ov.houdayer_finish(
                    ts, lab, bo, au, rt.geom, wolff=wolff, update=update,
                    with_winding=winding, with_stats=with_stats,
                )
            ))(tspins, labels, bonds, aux)
        elif mode.kind == "jorg":
            def build_d(ts_d, k_d, coup_d):
                return jax.vmap(
                    lambda ts, tp, k: ov.jorg_bonds(
                        ts, k, coup_d, tp, rt.geom
                    )
                )(ts_d, task_temps, k_d)

            bonds, aux = jax.vmap(build_d)(tspins, tkeys, rt.couplings)
            labels = unflat(self._cc_many(flat(bonds)))
            out = jax.vmap(jax.vmap(
                lambda ts, lab, bo, au: ov.jorg_finish(
                    ts, lab, bo, au, rt.geom, wolff=wolff, update=update,
                    with_winding=winding, with_stats=with_stats,
                )
            ))(tspins, labels, bonds, aux)
        else:  # cmr: two CC rounds (blue, then grey)
            def build_d(ts_d, k_d, coup_d):
                return jax.vmap(
                    lambda ts, tp, k: ov.cmr_blue_bonds(
                        ts, k, coup_d, tp, rt.geom
                    )
                )(ts_d, task_temps, k_d)

            blue, aux = jax.vmap(build_d)(tspins, tkeys, rt.couplings)
            blue_labels = unflat(self._cc_many(flat(blue)))

            def mid_d(ts_d, bl_d, b_d, au_d, coup_d):
                return jax.vmap(
                    lambda ts, bl, b, au: ov.cmr_mid(
                        ts, bl, b, au, coup_d, rt.geom, wolff=wolff,
                        update=update, with_winding=winding,
                        with_stats=with_stats,
                    )
                )(ts_d, bl_d, b_d, au_d)

            tsp2, grey_bonds, carry = jax.vmap(mid_d)(
                tspins, blue_labels, blue, aux, rt.couplings
            )
            grey_labels = unflat(self._cc_many(flat(grey_bonds)))
            out = jax.vmap(jax.vmap(
                lambda ts, gl, gb, bl, ca: ov.cmr_finish(
                    ts, gl, gb, bl, ca, rt.geom, wolff=wolff, update=update
                )
            ))(tsp2, grey_labels, grey_bonds, blue_labels, carry)
        if not (with_stats or with_snapshot):
            out = out._replace(labels=None, blue_labels=None, counts=None)
        return out

    def _task_stats(self, out, n_groups):
        """Per-temperature stats reduction of a task batch (temps-major
        order); returns ``(csd_t, top4_frac, obs_delta)`` or Nones."""
        rt = self.rt
        nb = rt.n_spins + 1
        if not (self.collect_overlap or self.observe_overlap):
            return None, None, None
        csd_t = out.csd.reshape(rt.n_temps, n_groups, nb).sum(1)
        by_temp = lambda x: x.reshape((rt.n_temps, n_groups) + x.shape[1:])
        obs_temp = cl.GraphObservation(
            top4=by_temp(out.obs.top4),
            active_bonds=by_temp(out.obs.active_bonds),
            winding_x=by_temp(out.obs.winding_x),
            winding_y=by_temp(out.obs.winding_y),
            large_components=by_temp(out.obs.large_components),
        )
        obs_delta = _sum_slots_obs(
            obs_temp, csd_t, n_groups, rt.n_spins, rt.lattice.n_neighbors
        )
        return csd_t, obs_delta["top4_frac"], obs_delta

    def _overlap_branch(self, mode, with_snapshot):
        """Build one disorder-batched ``lax.switch`` branch; all branches
        share output shapes.

        Cluster statistics (scatter-heavy) and snapshot payloads are built
        only when collected — XLA does not reliably dead-code them through
        the event ``lax.cond``, and they would otherwise dominate the event
        cost.  The branch takes the full ``[n_disorder, ...]`` batch
        so the CC fixed points inside :meth:`_run_tasks_batched` can run
        once over every (disorder, temp, group) task.
        """
        rt = self.rt
        g = mode.group_size
        n_groups = rt.n_replicas // g
        n_tasks = rt.n_temps * n_groups

        def branch(spins, sid, keys):
            d = spins.shape[0]

            def tasks_d(sid_d, key_d):
                k_shuffle, k_tasks = jax.random.split(
                    jax.random.fold_in(key_d, _PH_OVERLAP)
                )
                tasks = ov.build_tasks(sid_d, k_shuffle, g)  # [T, G, g]
                tkeys = jax.random.split(k_tasks, n_tasks)
                return tasks, tkeys

            tasks, tkeys = jax.vmap(tasks_d)(sid, keys)
            flat_idx = tasks.reshape(d, n_tasks, g)
            tspins = jax.vmap(lambda s, f: s[f])(spins, flat_idx)
            out = self._run_tasks_batched(mode, tspins, tkeys, with_snapshot)
            new_spins = jax.vmap(
                lambda s, f, o: s.at[f.reshape(-1)].set(
                    o.reshape(-1, rt.n_spins)
                )
            )(spins, flat_idx, out.spins)

            csd_t, top4_frac, obs_delta = jax.vmap(
                lambda o: self._task_stats(o, n_groups)
            )(out)

            if with_snapshot:
                # Snapshot payload: first group per temperature, first two
                # replicas, pre-move spins (mod.rs:682-714).
                labels_bt = out.labels.reshape(
                    d, rt.n_temps, n_groups, -1
                )[:, :, 0]
                blue_bt = out.blue_labels.reshape(
                    d, rt.n_temps, n_groups, -1
                )[:, :, 0]
                pair_sids = tasks[:, :, 0, :2]
                pair_spins = tspins.reshape(
                    d, rt.n_temps, n_groups, g, -1
                )[:, :, 0, :2]
                snap = (labels_bt, blue_bt, pair_spins, pair_sids)
            else:
                snap = None
            return new_spins, csd_t, top4_frac, obs_delta, snap

        return branch

    def _pt_phase(self, spins, sid, key, coup, parity, pt_state, e=None):
        """PT event for one realization.

        Energies are re-derived from spins when an overlap move may have
        mutated them this sweep (mod.rs:748-754); otherwise the values from
        the measurement phase are reused (mod.rs:492-509 computes once).
        """
        rt = self.rt
        if e is None:
            e = compute_energies(spins, coup, rt.geom)
        k = jax.random.fold_in(key, _PH_PT)
        att, acc_, rtrips, ts = pt_state
        if self.cfg.pt_schedule == "full_ladder":
            sid, att, acc_, rtrips, ts = pt.pt_full_ladder(
                e, sid, rt.temps, k, rt.n_spins, parity,
                att, acc_, rtrips, ts, rt.hot_slot, rt.cold_slot,
            )
        else:
            sid, att, acc_, rtrips, ts = pt.pt_single_random_edge(
                e, sid, rt.temps, k, rt.n_spins,
                att, acc_, rtrips, ts, rt.hot_slot, rt.cold_slot,
            )
        return sid, (att, acc_, rtrips, ts)

    def _measure_phase(self, spins, sid, coup):
        """Per-sweep records + histogram deltas + energies for one realization.

        Energies and magnetizations are re-derived from spins (the
        reference's single-source-of-truth recompute, mod.rs:492-509).
        """
        rt = self.rt
        n = rt.n_spins
        e, msum = energies_and_mags(spins, coup, rt.geom)
        m_rt = per_slot_values(msum, sid).astype(jnp.float32) / n  # [R, T]
        e_rt = per_slot_values(e, sid)
        rec = jnp.zeros((N_REC, rt.n_temps), jnp.float32)
        m2 = m_rt * m_rt
        rec = rec.at[REC["m_sum"]].set(m_rt.sum(0))
        rec = rec.at[REC["m2_sum"]].set(m2.sum(0))
        rec = rec.at[REC["m4_sum"]].set((m2 * m2).sum(0))
        rec = rec.at[REC["e_sum"]].set(e_rt.sum(0))
        rec = rec.at[REC["e2_sum"]].set((e_rt * e_rt).sum(0))
        rec = rec.at[REC["m2_ac"]].set(m2.sum(0) / rt.n_replicas)
        rec = rec.at[REC["diag_e"]].set(e_rt.sum(0) / rt.n_replicas)

        hist_delta = None
        if self.has_pairs:
            dot_spin, dot_link = overlap_dots(spins, sid, rt.geom)  # [P, T]
            n_bonds = n * rt.lattice.n_neighbors
            q = dot_spin.astype(jnp.float32) / n
            ql = dot_link.astype(jnp.float32) / n_bonds
            q2 = q * q
            ql2 = ql * ql
            rec = rec.at[REC["q_sum"]].set(q.sum(0))
            rec = rec.at[REC["q2_sum"]].set(q2.sum(0))
            rec = rec.at[REC["q4_sum"]].set((q2 * q2).sum(0))
            rec = rec.at[REC["ql_sum"]].set(ql.sum(0))
            rec = rec.at[REC["ql2_sum"]].set(ql2.sum(0))
            rec = rec.at[REC["ql4_sum"]].set((ql2 * ql2).sum(0))
            rec = rec.at[REC["q2_ac"]].set(q2.sum(0) / rt.n_pairs)
            rec = rec.at[REC["diag_ql"]].set(ql.sum(0) / rt.n_pairs)
            idx = (dot_spin + n) // 2  # histogram bin (overlap.rs:303)
            hist_delta = (idx, ql)
        return rec, hist_delta, e

    # ----------------------------------------------------------------- step

    def make_step(self, with_snapshot=False):
        step_body = self._make_step_body(with_snapshot)
        skip = self._make_step_skip(with_snapshot)

        def step(carry, sweep_local):
            # Chunks are padded to a fixed compiled length with sweep_local=-1
            # sentinels (cheap cond-skip) so each config compiles exactly once.
            active = sweep_local >= 0
            return jax.lax.cond(active, step_body, skip, carry, sweep_local)

        return step

    def _make_step_skip(self, with_snapshot):
        rt = self.rt

        def skip(carry, sweep_local):
            state, acc = carry
            if self.emit_series:
                series = jnp.zeros(
                    (rt.n_disorder, N_SERIES, rt.n_temps), jnp.float32
                )
            else:
                series = None
            if with_snapshot:
                return (state, acc), (series, self._dummy_snap())
            return (state, acc), series

        return skip

    def _dummy_snap(self):
        rt = self.rt
        return (
            jnp.zeros((rt.n_disorder, rt.n_temps, rt.n_spins), jnp.int32),
            jnp.zeros((rt.n_disorder, rt.n_temps, rt.n_spins), jnp.int32),
            jnp.zeros((rt.n_disorder, rt.n_temps, 2, rt.n_spins), jnp.int8),
            jnp.zeros((rt.n_disorder, rt.n_temps, 2), jnp.int32),
        )

    def _make_step_body(self, with_snapshot):
        rt = self.rt
        cfg = self.cfg
        c = cfg.cluster_update
        h = cfg.overlap_cluster

        branches = [
            self._overlap_branch(m, with_snapshot) for m in (h.modes if h else [])
        ]
        mode_kinds = (
            np.array([OBS_KINDS.index(m.kind) for m in h.modes], dtype=np.int32)
            if h
            else None
        )

        def step_body(carry, sweep_local):
            state, acc = carry
            counter = state["counter"]
            record = sweep_local >= state["warmup"]
            rec_i32 = record.astype(jnp.int32)
            rec_f32 = record.astype(jnp.float32)
            keys = jax.vmap(lambda k: jax.random.fold_in(k, counter))(
                state["base_keys"]
            )
            spins, sid = state["spins"], state["system_ids"]

            # 1. single-spin sweep
            with phase_scope("sweep"):
                spins = jax.vmap(self._sweep_phase)(
                    spins, sid, keys, rt.couplings, rt.coup_bwd
                )

            # 2. FK cluster update
            if c is not None:
                do_cluster = (sweep_local % c.interval) == 0

                def run_fk(args):
                    spins, acc = args
                    new_spins, csd_t, obs_delta = self._fk_phase_batched(
                        spins, sid, keys
                    )
                    acc = dict(acc)
                    if self.collect_fk:
                        acc["fk_csd"] = acc["fk_csd"] + rec_i32 * csd_t
                    if self.observe_fk:
                        acc["fk_obs"] = jax.vmap(
                            lambda a, d: _obs_add(a, d, rec_i32)
                        )(acc["fk_obs"], obs_delta)
                    return new_spins, acc

                spins, acc = jax.lax.cond(
                    do_cluster, run_fk, lambda args: args, (spins, acc)
                )

            # 3+4. measurement (energies/mags recomputed from spins)
            with phase_scope("measure"):
                rec, hist_delta, e_sys = jax.vmap(self._measure_phase)(
                    spins, sid, rt.couplings
                )
            acc = dict(acc)
            acc["rec_sums"], acc["rec_comp"] = _kahan_add(
                acc["rec_sums"], acc["rec_comp"], rec * rec_f32
            )
            acc["n_recorded"] = acc["n_recorded"] + rec_i32
            series = None
            if self.need_series_vals:
                svals = jnp.stack(
                    [
                        rec[:, REC["m2_ac"], :],
                        rec[:, REC["q2_ac"], :],
                        rec[:, REC["diag_e"], :],
                        rec[:, REC["diag_ql"], :],
                    ],
                    axis=1,
                )  # [D, N_SERIES, T]
                acc = self.ac_equil_block(
                    acc, svals[None], sweep_local[None], state["warmup"]
                )
                if self.emit_series:
                    series = svals
            if self.has_pairs:
                idx, ql = hist_delta  # each [D, P, T]
                t_cols = jnp.broadcast_to(
                    jnp.arange(rt.n_temps)[None, :], idx.shape[1:]
                )

                def upd_hist(qh, qla, qla2, ix, qlv):
                    qh = qh.at[t_cols, ix].add(rec_i32)
                    qla = qla.at[t_cols, ix].add(rec_f32 * qlv)
                    qla2 = qla2.at[t_cols, ix].add(rec_f32 * qlv * qlv)
                    return qh, qla, qla2

                acc = dict(acc)
                acc["q_hist"], acc["ql_at_q"], acc["ql2_at_q"] = jax.vmap(upd_hist)(
                    acc["q_hist"], acc["ql_at_q"], acc["ql2_at_q"], idx, ql
                )

            # 5. overlap cluster move
            snap_out = self._dummy_snap() if with_snapshot else None
            if h is not None:
                do_overlap = (sweep_local % h.interval) == 0
                mode_idx = (sweep_local // h.interval) % self.n_modes

                def run_overlap(args):
                    spins, acc, _ = args

                    new_spins, csd_t, top4_frac, obs_delta, snap = (
                        jax.lax.switch(mode_idx, branches, spins, sid, keys)
                    )
                    acc = dict(acc)
                    if self.collect_overlap:
                        acc["overlap_csd"] = (
                            acc["overlap_csd"].at[:, mode_idx].add(rec_i32 * csd_t)
                        )
                        acc["top4_sum"] = (
                            acc["top4_sum"].at[:, mode_idx].add(rec_f32 * top4_frac)
                        )
                        acc["top4_n"] = acc["top4_n"].at[:, mode_idx].add(rec_i32)
                    if self.observe_overlap:
                        active_kind = jnp.asarray(mode_kinds)[mode_idx]
                        for kind in self.obs_kinds_used:
                            gate = rec_i32 * (
                                active_kind == OBS_KINDS.index(kind)
                            ).astype(jnp.int32)
                            acc[f"ov_obs_{kind}"] = jax.vmap(
                                lambda a, d: _obs_add(a, d, gate)
                            )(acc[f"ov_obs_{kind}"], obs_delta)
                    return new_spins, acc, snap

                spins, acc, snap_out = jax.lax.cond(
                    do_overlap,
                    run_overlap,
                    lambda args: args,
                    (spins, acc, snap_out),
                )

            # 6. parallel tempering
            if cfg.pt_interval is not None and rt.n_temps >= 2:
                do_pt = (sweep_local % cfg.pt_interval) == 0

                def run_pt(args):
                    sid, att, pacc, rtrips, ts, parity = args
                    # reuse measured energies unless an overlap move mutated
                    # spins after measurement THIS sweep (mod.rs:748-754);
                    # observe-mode moves mutate nothing, and recomputing for
                    # them could flip a threshold-marginal PT decision via a
                    # different f32 sum order than the measured energies,
                    # breaking the observe == observer-free bitwise invariant
                    if h is None or h.action != "update":
                        e_use = e_sys
                    else:
                        e_use = jax.lax.cond(
                            do_overlap,
                            lambda: jax.vmap(
                                lambda s, cp: compute_energies(s, cp, rt.geom)
                            )(spins, rt.couplings),
                            lambda: e_sys,
                        )

                    def one(s, si, k, cp, a, b, r, t, e):
                        return self._pt_phase(
                            s, si, k, cp, parity, (a, b, r, t), e=e
                        )

                    new_sid, (att, pacc, rtrips, ts) = jax.vmap(one)(
                        spins, sid, keys, rt.couplings, att, pacc, rtrips, ts,
                        e_use,
                    )
                    if cfg.pt_schedule == "full_ladder":
                        parity = 1 - parity
                    return new_sid, att, pacc, rtrips, ts, parity

                sid, att, pacc, rtrips, ts, parity = jax.lax.cond(
                    do_pt,
                    run_pt,
                    lambda args: args,
                    (
                        sid,
                        state["pt_edge_attempts"],
                        state["pt_edge_acceptances"],
                        state["pt_round_trips"],
                        state["pt_trip_state"],
                        state["pt_parity"],
                    ),
                )
            else:
                att = state["pt_edge_attempts"]
                pacc = state["pt_edge_acceptances"]
                rtrips = state["pt_round_trips"]
                ts = state["pt_trip_state"]
                parity = state["pt_parity"]

            new_state = {
                "spins": spins,
                "system_ids": sid,
                "base_keys": state["base_keys"],
                "counter": counter + 1,
                "warmup": state["warmup"],
                "pt_edge_attempts": att,
                "pt_edge_acceptances": pacc,
                "pt_round_trips": rtrips,
                "pt_trip_state": ts,
                "pt_parity": parity,
            }
            if with_snapshot:
                return (new_state, acc), (series, snap_out)
            return (new_state, acc), series

        return step_body

    # ------------------------------------------------------------- runners

    def chunk_runner(self, chunk_len: int):
        """Jitted scan over ``chunk_len`` sweeps (cached per length)."""
        if chunk_len not in self._chunk_cache:
            step = self.make_step(with_snapshot=False)

            @functools.partial(jax.jit, donate_argnums=(0,))
            def run(carry, xs):
                (state, acc), ys = jax.lax.scan(step, carry, xs)
                return (state, self.fold_float_hists(acc)), ys

            self._chunk_cache[chunk_len] = run
        return self._chunk_cache[chunk_len]

    def snapshot_runner(self):
        """Jitted single-sweep step that also returns snapshot payloads."""
        if self._snap_fn is None:
            step = self.make_step(with_snapshot=True)

            @jax.jit
            def run(carry, sweep):
                (state, acc), out = step(carry, sweep)
                return (state, self.fold_float_hists(acc)), out

            self._snap_fn = run
        return self._snap_fn
