"""IsingSimulation: stateful simulation engine behind the public `Ising` API.

Counterpart of the reference PyO3 class
(``/root/reference/src/lib.rs:12-634``): ``new / sample / get_spins / reset``
with identical kwargs, defaults, result keys, and seed discipline.  Where the
reference crosses a Python->Rust FFI boundary and fans out over rayon threads,
this class owns device-resident JAX state (a pytree batched over disorder
realizations) and drives the fused ``lax.scan`` loop of
:mod:`peapods_tpu.engine.loop` in host-controlled chunks — chunking provides
progress reporting and Ctrl-C handling between chunks (the reference polls an
``AtomicBool`` per sweep, src/lib.rs:304-333).
"""

from __future__ import annotations

import contextlib
import signal
import threading

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.lattice import Lattice
from ..ops.tempering import init_trip_state
from . import seeds as seedlib
from .config import (
    ClusterConfig,
    OverlapClusterConfig,
    SimConfig,
    parse_ac_backend,
    parse_cluster_action,
    parse_cluster_mode,
    parse_overlap_modes,
    parse_pt_schedule,
    parse_sweep_mode,
)
from .loop import LoopProgram, Runtime
from .results import HostAccum

__all__ = ["IsingSimulation"]

_INIT_DOMAIN = 0x5EED


@contextlib.contextmanager
def _defer_sigint():
    """Hold Ctrl-C while a donating dispatch is in flight.

    The chunk runner donates the carry, so the input state buffers die at
    dispatch; a KeyboardInterrupt raised inside the dispatch call would lose
    the output and leave the simulation pointing at deleted arrays.  SIGINT
    is parked until ``self.state`` has been re-pointed at the output, then
    re-raised — the chunk-level analog of the reference's per-sweep AtomicBool poll
    (src/lib.rs:304-333): interrupts land at chunk granularity with the
    object consistent.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    hits = []
    try:
        prev = signal.signal(signal.SIGINT, lambda *_: hits.append(None))
    except ValueError:  # non-main interpreter contexts
        yield
        return
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, prev)
    if hits:
        raise KeyboardInterrupt


class IsingSimulation:
    """Holds lattice tables + batched realization state on device."""

    def __init__(
        self,
        lattice_shape,
        couplings,
        temperatures,
        n_replicas=None,
        neighbor_offsets=None,
        seed=None,
        default_chunk=256,
        mesh="auto",
    ):
        lattice_shape = [int(s) for s in lattice_shape]
        if neighbor_offsets is not None:
            lattice = Lattice(lattice_shape, neighbor_offsets)
        else:
            lattice = Lattice(lattice_shape)
        self.lattice = lattice
        n_replicas = int(n_replicas) if n_replicas is not None else 1

        couplings = np.asarray(couplings, dtype=np.float32)
        expected_single = tuple(lattice_shape) + (lattice.n_neighbors,)
        if couplings.shape == expected_single:
            n_realizations = 1
        elif (
            len(couplings.shape) == len(expected_single) + 1
            and couplings.shape[1:] == expected_single
        ):
            n_realizations = couplings.shape[0]
        else:
            raise ValueError(
                f"couplings shape {list(couplings.shape)} does not match "
                f"lattice {list(expected_single)}"
            )
        coup_nd = couplings.reshape(
            n_realizations, lattice.n_spins, lattice.n_neighbors
        )

        temps = np.asarray(temperatures, dtype=np.float32)
        self.n_replicas = n_replicas
        self.n_temps = len(temps)
        self.n_realizations = int(n_realizations)
        self.constructor_seed = int(seed) if seed is not None else 42
        self.default_chunk = int(default_chunk)

        # Disorder sharding across the device mesh (parallel/mesh.py): the
        # reference's rayon disorder fan-out becomes a partitioned batch axis.
        from ..parallel.mesh import auto_mesh, shard_runtime

        if mesh == "auto":
            mesh = auto_mesh(self.n_realizations)
        self.mesh = mesh

        # The disorder axis is padded to a multiple of the mesh's disorder
        # extent (the reference fans out any realization count over rayon,
        # mod.rs:887-903); padded slots replay realization 0's couplings
        # under their own seeds and are sliced away at host aggregation
        # (results.py HostAccum n_real).
        self.n_padded = self.n_realizations
        if mesh is not None and "disorder" in mesh.axis_names:
            pad = (-self.n_realizations) % mesh.shape["disorder"]
            if pad:
                coup_nd = np.concatenate(
                    [coup_nd, np.repeat(coup_nd[:1], pad, axis=0)], axis=0
                )
                self.n_padded += pad
        if mesh is not None and "space" in mesh.axis_names:
            # spatial row-band decomposition: the sharded flat spin axis
            # splits into contiguous row bands only when the leading lattice
            # extent divides over the axis
            space = mesh.shape["space"]
            if lattice_shape[0] % space != 0:
                raise ValueError(
                    f"lattice extent {lattice_shape[0]} does not divide over "
                    f"the {space}-way 'space' mesh axis"
                )

        self.rt = Runtime.build(lattice, coup_nd, temps, n_replicas, mesh=mesh)
        self._programs = {}
        self.state = None
        if self.mesh is not None:
            shard_runtime(self.rt, self.mesh)
        self._init_state(self.constructor_seed)

    # ----------------------------------------------------------------- state

    def _init_state(self, base_seed: int) -> None:
        """(Re-)initialize dynamics deterministically from ``base_seed``.

        Mirrors ``Realization::new`` (realization.rs:155-210): random +-1
        spins, identity PT permutation, zeroed PT diagnostics.
        """
        rt = self.rt
        d = rt.n_disorder
        real_seeds = [
            seedlib.realization_seed(base_seed, r) for r in range(d)
        ]
        base_keys = jnp.stack([seedlib.key_from_u64(s) for s in real_seeds])

        def init_spins(key):
            bits = jax.random.bernoulli(
                jax.random.fold_in(key, _INIT_DOMAIN),
                0.5,
                (rt.n_systems, rt.n_spins),
            )
            return jnp.where(bits, jnp.int8(1), jnp.int8(-1))

        spins = jax.vmap(init_spins)(base_keys)
        sid0 = jnp.broadcast_to(
            jnp.arange(rt.n_systems, dtype=jnp.int32).reshape(
                rt.n_replicas, rt.n_temps
            ),
            (d, rt.n_replicas, rt.n_temps),
        )
        n_edges = max(rt.n_temps - 1, 0)
        trip = jax.vmap(lambda s: init_trip_state(s, rt.hot_slot))(sid0)
        self.state = {
            "spins": spins,
            "system_ids": sid0,
            "base_keys": base_keys,
            "counter": jnp.int32(0),
            "warmup": jnp.int32(0),
            "pt_edge_attempts": jnp.zeros((d, n_edges), jnp.int32),
            "pt_edge_acceptances": jnp.zeros((d, n_edges), jnp.int32),
            "pt_round_trips": jnp.zeros((d, rt.n_systems), jnp.int32),
            "pt_trip_state": trip,
            "pt_parity": jnp.int32(0),
        }
        if self.mesh is not None:
            from ..parallel.mesh import shard_state

            self.state = shard_state(self.state, self.mesh, shard_systems=True)

    def save_checkpoint(self, path) -> None:
        """Persist the full dynamics state (spins, PT permutation and
        diagnostics, RNG counter) to an ``.npz`` file.

        The reference has object-level resume only (consecutive ``sample``
        calls continue the chain, SURVEY.md section 5); device state being a
        pytree makes durable checkpointing a natural additive capability.
        """
        flat = {k: np.asarray(v) for k, v in self.state.items()
                if k != "base_keys"}
        flat["__constructor_seed"] = np.int64(self.constructor_seed)
        flat["__key_data"] = np.asarray(
            jax.random.key_data(self.state["base_keys"])
        )
        np.savez(path, **flat)

    def load_checkpoint(self, path) -> None:
        """Restore state saved by :meth:`save_checkpoint`."""
        with np.load(path) as data:
            seed = int(data["__constructor_seed"])
            if seed != self.constructor_seed:
                raise ValueError(
                    f"checkpoint was written for constructor seed {seed}, "
                    f"this simulation uses {self.constructor_seed}"
                )
            state = {}
            for k in self.state:
                if k == "base_keys":
                    state[k] = jax.random.wrap_key_data(
                        jnp.asarray(data["__key_data"])
                    )
                else:
                    v = jnp.asarray(data[k])
                    state[k] = v if v.ndim else v[()]
            self.state = state
        if self.mesh is not None:
            from ..parallel.mesh import shard_state

            self.state = shard_state(self.state, self.mesh, shard_systems=True)

    def get_spins(self) -> np.ndarray:
        """Flat int8 spins of the first realization (src/lib.rs:620-622)."""
        return np.asarray(self.state["spins"][0]).reshape(-1)

    def reset(self, seed=None) -> None:
        """Deterministic re-initialization (src/lib.rs:624-633)."""
        base = int(seed) if seed is not None else self.constructor_seed
        self._init_state(base)

    # ---------------------------------------------------------------- sample

    def sample(
        self,
        n_sweeps,
        sweep_mode,
        cluster_update_interval=None,
        cluster_mode=None,
        cluster_action=None,
        pt_interval=None,
        pt_schedule=None,
        overlap_cluster_update_interval=None,
        overlap_cluster_build_mode=None,
        overlap_cluster_mode=None,
        overlap_cluster_action=None,
        warmup_ratio=None,
        collect_cluster_stats=None,
        autocorrelation_max_lag=None,
        autocorrelation_backend=None,
        sequential=None,
        equilibration_diagnostic=None,
        snapshot_interval=None,
        progress=None,
    ) -> dict:
        """Run the Monte Carlo loop; returns the raw results dict.

        Kwarg semantics and defaults mirror src/lib.rs:176-284.
        """
        n_sweeps = int(n_sweeps)
        warmup = warmup_ratio if warmup_ratio is not None else 0.25
        warmup_sweeps = int(np.floor(n_sweeps * float(warmup) + 0.5))
        collect = bool(collect_cluster_stats) if collect_cluster_stats else False

        sweep_mode = parse_sweep_mode(sweep_mode)
        pt_sched = parse_pt_schedule(pt_schedule or "single_random_edge")
        ac_backend = parse_ac_backend(autocorrelation_backend or "ring")

        cluster_update = None
        if cluster_update_interval is not None:
            mode = parse_cluster_mode(cluster_mode or "sw")
            action = parse_cluster_action(cluster_action or "update")
            cluster_update = ClusterConfig(
                interval=int(cluster_update_interval),
                mode=mode,
                action=action,
                collect_stats=collect or action == "observe",
            )

        overlap_cluster = None
        if overlap_cluster_update_interval is not None:
            modes = parse_overlap_modes(overlap_cluster_build_mode or "houdayer")
            oc_mode = parse_cluster_mode(overlap_cluster_mode or "wolff")
            action = parse_cluster_action(overlap_cluster_action or "update")
            overlap_cluster = OverlapClusterConfig(
                interval=int(overlap_cluster_update_interval),
                modes=modes,
                cluster_mode=oc_mode,
                action=action,
                collect_stats=collect or action == "observe",
                snapshot_interval=snapshot_interval,
            )

        cfg = SimConfig(
            n_sweeps=n_sweeps,
            warmup_sweeps=warmup_sweeps,
            sweep_mode=sweep_mode,
            cluster_update=cluster_update,
            pt_interval=int(pt_interval) if pt_interval is not None else None,
            pt_schedule=pt_sched,
            overlap_cluster=overlap_cluster,
            autocorrelation_max_lag=autocorrelation_max_lag,
            autocorrelation_backend=ac_backend,
            sequential=bool(sequential) if sequential is not None else False,
            equilibration_diagnostic=bool(equilibration_diagnostic)
            if equilibration_diagnostic is not None
            else False,
        )
        cfg.validate()
        if cfg.overlap_cluster is not None:
            max_gs = cfg.overlap_cluster.max_group_size()
            if self.n_replicas < max_gs:
                raise ValueError(
                    "overlap cluster requires n_replicas >= max group_size "
                    f"({self.n_replicas} < {max_gs})"
                )

        program = self._program_for(cfg)
        accum = HostAccum(program, n_sweeps, warmup_sweeps,
                          n_real=self.n_realizations)
        self.state["warmup"] = jnp.int32(warmup_sweeps)

        if progress is None:
            import sys

            if sys.stderr.isatty():
                from ..utils.progress import ProgressPrinter

                progress = ProgressPrinter()

        h = cfg.overlap_cluster
        si = h.snapshot_interval if h is not None else None
        # Snapshot sweeps: recorded overlap-move sweeps on the snapshot grid
        # (mod.rs:628-629); run as dedicated single-sweep steps so the labels
        # can be returned, everything else in scan chunks.
        snap_sweeps = []
        if si is not None:
            first = ((warmup_sweeps + si - 1) // si) * si
            snap_sweeps = list(range(first, n_sweeps, si))

        # Everything accumulates on device; the python loop below dispatches
        # chunks asynchronously and only synchronizes once at the end (plus
        # snapshot payload pulls) — every host round-trip stalls the device.
        #
        # Interrupt contract (reference src/lib.rs:304-333 polls an AtomicBool
        # per sweep and surfaces KeyboardInterrupt with the object usable):
        # chunk_runner donates the carry, so the *input* state buffers die at
        # dispatch — self.state is therefore re-pointed at the output state
        # immediately after every dispatch, before anything (progress
        # callbacks, Ctrl-C between chunks) can raise.  An exception anywhere
        # in this loop loses the partial results of the current sample() but
        # leaves the simulation consistent at the last dispatched chunk, and
        # a subsequent sample()/get_spins()/reset() works.
        s = 0
        snap_i = 0
        state = self.state
        acc = program.init_accumulators()
        series_blocks = []  # (n_real_sweeps, device array); materialized later
        # One fixed compiled chunk length per config: shorter spans are padded
        # with sweep_local = -1 sentinels that the step cond-skips.
        chunk = min(self.default_chunk, 1 << max(0, (n_sweeps - 1)).bit_length())
        chunk = max(chunk, 1)
        while s < n_sweeps:
            if snap_i < len(snap_sweeps) and s == snap_sweeps[snap_i]:
                run1 = program.snapshot_runner()
                with _defer_sigint():
                    (state, acc), (series, snap) = run1(
                        (state, acc), jnp.int32(s)
                    )
                    self.state = state
                if series is not None:
                    series_blocks.append((1, series[None]))
                mode_idx = (s // h.interval) % program.n_modes
                accum.add_snapshot(
                    s, mode_idx, snap, h.modes[mode_idx].kind == "cmr"
                )
                s += 1
                snap_i += 1
            else:
                limit = min(n_sweeps, s + chunk)
                if snap_i < len(snap_sweeps):
                    limit = min(limit, snap_sweeps[snap_i])
                actual = limit - s
                xs = np.full(chunk, -1, dtype=np.int32)
                xs[:actual] = np.arange(s, limit, dtype=np.int32)
                runner = program.chunk_runner(chunk)
                with _defer_sigint():
                    (state, acc), series = runner((state, acc), jnp.asarray(xs))
                    self.state = state
                if series is not None:
                    series_blocks.append((actual, series))
                s = limit
            if progress is not None:
                progress(s, n_sweeps)
        for actual, block in series_blocks:
            accum.add_series(np.asarray(block)[:actual])
        accum.drain_device_acc(acc)
        from ..utils.fetch import fetch_pytree

        return accum.finalize(
            fetch_pytree({k: v for k, v in state.items()
                          if k.startswith("pt_")})
        )

    def _program_for(self, cfg: SimConfig) -> LoopProgram:
        import dataclasses

        key = dataclasses.replace(cfg, n_sweeps=1, warmup_sweeps=0)
        if key not in self._programs:
            self._programs[key] = LoopProgram(self.rt, cfg)
        return self._programs[key]
