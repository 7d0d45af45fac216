"""Public `Ising` model class — API parity with the reference Python layer.

Counterpart of ``/root/reference/python/peapods/spin_models.py``: identical
constructor/`sample` signatures, seed discipline (independent SeedSequence
streams for couplings vs dynamics, spin_models.py:13-23), coupling synthesis
(per-disorder child seeds so realization 0 is stable as n_disorder grows,
:104-127), derived observables (:270-335), and the Zhu et al. equilibration
diagnostic (:339-358).
"""

from __future__ import annotations

import numpy as np

from ..engine.seeds import dynamics_seed, seed_material
from ..engine.simulation import IsingSimulation
from ..ops.lattice import GEOMETRY_OFFSETS as GEOMETRIES

__all__ = ["Ising", "GEOMETRIES"]

_COUPLING_MODES = ("ferro", "bimodal", "gaussian")

# result-dict keys copied onto the instance verbatim when present
_PASSTHROUGH_ATTRS = {
    "overlap_histogram": "overlap_histogram",
    "ql_at_q_sum": "ql_at_q_sum",
    "ql2_at_q_sum": "ql2_at_q_sum",
    "per_sample_overlap_histogram": "per_sample_overlap_histogram",
    "per_sample_ql_at_q_sum": "per_sample_ql_at_q_sum",
    "per_sample_ql2_at_q_sum": "per_sample_ql2_at_q_sum",
    "top_cluster_sizes": "top_cluster_sizes",
    "mags2_tau": "mags2_tau",
    "overlap2_tau": "overlap2_tau",
    "equil_sweeps": "_equil_sweeps",
    "equil_energy_avg": "_equil_energy_avg",
    "equil_link_overlap_avg": "_equil_link_overlap_avg",
    "cluster_snapshots": "cluster_snapshots",
}

# sample() kwarg validation, declaratively (same user-facing strings as the
# reference pre-FFI checks, spin_models.py:222-247): enum membership, then
# value-conditional requirements, then sub-config kwargs nulled out when
# their governing interval is unset.
_SAMPLE_ENUMS = (
    ("cluster_action", ("update", "observe")),
    ("overlap_cluster_action", ("update", "observe")),
    ("pt_schedule", ("single_random_edge", "full_ladder")),
    ("autocorrelation_backend", ("ring", "fft")),
)
_SAMPLE_REQUIRES = (
    ("autocorrelation_backend", "fft", "autocorrelation_max_lag"),
    ("cluster_action", "observe", "cluster_update_interval"),
    ("overlap_cluster_action", "observe", "overlap_cluster_update_interval"),
)
_SAMPLE_GATES = (
    ("cluster_mode", "cluster_update_interval"),
    ("cluster_action", "cluster_update_interval"),
    ("overlap_cluster_build_mode", "overlap_cluster_update_interval"),
    ("overlap_cluster_mode", "overlap_cluster_update_interval"),
    ("overlap_cluster_action", "overlap_cluster_update_interval"),
    ("snapshot_interval", "overlap_cluster_update_interval"),
)


def _synthesize_couplings(mode, coupling_seed, n_disorder, single_shape):
    """Per-disorder coupling arrays from independent SeedSequence children."""
    if mode not in _COUPLING_MODES:
        raise ValueError("Invalid mode for couplings.")
    samples = []
    for child in coupling_seed.spawn(n_disorder):
        rng = np.random.default_rng(child)
        if mode == "ferro":
            j = np.ones(single_shape, dtype=np.float32)
        elif mode == "bimodal":
            j = (2 * rng.integers(0, 2, size=single_shape) - 1).astype(np.float32)
        else:  # gaussian
            j = rng.standard_normal(single_shape).astype(np.float32)
        samples.append(j)
    return samples[0] if n_disorder == 1 else np.stack(samples)


class Ising:
    """Ising model on a periodic Bravais lattice with Monte Carlo sampling.

    Covers ferromagnets and spin glasses on hypercubic, triangular, FCC, BCC,
    or custom offset-defined lattices; with two or more replicas per
    temperature the full replica-overlap observable set becomes available.
    After `sample`, derived observables live on the instance:
    ``binder_cumulant``, ``heat_capacity``, and (with replicas) ``sg_binder``
    and ``link_overlap_binder``; optional statistics (``fk_csd``,
    ``top_cluster_sizes``, taus, equilibration curves, snapshots) appear when
    the corresponding sampling options are enabled.
    """

    def __init__(
        self,
        lattice_shape,
        couplings="ferro",
        temperatures=np.geomspace(0.1, 10, 32),
        n_replicas=1,
        n_disorder=1,
        neighbor_offsets=None,
        geometry=None,
        seed=None,
    ):
        """Create an Ising model.

        Args:
            lattice_shape: periodic lattice extents, e.g. ``(32, 32)``.
            couplings: ``"ferro"`` (all +1), ``"bimodal"`` (random +-1),
                ``"gaussian"`` (standard normal), or an explicit array of
                shape ``(*lattice_shape, n_neighbors)`` (optionally with a
                leading ``n_disorder`` axis).
            temperatures: temperature grid for the ladder.
            n_replicas: independent replicas per temperature; >= 2 enables
                overlap statistics and the replica cluster moves.
            n_disorder: number of coupling realizations.
            neighbor_offsets: integer offset vectors defining the forward
                bonds (mutually exclusive with ``geometry``).
            geometry: named lattice (``"triangular"``/``"tri"``, ``"fcc"``,
                ``"bcc"``); hypercubic when neither is given.
            seed: non-negative integer controlling both coupling synthesis
                and the dynamics; ``None`` draws fresh entropy.
        """
        if geometry is not None:
            if neighbor_offsets is not None:
                raise ValueError("Cannot specify both geometry and neighbor_offsets")
            if geometry not in GEOMETRIES:
                raise ValueError(
                    f"Unknown geometry '{geometry}', choose from: "
                    f"{list(GEOMETRIES.keys())}"
                )
            neighbor_offsets = GEOMETRIES[geometry]

        self.lattice_shape = tuple(lattice_shape)
        self.n_spins = int(np.prod(lattice_shape))
        self.n_dims = len(lattice_shape)
        self.n_neighbors = len(neighbor_offsets) if neighbor_offsets else self.n_dims
        self.temperatures = np.asarray(temperatures).copy().astype(np.float32)
        self.n_temps = len(temperatures)
        self.n_replicas = n_replicas
        self.n_disorder = n_disorder
        self.seed = seed
        coupling_seed, self._constructor_dynamics_seed = seed_material(seed)

        if isinstance(couplings, np.ndarray):
            self.couplings = couplings.astype(np.float32)
        else:
            self.couplings = _synthesize_couplings(
                couplings,
                coupling_seed,
                n_disorder,
                self.lattice_shape + (self.n_neighbors,),
            )

        self._sim = IsingSimulation(
            list(lattice_shape),
            self.couplings,
            self.temperatures,
            n_replicas,
            neighbor_offsets,
            self._constructor_dynamics_seed,
        )

    def reset(self, seed=None):
        """Reset dynamics while keeping the couplings fixed.

        With no argument the constructor's initial dynamics replay exactly; a
        seed performs a deterministic one-off reset without replacing the
        constructor seed.
        """
        self._sim.reset(None if seed is None else dynamics_seed(seed))

    def sample(
        self,
        n_sweeps,
        sweep_mode="metropolis",
        cluster_update_interval=None,
        cluster_mode="sw",
        cluster_action="update",
        pt_interval=None,
        pt_schedule="single_random_edge",
        overlap_cluster_update_interval=None,
        overlap_cluster_build_mode="houdayer",
        overlap_cluster_mode="wolff",
        overlap_cluster_action="update",
        warmup_ratio=0.25,
        collect_cluster_stats=False,
        autocorrelation_max_lag=None,
        autocorrelation_backend="ring",
        sequential=False,
        equilibration_diagnostic=False,
        snapshot_interval=None,
    ):
        """Run Monte Carlo sampling and compute observables.

        All kwargs carry the reference semantics (spin_models.py:146-269):
        ``sweep_mode`` in {metropolis, gibbs}; optional FK cluster updates
        every ``cluster_update_interval`` sweeps with ``cluster_mode`` in
        {sw, wolff} and ``cluster_action`` in {update, observe}; optional
        parallel tempering every ``pt_interval`` sweeps with
        ``pt_schedule`` in {single_random_edge, full_ladder}; optional
        replica-overlap moves every ``overlap_cluster_update_interval``
        sweeps with a '+'-separated ``overlap_cluster_build_mode`` mix of
        houdayer/houdN/jorg/cmr (houdN with N > 2 is experimental and very
        likely violates detailed balance).  ``warmup_ratio`` of the sweeps
        is discarded before recording; ``sequential`` is accepted for API
        compatibility (the engine always fuses the inner parallelism).

        Returns the raw results dictionary (keys like ``"mags"``,
        ``"energies"``, ``"overlap2"``, ``"per_disorder"``, ...).
        """
        kw = dict(
            cluster_update_interval=cluster_update_interval,
            cluster_mode=cluster_mode,
            cluster_action=cluster_action,
            pt_interval=pt_interval,
            pt_schedule=pt_schedule,
            overlap_cluster_update_interval=overlap_cluster_update_interval,
            overlap_cluster_build_mode=overlap_cluster_build_mode,
            overlap_cluster_mode=overlap_cluster_mode,
            overlap_cluster_action=overlap_cluster_action,
            warmup_ratio=warmup_ratio,
            collect_cluster_stats=collect_cluster_stats,
            autocorrelation_max_lag=autocorrelation_max_lag,
            autocorrelation_backend=autocorrelation_backend,
            sequential=sequential,
            equilibration_diagnostic=equilibration_diagnostic,
            snapshot_interval=snapshot_interval,
        )
        for name, choices in _SAMPLE_ENUMS:
            if kw[name] not in choices:
                raise ValueError(
                    f"{name} must be " + " or ".join(f"'{c}'" for c in choices)
                )
        for name, value, needed in _SAMPLE_REQUIRES:
            if kw[name] == value and kw[needed] is None:
                raise ValueError(f"{name}='{value}' requires {needed}")
        for name, interval in _SAMPLE_GATES:
            if not kw[interval]:
                kw[name] = None

        result = self._sim.sample(n_sweeps, sweep_mode, **kw)
        self._attach_observables(result)
        return result

    def _attach_observables(self, result):
        """Derived quantities + passthrough attributes (spin_models.py:270-335)."""
        self.mags = result["mags"]
        self.mags2 = result["mags2"]
        self.mags4 = result["mags4"]
        self.energies_avg = result["energies"]
        self.energies2_avg = result["energies2"]

        # Observe-mode runs can record zero moments; the cumulants are then
        # undefined (0/0) and NaN is the right value — suppress the warnings.
        with np.errstate(divide="ignore", invalid="ignore"):
            self.binder_cumulant = 1 - self.mags4 / (3 * self.mags2**2)
        self.heat_capacity = (
            self.n_spins
            * (self.energies2_avg - self.energies_avg**2)
            / self.temperatures**2
        )

        if "overlap2" in result:
            for key in (
                "overlap", "overlap2", "overlap4",
                "link_overlap", "link_overlap2", "link_overlap4",
            ):
                setattr(self, key, result[key])
            with np.errstate(divide="ignore", invalid="ignore"):
                self.sg_binder = 1 - self.overlap4 / (3 * self.overlap2**2)
                self.link_overlap_binder = 1 - self.link_overlap4 / (
                    3 * self.link_overlap2**2
                )

        for key, attr in _PASSTHROUGH_ATTRS.items():
            if key in result:
                setattr(self, attr, result[key])

        if "fk_csd" in result:
            self.fk_csd = result["fk_csd"]
            self.mean_cluster_size = np.array(
                [self._mean_cluster_size(h) for h in self.fk_csd]
            )

        self.per_disorder = result.get("per_disorder", {})

    @staticmethod
    def _mean_cluster_size(hist):
        """Site-weighted mean cluster size from a CSD histogram."""
        sizes = np.arange(len(hist))
        site_weights = sizes * hist
        n_sites = site_weights.sum()
        return (sizes * site_weights).sum() / n_sites if n_sites > 0 else 0.0

    def equilibration_delta(self, j_squared=1.0):
        """Zhu et al. thermalization diagnostic Delta(t).

        ``Delta = e(t) - J^2 beta z (1 - q_l(t))`` approaches zero as the
        system equilibrates.  The engine's energy convention is the positive
        bond sum ``e = +sum J s s / N`` (matching the reference,
        spin_models.py:343-349), hence the flipped sign relative to the
        Hamiltonian form.

        Returns ``(sweeps [n_checkpoints], delta [n_checkpoints, n_temps])``.
        """
        beta = 1.0 / self.temperatures
        delta = self._equil_energy_avg - j_squared * beta * self.n_neighbors * (
            1 - self._equil_link_overlap_avg
        )
        return self._equil_sweeps, delta

    def save_checkpoint(self, path):
        """Write the dynamics state to ``path`` (couplings are derived from
        the constructor seed and are not stored)."""
        self._sim.save_checkpoint(path)

    def load_checkpoint(self, path):
        """Resume from a checkpoint written by :meth:`save_checkpoint`."""
        self._sim.load_checkpoint(path)

    def get_energies(self):
        """Mean energies per temperature from the last `sample` run."""
        return self.energies_avg
