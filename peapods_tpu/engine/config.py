"""Simulation configuration: enums, parsing, and cross-field validation.

Mirrors the user-visible semantics (and error strings) of the reference's
``spin-sim/src/config.rs:3-247`` so that invalid configurations fail with the
same messages, *before* any device state is touched (the "errors before
mutation" contract tested in the reference's
``tests/test_sampling_interfaces.py:145-206``).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

__all__ = [
    "SWEEP_MODES",
    "CLUSTER_MODES",
    "CLUSTER_ACTIONS",
    "PT_SCHEDULES",
    "AC_BACKENDS",
    "OverlapBuildMode",
    "ClusterConfig",
    "OverlapClusterConfig",
    "SimConfig",
    "parse_sweep_mode",
    "parse_cluster_mode",
    "parse_cluster_action",
    "parse_pt_schedule",
    "parse_ac_backend",
    "parse_overlap_modes",
]

SWEEP_MODES = ("metropolis", "gibbs")
CLUSTER_MODES = ("wolff", "sw")
CLUSTER_ACTIONS = ("update", "observe")
PT_SCHEDULES = ("single_random_edge", "full_ladder")
AC_BACKENDS = ("ring", "fft")


def parse_sweep_mode(s: str) -> str:
    if s not in SWEEP_MODES:
        raise ValueError(f"unknown sweep_mode '{s}', expected 'metropolis' or 'gibbs'")
    return s


def parse_cluster_mode(s: str) -> str:
    if s not in CLUSTER_MODES:
        raise ValueError(f"unknown cluster_mode '{s}', expected 'wolff' or 'sw'")
    return s


def parse_cluster_action(s: str) -> str:
    if s not in CLUSTER_ACTIONS:
        raise ValueError(f"unknown cluster action '{s}', expected 'update' or 'observe'")
    return s


def parse_pt_schedule(s: str) -> str:
    if s not in PT_SCHEDULES:
        raise ValueError(
            f"unknown pt_schedule '{s}', expected 'single_random_edge' or 'full_ladder'"
        )
    return s


def parse_ac_backend(s: str) -> str:
    if s not in AC_BACKENDS:
        raise ValueError(
            f"unknown autocorrelation_backend '{s}', expected 'ring' or 'fft'"
        )
    return s


@dataclass(frozen=True)
class OverlapBuildMode:
    """One overlap-cluster build mode (reference config.rs:101-148).

    ``kind`` is one of ``"houdayer" | "jorg" | "cmr"``; ``group_size`` is the
    number of replicas grouped per task (N for Houdayer-N, otherwise 2).
    """

    kind: str
    group_size: int = 2

    @staticmethod
    def parse(s: str) -> "OverlapBuildMode":
        s = s.strip()
        if s in ("houdayer", "houd2"):
            return OverlapBuildMode("houdayer", 2)
        if s == "jorg":
            return OverlapBuildMode("jorg", 2)
        if s in ("cmr", "cmr2"):
            return OverlapBuildMode("cmr", 2)
        if s.startswith("houd"):
            try:
                n = int(s[4:])
            except ValueError:
                raise ValueError(
                    f"invalid Houdayer group size in '{s}', expected 'houdN' with "
                    "even integer N >= 2"
                ) from None
            if n < 2 or n % 2 != 0:
                raise ValueError(f"Houdayer group size must be even and >= 2, got {n}")
            if n > 2:
                print(
                    f"WARNING: houd{n} (group_size > 2) is experimental and very "
                    "likely does not satisfy detailed balance",
                    file=sys.stderr,
                )
            return OverlapBuildMode("houdayer", n)
        raise ValueError(
            f"unknown overlap_cluster_build_mode '{s}', expected 'houdayer', "
            "'houdN', 'jorg', or 'cmr'"
        )


def parse_overlap_modes(s: str) -> tuple[OverlapBuildMode, ...]:
    """Parse '+'-separated round-robin mode list (reference config.rs:174-178)."""
    return tuple(OverlapBuildMode.parse(part) for part in s.split("+"))


@dataclass(frozen=True)
class ClusterConfig:
    interval: int
    mode: str = "sw"  # "wolff" | "sw"
    action: str = "update"  # "update" | "observe"
    collect_stats: bool = False


@dataclass(frozen=True)
class OverlapClusterConfig:
    interval: int
    modes: tuple[OverlapBuildMode, ...] = (OverlapBuildMode("houdayer", 2),)
    cluster_mode: str = "wolff"
    action: str = "update"
    collect_stats: bool = False
    snapshot_interval: int | None = None

    def max_group_size(self) -> int:
        return max((m.group_size for m in self.modes), default=2)


@dataclass(frozen=True)
class SimConfig:
    """Full simulation configuration (reference config.rs:249-263)."""

    n_sweeps: int
    warmup_sweeps: int = 0
    sweep_mode: str = "metropolis"
    cluster_update: ClusterConfig | None = None
    pt_interval: int | None = None
    pt_schedule: str = "single_random_edge"
    overlap_cluster: OverlapClusterConfig | None = None
    autocorrelation_max_lag: int | None = None
    autocorrelation_backend: str = "ring"
    sequential: bool = False  # layout hint only; kept for API parity
    equilibration_diagnostic: bool = False

    def validate(self) -> None:
        """Cross-field validation, mirroring config.rs:180-247."""
        if self.n_sweeps < 1:
            raise ValueError("n_sweeps must be >= 1")
        if self.warmup_sweeps > self.n_sweeps:
            raise ValueError("warmup_sweeps must be <= n_sweeps")
        c = self.cluster_update
        if c is not None:
            if c.interval < 1:
                raise ValueError("cluster_update interval must be >= 1")
            if c.action == "observe" and c.mode == "wolff":
                raise ValueError("cluster_action='observe' requires cluster_mode='sw'")
        if self.pt_interval is not None and self.pt_interval == 0:
            raise ValueError("pt_interval must be >= 1")
        if (
            self.autocorrelation_backend == "fft"
            and self.autocorrelation_max_lag is None
        ):
            raise ValueError(
                "autocorrelation_backend='fft' requires autocorrelation_max_lag"
            )
        h = self.overlap_cluster
        if h is not None:
            if h.interval < 1:
                raise ValueError("overlap_cluster interval must be >= 1")
            if h.snapshot_interval is not None:
                si = h.snapshot_interval
                if si < 1 or si % h.interval != 0:
                    raise ValueError(
                        "snapshot_interval must be a positive multiple of "
                        "overlap_cluster interval"
                    )
            if not h.modes:
                raise ValueError("overlap_cluster modes must not be empty")
            if h.action == "observe":
                if h.cluster_mode == "wolff":
                    raise ValueError(
                        "overlap_cluster_action='observe' requires "
                        "overlap_cluster_mode='sw'"
                    )
                if h.snapshot_interval is not None:
                    raise ValueError(
                        "snapshot_interval is not supported with "
                        "overlap_cluster_action='observe'"
                    )
                if any(m.kind == "houdayer" and m.group_size > 2 for m in h.modes):
                    raise ValueError(
                        "overlap_cluster_action='observe' does not support "
                        "experimental houdN with N > 2"
                    )
