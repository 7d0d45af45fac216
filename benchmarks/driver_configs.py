"""Throughput benchmarks for the five driver-selected configs.

BASELINE.md lists five configs (from /root/repo/BASELINE.json) whose
throughput anchors the rebuild; this harness times each on the current
backend and prints one JSON line per config:

    {"config": N, "metric": ..., "value": flips_per_sec, "unit": "flips/s",
     "ms_per_sweep": ..., "extra": {...}}

Reference analog: spin-sim/examples/bench.rs:12-16,51-87 (per-mode ms/sweep)
and benchmarks/sweep_modes.py.  Run on the GPU in one process (a second JAX
process on the same card fails for want of memory).  ``--quick`` shrinks
sweep counts ~8x for smoke runs; ``--only N`` runs a single config.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

T_C_2D = 2.269185


def _time_sample(model, n_sweeps, **kw):
    # warm with the SAME sweep count: the engine compiles one scan program
    # per chunk length, and chunk length follows n_sweeps — a shorter warmup
    # would leave a recompile inside the timed region
    model.sample(n_sweeps, warmup_ratio=0.0, **kw)
    t0 = time.perf_counter()
    model.sample(n_sweeps, warmup_ratio=0.0, **kw)
    return time.perf_counter() - t0


def config_1(quick):
    """32x32 ferro, Metropolis, 16-temp PT ladder, 2 replicas (README:39-41)."""
    from peapods_tpu import Ising

    n_sweeps = 2048 if quick else 16384
    model = Ising((32, 32), temperatures=np.geomspace(1.8, 3.2, 16),
                  n_replicas=2, seed=1)
    dt = _time_sample(model, n_sweeps, pt_interval=1)
    return model, n_sweeps, dt, dict(lattice="32x32", n_systems=32)


def config_2(quick):
    """32x32 triangular, Wolff clusters (README:59-64)."""
    from peapods_tpu import Ising

    n_sweeps = 1024 if quick else 8192
    model = Ising((32, 32), geometry="triangular",
                  temperatures=np.geomspace(3.0, 4.4, 8), seed=2)
    dt = _time_sample(model, n_sweeps, cluster_update_interval=2,
                      cluster_mode="wolff")
    return model, n_sweeps, dt, dict(lattice="32x32 tri", n_systems=8)


def config_3(quick):
    """256x256 ferro, Swendsen-Wang at T_c (CC kernel stress)."""
    from peapods_tpu import Ising

    n_sweeps = 64 if quick else 256
    model = Ising((256, 256), temperatures=np.array([T_C_2D]), seed=3)
    dt = _time_sample(model, n_sweeps, cluster_update_interval=1,
                      cluster_mode="sw")
    return model, n_sweeps, dt, dict(lattice="256x256", n_systems=1)


def config_4(quick):
    """8^3 +-J spin glass, 24-temp PT + Houdayer ICM, 4 replicas."""
    from peapods_tpu import Ising

    n_sweeps = 1024 if quick else 8192
    model = Ising((8, 8, 8), couplings="bimodal",
                  temperatures=np.geomspace(0.9, 2.2, 24), n_replicas=4,
                  n_disorder=8, seed=4)
    dt = _time_sample(model, n_sweeps, pt_interval=1,
                      overlap_cluster_update_interval=10,
                      overlap_cluster_build_mode="houdayer")
    return model, n_sweeps, dt, dict(lattice="8^3", n_systems=96, n_disorder=8)


def config_5(quick):
    """16^3 Gaussian SG, Joerg+CMR overlap moves, full-ladder PT, disorder
    batch (the sharded-disorder flagship; single-chip here)."""
    from peapods_tpu import Ising

    n_sweeps = 256 if quick else 2048
    model = Ising((16, 16, 16), couplings="gaussian",
                  temperatures=np.geomspace(0.8, 2.0, 24), n_replicas=4,
                  n_disorder=8, seed=5)
    dt = _time_sample(model, n_sweeps, pt_interval=1,
                      pt_schedule="full_ladder",
                      overlap_cluster_update_interval=10,
                      overlap_cluster_build_mode="jorg+cmr")
    return model, n_sweeps, dt, dict(lattice="16^3", n_systems=96, n_disorder=8)


CONFIGS = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", type=int, default=None, choices=sorted(CONFIGS))
    args = ap.parse_args()

    picks = [args.only] if args.only else sorted(CONFIGS)
    for n in picks:
        model, n_sweeps, dt, extra = CONFIGS[n](args.quick)
        n_sites = int(np.prod(model.lattice_shape))
        flips = n_sites * extra["n_systems"] * extra.get("n_disorder", 1)
        flips_per_sec = flips * n_sweeps / dt
        print(json.dumps({
            "config": n,
            "metric": f"driver_config_{n}",
            "value": flips_per_sec,
            "unit": "flips/s",
            "ms_per_sweep": dt / n_sweeps * 1e3,
            "extra": extra,
        }))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
