"""ms/sweep benchmark over the five sampler modes.

Port of the reference harness (``/root/reference/benchmarks/sweep_modes.py``:
64^2 lattice, 16 temps, 128 disorder realizations) with the same configs so
numbers are directly comparable; a warm pass is added because compilation is
one-time per program, and the sweep count is raised so the asynchronous dispatch
amortizes (the reference is an eager CPU program; this one is one fused scan).

Run: ``python benchmarks/sweep_modes.py [--quick]``.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

from peapods_tpu import Ising  # noqa: E402

LATTICE_SHAPE = (64, 64)
N_TEMPS = 16

MODES = {
    "metropolis": dict(sweep_mode="metropolis"),
    "gibbs": dict(sweep_mode="gibbs"),
    "metropolis + SW cluster": dict(
        sweep_mode="metropolis", cluster_update_interval=1, cluster_mode="sw"
    ),
    "metropolis + Wolff cluster": dict(
        sweep_mode="metropolis", cluster_update_interval=1, cluster_mode="wolff"
    ),
    "metropolis + PT": dict(sweep_mode="metropolis", pt_interval=1),
}


def run(n_sweeps=512, n_realizations=128):
    shape_str = "x".join(str(s) for s in LATTICE_SHAPE)
    print(
        f"Lattice: {shape_str}  |  Temps: {N_TEMPS}  |  Sweeps: {n_sweeps}  |  "
        f"Realizations: {n_realizations}"
    )
    print("-" * 64)

    results = {}
    for name, kwargs in MODES.items():
        temperatures = np.geomspace(0.1, 10, N_TEMPS)
        model = Ising(
            LATTICE_SHAPE, temperatures=temperatures, n_disorder=n_realizations
        )
        model.sample(n_sweeps, warmup_ratio=0.0, **kwargs)  # compile + warm
        t0 = time.perf_counter()
        model.sample(n_sweeps, warmup_ratio=0.0, **kwargs)
        elapsed = time.perf_counter() - t0
        per_sweep = elapsed / n_sweeps * 1000
        flips = (
            n_realizations
            * N_TEMPS
            * LATTICE_SHAPE[0]
            * LATTICE_SHAPE[1]
            * n_sweeps
            / elapsed
        )
        results[name] = per_sweep
        print(
            f"  {name:<30s}  {elapsed:8.3f} s  ({per_sweep:.3f} ms/sweep, "
            f"{flips / 1e9:.2f} Gflips/s)"
        )
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if args.quick:
        run(n_sweeps=128, n_realizations=16)
    else:
        run()
