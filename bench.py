"""Benchmark: spin-flip attempts/s on the flagship config, on one GPU.

256x256 2D Ising ferromagnet, 24-temperature parallel-tempering ladder,
Metropolis sweeps with a PT event every sweep.  Prints ONE JSON line with
the median of four timed repetitions, every repetition, the device as JAX
reports it, the card's name and power limit from ``nvidia-smi``, and a
determinism checksum over the final spins, PT permutation and results (the
reference bench harness's convention, spin-sim/examples/bench.rs:125-187).

Refuses to run anywhere but on a GPU: a number from another backend is not
a number for this system.
"""

import json
import sys
import time

import numpy as np

from chip_smoke import (
    SmokeError, card_lines, import_package, require_gpu, state_checksum,
)


def main():
    try:
        import_package()
        devs = require_gpu()
        card = card_lines()[0]
    except SmokeError as err:
        print(f"bench: {err}", file=sys.stderr)
        return 1
    from peapods_tpu.engine.simulation import IsingSimulation

    L, n_temps, n_replicas = 256, 24, 1
    temps = np.geomspace(1.8, 3.2, n_temps).astype(np.float32)
    coup = np.ones((L, L, 2), np.float32)
    sim = IsingSimulation(
        [L, L], coup, temps, n_replicas, None, 42, default_chunk=4096, mesh=None
    )
    n_sweeps = 4096
    # warm with the same chunk length as the timed reps (one compile)
    sim.sample(n_sweeps, "metropolis", pt_interval=1, warmup_ratio=0.0)
    reps = []
    for _ in range(4):
        t0 = time.perf_counter()
        result = sim.sample(n_sweeps, "metropolis", pt_interval=1,
                            warmup_ratio=0.0)
        reps.append(n_sweeps / (time.perf_counter() - t0))

    sweeps_per_sec = float(np.median(reps))
    flips = L * L * n_temps * n_replicas
    print(json.dumps({
        "metric": "spin_flip_attempts_per_sec_256x256_24T_pt",
        "value": sweeps_per_sec * flips,
        "unit": "flips/s",
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
        "card": card,
        "extra": {
            "ms_per_sweep": 1000.0 / sweeps_per_sec,
            "rep_sweeps_per_sec": reps,
            "state_checksum": state_checksum(sim, result),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
