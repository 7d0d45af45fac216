"""Run every benchmark table in ONE process on one GPU.

A JAX process reserves most of the card's memory, so a second process on
the same card fails; every table therefore comes from one invocation:

    python benchmarks/bench_all.py [--quick]

Sections (each also runnable standalone):
  1. flagship  — bench.py (256^2 Metropolis + 24-temp PT, median-of-4;
                 refuses a non-GPU backend)
  2. configs   — benchmarks/driver_configs.py (the five BASELINE configs)
  3. modes     — benchmarks/sweep_modes.py (the reference 5-mode harness)

Output: each section's own JSON/table lines, prefixed with a section
banner; exit nonzero if any section raises.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--only", choices=["flagship", "configs", "modes"], default=None
    )
    args = ap.parse_args()

    failures = []

    def section(name, fn):
        if args.only and args.only != name:
            return
        print(f"==== {name} ====", flush=True)
        t0 = time.time()
        try:
            fn()
        except Exception as e:  # keep later sections running
            failures.append((name, e))
            print(f"[{name} FAILED: {e!r}]", flush=True)
        print(f"==== {name} done ({time.time() - t0:.0f}s) ====", flush=True)

    def flagship():
        import bench

        if bench.main():
            raise RuntimeError("bench.py found no GPU")

    def configs():
        import driver_configs

        saved = sys.argv
        sys.argv = ["driver_configs.py"] + (["--quick"] if args.quick else [])
        try:
            driver_configs.main()
        finally:
            sys.argv = saved

    def modes():
        import sweep_modes

        sweep_modes.run(
            n_sweeps=128 if args.quick else 512,
            n_realizations=128,
        )

    # the repo root on sys.path makes `import bench` resolve the repo's bench.py
    section("flagship", flagship)
    section("configs", configs)
    section("modes", modes)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
