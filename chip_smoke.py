"""Smoke test of the engine on an NVIDIA GPU.

    python chip_smoke.py           # one GPU: phases 1-6
    python chip_smoke.py --multi   # four GPUs: the sharded-disorder phase only

Drives the main path through the entry points users call (``Ising.sample()``
and the CLI's ``main``) at full width, compares the device ops with the
plain numpy references of ``tests/reference_np.py`` at real widths, and
checks an exact-enumeration equilibrium oracle.  Phases:

1. device: the JAX platform must be ``gpu`` (no CPU fallback); prints the
   card's name and power limit, ``XLA_FLAGS`` and the compile-cache path;
2. flagship: 256^2 ferromagnet, 24-temperature PT ladder, Metropolis; then
   the same model through ``peapods simulate``;
3. Swendsen-Wang at T_c on 256^2 (benchmarks/driver_configs.py config 3);
4. 16^3 Gaussian glass, 24 temperatures x 4 replicas x 8 disorder
   realizations, Joerg+CMR overlap moves, full-ladder PT (config 5);
5. ``mc_sweep`` / ``connected_components`` / energies and overlaps on the
   GPU against the numpy references;
6. 4x4 torus with Metropolis + SW + PT against exact enumeration.

``--multi`` runs config 5 with ``mesh="auto"`` over four cards and with
``mesh=None`` on one card, and requires bitwise-equal spins.

Each phase prints one line.  Every failure raises and exits nonzero before
the last line, which is one JSON object naming the device.  Only one JAX
process ever uses the card: ``nvidia-smi`` is the only child process.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_C_2D = 2.269185


class SmokeError(RuntimeError):
    """A phase found a wrong result or a missing prerequisite."""


def import_package():
    """Import ``peapods_tpu`` and ``tests/reference_np`` from this checkout,
    never from anywhere else on the path."""
    pkg = ROOT / "peapods_tpu"
    if not (pkg / "__init__.py").is_file():
        raise SmokeError(f"no peapods_tpu package beside {Path(__file__).name}")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import peapods_tpu

    if Path(peapods_tpu.__file__).resolve().parent != pkg:
        raise SmokeError(f"peapods_tpu imported from {peapods_tpu.__file__}")
    return peapods_tpu


def require_gpu(count=1):
    """The JAX devices, if they are GPUs and there are at least ``count``."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeError(
            f"JAX found no GPU (platform {devs[0].platform!r}); "
            "this script measures the GPU path only"
        )
    if len(devs) < count:
        raise SmokeError(f"need {count} GPUs, JAX sees {len(devs)}")
    return devs


def card_lines():
    """``nvidia-smi`` name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def result_line(devs):
    """The closing JSON line: the device as JAX reports it."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    })


def state_checksum(sim, result):
    """Hash of final spins + PT permutation + per-temperature observables."""
    h = hashlib.sha256()
    h.update(np.asarray(sim.state["spins"]).tobytes())
    h.update(np.asarray(sim.state["system_ids"]).tobytes())
    h.update(np.asarray(sim.state["counter"]).tobytes())
    for key in ("mags", "mags2", "energies", "energies2"):
        h.update(np.asarray(result[key]).tobytes())
    return h.hexdigest()[:16]


def plan_of(model):
    """The engine plans of every program the model compiled."""
    plans = sorted({p.describe_plan() for p in model._sim._programs.values()})
    for plan in plans:
        if "pallas" in plan.lower():
            raise SmokeError(f"plan names a Pallas kernel: {plan}")
    return " | ".join(plans)


def peak_gib():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2**30


def timed(model, n_warm, n_sweeps, **kw):
    """``(result, compile_s, ms_per_sweep)``.  The warm call compiles the
    same chunk program the timed call runs; its excess over the warm
    per-sweep rate is the compile time.  ``sample`` returns host arrays, so
    both calls end with the device idle."""
    t0 = time.perf_counter()
    model.sample(n_warm, warmup_ratio=0.0, **kw)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = model.sample(n_sweeps, warmup_ratio=0.0, **kw)
    dt = time.perf_counter() - t0
    return result, max(first - n_warm * dt / n_sweeps, 0.0), 1e3 * dt / n_sweeps


def check_finite(result, keys, where):
    for key in keys:
        v = np.asarray(result[key])
        if not np.isfinite(v).all():
            raise SmokeError(f"{where}: non-finite {key}")


# ------------------------------------------------------------------ phases


def phase_device(count=1):
    import jax

    devs = require_gpu(count)
    cards = card_lines()
    for line in cards:
        print(line)
    print(
        f"phase 1 device: platform={devs[0].platform} "
        f"kind={devs[0].device_kind!r} count={len(devs)} "
        f"nvidia_smi={cards!r} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={jax.config.jax_compilation_cache_dir!r}",
        flush=True,
    )
    return devs, cards[0]


def phase_flagship(card, shape=(256, 256), n_temps=24, n_warm=512,
                   n_sweeps=2048):
    from peapods_tpu import Ising
    from peapods_tpu.cli import main as cli_main

    temps = np.geomspace(1.8, 3.2, n_temps)
    model = Ising(shape, temperatures=temps, seed=42)
    res, compile_s, ms = timed(model, n_warm, n_sweeps, pt_interval=1)
    check_finite(res, ("mags2", "energies", "energies2"), "flagship")
    e = np.asarray(res["energies"])
    if e.shape != (n_temps,) or not e[0] > e[-1]:
        raise SmokeError(f"flagship energies not ordered by temperature: {e}")
    n_spins = int(np.prod(shape))
    flips = n_spins * n_temps * 1e3 / ms

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        out = Path(tmp) / "cli.npz"
        argv = ["simulate", "--shape", *map(str, shape),
                "--temp-min", "1.8", "--temp-max", "3.2",
                "--n-temps", str(n_temps), "--n-sweeps", "256",
                "--pt-interval", "1", "--seed", "42", "-o", str(out)]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli_main(argv)
        cli_s = time.perf_counter() - t0
        with np.load(out) as data:
            cli_e = data["energies"]
        if cli_e.shape != (n_temps,) or not np.isfinite(cli_e).all():
            raise SmokeError(f"CLI energies malformed: {cli_e}")

    print(
        f"phase 2 flagship {shape[0]}x{shape[1]}x{n_temps}T metropolis+pt: "
        f"compile_s={compile_s:.2f} ms_per_sweep={ms:.4f} "
        f"flips_per_s={flips:.4e} card={card!r} peak_gib={peak_gib():.2f} "
        f"checksum={state_checksum(model._sim, res)} "
        f"cli_simulate_s={cli_s:.2f} plan={plan_of(model)!r}",
        flush=True,
    )
    return model


def phase_cluster(card, shape=(256, 256), n_warm=256, n_sweeps=256):
    from peapods_tpu import Ising

    model = Ising(shape, temperatures=np.array([T_C_2D]), seed=3)
    res, compile_s, ms = timed(model, n_warm, n_sweeps,
                               cluster_update_interval=1, cluster_mode="sw")
    check_finite(res, ("mags2", "energies"), "cluster")
    if not 0.0 < float(res["mags2"][0]) <= 1.0:
        raise SmokeError(f"SW at T_c: m^2 = {res['mags2']}")
    # the same lattice without the FK phase splits sweep from FK + CC time
    plain = Ising(shape, temperatures=np.array([T_C_2D]), seed=3)
    _, compile_p, ms_plain = timed(plain, n_warm, n_sweeps)
    n_spins = int(np.prod(shape))
    print(
        f"phase 3 cluster {shape[0]}x{shape[1]} sw@Tc: "
        f"compile_s={compile_s:.2f} ms_per_sweep={ms:.4f} "
        f"flips_per_s={n_spins * 1e3 / ms:.4e} card={card!r} "
        f"sweep_only_ms={ms_plain:.4f} fk_cc_ms={ms - ms_plain:.4f} "
        f"sweep_only_compile_s={compile_p:.2f} peak_gib={peak_gib():.2f} "
        f"checksum={state_checksum(model._sim, res)} plan={plan_of(model)!r}",
        flush=True,
    )


def phase_glass(card, shape=(16, 16, 16), n_temps=24, n_replicas=4,
                n_disorder=8, n_warm=130, n_sweeps=200):
    from peapods_tpu import Ising

    def make():
        return Ising(shape, couplings="gaussian",
                     temperatures=np.geomspace(0.8, 2.0, n_temps),
                     n_replicas=n_replicas, n_disorder=n_disorder, seed=5)

    pt_kw = dict(pt_interval=1, pt_schedule="full_ladder")
    model = make()
    res, compile_s, ms = timed(
        model, n_warm, n_sweeps, overlap_cluster_update_interval=10,
        overlap_cluster_build_mode="jorg+cmr", **pt_kw,
    )
    check_finite(res, ("mags2", "energies", "overlap2", "link_overlap2"),
                 "glass")
    q2 = np.asarray(res["overlap2"])
    if q2.shape != (n_temps,) or (q2 < 0).any() or (q2 > 1).any():
        raise SmokeError(f"glass q^2 out of range: {q2}")
    # the same ensemble without overlap moves splits sweep+PT from the events
    plain = make()
    _, compile_p, ms_plain = timed(plain, n_warm, n_sweeps, **pt_kw)
    n_spins = int(np.prod(shape)) * n_temps * n_replicas * n_disorder
    print(
        f"phase 4 glass {'x'.join(map(str, shape))} gaussian "
        f"{n_temps}T x {n_replicas}R x {n_disorder}D jorg+cmr/10 "
        f"full-ladder: compile_s={compile_s:.2f} ms_per_sweep={ms:.4f} "
        f"flips_per_s={n_spins * 1e3 / ms:.4e} card={card!r} "
        f"no_overlap_ms={ms_plain:.4f} "
        f"overlap_event_ms_per_event={(ms - ms_plain) * 10:.4f} "
        f"no_overlap_compile_s={compile_p:.2f} peak_gib={peak_gib():.2f} "
        f"checksum={state_checksum(model._sim, res)} plan={plan_of(model)!r}",
        flush=True,
    )
    return model


def _sweep_vs_reference(shape, n_sys, gaussian, gibbs, seed):
    """Per-colour ``mc_sweep`` on the device vs the numpy colour step, both
    from the device's previous state.  Returns (tie mismatches, flips)."""
    import jax
    import jax.numpy as jnp

    import reference_np as ref
    from peapods_tpu.ops.geometry import GridOps
    from peapods_tpu.ops.lattice import Lattice
    from peapods_tpu.ops.sweep import mc_sweep

    lat = Lattice(list(shape))
    fwd, bwd = ref.neighbor_tables(shape, lat.offsets)
    rng = np.random.default_rng(seed)
    if gaussian:
        coup = rng.standard_normal((lat.n_spins, lat.n_neighbors))
    else:
        coup = rng.choice([-1.0, 1.0], size=(lat.n_spins, lat.n_neighbors))
    coup = coup.astype(np.float32)
    coup_bwd = coup[lat.bwd, np.arange(lat.n_neighbors)[None, :]]
    temps = rng.uniform(0.8, 3.2, n_sys).astype(np.float32)
    masks = lat.color_masks()
    spins0 = rng.choice([-1, 1], size=(n_sys, lat.n_spins)).astype(np.int8)
    geom = GridOps.from_lattice(lat)
    step = jax.jit(lambda s, m, u: mc_sweep(
        s, jnp.asarray(coup), jnp.asarray(coup_bwd), geom, m,
        jnp.asarray(temps), jax.random.PRNGKey(0), gibbs=gibbs, uniforms=u,
    ))
    spins, n_tie = spins0, 0
    for c in range(lat.n_colors):
        u = rng.random((1, n_sys, lat.n_spins), dtype=np.float32)
        got = np.asarray(step(jnp.asarray(spins), jnp.asarray(masks[c:c + 1]),
                              jnp.asarray(u)))
        want, tie = ref.sweep_color(spins, coup, fwd, bwd, masks[c], temps,
                                    u[0], gibbs)
        ties, hard = ref.sweep_mismatches(got, want, tie)
        if hard:
            raise SmokeError(
                f"mc_sweep {shape} gibbs={gibbs} colour {c}: {hard} sites "
                "differ from the numpy reference outside the rounding window"
            )
        n_tie += ties
        spins = got
    return n_tie, int((spins != spins0).sum())


def phase_reference(flagship, glass, sweep_cases=None, cc_shape=(256, 256)):
    import jax
    import jax.numpy as jnp

    import reference_np as ref
    from peapods_tpu.ops import cluster as cl
    from peapods_tpu.ops.energy import energies_and_mags
    from peapods_tpu.ops.geometry import GridOps
    from peapods_tpu.ops.lattice import Lattice
    from peapods_tpu.ops.measure import overlap_dots

    parts = []
    cases = sweep_cases or [((256, 256), 24, False), ((16, 16, 16), 96, True)]
    for i, (shape, n_sys, gaussian) in enumerate(cases):
        for gibbs in (False, True):
            ties, flips = _sweep_vs_reference(shape, n_sys, gaussian, gibbs,
                                              seed=100 + i)
            parts.append(
                f"sweep_{'x'.join(map(str, shape))}x{n_sys}_"
                f"{'gibbs' if gibbs else 'metropolis'}: tie_sites={ties} "
                f"flips={flips}"
            )

    lat = Lattice(list(cc_shape))
    fwd, _ = ref.neighbor_tables(cc_shape, lat.offsets)
    rng = np.random.default_rng(7)
    active = rng.random((4, lat.n_spins, lat.n_neighbors)) < 0.5
    geom = GridOps.from_lattice(lat)
    labels = np.asarray(jax.jit(jax.vmap(
        lambda a: cl.connected_components(a, geom)
    ))(jnp.asarray(active)))
    for g in range(active.shape[0]):
        want = ref.union_find_labels(active[g], fwd)
        if not np.array_equal(labels[g], want):
            raise SmokeError(f"connected_components graph {g} != union-find")
    parts.append(
        f"cc_{'x'.join(map(str, cc_shape))}_p0.5: 4 graphs equal to "
        f"union-find, {len(np.unique(labels[0]))} components in graph 0"
    )

    for name, model in (("flagship", flagship), ("glass", glass)):
        lat = model._sim.lattice
        fwd, _ = ref.neighbor_tables(lat.shape, lat.offsets)
        spins = np.asarray(model._sim.state["spins"][0])
        coup = np.asarray(model._sim.rt.couplings[0])
        geom = GridOps.from_lattice(lat)
        e, m = jax.jit(lambda s, c: energies_and_mags(s, c, geom))(
            jnp.asarray(spins), jnp.asarray(coup))
        e_ref, scale, m_ref = ref.energies_and_mags(spins, coup, fwd)
        err = float(np.max(np.abs(np.asarray(e, np.float64) - e_ref)))
        if err > 1e-6 * scale or not np.array_equal(np.asarray(m), m_ref):
            raise SmokeError(f"{name} energies: max err {err} (scale {scale})")
        part = f"energy_{name}: max_rel_err={err / scale:.2e}"
        if model._sim.n_replicas >= 2:
            sid = np.asarray(model._sim.state["system_ids"][0])
            q, ql = jax.jit(lambda s, i: overlap_dots(s, i, geom))(
                jnp.asarray(spins), jnp.asarray(sid))
            q_ref, ql_ref = ref.overlap_dots(spins, sid, fwd)
            if not (np.array_equal(np.asarray(q), q_ref)
                    and np.array_equal(np.asarray(ql), ql_ref)):
                raise SmokeError(f"{name} overlap dots != numpy reference")
            part += " overlaps_equal"
        parts.append(part)
    print("phase 5 reference: " + "; ".join(parts), flush=True)


def _exact_4x4(temps):
    """Exact <e> and <m^2> per spin of the 4x4 periodic ferromagnet."""
    n = 16
    states = ((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1
    idx = np.arange(n).reshape(4, 4)
    bi = np.repeat(idx.reshape(-1), 2)
    bj = np.stack([np.roll(idx, -1, 0), np.roll(idx, -1, 1)], -1).reshape(-1)
    energy = (states[:, bi] * states[:, bj]).sum(1).astype(np.float64)
    mag = states.sum(1).astype(np.float64)
    out = []
    for t in temps:
        w = np.exp((energy - energy.max()) / t)
        w /= w.sum()
        out.append(((energy * w).sum() / n, ((mag / n) ** 2 * w).sum()))
    return np.array(out)


def phase_exact(n_blocks=24, block_sweeps=1000):
    from peapods_tpu import Ising

    temps = np.array([2.0, 2.5, 3.0], np.float32)
    exact = _exact_4x4(temps.astype(np.float64))
    model = Ising((4, 4), temperatures=temps, n_replicas=4, seed=29)
    kw = dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1,
              warmup_ratio=0.0)
    model.sample(block_sweeps // 2, **kw)  # burn-in
    blocks = []
    for _ in range(n_blocks):
        res = model.sample(block_sweeps, **kw)
        blocks.append(np.stack([res["energies"], res["mags2"]], -1))
    blocks = np.asarray(blocks, np.float64)  # [K, T, 2]
    mean = blocks.mean(0)
    sigma = blocks.std(0, ddof=1) / np.sqrt(n_blocks)
    z = np.abs(mean - exact) / np.maximum(sigma, 1e-12)
    if (z > 4).any():
        raise SmokeError(f"4x4 exact oracle: |z| = {z.tolist()} (> 4)")
    print(
        f"phase 6 exact 4x4 metropolis+sw+pt, {n_blocks} blocks x "
        f"{block_sweeps} sweeps: max_z={z.max():.2f} "
        f"e={mean[:, 0].round(5).tolist()} e_exact="
        f"{exact[:, 0].round(5).tolist()} m2={mean[:, 1].round(5).tolist()} "
        f"m2_exact={exact[:, 1].round(5).tolist()}",
        flush=True,
    )


def phase_multi(cards, shape=(16, 16, 16), n_temps=24, n_replicas=4,
                n_disorder=8, n_warm=130, n_sweeps=200, n_devices=4):
    """Config 5 over ``mesh="auto"`` (disorder sharded over the cards) vs
    ``mesh=None`` on one card: same seed, bitwise-equal spins."""
    import jax

    from peapods_tpu.engine.simulation import IsingSimulation

    rng = np.random.default_rng(5)
    coup = rng.standard_normal((n_disorder,) + tuple(shape) + (len(shape),))
    temps = np.geomspace(0.8, 2.0, n_temps)
    kw = dict(pt_interval=1, pt_schedule="full_ladder",
              overlap_cluster_update_interval=10,
              overlap_cluster_build_mode="jorg+cmr")
    runs = {}
    for name, mesh in (("sharded", "auto"), ("single", None)):
        sim = IsingSimulation(list(shape), coup, temps, n_replicas, None, 5,
                              mesh=mesh)
        if name == "sharded" and (
            sim.mesh is None or sim.mesh.devices.size != n_devices
        ):
            raise SmokeError(f"auto mesh is {sim.mesh}, not {n_devices} cards")
        t0 = time.perf_counter()
        sim.sample(n_warm, "metropolis", warmup_ratio=0.0, **kw)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = sim.sample(n_sweeps, "metropolis", warmup_ratio=0.0, **kw)
        dt = time.perf_counter() - t0
        runs[name] = dict(
            res=res,
            spins=np.asarray(sim.state["spins"]),
            sid=np.asarray(sim.state["system_ids"]),
            compile_s=max(first - n_warm * dt / n_sweeps, 0.0),
            ms=1e3 * dt / n_sweeps,
            plan=" | ".join(p.describe_plan() for p in sim._programs.values()),
        )
    a, b = runs["sharded"], runs["single"]
    if not (np.array_equal(a["spins"], b["spins"])
            and np.array_equal(a["sid"], b["sid"])):
        n_diff = int((a["spins"] != b["spins"]).sum())
        raise SmokeError(f"sharded spins differ from single-card: {n_diff}")
    worst = 0.0
    for key, ref_v in b["res"].items():
        ref_v = np.asarray(ref_v) if isinstance(ref_v, np.ndarray) else None
        if ref_v is None or ref_v.dtype.kind != "f" or not ref_v.size:
            continue
        scale = max(float(np.max(np.abs(ref_v))), 1e-30)
        err = float(np.max(np.abs(np.asarray(a["res"][key]) - ref_v))) / scale
        worst = max(worst, err)
        if err > 1e-5:
            raise SmokeError(f"observable {key}: relative diff {err:.2e}")
    n_spins = int(np.prod(shape)) * n_temps * n_replicas * n_disorder
    print(
        f"phase multi config5 {'x'.join(map(str, shape))} x{n_disorder}D: "
        f"cards={cards!r} spins+system_ids bitwise equal, "
        f"max_rel_obs_diff={worst:.2e}; "
        f"sharded({len(jax.devices())} cards) compile_s={a['compile_s']:.2f} "
        f"ms_per_sweep={a['ms']:.4f} "
        f"flips_per_s={n_spins * 1e3 / a['ms']:.4e} plan={a['plan']!r}; "
        f"single compile_s={b['compile_s']:.2f} ms_per_sweep={b['ms']:.4f} "
        f"flips_per_s={n_spins * 1e3 / b['ms']:.4e} plan={b['plan']!r}",
        flush=True,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded-disorder phase")
    args = ap.parse_args(argv)
    try:
        import_package()
        devs, card = phase_device(4 if args.multi else 1)
    except (SmokeError, OSError, subprocess.SubprocessError) as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        return 1
    if args.multi:
        phase_multi(card_lines())
    else:
        flagship = phase_flagship(card)
        phase_cluster(card)
        glass = phase_glass(card)
        phase_reference(flagship, glass)
        phase_exact()
    print(result_line(devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
