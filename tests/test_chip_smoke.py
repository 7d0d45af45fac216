"""Host logic of ``chip_smoke.py`` and the GPU-independence of the engine.

The smoke script itself only runs on a GPU; here it must refuse the CPU,
refuse to run outside a checkout, and format its closing line exactly.
The engine must build the same plain path whatever backend JAX reports.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(args, cwd, env_update=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_update or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_require_gpu_refuses_cpu_backend():
    with pytest.raises(chip_smoke.SmokeError, match="no GPU"):
        chip_smoke.require_gpu()


def test_script_exits_nonzero_on_cpu_and_prints_no_result():
    proc = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path, drop=("PYTHONPATH",))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_result_line_is_exact_json():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(chip_smoke.result_line([Dev()] * 4))["device"][
        "count"] == 4


_PRINT_CACHE = (
    "import jax, peapods_tpu; print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_honours_env(tmp_path):
    proc = _run(["-c", _PRINT_CACHE], cwd=ROOT,
                env_update={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(tmp_path)


def test_compile_cache_defaults_to_checkout():
    proc = _run(["-c", _PRINT_CACHE], cwd=ROOT,
                drop=("JAX_COMPILATION_CACHE_DIR",))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(ROOT / ".jax_cache")


def test_exact_4x4_matches_test_oracle():
    from test_exact_equilibrium import enumerate_2x2x4, exact_em

    temps = np.array([2.0, 2.5, 3.0])
    got = chip_smoke._exact_4x4(temps)
    E, M = enumerate_2x2x4()
    want = np.array([exact_em(E, M, t) for t in temps])
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize(
    "shape,offsets",
    [
        ((8, 8), None),
        ((8, 16), [[1, 0], [0, 1], [1, -1]]),
        ((4, 4, 4), None),
        ((4, 4, 4), [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1]]),
        ((4, 4, 4), [[1, 1, 0], [1, 0, 1], [0, 1, 1],
                     [1, -1, 0], [1, 0, -1], [0, 1, -1]]),
    ],
    ids=["square", "triangular", "cubic", "bcc", "fcc"],
)
def test_engine_plan_is_plain_under_gpu_backend(monkeypatch, shape, offsets):
    """With JAX reporting a GPU, the engine builds and traces the same plain
    XLA program: no kernel selection depends on the backend."""
    from peapods_tpu.engine.config import (
        ClusterConfig, OverlapClusterConfig, SimConfig, parse_overlap_modes,
    )
    from peapods_tpu.engine.loop import LoopProgram, Runtime
    from peapods_tpu.engine.simulation import IsingSimulation
    from peapods_tpu.ops.lattice import Lattice

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    lat = Lattice(list(shape), offsets)
    temps = np.array([1.5, 2.5], np.float32)
    coup = np.ones((2, lat.n_spins, lat.n_neighbors), np.float32)
    rt = Runtime.build(lat, coup, temps, 2)
    cfg = SimConfig(
        n_sweeps=4, warmup_sweeps=0, sweep_mode="metropolis",
        cluster_update=ClusterConfig(interval=2, mode="sw", action="update"),
        pt_interval=1,
        overlap_cluster=OverlapClusterConfig(
            interval=2, modes=parse_overlap_modes("houdayer+jorg+cmr"),
            cluster_mode="wolff", action="update",
        ),
    )
    prog = LoopProgram(rt, cfg)
    assert prog.describe_plan() == "sweep=jnp, cc=jnp"
    sim = IsingSimulation(list(shape), coup.reshape((2,) + shape + (-1,)),
                          temps, 2, offsets, 3, mesh=None)
    xs = np.arange(4, dtype=np.int32)
    out = jax.eval_shape(
        prog.chunk_runner(4), (sim.state, prog.init_accumulators()), xs
    )
    assert out[0][0]["spins"].shape == (2, 4, lat.n_spins)
