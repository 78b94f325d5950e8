"""``chip_smoke.py``: its phases at toy sizes on the CPU, its refusal to run
without a GPU, and (marked ``gpu``) the phases on the card itself."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: toy shapes: short steps along the loop, odometry noise well above the
#: matcher's error so the ATE check has a margin at 24 scans
TOY = chip_smoke.Sizes(
    n_beams=90, map_size=160, track=(24, 0.04), loop=(24, 0.1),
    rbpf=(24, 0.04), n_poses=64, n_particles=4, n_keyframes=32, run_steps=12,
    odom_noise_xy=0.03, odom_noise_theta=0.02,
)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; on the card run: python chip_smoke.py")


def test_device_phase_raises_without_gpu():
    with pytest.raises(AssertionError, match="no GPU"):
        chip_smoke.device_phase()


def test_reference_phase_toy(capsys):
    chip_smoke.reference_phase(TOY)
    out = capsys.readouterr().out
    assert out.count("reference:") == 8
    assert "plane_bitwise=True" in out and "rbpf_3_steps_bitwise=True" in out


@pytest.mark.parametrize("preset", chip_smoke.PRESETS)
def test_end_to_end_phase_toy(preset, capsys):
    out = chip_smoke.end_to_end_phase(TOY, (preset,))
    traj, _ = out[preset]
    assert traj.shape == (24, 3)
    assert f"preset={preset}" in capsys.readouterr().out


def test_run_main_determinism_memory_toy(capsys):
    summary = chip_smoke.run_main_phase(TOY)
    assert summary["scans"] == TOY.run_steps
    chip_smoke.determinism_phase(TOY)
    chip_smoke.memory_phase(TOY)
    out = capsys.readouterr().out
    assert "trajectory_bitwise=True map_bitwise=True" in out
    assert "CompiledMemoryStats" in out


def _run_smoke(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = _run_smoke(ROOT, env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot import the engine and must fail without a result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run_smoke(tmp_path, env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_smoke_on_gpu(gpu, capsys):
    """Every single-card phase at the shipped shapes (the script's own run)."""
    chip_smoke.main([])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["device"]["platform"] == "gpu"
