"""The CPU-testable parts of chip_smoke.py, and its phases rehearsed at a
tiny width on the CPU backend (the card runs them at full width)."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from dstdgcn_tpu.utils import compile_cache  # noqa: E402

TINY = cs.Widths(input_n=4, output_n=6, joints=22, channels=8, layers=1,
                 train_batch=8, eval_batch=16, mesh_batch=8)


def test_refuses_cpu_only_devices():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.require_gpu(jax.devices("cpu"))
    with pytest.raises(SystemExit):
        cs.require_gpu([])


def test_script_without_gpu_exits_nonzero_and_prints_no_result():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_last_line_has_the_required_form():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = cs.result_line([Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line
    assert json.loads(cs.result_line([Dev()] * 4))["device"]["count"] == 4


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}, "/somewhere/cache"),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir_rules(env, want):
    assert compile_cache.cache_dir(env) == want


def test_four_cards_selects_only_the_mesh_phase():
    assert cs.selected_phases(["--four-cards"]) == ["mesh"]
    default = cs.selected_phases([])
    assert "mesh" not in default
    assert default[:2] == ["runner", "correctness"]
    assert set(default) <= set(cs.PHASES)


@pytest.fixture
def in_repo(monkeypatch, tmp_path):
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(cs, "RUN_ROOT", str(tmp_path / "runs"))


def test_runner_phase_rehearsal(in_repo, capsys):
    cs.runner_phase(TINY)
    out = capsys.readouterr().out
    assert out.count("best.ckpt reload test_loss") == 2
    assert "FAIL" not in out


def test_correctness_phase_rehearsal(capsys):
    cs.correctness_phase(TINY)
    out = capsys.readouterr().out
    assert "gradient rel err" in out and "FAIL" not in out


def test_memory_phase_rehearsal(capsys):
    cs.memory_phase(TINY)
    assert "0 compilations in 5 train steps" in capsys.readouterr().out


def test_mesh_phase_rehearsal(in_repo, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cs.mesh_phase(TINY)
    out = capsys.readouterr().out
    assert "shards on 4 distinct devices" in out and "FAIL" not in out
