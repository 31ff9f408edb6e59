"""Whole runs of each cell at a CPU test's size: correct as they stand,
not correct under each planted fault and under the control; a cell, a
configuration, a traffic mix and a per-layer metric added as files; no
JAX in a run's process."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import check, control, faults, manifest
from benchmark import run as harness
from benchmark.reference import nets

from .conftest import ROOT, tiny

CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]
SEED = 2**31 + 12345


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct(cell):
    res = harness.run(cell, SEED, 1.0, False, "cpu", cell=tiny(cell, fp32=True))
    assert res["correct"], res["checked"]
    assert set(res["metrics"]) == {"audio_rtf", "setup_s"}
    assert res["metrics"]["audio_rtf"]["value"] > 0
    assert list(res)[-1] == "checked"
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("fault", list(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    """The window is long enough for a request to finish on a loaded CPU:
    a GAN read out a few epochs in has not yet moved far from the
    reference's readout under half the frames."""
    with faults.FAULTS[fault]():
        res = harness.run(cell, SEED + 1, 3.0, False, "cpu", cell=tiny(cell, fp32=True))
    assert not res["correct"], res["checked"]
    assert res["failed"] == 1


def _control_fails(cell, device):
    """The control's readout comes after 30 steps, as a run's come after
    many: after three, the fp8 GAN's readout still reads as the
    reference's (0.002)."""
    c = tiny(cell)
    numbers, _ = control.readings(c, SEED + 2, device, epochs=30)
    ok, checked = check.judge(numbers, c.limits)
    assert not ok, checked


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("gan")])
def test_the_control_is_not_correct(cell):
    """The GAN cells' control (float8 operands) runs on the CPU."""
    _control_fails(cell, torch.device("cpu"))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("unet")])
def test_the_tf32_control_is_not_correct_on_the_card(cell, cuda):
    """The U-Net cells' control (TF32) exists only on the card."""
    _control_fails(cell, cuda)


def test_the_control_computes_one_precision_lower():
    assert nets.control_precision({"conv_dtype": "float32"}) == "tf32"
    assert nets.control_precision({"conv_dtype": "bfloat16"}) == "fp8"
    assert nets.reference_precision({"conv_dtype": "bfloat16"}) == "bf16"


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    """A throwaway configuration, traffic mix, cell, limits and per-layer
    metric, added as files and manifest entries to a copy, are found by
    name without an edit to any file of the harness."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = root / "benchmark"
    shutil.copy(b / "configs" / "unet_part1.json", b / "configs" / "unet_throwaway.json")
    traffic = json.loads((b / "workloads" / "single_frame_dropouts.json").read_text())
    traffic.update(sample_rate=8000, clip_seconds=1.0, epochs=5, distinct_requests=2)
    (b / "workloads" / "tiny_dropouts.json").write_text(json.dumps(traffic))
    (b / "limits" / "throwaway-cell.json").write_text(json.dumps({"loss_gap": 1e-4}))
    (b / "layer_metrics" / "clip_epochs_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.clip_epochs)\n")
    m = manifest.load(ROOT)
    m["configs"].append({"name": "unet_throwaway", "source": "https://example.org/x",
                         "file": "benchmark/configs/unet_throwaway.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "throwaway-cell", "config": "unet_throwaway",
                           "traffic": "tiny_dropouts", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "clip_epochs_traced", "unit": "epochs", "better": "higher",
                           "source": "program_counter", "layer": "model step",
                           "moves": "audio_rtf", "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    res = harness.run("throwaway-cell", SEED, 1.0, True, "cpu", root=str(root))
    assert res["correct"], res["checked"]
    assert res["metrics"]["clip_epochs_traced"]["value"] > 0
    assert res["checked"]["loss_gap"]["limit"] == 1e-4
    assert res["checked"]["grad_gap"]["limit"] is None


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "audio_inpainting_tpu_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "audio_inpainting_tpu.ops", sys)
    assert harness.forbidden_modules() == ["audio_inpainting_tpu", "jax"]


def test_a_run_loads_no_jax():
    code = ("import sys, dataclasses; sys.path.insert(0, %r)\n"
            "from benchmark.tests.conftest import tiny\n"
            "from benchmark import run\n"
            "run.run('gan-part2-hole2s', 7, 0.5, False, 'cpu', cell=tiny('gan-part2-hole2s', fp32=True))\n"
            "print(run.forbidden_modules())\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


@pytest.mark.requires_cuda
def test_a_cell_runs_on_the_card(cuda):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "unet-single-10s",
                          "--seed", "3", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
