"""Whole runs of each cell at a CPU test's size: correct as they stand,
not correct under each planted fault and under the control; a cell, a
configuration, a traffic mix and a per-layer metric added as files, and a
new kind of configuration with its own driver and check; no JAX in a
run's process."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
import torch

from benchmark import check, control, manifest
from benchmark import run as harness
from benchmark.checks import training
from benchmark.reference import nets

from .conftest import ROOT, tiny

CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]
SEED = 2**31 + 12345


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct(cell):
    res = harness.run(cell, SEED, 1.0, False, "cpu", cell=tiny(cell, fp32=True))
    assert res["correct"], res["checked"]
    # the CPU has no device time: a rate over it is left out there
    e2e = manifest.cell(ROOT, cell).end_to_end
    assert set(res["metrics"]) == {m["name"] for m in e2e if m["source"] == "host_clock"}
    assert "setup_s" in res["metrics"] and all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checked"
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_a_rate_over_device_time_reads_one_busy_session_over_the_window(monkeypatch):
    """Untraced, a cell that reports ``audio_per_device_s`` runs its window
    under one session, and divides the audio of all the window's
    clip-epochs by its busy seconds."""
    seen = []

    def reading(kind, prof):
        seen.append(kind)
        return SimpleNamespace(busy_s=0.25)

    monkeypatch.setattr(harness, "_reading", reading)
    cell = "gan-part2-hole2s"
    c = tiny(cell, fp32=True)
    res = harness.run(cell, SEED + 3, 1.5, False, "cpu", cell=c)
    assert res["correct"], res["checked"]
    assert seen == ["busy"]
    assert set(res["metrics"]) == {"audio_per_device_s", "setup_s"}
    audio = res["metrics"]["audio_per_device_s"]["value"] * 0.25
    clip_epochs = audio * c.traffic["epochs"] / c.traffic["clip_seconds"]
    assert clip_epochs >= 1 and clip_epochs == pytest.approx(round(clip_epochs), abs=1e-9)


def test_a_busy_session_that_lost_a_record_fails_the_run(monkeypatch):
    def reading(kind, prof):
        raise RuntimeError(f"1 of 9 launches traced in the {kind} slice have no device record")

    monkeypatch.setattr(harness, "_reading", reading)
    cell = "gan-part2-hole2s"
    with pytest.raises(RuntimeError, match="busy slice"):
        harness.run(cell, SEED + 6, 0.5, False, "cpu", cell=tiny(cell, fp32=True))


def test_a_cell_that_reads_no_device_time_opens_no_session(monkeypatch):
    opened = []
    monkeypatch.setattr(harness.trace, "session", lambda ops=True: opened.append(ops))
    cell = "unet-single-10s"
    res = harness.run(cell, SEED + 4, 0.5, False, "cpu", cell=tiny(cell, fp32=True))
    assert opened == [] and set(res["metrics"]) == {"audio_rtf", "setup_s"}


@pytest.mark.parametrize("fault", list(training.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    """The window is long enough for a request to finish on a loaded CPU:
    a GAN read out a few epochs in has not yet moved far from the
    reference's readout under half the frames."""
    with training.FAULTS[fault]():
        res = harness.run(cell, SEED + 1, 3.0, False, "cpu", cell=tiny(cell, fp32=True))
    assert not res["correct"], res["checked"]
    assert res["failed"] == 1


def test_faults_py_plants_the_faults_of_the_cells_kind(monkeypatch, capsys):
    """``faults.py`` runs the cell under each fault of its kind's FAULTS by
    default, and refuses a fault that the kind does not have."""
    from benchmark import faults

    monkeypatch.setattr(harness, "run", lambda *a: {"correct": False, "checked": {}})
    assert faults.main(["--workload", CELLS[0], "--seeds", "5", "6"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["fault"], r["seed"]) for r in lines] == [(f, s) for f in training.FAULTS
                                                         for s in (5, 6)]
    with pytest.raises(SystemExit):
        faults.main(["--workload", CELLS[0], "--seeds", "5", "--faults", "no_such_fault"])


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


def test_the_control_loads_nothing_of_the_port():
    """The control's process runs the reference alone: importing the port
    would turn on cuDNN's deterministic algorithms under it."""
    code = ("import sys, torch; sys.path.insert(0, %r)\n"
            "from benchmark.tests.conftest import tiny\n"
            "from benchmark import control\n"
            "control.readings(tiny('gan-part2-hole2s'), 7, torch.device('cpu'))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'audio_inpainting_torch'}))\n"
            ) % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


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
    _reports_audio_rtf(m, "throwaway-cell")
    m["per_layer"].append({"name": "clip_epochs_traced", "unit": "epochs", "better": "higher",
                           "source": "program_counter", "layer": "model step",
                           "moves": "audio_rtf", "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    res = harness.run("throwaway-cell", SEED, 1.0, True, "cpu", root=str(root))
    assert res["correct"], res["checked"]
    assert res["metrics"]["clip_epochs_traced"]["value"] > 0
    assert res["checked"]["loss_gap"]["limit"] == 1e-4
    assert res["checked"]["grad_gap"]["limit"] is None


def _reports_audio_rtf(m, cell):
    """Lists a new cell under ``audio_rtf``, as a change that adds a cell
    does."""
    (e2e,) = [e for e in m["end_to_end"] if e["name"] == "audio_rtf"]
    e2e["workloads"].append(cell)


# A throwaway kind of configuration: a seeded iterative sampler with no
# optimizer, its driver, check, reference, traffic and limits, each a new
# file of the copy.
SAMPLER = {
    "drivers/toy_sampler.py": '''
        """A seeded iterative sampler: the state starts as noise drawn from
        the request's seed and each step moves it a fixed share of the way to
        the damaged clip's magnitude over its peak; the readout takes it back
        to audio through the port's iSTFT with the clip's phase."""

        import torch

        from audio_inpainting_torch import ops

        from . import base


        class Job(base.Job):
            def __init__(self, driver, req):
                super().__init__(driver, req)
                (x,) = req.damaged
                self.n = len(x)
                self.cfg = ops.torch_stft_config(driver.config["stft"]["n_fft"],
                                                 driver.config["stft"]["hop"])
                mag, self.phase = ops.magphase(ops.stft(torch.tensor(x, device=driver.device),
                                                        self.cfg))
                self.peak = mag.max().clamp_min(1e-12)
                self.target = mag / self.peak
                noise = torch.randn(mag.shape, generator=torch.Generator().manual_seed(req.seed))
                self.x = noise.to(driver.device)

            def epoch(self):
                est = self.x - self.target
                self.x = self.x - self.driver.config["rate"] * est
                return est

            def losses(self, ret):
                return ret.double().cpu().reshape(1, -1).numpy()

            def states(self, clone=True):
                return [{"x": self.x.clone() if clone else self.x}]

            def finish(self):
                z = ops.polar(self.x.clamp_min(0.0) * self.peak, self.phase)
                return ops.istft(z, self.cfg, self.n).cpu().numpy()[None]


        class Driver(base.Driver):
            Job = Job
    ''',
    "reference/toy_sampler.py": '''
        """The sampler written out again in plain PyTorch."""

        import torch

        from .stft import istft, stft


        def analyse(req, config, device, dtype):
            (x,) = req.damaged
            z = stft(torch.from_numpy(x).to(device), config["stft"]["n_fft"], config["stft"]["hop"])
            mag = z.abs()
            peak = mag.max().clamp_min(1e-12)
            noise = torch.randn(mag.shape, generator=torch.Generator().manual_seed(req.seed))
            return {"x": noise.to(device, dtype), "target": (mag / peak).to(dtype), "peak": peak,
                    "phase": z.angle(), "n": len(x)}


        def step(x, a, rate):
            est = x - a["target"]
            return x - rate * est, est


        def readout(x, a, config):
            z = torch.polar(x.float().clamp_min(0.0) * a["peak"], a["phase"])
            return istft(z, config["stft"]["n_fft"], config["stft"]["hop"], a["n"]).cpu().numpy()
    ''',
    "checks/toy_sampler.py": '''
        """The sampler's check: each step's estimate and state, and each
        readout, against the reference (the worst max gap over the
        reference's peak); the control computes in bfloat16; the fault
        scales the port's iSTFT by 0.9."""

        import contextlib

        import numpy as np
        import torch

        from ..check import Answer, Start, Step
        from ..reference import toy_sampler as ref

        NUMBERS = ("estimate_gap", "state_gap", "readout_gap")


        def _gap(a, b):
            a = torch.as_tensor(a).double().cpu().reshape(-1)
            b = torch.as_tensor(b).double().cpu().reshape(-1)
            return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


        def compare(config, traffic, start, steps, answers, device):
            out, where = dict.fromkeys(NUMBERS, 0.0), dict.fromkeys(NUMBERS, "")

            def worst(name, value, at):
                if value > out[name] or not where[name]:
                    out[name], where[name] = max(out[name], value), at

            if start is not None:
                a = ref.analyse(start.req, config, device, torch.float32)
                xs = [a["x"]]
                for k in range(3):
                    x, est = ref.step(xs[-1], a, config["rate"])
                    xs.append(x)
                    worst("estimate_gap", _gap(start.losses[k][0], est), f"step {k + 1}")
                for k, s in ((0, start.s0), (1, start.s1), (3, start.s3)):
                    worst("state_gap", _gap(s[0]["x"], xs[k]), f"after step {k}")
            for s in steps:
                a = ref.analyse(s.req, config, device, torch.float32)
                x, est = ref.step(s.before[0]["x"].to(device), a, config["rate"])
                worst("estimate_gap", _gap(s.losses[0], est), f"request {s.req.index}, later step")
                worst("state_gap", _gap(s.after[0]["x"], x), f"request {s.req.index}, later step")
            for ans in answers:
                a = ref.analyse(ans.req, config, device, torch.float32)
                y = ref.readout(ans.state[0]["x"].to(device), a, config)
                worst("readout_gap", _gap(ans.audio[0], y), f"request {ans.req.index}")
            return out, where


        def control(config, traffic, req, device, epochs=3):
            a = ref.analyse(req, config, device, torch.bfloat16)
            xs, ests = [a["x"]], []
            for _ in range(epochs + 1):
                x, est = ref.step(xs[-1], a, config["rate"])
                xs.append(x)
                ests.append(est.double().cpu().reshape(1, -1).numpy())
            state = [[{"x": x.float()}] for x in xs]
            return (Start(req, ests[:3], state[0], state[1], state[3]),
                    [Step(req, state[epochs], ests[epochs], state[epochs + 1])],
                    [Answer(req, state[epochs + 1], np.stack([ref.readout(xs[-1], a, config)]))])


        @contextlib.contextmanager
        def altered_answer():
            from audio_inpainting_torch import ops

            orig = ops.istft
            ops.istft = lambda *args, **kwargs: orig(*args, **kwargs) * 0.9
            try:
                yield
            finally:
                ops.istft = orig


        FAULTS = {"altered_answer": altered_answer}
    ''',
    "configs/toy_sampler.json": json.dumps(
        {"driver": "toy_sampler", "check": "toy_sampler", "stft": {"n_fft": 256, "hop": 64},
         "rate": 0.25}),
    "workloads/toy_hole.json": json.dumps(
        {"entry": "sampler", "clips_per_request": 1, "clip_seconds": 1.0, "sample_rate": 8000,
         "originals": False, "damage": {"kind": "centre_hole", "half_seconds": 0.25},
         "epochs": 6, "distinct_requests": 2, "arrivals": "closed loop, one client"}),
    "limits/toy-cell.json": json.dumps(
        {"estimate_gap": 1e-5, "state_gap": 1e-5, "readout_gap": 1e-5}),
}

# run from the copy, so that its new files are found as the benchmark's own
SAMPLER_RUNS = '''
import json, sys
sys.path[:0] = [{copy!r}, {root!r}]
import torch
torch.set_num_threads(2)
from benchmark import check, control, manifest, run
assert run.ROOT == {copy!r}, run.ROOT
cell = manifest.cell(run.ROOT, "toy-cell")
res = run.run("toy-cell", {seed}, 1.0, False, "cpu")
print(json.dumps({{"run": "sound", "result": res}}))
for name, fault in manifest.check(run.ROOT, cell.config).FAULTS.items():
    with fault():
        res = run.run("toy-cell", {seed} + 1, 1.0, False, "cpu")
    print(json.dumps({{"run": name, "result": res}}))
numbers, _ = control.readings(cell, {seed} + 2, torch.device("cpu"))
ok, checked = check.judge(numbers, cell.limits)
print(json.dumps({{"run": "control", "result": {{"correct": ok, "checked": checked}}}}))
'''


def _digests(root):
    return {os.path.relpath(os.path.join(d, f), root):
            hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for d, _, files in os.walk(root) for f in files}


def test_a_kind_of_configuration_added_as_files(tmp_path):
    """A kind with no optimizer (a seeded sampler, its driver, check,
    reference, traffic and limits), added as files and manifest entries to
    a copy, runs correct, is not correct under its fault or its control,
    and leaves every file that the copy held before as it was."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(root / "benchmark")
    for rel, text in SAMPLER.items():
        assert not (root / "benchmark" / rel).exists(), rel
        (root / "benchmark" / rel).write_text(textwrap.dedent(text).lstrip())
    m = manifest.load(ROOT)
    m["configs"].append({"name": "toy_sampler", "source": "https://example.org/x",
                         "file": "benchmark/configs/toy_sampler.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "toy-cell", "config": "toy_sampler", "traffic": "toy_hole",
                           "chips": 1, "why": "a test"})
    _reports_audio_rtf(m, "toy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    out = subprocess.run(
        [sys.executable, "-c", SAMPLER_RUNS.format(copy=str(root), root=ROOT, seed=SEED)],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = {r["run"]: r["result"] for r in map(json.loads, out.stdout.strip().splitlines())}
    assert set(runs) == {"sound", "altered_answer", "control"}
    sound = runs["sound"]
    assert sound["correct"], sound["checked"]
    assert set(sound["checked"]) == {"estimate_gap", "state_gap", "readout_gap"}
    assert sound["attempted"] > 1 and sound["metrics"]["audio_rtf"]["value"] > 0
    assert not runs["altered_answer"]["correct"], runs["altered_answer"]["checked"]
    assert runs["altered_answer"]["checked"]["readout_gap"]["value"] > 0.05
    assert not runs["control"]["correct"], runs["control"]["checked"]
    after = _digests(root / "benchmark")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) >= set(SAMPLER)


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
