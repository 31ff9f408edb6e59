"""The SD kind (``drivers/riffusion.py``, ``checks/denoising.py``,
``reference/sd.py``) at a CPU test's size: the cell's run is correct, and
not correct under each planted fault or under a bfloat16 control; the
driver refuses traffic whose steps are not the sampler's; the control's
process loads nothing of the port; and the cell's three readers
(``sd_mfu_pct``, ``attention_roofline``, ``launches_per_step``) on
made-up events and spans.

The CPU size: the port's ``tiny()`` widths, a 32^2 canvas, 3 PLMS steps
(4 evaluations a request), 1 s clips at 8 kHz with a centred 0.5 s hole.
Its limits, each of the reference's largest magnitude: 3e-4 for the
estimates and latents (measured up to 7e-5: the guidance and a UNet on
random weights amplify rounding from one evaluation to the next) and
1e-5 for the audio (measured 0)."""

import copy
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from audio_inpainting_torch.utils import profiling
from benchmark import check, counting_sd, gen, manifest, trace
from benchmark import run as harness
from benchmark.checks import denoising
from benchmark.trace import Event

from .conftest import ROOT

CELL = "riffusion-sd1-512"
SEED = 2**31 + 1919
LIMITS = {"eps_gap": 3e-4, "latent_gap": 3e-4, "step_eps_gap": 3e-4, "step_latent_gap": 3e-4,
          "readout_gap": 1e-5}


def tiny_cell():
    c = manifest.cell(ROOT, CELL)
    cfg = copy.deepcopy(c.config)
    cfg["unet"].update(block_out_channels=[8, 16], layers_per_block=1, cross_attention_dim=16,
                       attention_head_dim=2, norm_num_groups=4,
                       down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                       up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"])
    cfg["vae"].update(block_out_channels=[8, 16], layers_per_block=1, norm_num_groups=4)
    cfg["sampler"].update(steps=3, canvas=32)
    cfg["context"].update(width=16)
    traffic = dict(c.traffic, sample_rate=8000, clip_seconds=1.0, epochs=4,
                   damage={"kind": "centre_hole", "half_seconds": 0.25})
    return dataclasses.replace(c, config=cfg, traffic=traffic, limits=LIMITS)


def test_the_cells_files_and_entries():
    c = manifest.cell(ROOT, CELL)
    assert c.config["driver"] == "riffusion" and c.config["check"] == "denoising"
    assert c.traffic["epochs"] == c.config["sampler"]["steps"] + 1 == 51
    assert set(c.limits) == set(denoising.NUMBERS)
    assert [m["name"] for m in c.end_to_end] == ["audio_per_device_s", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["audio_rtf.gan", "device_idle_pct.gan",
                                                 "sd_mfu_pct", "attention_roofline",
                                                 "launches_per_step"]


def test_a_tiny_run_is_correct():
    c = tiny_cell()
    res = harness.run(CELL, SEED, 1.0, False, "cpu", cell=c)
    assert res["correct"], res["checked"]
    assert set(res["checked"]) == set(denoising.NUMBERS)
    # the CPU has no device time, so the rate over it is left out there
    assert res["attempted"] > 1 and set(res["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("fault", list(denoising.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    with denoising.FAULTS[fault]():
        res = harness.run(CELL, SEED + 1, 1.0, False, "cpu", cell=tiny_cell())
    assert not res["correct"], res["checked"]
    assert res["failed"] == 1


def test_a_bfloat16_control_is_not_correct():
    c = tiny_cell()
    req = gen.make_request(c.traffic, c.config, SEED + 2, 0)
    cpu = torch.device("cpu")
    start, steps, answers = denoising.control(c.config, c.traffic, req, cpu, prec="bf16")
    ok, checked = check.judge(denoising.compare(c.config, c.traffic, start, steps, answers,
                                                cpu)[0], c.limits)
    assert not ok, checked
    # the same handover in float32 reads as the reference itself
    start, steps, answers = denoising.control(c.config, c.traffic, req, cpu, prec="fp32")
    numbers, _ = denoising.compare(c.config, c.traffic, start, steps, answers, cpu)
    assert numbers == dict.fromkeys(denoising.NUMBERS, 0.0)


def test_a_float32_computation_in_another_order_is_correct():
    """The reference in float64 handed over in the port's place reads as
    a sound float32 computation whose sums run in another order (a fused
    kernel, another convolution algorithm): under the limits."""
    c = tiny_cell()
    req = gen.make_request(c.traffic, c.config, SEED + 4, 0)
    cpu = torch.device("cpu")
    out = denoising.control(c.config, c.traffic, req, cpu, prec="fp64")
    ok, checked = check.judge(denoising.compare(c.config, c.traffic, *out, cpu)[0], c.limits)
    assert ok, checked
    assert checked["eps_gap"]["value"] > 0


def test_the_driver_refuses_other_steps():
    from benchmark.drivers import riffusion

    c = tiny_cell()
    with pytest.raises(ValueError, match="4 evaluations"):
        riffusion.Driver(c.config, dict(c.traffic, epochs=12), torch.device("cpu"))


def test_an_evaluation_past_a_requests_last_starts_its_sample_again():
    """The harness may take the later step from a request whose sample is
    done; the reference then follows it from the request's start."""
    from benchmark.drivers import riffusion

    c = tiny_cell()
    d = riffusion.Driver(c.config, c.traffic, torch.device("cpu"))
    req = gen.make_request(c.traffic, c.config, SEED + 3, 0)
    job = d.start(req)
    first = job.losses(job.epoch())
    for _ in range(3):
        job.epoch()
    before = job.states()
    assert before[0]["index"] == 4
    again = job.losses(job.epoch())
    assert (again == first).all() and job.states()[0]["index"] == 1
    step = check.Step(req, before, again, job.states())
    numbers, _ = denoising.compare(c.config, c.traffic, None, [step], [], torch.device("cpu"))
    assert numbers["step_eps_gap"] <= LIMITS["step_eps_gap"]
    assert numbers["step_latent_gap"] <= LIMITS["step_latent_gap"]


def test_the_control_loads_nothing_of_the_port():
    c = tiny_cell()
    code = ("import json, sys, torch; sys.path.insert(0, %r)\n"
            "from benchmark import gen\n"
            "from benchmark.checks import denoising\n"
            "cfg, traffic = json.loads(%r)\n"
            "req = gen.make_request(traffic, cfg, 7, 0)\n"
            "out = denoising.control(cfg, traffic, req, torch.device('cpu'), prec='bf16')\n"
            "denoising.compare(cfg, traffic, *out, torch.device('cpu'))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'audio_inpainting_torch', 'jax', 'audio_inpainting_tpu'}))\n"
            ) % (ROOT, json.dumps([c.config, c.traffic]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- the readers, on made-up events and spans ------------------------------

T = 1_000_000.0          # µs: the slice's events lie on the Unix clock


def ev(kind, name, start, end, corr=0):
    return Event(kind, name, T + start, T + end, 1, corr, 0)


def span(name, start, end, k=0, **attrs):
    return profiling.Span(name, int((T + start) * 1e3), int((T + end) * 1e3), 1, k, None, None,
                          attrs)


SELF = dict(batch=2, heads=8, q_tokens=4096, k_tokens=4096, head_dim=40)
CROSS = dict(batch=2, heads=8, q_tokens=4096, k_tokens=77, head_dim=40)


def _slice():
    """The slice 0 .. 100 µs: launches at 10, 12 (attention 9-13, its
    kernels 20-30 and 25-35), 14 (outside any attention), 16 (attention
    15-17, its kernel 40-42) inside the step 8-18, and 60 in a step
    (55-120) that ends after the slice; a copy at 0-1 and a kernel 95-100
    bound the slice."""
    evs = [ev("device", "memcpy", 0, 1, 99), ev("device", "k", 95, 100, 98)]
    for t, corr, (s, e) in ((10, 1, (20, 30)), (12, 2, (25, 35)), (14, 3, (36, 38)),
                            (16, 4, (40, 42)), (60, 5, (61, 70))):
        evs += [ev("runtime", "cudaLaunchKernel", t, t + 0.5, corr), ev("device", "k", s, e, corr)]
    return trace.Reading(evs)


SPANS = [span("sd.encode", -5, 5), span("sd.step", 8, 18), span("sd.attention", 9, 13, **SELF),
         span("sd.attention", 15, 17, **CROSS), span("sd.step", 55, 120),
         span("sd.attention", 99, 110, **SELF)]


@pytest.fixture
def recorded(monkeypatch):
    rec = profiling._Recorder()
    for s in SPANS:
        rec.add(s)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def read(metric, reading, config=None):
    return manifest.reader(ROOT, metric)(SimpleNamespace(reading=reading, config=config))


def test_the_readers_read_the_whole_spans_in_the_slice(recorded):
    r = _slice()
    cfg = manifest.cell(ROOT, CELL).config
    assert r.window_s == pytest.approx(100e-6)
    assert read("launches_per_step", r) == 4.0
    # one whole step; the encode began before the slice and the second step ends after it
    # over the busy time: 0-1, 20-35, 36-38, 40-42, 61-70 and 95-100
    assert r.busy_s == pytest.approx(34e-6)
    assert read("sd_mfu_pct", r, cfg) == pytest.approx(
        100 * counting_sd.step_flops(cfg) / 34e-6 / 67e12)
    bound = counting_sd.attention_bound_s(**SELF) + counting_sd.attention_bound_s(**CROSS)
    # the kernels launched inside the two whole attention spans: 20-35 and 40-42
    assert read("attention_roofline", r) == pytest.approx(100 * bound / 17e-6)


@pytest.mark.parametrize("metric", ["sd_mfu_pct", "attention_roofline", "launches_per_step"])
def test_no_whole_span_in_the_slice_reads_nothing(metric, monkeypatch):
    rec = profiling._Recorder()
    for s in (span("sd.step", -3, 50), span("sd.attention", 90, 110, **SELF),
              span("sd.decode", 80, 120)):
        rec.add(s)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    assert read(metric, _slice(), manifest.cell(ROOT, CELL).config) is None


@pytest.mark.parametrize("metric", ["sd_mfu_pct", "attention_roofline", "launches_per_step"])
def test_a_dropped_span_or_a_port_without_spans_reads_nothing(metric, monkeypatch):
    cfg = manifest.cell(ROOT, CELL).config
    rec = profiling._Recorder(capacity=2)
    for s in SPANS:
        rec.add(s)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    assert read(metric, _slice(), cfg) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(metric, _slice(), cfg) is None
    assert read(metric, trace.Reading([]), cfg) is None


def test_the_new_metrics_list_the_cell_alone():
    m = manifest.load(ROOT)
    for name in ("sd_mfu_pct", "attention_roofline", "launches_per_step"):
        (entry,) = [p for p in m["per_layer"] if p["name"] == name]
        assert entry["workloads"] == [CELL] and entry["moves"] == "audio_per_device_s"
        assert entry["source"] == "device_trace"
    assert json.load(open(os.path.join(ROOT, "benchmark", "limits", f"{CELL}.json")))
