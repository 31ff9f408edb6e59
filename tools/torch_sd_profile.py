#!/usr/bin/env python3
"""Where the time of the port's full-width SD-v1 UNet forward goes, on one
CUDA GPU.

    python3 tools/torch_sd_profile.py      # from the repository root

The UNet2DCondition at full width on chip_smoke.py's seeded weights, the
classifier-free-guidance forward of the Riffusion loop (batch 2, 64x64
latents, L = 77), float32 with TF32 off:

1. its device time (CUDA events) with cuDNN's default heuristics and, in
   a fresh process (PyTorch caches a conv's plan at its first call, so a
   later change of the flag does not reach shapes already run), with
   ``torch.backends.cudnn.benchmark`` (a search per conv shape);
2. one profiled forward, default heuristics: device time by kernel name;
   the kernels' summed time against the union of their intervals (cuDNN
   runs some kernels side by side on its own streams) and the span; the
   streams; the device time of each conv shape (aten::cudnn_convolution,
   by input shapes) and of the attention softmax, read from the
   profile's Chrome trace (written to a temporary file);
3. from the same profile, each conv shape's wall time on the device (by
   input and weight shape): the union of the intervals of the kernels
   launched inside its aten::cudnn_convolution calls (cuDNN splits one
   conv over its side streams, so the summed time overstates it), beside
   the summed time; the same for the five wide up-path 3x3 convs
   together, and for the hand-written 3x3 kernel's launches
   (ops/sd_conv3x3.py, by kernel name).

Prints one JSON line. It needs a GPU; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from audio_inpainting_torch.models import sd  # noqa: E402

# the five up-path resnet 3x3 convs that cuDNN runs slowest, by ((batch,
# C_in, H, W), C_out): 2560 -> 1280 at 16^2 twice, the other three once
WIDE = (((2, 2560, 16, 16), 1280), ((2, 1920, 16, 16), 1280), ((2, 1920, 32, 32), 640),
        ((2, 1280, 32, 32), 640))


def setup(dev):
    with torch.device("meta"):
        meta = sd.UNet2DCondition()
    unet = sd.load_module(sd.UNet2DCondition, sd.UNetConfig(),
                          cs.seeded_sd_state(meta, torch.Generator().manual_seed(0)), dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 4, 64, 64), generator=g).to(dev)
    t = torch.full((2,), 501.0, device=dev)
    ctx = torch.randn((2, cs.SD_CTX_LEN, 768), generator=g).to(dev)

    def forward():
        with torch.no_grad():
            unet(x, t, ctx)

    return forward


def profiled(forward) -> dict:
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        forward()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        with open(trace) as f:
            kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e["name"][:70], []).append(e["dur"])
    walls = conv_walls(prof)
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::cudnn_convolution"]
    convs.sort(key=lambda e: -e.device_time_total)
    soft = [e for e in prof.key_averages() if e.key == "aten::_softmax"]
    return {
        "kernels": len(kernels),
        "streams": sorted({str(e["args"].get("stream")) for e in kernels}),
        "kernel_sum_ms": sum(e["dur"] for e in kernels) / 1e3,
        "kernel_union_ms": cs.union_ms((e["ts"], e["ts"] + e["dur"]) for e in kernels),
        "span_ms": (max(e["ts"] + e["dur"] for e in kernels)
                    - min(e["ts"] for e in kernels)) / 1e3,
        "conv_device_ms": sum(e.device_time_total for e in convs) / 1e3,
        "softmax_device_ms": sum(e.device_time_total for e in soft) / 1e3,
        "convs_by_shape": [{"input_shapes": e.input_shapes[:2], "calls": e.count,
                            "device_ms": e.device_time_total / 1e3} for e in convs[:8]],
        **walls,
        "top_kernels": [{"name": k, "calls": len(v), "ms": sum(v) / 1e3} for k, v in
                        sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]]}


def conv_walls(prof) -> dict:
    """Device ms of each conv shape's calls, summed and as the union of the
    intervals of what they launched (by correlation id, from launches made
    inside an aten::cudnn_convolution on its thread); the same for the
    WIDE shapes together and for the hand-written kernel's launches."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    device = {}
    for e in evs:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.setdefault(e.correlation_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    ops = sorted({(e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
                   tuple(e.shapes()[0]), tuple(e.shapes()[1]))
                  for e in evs if e.device_type() == DeviceType.CPU
                  and e.name() == "aten::cudnn_convolution"})
    by_shape: dict[tuple, list] = {}
    for e in evs:
        if e.device_type() != DeviceType.CPU or not cs.LAUNCH_CALLS.search(e.name()):
            continue
        t, tid = e.start_ns(), e.start_thread_id()
        for s0, s1, otid, x, k in ops:
            if otid == tid and s0 <= t <= s1:
                by_shape.setdefault((x, k), []).extend(device.get(e.correlation_id(), []))
                break

    def ms(iv) -> dict:
        iv = [(a, b) for a, b, _ in iv]
        return {"sum_ms": sum(b - a for a, b in iv) / 1e6,
                "union_ms": cs.union_ms(iv) / 1e3 if iv else 0.0}

    calls: dict[tuple, int] = {}
    for _, _, _, x, k in ops:
        calls[(x, k)] = calls.get((x, k), 0) + 1
    shapes = sorted(({"input": list(x), "weight": list(k), "calls": calls[(x, k)], **ms(iv)}
                     for (x, k), iv in by_shape.items()), key=lambda r: -r["union_ms"])
    wide = [iv for (x, k), ivs in by_shape.items()
            if k[2:] == (3, 3) and (x, k[0]) in WIDE for iv in ivs]
    kernel = [iv for ivs in device.values() for iv in ivs if "sd_conv3x3" in iv[2]]
    return {"conv_walls": shapes,
            "wide_convs": {"shapes": [[list(x), k] for x, k in WIDE], **ms(wide)},
            "sd_conv3x3": {"kernels": len(kernel), **ms(kernel)}}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sd_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--benchmark"]:
        torch.backends.cudnn.benchmark = True
        print(cs.cuda_ms(setup(dev), calls=3, rounds=3))
        return 0
    forward = setup(dev)
    res = {"gpu": cs.gpu_name_and_power(), "torch": torch.__version__,
           "forward_ms": cs.cuda_ms(forward, calls=3, rounds=3),
           "device_profile": {k: v for k, v in cs.device_profile(forward).items()
                              if k != "top"},
           "profiled_forward": profiled(forward)}
    bench = subprocess.run([sys.executable, __file__, "--benchmark"], check=True,
                           capture_output=True, text=True)
    res["forward_ms_cudnn_benchmark"] = float(bench.stdout.split()[-1])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
