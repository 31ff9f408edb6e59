"""The port's trace_breakdown (audio_inpainting_torch/tools/
trace_breakdown.py) on synthetic torch.profiler traces, in the form of
tests/test_trace_tools.py, and on a real trace that utils.profiling's
device_trace writes on the CPU (no device events there: no rows, 0 ms).
"""

import gzip
import json
import os
import sys
import time

import pytest
import torch

from audio_inpainting_torch.tools import trace_breakdown as tb
from audio_inpainting_torch.utils import device_trace
from audio_inpainting_torch.utils.profiling import PRIMING

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

KERNEL_A = "void at::native::vectorized_elementwise_kernel<4, float>(int, float*)"
KERNEL_B = "void at::native::vectorized_elementwise_kernel<2, at::Half>(int, at::Half*)"

EVENTS = [
    # device events: counted
    {"ph": "X", "cat": "kernel", "name": KERNEL_A, "ts": 100.0, "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": KERNEL_B, "ts": 105.0, "dur": 5.0},
    {"ph": "X", "cat": "kernel", "name": "sm90_gemm_kernel.7", "ts": 130.0, "dur": 4.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
     "ts": 90.0, "dur": 2.0},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 140.0, "dur": 1.0},
    # host ops that launched them and annotations over the device lanes
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 80.0, "dur": 50.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 85.0, "dur": 3.0},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "epoch", "ts": 90.0, "dur": 60.0},
    {"ph": "X", "cat": "python_function", "name": "epoch", "ts": 60.0, "dur": 100.0},
    # not complete events
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 120.0},
    {"ph": "M", "name": "process_name", "pid": 0},
]


def _write(path, events, gz=False):
    path.parent.mkdir(parents=True, exist_ok=True)
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events, "deviceProperties": []}, f)
    return str(path)


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json_gz"])
def test_breakdown_sums_device_events_by_collapsed_name(tmp_path, gz):
    name = "host_1.1700000000.pt.trace.json" + (".gz" if gz else "")
    path = _write(tmp_path / name, EVENTS, gz)
    rows, total = tb.breakdown(path)
    assert total == pytest.approx(0.022)                       # 22 µs of device events
    assert rows[0] == (pytest.approx(0.015), 2,
                       "void at::native::vectorized_elementwise_kernel<>()")
    assert [r[2] for r in rows[1:]] == ["sm90_gemm_kernel", "Memcpy HtoD ()", "Memset ()"]
    assert [r[1] for r in rows] == [2, 1, 1, 1]
    rows_exact, total_exact = tb.breakdown(path, exact=True)
    assert total_exact == pytest.approx(total)
    assert {r[2] for r in rows_exact} == {KERNEL_A, KERNEL_B, "sm90_gemm_kernel.7",
                                          "Memcpy HtoD (Pageable -> Device)", "Memset (Device)"}


def test_breakdown_reads_the_newest_trace_of_a_directory(tmp_path):
    old = _write(tmp_path / "a" / "w.1.pt.trace.json", EVENTS[:1])
    new = _write(tmp_path / "b" / "w.2.pt.trace.json.gz", EVENTS[2:3], gz=True)
    _write(tmp_path / "notes.json", EVENTS)                   # not a trace file name
    os.utime(old, (time.time() - 100, time.time() - 100))
    assert tb.trace_file(str(tmp_path)) == new
    rows, total = tb.breakdown(str(tmp_path))
    assert rows == [(pytest.approx(0.004), 1, "sm90_gemm_kernel")]


def test_breakdown_of_an_empty_directory_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tb.breakdown(str(tmp_path / "empty"))


@pytest.mark.parametrize("name,want", [
    ("void k<float, 4>(float*, int)", "void k<>()"),
    ("void a::b<c<d, e>, 2>::f<g>(h<i>)", "void a::b<>::f<>()"),
    ("fusion.123", "fusion"),
    ("ampere_sgemm_128x64_nn", "ampere_sgemm_128x64_nn"),
    ("cudnn_kernel_5", "cudnn_kernel"),
])
def test_collapse(name, want):
    assert tb.collapse(name) == want


def test_busy_share_is_the_union_over_the_traced_window(tmp_path):
    path = _write(tmp_path / "t.pt.trace.json", EVENTS)
    busy = tb.busy_share(path)
    # device intervals [90, 92], [100, 110] with [105, 110] inside, [130, 134], [140, 141]
    assert busy["busy_ms"] == pytest.approx(0.017)
    # the window spans every complete event: the python span 60 .. 160
    assert busy["window_ms"] == pytest.approx(0.1)
    assert busy["busy_share"] == pytest.approx(0.17)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 1000.0)], 1.0),
    ([(0.0, 1000.0), (500.0, 1500.0)], 1.5),
    ([(2000.0, 3000.0), (0.0, 1000.0), (100.0, 200.0)], 2.0),
])
def test_union_ms(intervals, want):
    assert tb.union_ms(intervals) == pytest.approx(want)


def test_the_smoke_takes_the_package_union():
    """chip_smoke's device_profile counts busy time with the package's
    arithmetic, so phase tools compares like with like."""
    assert chip_smoke.union_ms is tb.union_ms


def test_breakdown_of_a_device_trace_written_on_the_cpu(tmp_path):
    """utils.profiling.device_trace on the CPU: a real trace with host ops
    and no device events."""
    conv = torch.nn.Conv2d(1, 4, 3)
    x = torch.randn(1, 1, 16, 16)
    with device_trace(str(tmp_path / "trace")):
        conv(x).sum().backward()
    found = tb.trace_file(str(tmp_path / "trace"))
    assert found.endswith(".pt.trace.json")
    events = tb.load_events(found)
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert tb.breakdown(str(tmp_path / "trace")) == ([], 0)
    busy = tb.busy_share(str(tmp_path / "trace"))
    assert busy["busy_ms"] == 0.0 and busy["window_ms"] > 0.0 and busy["busy_share"] == 0.0
    assert tb.unrecorded(str(tmp_path / "trace")) == {"launches": 0, "unrecorded": 0}


LAUNCHES = [
    {"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 5.0, "args": {"correlation": 1}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 20.0,
     "dur": 1.0, "args": {"correlation": 2}},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 22.0, "dur": 1.0,
     "args": {"correlation": 3}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0, "dur": 2.0,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 4.0, "dur": 2.0,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync", "ts": 6.0, "dur": 1.0,
     "args": {"correlation": 3}},
    # launches whose device records the session lost
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 7.0, "dur": 1.0,
     "args": {"correlation": 4}},
    {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 8.0, "dur": 1.0,
     "args": {"correlation": 5}},
    # runtime calls that queue no device work
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 9.0, "dur": 20.0,
     "args": {"correlation": 6}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventRecord", "ts": 9.5, "dur": 0.1,
     "args": {"correlation": 7}},
]


def test_unrecorded_counts_launches_without_a_device_record(tmp_path, capsys):
    path = _write(tmp_path / "t.pt.trace.json", LAUNCHES)
    assert tb.unrecorded(path) == {"launches": 5, "unrecorded": 2}
    assert tb.unrecorded(_write(tmp_path / "u.pt.trace.json", EVENTS)) == {
        "launches": 1, "unrecorded": 0}
    assert tb.main([path]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "2 of 5 launches have no device record")


def test_the_priming_of_a_session_is_left_out(tmp_path):
    """device_trace opens a GPU session with launches of its own under a
    PRIMING range: nothing that starts before the range ends is read,
    lost records of the priming included."""
    priming = [
        {"ph": "X", "cat": "user_annotation", "name": PRIMING, "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": PRIMING, "ts": 3.0, "dur": 40.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0, "dur": 1.0,
         "args": {"correlation": 90}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2.0, "dur": 1.0,
         "args": {"correlation": 91}},
        {"ph": "X", "cat": "kernel", "name": "fill", "ts": 30.0, "dur": 5.0,
         "args": {"correlation": 91}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 3.0,
         "dur": 46.0},
    ]
    later = [{**e, "ts": e["ts"] + 100.0} for e in LAUNCHES]
    path = _write(tmp_path / "t.pt.trace.json", priming + later)
    rows, total = tb.breakdown(path)
    assert {r[2] for r in rows} == {"k", "Memcpy DtoH ()", "Memset ()"}
    assert total == pytest.approx(0.007)
    assert tb.unrecorded(path) == {"launches": 5, "unrecorded": 2}
    busy = tb.busy_share(path)
    assert busy["busy_ms"] == pytest.approx(0.007)
    assert busy["window_ms"] == pytest.approx(0.028)        # 101 .. 129: after the priming
    assert tb.load_events(_write(tmp_path / "u.pt.trace.json", LAUNCHES)) == LAUNCHES


def test_main_prints_the_table(tmp_path, capsys):
    path = _write(tmp_path / "t.pt.trace.json", EVENTS)
    assert tb.main([path, "-k", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["ms", "%", "count", "kernel"]
    assert out[1].split()[:3] == ["0.015", "68.18", "2"]
    assert len(out) == 1 + 2 + 2                # header, 2 rows, total, busy
    assert out[3].split()[:2] == ["0.022", "100.00"]
    assert out[4].startswith("busy 0.017 ms of a 0.100 ms window (17.00 %)")


SPANNED = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 50.0, "dur": 10.0},
    {"ph": "X", "cat": "user_annotation", "name": "api.restore", "ts": 85.0, "dur": 235.0},
    {"ph": "X", "cat": "user_annotation", "name": "unet.epoch", "ts": 120.0, "dur": 80.0},
    # not a port span, and a mirror over the device lanes: neither is read
    {"ph": "X", "cat": "user_annotation", "name": "Optimizer.step#Adam.step", "ts": 125.0,
     "dur": 15.0},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "ops.stft", "ts": 200.0, "dur": 120.0},
    {"ph": "X", "cat": "kernel", "name": "k", "ts": 100.0, "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": "k", "ts": 150.0, "dur": 10.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 300.0,
     "dur": 10.0},
]


def test_idle_time_by_the_innermost_port_span(tmp_path, capsys):
    """Idle gaps (the window 50 .. 320 less the device intervals): 50-100
    before any span, 110-150 inside unet.epoch, 160-300 and 310-320 inside
    api.restore alone."""
    path = _write(tmp_path / "t.pt.trace.json", SPANNED)
    assert tb.idle_by_span(path) == [(pytest.approx(0.15), "api.restore"),
                                     (pytest.approx(0.05), tb.NO_SPAN),
                                     (pytest.approx(0.04), "unet.epoch")]
    assert tb.main([path]) == 0
    out = capsys.readouterr().out.splitlines()
    at = out.index("device idle ms by the innermost port span the host was in:")
    assert out[at + 1].split() == ["0.150", "api.restore"]
    # no device events, or no port span: no listing
    assert tb.idle_by_span(_write(tmp_path / "u.pt.trace.json", SPANNED[:5])) == []
    assert tb.idle_by_span(_write(tmp_path / "v.pt.trace.json", EVENTS)) == []


def test_a_device_trace_shows_the_ports_spans(tmp_path):
    """device_trace on the CPU: the trainer's spans appear as ranges of
    their names; with no device events there is no idle listing."""
    from audio_inpainting_torch.methods.neural import UNetTrainConfig, UNetTrainer

    with device_trace(str(tmp_path / "trace")):
        trainer = UNetTrainer(torch.rand(8, 32), torch.ones(8, 32), UNetTrainConfig(),
                              device="cpu")
        trainer.epoch()
        trainer.restore()
    ranges = {e["name"] for e in tb.load_events(str(tmp_path / "trace"))
              if e.get("cat") == "user_annotation"}
    assert {"unet.build", "unet.epoch", "unet.readout"} <= ranges
    assert tb.idle_by_span(str(tmp_path / "trace")) == []
