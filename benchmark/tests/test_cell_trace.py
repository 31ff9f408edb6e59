"""The reading of a traced slice, on made-up events and on a CPU session."""

import torch

from benchmark import trace
from benchmark.trace import Event


def ev(kind, name, start, end, tid=1, corr=0, linked=0):
    return Event(kind, name, float(start), float(end), tid, corr, linked)


def _slice():
    return [
        ev("range", trace.PRIMING, 0, 10),
        ev("device", "prime_kernel", 2, 3, corr=1),
        ev("range", "epoch", 20, 60),
        ev("op", "aten::convolution", 21, 30, corr=100),
        ev("op", "aten::cudnn_convolution", 22, 29, corr=101),
        ev("runtime", "cudaLaunchKernel", 23, 24, corr=7, linked=101),
        ev("op", "aten::add", 31, 33, corr=102),
        ev("runtime", "cudaLaunchKernel", 32, 33, corr=8, linked=102),
        ev("runtime", "cudaLaunchKernel", 34, 35, corr=9, linked=102),
        ev("device", "void conv_kernel<float, 4>(float*)", 25, 40, corr=7, linked=101),
        ev("device", "add_kernel_1", 38, 45, corr=8, linked=102),
        ev("range", "readout", 61, 70),
        ev("device", "add_kernel_2", 80, 90, corr=10, linked=103),
    ]


def test_the_priming_is_left_out():
    evs = trace.without_priming(_slice())
    assert all(e.start >= 10 for e in evs) and not any(e.name == "prime_kernel" for e in evs)


def test_the_priming_is_left_out_of_a_session_without_host_events():
    """A device slice has no ranges: the priming ends with its last
    PRIME_KERNEL."""
    evs = [ev("runtime", "cudaLaunchKernel", 0, 1, corr=1),
           ev("device", "at::cuda::(anonymous namespace)::spin_kernel(long)", 2, 3, corr=1),
           ev("runtime", "cudaLaunchKernel", 1, 2, corr=2),
           ev("device", "at::cuda::(anonymous namespace)::spin_kernel(long)", 3, 5, corr=2),
           ev("runtime", "cudaLaunchKernel", 8, 9, corr=3),
           ev("device", "gemm_kernel", 10, 20, corr=3)]
    r = trace.Reading(trace.without_priming(evs))
    assert [e.corr for e in r.events] == [3, 3]
    # a priming launch that the device's clock places after the cut is left out too
    late = evs + [ev("runtime", "cudaLaunchKernel", 6, 7, corr=2)]
    assert trace.Reading(trace.without_priming(late)).unrecorded() == (1, [])
    assert r.window_s == (20 - 8) / 1e6 and r.busy_s == 10e-6
    assert r.unrecorded() == (1, [])


SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def _device_slice_with_a_tail():
    """A device slice: priming, two launches of work, then the tail, whose
    last launch lost its device record."""
    return [ev("runtime", "cudaLaunchKernel", 0, 1, corr=1),
            ev("device", SPIN, 2, 3, corr=1),
            ev("runtime", "cudaLaunchKernel", 8, 9, corr=3),
            ev("device", "gemm_kernel", 10, 20, corr=3),
            ev("runtime", "cudaLaunchKernel", 11, 12, corr=4),
            ev("device", "add_kernel", 21, 25, corr=4),
            ev("runtime", "cudaDeviceSynchronize", 13, 26, corr=5),
            ev("runtime", "cudaLaunchKernel", 27, 28, corr=6),
            ev("device", SPIN, 29, 30, corr=6),
            ev("runtime", "cudaLaunchKernel", 28, 29, corr=7),
            ev("runtime", "cudaDeviceSynchronize", 29, 31, corr=8)]


def test_the_tail_is_left_out_of_a_session_without_host_events():
    r = trace.Reading(trace.without_tail(trace.without_priming(_device_slice_with_a_tail())))
    assert [e.corr for e in r.events] == [3, 3, 4, 4, 5]
    assert r.unrecorded() == (2, [])
    assert r.window_s == (26 - 8) / 1e6 and r.busy_s == 14e-6


def test_a_lost_record_before_the_tail_still_counts():
    evs = [e for e in _device_slice_with_a_tail() if not (e.kind == "device" and e.corr == 4)]
    launches, lost = trace.Reading(trace.without_tail(trace.without_priming(evs))).unrecorded()
    assert launches == 2 and [e.corr for e in lost] == [4]


def test_the_tail_is_left_out_of_a_slice_with_ranges():
    tail = [ev("range", trace.TAIL, 91, 99),
            ev("runtime", "cudaLaunchKernel", 92, 93, corr=20),
            ev("device", SPIN, 94, 95, corr=20),
            ev("runtime", "cudaLaunchKernel", 93, 94, corr=21)]
    plain = trace.Reading(trace.without_tail(trace.without_priming(_slice())))
    r = trace.Reading(trace.without_tail(trace.without_priming(_slice() + tail)))
    assert r.events == plain.events and r.unrecorded() == plain.unrecorded()
    assert r.window_s == plain.window_s == (90 - 20) / 1e6


def test_busy_is_the_union_of_device_intervals():
    r = trace.Reading(trace.without_priming(_slice()))
    assert r.busy_s == (45 - 25 + 90 - 80) / 1e6
    assert r.window_s == (90 - 20) / 1e6


def test_unrecorded_launches():
    launches, lost = trace.Reading(trace.without_priming(_slice())).unrecorded()
    assert launches == 3 and [e.corr for e in lost] == [9]


def test_device_ops_collapse_names():
    ops = dict(trace.Reading(trace.without_priming(_slice())).device_ops())
    assert ops == {"void conv_kernel<>()": 15e-6, "add_kernel": 17e-6}


def test_idle_by_the_range_the_host_was_in():
    idle = dict(trace.Reading(trace.without_priming(_slice())).idle_by_range())
    # 20-25 in epoch, 45-80 mostly after the epoch: its middle (62.5) in readout
    assert idle == {"epoch": 5e-6, "readout": 35e-6}


def test_device_time_under_the_conv_ops_inside_epochs():
    r = trace.Reading(trace.without_priming(_slice()))
    assert r.device_s_under(("aten::convolution",), "epoch") == 15e-6
    assert r.device_s_under(("aten::add",), "epoch") == 7e-6
    assert r.device_s_under(("aten::convolution",), "readout") == 0.0


def test_device_time_under_ops_counts_overlapping_streams_once():
    evs = _slice() + [ev("device", "void conv_side<float>(float*)", 30, 50, corr=11, linked=101)]
    r = trace.Reading(trace.without_priming(evs))
    # 25-40 and 30-50 overlap: 25 us of device time, not 35
    assert r.device_s_under(("aten::convolution",), "epoch") == 25e-6


def test_cuda_calls_are_runtime_events():
    assert trace.RUNTIME_CALL.match("cudaLaunchKernel") and trace.RUNTIME_CALL.match("cuLaunchKernel")
    assert not trace.RUNTIME_CALL.match("cudnn_convolution")
    assert not trace.RUNTIME_CALL.match("aten::convolution")


def test_a_cpu_session_reads_its_ranges():
    prof = trace.session()
    with torch.profiler.record_function("epoch"):
        torch.nn.functional.conv2d(torch.ones(1, 1, 8, 8), torch.ones(2, 1, 3, 3))
    trace.close(prof)
    evs = trace.events(prof)
    assert any(e.kind == "range" and e.name == "epoch" for e in evs)
    assert any(e.kind == "op" and e.name == "aten::convolution" for e in evs)
    assert not any(e.kind == "device" for e in evs)
