"""The per-layer metrics read from the port's own spans in the traced
``device`` slice (``launches_per_epoch``, ``epoch_idle_pct``), on made-up
events and spans."""

from types import SimpleNamespace

import pytest

from audio_inpainting_torch.utils import profiling
from benchmark import manifest, trace
from benchmark.trace import Event

from .conftest import ROOT

T = 1_000_000.0          # µs: the slice's events lie on the Unix clock


def ev(kind, name, start, end, corr=0):
    return Event(kind, name, T + start, T + end, 1, corr, 0)


def span(name, start, end, k=0):
    return profiling.Span(name, int((T + start) * 1e3), int((T + end) * 1e3), 1, k, None, 1,
                          {"clips": 1})


def launch(t, corr):
    return [ev("runtime", "cudaLaunchKernel", t, t + 0.5, corr),
            ev("device", "k", t + 1, t + 2, corr)]


def _slice():
    """Device events 5 .. 40 µs: launches at 10, 12, 14 (first epoch
    9-15), 20, 22 (second, 19-25), 30 (between), 36 (in an epoch that ends
    after the slice); the device busy 6-8, 11-16, 21-24, 31-32, 37-40."""
    evs = [ev("device", "k", 6, 8), ev("runtime", "cudaDeviceSynchronize", 5, 9)]
    for k, t in enumerate((10, 12, 14, 20, 22, 30, 36)):
        evs += launch(t, k + 1)
    evs[-1] = ev("device", "k", 37, 40, 7)
    evs.append(ev("device", "k", 11, 16))
    evs.append(ev("device", "k", 21, 24))
    return trace.Reading(evs)


EPOCHS = [span("gan.epoch", 3, 4.5), span("unet.build", 4, 8.5), span("gan.epoch", 9, 15),
          span("gan.readout", 15, 18), span("gan.epoch", 19, 25), span("gan.epoch", 35, 45)]


@pytest.fixture
def recorded(monkeypatch):
    """A span buffer holding EPOCHS (one partly before the slice, one
    partly after it)."""
    rec = profiling._Recorder()
    for s in EPOCHS:
        rec.add(s)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def read(metric, reading):
    return manifest.reader(ROOT, metric)(SimpleNamespace(reading=reading))


def test_launches_per_epoch_counts_the_launches_inside_whole_epoch_spans(recorded):
    r = _slice()
    assert (r.t0, r.t1) == (T + 5, T + 40)
    assert read("launches_per_epoch", r) == (3 + 2) / 2


def test_epoch_idle_is_the_idle_time_whose_middle_lies_in_an_epoch(recorded):
    """Idle gaps of the slice: 5-6 (before any epoch), 8-11 (middle 9.5,
    first epoch), 16-21 (18.5, between), 24-31 (27.5, between), 32-37
    (34.5, between: the last epoch starts at 35), none after 40."""
    r = _slice()
    assert read("epoch_idle_pct", r) == pytest.approx(100 * 3e-6 / r.window_s)
    assert read("device_idle_pct", r) == pytest.approx(100 * (1 + 3 + 5 + 7 + 5) * 1e-6 / r.window_s)
    assert read("epoch_idle_pct", r) <= read("device_idle_pct", r)


@pytest.mark.parametrize("metric", ["launches_per_epoch", "epoch_idle_pct"])
def test_no_whole_epoch_span_reads_nothing(metric, monkeypatch):
    rec = profiling._Recorder()
    rec.add(span("gan.epoch", 3, 12))
    rec.add(span("unet.readout", 15, 18))
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    assert read(metric, _slice()) is None


@pytest.mark.parametrize("metric", ["launches_per_epoch", "epoch_idle_pct"])
def test_a_dropped_span_in_the_slice_reads_nothing(metric, monkeypatch):
    rec = profiling._Recorder(capacity=3)
    for s in EPOCHS:
        rec.add(s)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    assert rec.dropped == 3
    assert read(metric, _slice()) is None


@pytest.mark.parametrize("metric", ["launches_per_epoch", "epoch_idle_pct"])
def test_a_port_without_spans_reads_nothing(metric, monkeypatch):
    """The harness reads a program that records no spans (one from before
    them) without raising."""
    monkeypatch.delattr(profiling, "spans")
    assert read(metric, _slice()) is None
    assert read(metric, trace.Reading([])) is None


def test_the_new_metrics_are_reported_in_every_cell():
    """Each cell reports both, under the plain name where it reports
    ``audio_rtf`` and under ``<name>.gan`` where its rate is
    ``audio_per_device_s``."""
    m = manifest.load(ROOT)
    cells = [w["name"] for w in m["workloads"]]
    for name in ("launches_per_epoch", "epoch_idle_pct"):
        covered = []
        for suffix, moves in (("", "audio_rtf"), (".gan", "audio_per_device_s")):
            (entry,) = [p for p in m["per_layer"] if p["name"] == name + suffix]
            assert entry["layer"] == "model step" and entry["source"] == "device_trace"
            (e2e,) = [e for e in m["end_to_end"] if e["name"] == moves]
            assert entry["moves"] == moves and entry["workloads"] == e2e["workloads"]
            covered += entry["workloads"]
        assert sorted(covered) == sorted(cells)
