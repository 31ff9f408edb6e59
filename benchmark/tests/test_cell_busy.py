"""The readers of the cells whose end-to-end rate is audio over the
device's busy time (``audio_per_device_s``): ``busy_mfu_pct``,
``audio_rtf.gan`` and the ``.gan`` names of the shared readers, on
made-up events."""

from types import SimpleNamespace

import pytest

from benchmark import counting, manifest, trace
from benchmark.trace import Event

from .conftest import ROOT

M = manifest.load(ROOT)
CFG = manifest.cell(ROOT, "gan-part2-hole2s").config
SHAPE = (513, 1723)


def reading(busy):
    """A slice of 1 s whose device is busy for ``busy`` of it."""
    evs = [Event("device", "k", 0.0, busy * 1e6, 1, 1, 0),
           Event("runtime", "cudaDeviceSynchronize", 0.0, 1e6, 1, 2, 0)]
    return trace.Reading(evs)


def ctx(busy, clip_epochs=40):
    return SimpleNamespace(config=CFG, traffic={"clip_seconds": 10.0, "epochs": 1500},
                           reading=reading(busy), clip_epochs=clip_epochs, clip_shape=SHAPE)


def read(name, c):
    return manifest.reader(ROOT, name)(c)


def test_busy_mfu_is_epoch_mfu_over_the_busy_share():
    half, full = ctx(0.5), ctx(1.0)
    assert read("busy_mfu_pct", full) == pytest.approx(read("epoch_mfu_pct", full))
    assert read("busy_mfu_pct", half) == pytest.approx(2 * read("epoch_mfu_pct", half))
    flops = counting.epoch_flops(CFG, *SHAPE) * 40
    assert read("busy_mfu_pct", half) == pytest.approx(
        100 * flops / 0.5 / counting.peak_flops(CFG))


def test_the_slices_rate_is_its_audio_over_its_length():
    assert read("audio_rtf.gan", ctx(0.5, clip_epochs=150)) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["busy_mfu_pct", "audio_rtf.gan"])
def test_a_slice_with_nothing_to_read_reads_nothing(name):
    assert read(name, ctx(0.5, clip_epochs=0)) is None
    assert read(name, SimpleNamespace(config=CFG, traffic={}, reading=trace.Reading([]),
                                      clip_epochs=5, clip_shape=SHAPE)) is None


@pytest.mark.parametrize("name", ["conv_roofline", "device_idle_pct", "launches_per_epoch",
                                  "epoch_idle_pct"])
def test_a_gan_name_reads_as_the_shared_reader(name):
    gan, shared = manifest.reader(ROOT, name + ".gan"), manifest.reader(ROOT, name)
    assert gan.__code__.co_filename == shared.__code__.co_filename
    assert gan.__code__.co_code == shared.__code__.co_code


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cells(metric):
    (e2e,) = [e for e in M["end_to_end"] if e["name"] == metric["moves"]]
    assert set(metric["workloads"]) <= set(e2e.get("workloads", metric["workloads"]))
    assert callable(manifest.reader(ROOT, metric["name"]))


def test_the_host_paced_cell_reports_a_rate_over_device_time_and_not_the_wall_rate():
    cells = {e["name"]: e.get("workloads") for e in M["end_to_end"]}
    assert "gan-part2-hole2s" in cells["audio_per_device_s"]
    assert "gan-part2-hole2s" not in cells["audio_rtf"]
    (busy,) = [e for e in M["end_to_end"] if e["name"] == "audio_per_device_s"]
    assert busy["source"] == "device_trace" and busy["bound"] >= 0.01
