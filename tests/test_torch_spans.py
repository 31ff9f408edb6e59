"""The port's spans (audio_inpainting_torch/utils/profiling.py) on the CPU:
nothing without a profiler session, each span with its parent, run and
attributes inside one, on the clock of the profiler's events, in a
bounded buffer that says when it dropped spans; the trainers' and entry
points' spans, and training that repeats itself bit for bit with them
recorded. The card's clock: tests/test_torch_spans_cuda.py."""

import contextlib
import os
import re
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_inpainting_torch.methods import neural
from audio_inpainting_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "audio_inpainting_torch")


@pytest.fixture
def recorder(monkeypatch):
    """A fresh span buffer for the test."""
    rec = profiling._Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_session_a_span_records_nothing_and_opens_no_range(recorder, monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function", lambda name: opened.append(name))
    assert not torch.autograd._profiler_enabled()
    with profiling.span("unet.epoch", run=3, clips=2) as s:
        torch.ones(4).sum()
    assert s is None and opened == [] and profiling.spans() == []


def test_a_span_in_a_session_has_its_parent_run_and_attributes(recorder):
    with _session():
        with profiling.span("serve.batch", method="unet", clips=2):
            with profiling.span("unet.build", run=7, clips=2):
                with profiling.span("ops.stft"):
                    torch.ones(8).sum()
            with profiling.span("ops.istft"):
                pass
    batch, build, stft, istft = profiling.spans()
    assert [s.name for s in (batch, build, stft, istft)] == [
        "serve.batch", "unet.build", "ops.stft", "ops.istft"]
    assert batch.parent is None and build.parent == batch.id and stft.parent == build.id
    assert istft.parent == batch.id
    # a span without a run takes its parent's
    assert (batch.run, build.run, stft.run, istft.run) == (None, 7, 7, None)
    assert batch.attrs == {"method": "unet", "clips": 2} and stft.attrs == {}
    assert {s.thread for s in (batch, build, stft, istft)} == {threading.get_native_id()}
    assert batch.start_ns <= build.start_ns <= stft.start_ns <= stft.end_ns <= build.end_ns
    assert build.end_ns <= istft.start_ns <= istft.end_ns <= batch.end_ns


def _bracket_offsets(n: int) -> list[tuple[float, float]]:
    """(µs from a span's start to its range's start, µs from the range's
    end to the span's end) of n spans under a CPU session."""
    with _session() as prof:
        with profiling.span("warm-up"):
            pass
        for k in range(n):
            with profiling.span(f"block{k}"):
                torch.ones(64).sum()
                time.sleep(0.0005)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    out = []
    for s in profiling.spans():
        if s.name.startswith("block"):
            e = ranges[s.name]
            out.append(((e.start_ns() - s.start_ns) / 1e3,
                        (s.end_ns - e.start_ns() - e.duration_ns()) / 1e3))
    return out


def test_span_stamps_bracket_their_range_on_the_profilers_clock(recorder):
    """kineto stamps the host's events in Unix ns, as time.time_ns() is:
    each span's stamps hold its record_function range, within 50 us on
    either side (an idle CPU reads 3-30 us: the range's own entry and
    exit). A machine that stalls the test between two clock reads gets
    two more tries."""
    for _ in range(3):
        recorder.closed.clear()
        offsets = _bracket_offsets(8)
        assert len(offsets) == 8
        assert all(a >= 0 and b >= 0 for a, b in offsets), offsets
        if max(max(a, b) for a, b in offsets) <= 50.0:
            break
    print(f"\nspan start to range start, range end to span end (us): {offsets}")
    assert max(max(a, b) for a, b in offsets) <= 50.0, offsets


def test_a_full_buffer_drops_its_oldest_spans_and_says_so(monkeypatch):
    rec = profiling._Recorder(capacity=4)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    with _session():
        for k in range(6):
            with profiling.span(f"s{k}"):
                time.sleep(0.0002)
            if k == 1:
                after_dropped = time.time_ns()
    assert rec.dropped == 2
    with pytest.raises(profiling.SpansDropped):
        profiling.spans()
    with pytest.raises(profiling.SpansDropped):
        profiling.spans(after_dropped - 10**9, after_dropped)
    assert [s.name for s in profiling.spans(after_dropped)] == ["s2", "s3", "s4", "s5"]
    assert rec.dropped_until_ns < after_dropped


def test_the_buffer_holds_at_least_65536_spans():
    assert profiling.SPAN_CAPACITY >= 65_536
    assert profiling._Recorder().closed.maxlen == profiling.SPAN_CAPACITY


def test_spans_of_an_interval_lie_in_it_wholly_or_in_part(recorder):
    with _session():
        with profiling.span("a"):
            time.sleep(0.001)
        mid = time.time_ns()
        with profiling.span("b"):
            time.sleep(0.001)
    a, b = profiling.spans()
    assert [s.name for s in profiling.spans(mid)] == ["b"]
    assert [s.name for s in profiling.spans(None, mid)] == ["a"]
    assert [s.name for s in profiling.spans(a.end_ns - 1, b.start_ns + 1)] == ["a", "b"]


def _unet(seed=0):
    rng = np.random.default_rng(seed)
    mag = rng.random((2, 40, 64)).astype(np.float32)
    mask = np.ones_like(mag)
    mask[:, :, 20:28] = 0.0
    return neural.UNetTrainer(mag, mask, neural.UNetTrainConfig(epochs=3), [1, 2], device="cpu")


def _gan(seed=0):
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (64, 64)).astype(np.float32)
    mask = np.ones_like(real)
    mask[:, 24:40] = 0.0
    cfg = neural.GANTrainConfig(epochs=3, ema_decay=0.99, ema_scope="gap")
    return neural.GANTrainer(real * mask - (1 - mask), real, mask, cfg, 3, device="cpu")


def _train(make, traced: bool):
    with _session() if traced else contextlib.nullcontext():
        trainer = make()
        losses = [trainer.epoch() for _ in range(3)]
        out = trainer.restore()
    return trainer, losses, out


def _flat(x):
    return [t for v in (x if isinstance(x, (list, tuple)) else [x])
            for t in (_flat(v) if isinstance(v, (list, tuple)) else [v])]


@pytest.mark.parametrize("kind", ["unet", "gan"])
def test_trainers_repeat_bit_for_bit_with_a_session_active(kind, recorder):
    make = {"unet": _unet, "gan": _gan}[kind]
    _, plain_losses, plain_out = _train(make, traced=False)
    assert profiling.spans() == []
    trainer, losses, out = _train(make, traced=True)
    for a, b in zip(_flat(plain_losses) + _flat(plain_out), _flat(losses) + _flat(out)):
        assert torch.equal(a, b)
    spans = profiling.spans()
    assert [s.name for s in spans] == [f"{kind}.build"] + [f"{kind}.epoch"] * 3 + [f"{kind}.readout"]
    assert {s.run for s in spans} == {trainer.run}
    assert all(s.attrs == {"clips": trainer.clips} for s in spans)
    assert trainer.clips == (2 if kind == "unet" else 1)
    # each trainer is a run of its own
    assert make().run != trainer.run


def test_the_gan_retry_shows_as_a_second_run(recorder):
    rng = np.random.default_rng(5)
    real = rng.uniform(-1, 1, (64, 64)).astype(np.float32)
    mask = np.ones_like(real)
    mask[:, 24:40] = 0.0
    cfg = neural.GANTrainConfig(epochs=2, retry_l1=1e-9)
    with _session():
        _, _, attempts = neural.gan_train_restore(real * mask - (1 - mask), real, mask, cfg, 1,
                                                  device="cpu")
    assert attempts == 2
    spans = profiling.spans()
    runs = [s for s in spans if s.name == "gan.run"]
    assert [s.attrs for s in runs] == [{"attempt": 0}, {"attempt": 1}]
    builds = [s for s in spans if s.name == "gan.build"]
    assert [b.parent for b in builds] == [r.id for r in runs]
    assert builds[0].run != builds[1].run


def test_the_facade_opens_its_span_around_the_transforms_and_the_trainer(recorder):
    from audio_inpainting_torch import restore

    sr = 16000
    t = np.arange(sr // 2) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    x[3000:3600] = 0.0
    with _session():
        restore(x, sr, method="unet", gaps=[(3000, 3600)], device="cpu", epochs=2)
    spans = profiling.spans()
    (top,) = [s for s in spans if s.parent is None]
    assert top.name == "api.restore" and top.attrs == {"method": "unet"}
    assert {s.name for s in spans if s.parent == top.id} == {
        "ops.stft", "unet.build", "unet.epoch", "unet.readout", "ops.istft"}


def test_serve_opens_one_span_around_its_batch(recorder, tmp_path):
    from audio_inpainting_torch.io import save_wav_int16
    from audio_inpainting_torch.pipelines import serve

    sr = 8000
    din = tmp_path / "in"
    din.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        x = (0.3 * rng.standard_normal(sr // 2)).astype(np.float32)
        x[1000:1500] = 0.0
        save_wav_int16(x, sr, str(din / f"c{i}.wav"))
    with _session():
        serve.run_serve(str(din), str(tmp_path / "out"), method="unet", epochs=2, device="cpu")
    spans = profiling.spans()
    (batch,) = [s for s in spans if s.name == "serve.batch"]
    assert batch.attrs == {"method": "unet", "clips": 2}
    assert [s.attrs["clips"] for s in spans if s.name == "unet.build"] == [2]
    assert all(batch.start_ns <= s.start_ns <= s.end_ns <= batch.end_ns
               for s in spans if s.name.startswith("unet."))


def _opened_span_names() -> set[str]:
    """The names of every ``span("...")`` in the package's source."""
    names = set()
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    names |= set(re.findall(r'\bspan\("([^"]+)"', fh.read()))
    return names


def test_the_port_opens_the_spans_it_names_and_none_the_benchmark_reads():
    from benchmark import trace

    assert _opened_span_names() == set(profiling.PORT_SPANS)
    assert not set(profiling.PORT_SPANS) & {*trace.SPANS, trace.PRIMING, trace.TAIL}
