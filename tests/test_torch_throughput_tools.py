"""The port's serve_throughput and stream_throughput tools
(audio_inpainting_torch/tools/), in-process on the CPU at small sizes.

serve_throughput's ``run`` serves batches of 1 and 2 clips of (64, 128)
for 2 epochs with each method; ``main`` keeps the JAX tool's (513, 1723)
and is checked for what it hands ``run``. stream_throughput's ``main``
reads an 8 kHz clip through ``BENCH_INPUT`` and streams 6 s of it with
``--method ar``; its program is the JAX tool's, gap for gap.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from audio_inpainting_torch.corrupt import synth_music_clip
from audio_inpainting_torch.io import save_wav_int16
from audio_inpainting_torch.tools import serve_throughput, stream_throughput

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tools.stream_throughput as jax_stream  # noqa: E402

torch.set_num_threads(1)

SERVE_KEYS = {"method", "batch", "epochs", "wall_s", "clips_per_s", "rtf", "groups",
              "device"}
STREAM_KEYS = {"method", "minutes", "gaps", "warmup", "warmup_wall_s", "rtf_cold",
               "rtf_warm", "peak_latency_ms", "p99_latency_ms", "max_feed_stall_cold_ms",
               "max_feed_stall_warm_ms", "passthrough_exact", "all_gaps_filled",
               "gap_snr_mean_db", "gap_lsd_mean_db", "device", "input"}


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("method", ["unet", "gan"])
def test_serve_throughput_run(method, capsys):
    rows = serve_throughput.run(method, 2, (1, 2), 64, 128, "cpu")
    captured = capsys.readouterr()
    assert _json_lines(captured.out) == rows
    assert [r["batch"] for r in rows] == [1, 2]
    assert "[warmup] batch=1" in captured.err and "[warmup] batch=2" in captured.err
    for n, row in zip((1, 2), rows):
        assert set(row) == SERVE_KEYS
        assert "projected_8chip_clips_per_s" not in row
        assert row["method"] == method and row["epochs"] == 2 and row["device"] == "cpu"
        assert row["groups"] == [n]                  # the CPU has no memory cap
        assert row["clips_per_s"] == pytest.approx(n / row["wall_s"])
        assert row["rtf"] == pytest.approx(n * 10.0 * 128 / 1723 / row["wall_s"])


@pytest.mark.parametrize("env,argv,want", [
    (None, ["--device", "cpu"], ("unet", 400, [1, 2, 4, 8])),
    ("gan", ["50", "1", "2", "--device", "cpu"], ("gan", 50, [1, 2])),
])
def test_serve_throughput_main_keeps_the_jax_interface(monkeypatch, env, argv, want):
    calls = []
    monkeypatch.setattr(serve_throughput, "run", lambda *a: calls.append(a) or [])
    if env is None:
        monkeypatch.delenv("SERVE_METHOD", raising=False)
    else:
        monkeypatch.setenv("SERVE_METHOD", env)
    assert serve_throughput.main(argv) == 0
    assert calls == [(*want, 513, 1723, "cpu")]


def test_serve_throughput_wants_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_throughput.run("unet", 1, (1,), 64, 128, None)


@pytest.mark.parametrize("minutes,gap_every_s", [(0.1, 2.0), (0.5, 7.0)])
def test_stream_program_is_the_jax_tools(monkeypatch, minutes, gap_every_s):
    """The same clip tiled the same way with the same seeded gaps."""
    sr = 8000
    clip = synth_music_clip(1, sr, 2.0)
    monkeypatch.setattr(jax_stream, "load_mono_normalized", lambda path: (sr, clip))
    ours = stream_throughput.build_program(clip, sr, minutes, gap_every_s, 300.0)
    theirs = jax_stream.build_program(minutes, gap_every_s, 300.0)
    assert theirs[0] == sr
    for a, b in zip(ours[:2], theirs[1:3]):
        np.testing.assert_array_equal(a, b)
    assert ours[2] == theirs[3] and len(ours[2]) > 0


def _bench_input(tmp_path, monkeypatch):
    path = save_wav_int16(synth_music_clip(1, 8000, 2.0), 8000,
                          str(tmp_path / "clip8k.wav"))
    monkeypatch.setenv("BENCH_INPUT", path)
    return path


def test_stream_throughput_main_ar(tmp_path, monkeypatch, capsys):
    path = _bench_input(tmp_path, monkeypatch)
    rc = stream_throughput.main(["--minutes", "0.1", "--method", "ar", "--gap-every-s", "2",
                                 "--device", "cpu"])
    captured = capsys.readouterr()
    (res,) = _json_lines(captured.out)
    assert rc == 0
    assert set(res) == STREAM_KEYS
    assert res["method"] == "ar" and res["gaps"] == 2 and res["input"] == path
    assert res["passthrough_exact"] is True and res["all_gaps_filled"] is True
    assert res["device"] == "cpu" and res["warmup"] is False
    assert res["rtf_cold"] > 0 and res["rtf_warm"] > 0
    assert np.isfinite(res["gap_snr_mean_db"]) and np.isfinite(res["gap_lsd_mean_db"])
    assert "[check] passthrough_exact=True all_gaps_filled=True" in captured.err


def test_stream_throughput_linear_with_warmup(capsys):
    clip = synth_music_clip(1, 8000, 2.0)
    res = stream_throughput.run(clip, 8000, minutes=0.1, method="linear", gap_every_s=2.0,
                                warmup=True, device="cpu", input_label="synthetic")
    assert res["warmup"] is True and res["warmup_wall_s"] >= 0.0
    assert res["passthrough_exact"] is True and res["all_gaps_filled"] is True
    assert _json_lines(capsys.readouterr().out) == [res]


def test_stream_throughput_exits_1_when_a_gap_stays_silent(tmp_path, monkeypatch, capsys):
    """A restorer that fills nothing: the fill check fails, the exit code
    is 1 (the JAX tool's)."""
    _bench_input(tmp_path, monkeypatch)

    class Silent:
        pending = 0

        def __init__(self, *args, **kwargs):
            self.parts = []

        def feed(self, chunk):
            return chunk

        def flush(self):
            return np.zeros(0, np.float32)

    monkeypatch.setattr(stream_throughput, "StreamRestorer", Silent)
    rc = stream_throughput.main(["--minutes", "0.1", "--gap-every-s", "2", "--device", "cpu"])
    (res,) = _json_lines(capsys.readouterr().out)
    assert rc == 1
    assert res["all_gaps_filled"] is False and res["passthrough_exact"] is True
