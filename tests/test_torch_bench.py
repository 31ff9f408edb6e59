"""The port's bench (audio_inpainting_torch/tools/bench.py) against the
repository's bench.py, on the CPU.

The gates and their rule are bench.py's, so both give the same verdicts on
the same results; on an input other than the reference clip the parts'
gates are listed as not evaluated and only the engines gates are held.
run_engines runs at 8 kHz on a 2 s clip with a 2-epoch stream U-Net (the
programs keep their shape: 6 and 3 tiles, one 4,000-sample hole, three
300 ms gaps), and main runs with the suites stubbed by bench.py's own
results, so the JSON line's keys and the stderr lines are checked without
training at the reference's budgets.
"""

import copy
import json
import os
import sys
import wave

import numpy as np
import pytest
import torch

from audio_inpainting_torch.corrupt import synth_music_clip
from audio_inpainting_torch.methods.diffusion import PRIOR_DIR, DiffusionConfig
from audio_inpainting_torch.tools import bench as tbench
from audio_inpainting_torch.utils import load_params

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
sys.path.insert(0, os.path.dirname(__file__))

import bench as jbench  # noqa: E402
from test_bench_gates import GOOD  # noqa: E402

torch.set_num_threads(1)

JSON_KEYS = {"metric", "value", "unit", "vs_baseline", "quality_regressions",
             "input", "quality_not_evaluated", "device"}
PARTS_GATES = [g for g in jbench.GATES if g[0] != "engines"]
ENGINES_GATES = [g for g in jbench.GATES if g[0] == "engines"]


def _broken(path, value):
    res = copy.deepcopy(GOOD)
    *keys, last = path
    node = res
    for k in keys:
        node = node[k]
    if value is None:
        del node[last]
    else:
        node[last] = value
    return res


CASES = {
    "good": copy.deepcopy(GOOD),
    "min": _broken(("part2", "gan", "snr_db"), -6.0),
    "max": _broken(("part2", "nmf", "lsd_db"), 16.0),
    "missing": _broken(("part0", "ar_texture", "snr_db_mean"), None),
    "engines_min": _broken(("engines", "streaming_unet", "chunk_invariant"), 0.0),
    "engines_max": _broken(("engines", "windowed_ar", "steady_wall_s"), 2.5),
    "engines_missing": _broken(("engines", "streaming_unet", "filled"), None),
}


def _with_walls(res, seed=0):
    """``res`` with a wall_s on every leg comparable_seconds reads."""
    rng = np.random.RandomState(seed)
    res = copy.deepcopy(res)
    for part, names in (("part0", ("gp", "ar", "ar_texture", "nmf")),
                        ("part1", ("damaged", "linear", "ar", "nmf", "unet")),
                        ("part2", ("linear", "ar", "nmf", "gan", "diffusion"))):
        for name in names:
            res[part].setdefault(name, {})["wall_s"] = float(rng.uniform(0.01, 30.0))
    return res


def test_gates_are_bench_gates():
    assert tbench.GATES == jbench.GATES
    assert len(tbench.GATES) == 31 and len(ENGINES_GATES) == 7


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_quality_matches_bench(case):
    got = tbench.check_quality(CASES[case])
    assert got == jbench.check_quality(CASES[case])
    assert (got == []) == (case == "good")


@pytest.mark.parametrize("seed", [0, 1])
def test_comparable_seconds_matches_bench(seed):
    res = _with_walls(GOOD, seed)
    assert tbench.comparable_seconds(res) == jbench.comparable_seconds(res)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_non_reference_input_holds_only_the_engines_gates(case):
    res = CASES[case]
    regs, skipped = tbench.held_quality(res, reference=False)
    assert [(g["part"], g["method"], g["metric"], g["bound"], g["kind"])
            for g in skipped] == PARTS_GATES
    assert regs == [r for r in jbench.check_quality(res) if r["part"] == "engines"]
    assert tbench.held_quality(res, reference=True) == (jbench.check_quality(res), [])


def _wav(path, channels, frames, sr=44100):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.zeros(frames * channels, "<i2").tobytes())
    return str(path)


def test_only_the_reference_clip_is_the_reference(tmp_path):
    name = "vocals_accompaniment_10s.wav"
    assert tbench.is_reference_clip(_wav(tmp_path / name, 2, 441000))
    (tmp_path / "mono").mkdir()
    assert not tbench.is_reference_clip(_wav(tmp_path / "mono" / name, 1, 441000))
    (tmp_path / "short").mkdir()
    assert not tbench.is_reference_clip(_wav(tmp_path / "short" / name, 2, 44100))
    assert not tbench.is_reference_clip(_wav(tmp_path / "other.wav", 2, 441000))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / name).write_bytes(b"not a wav")
    assert not tbench.is_reference_clip(str(tmp_path / "bad" / name))


def test_bench_input_defaults_to_part2_synthetic_clip(tmp_path, monkeypatch):
    from audio_inpainting_torch.io import load_mono_normalized

    monkeypatch.delenv("BENCH_INPUT", raising=False)
    path, label = tbench.bench_input(str(tmp_path))
    assert label == "synthetic:1" and not tbench.is_reference_clip(path)
    sr, x = load_mono_normalized(path)
    want = synth_music_clip(1, 44100, 10.0)
    assert sr == 44100 and x.shape == want.shape
    assert np.abs(x - want).max() < 2.0 / 32767      # the int16 chain
    monkeypatch.setenv("BENCH_INPUT", "/some/clip.wav")
    assert tbench.bench_input(str(tmp_path)) == ("/some/clip.wav", "/some/clip.wav")


def test_engine_programs_are_bench_programs():
    # a 10 s clip gives bench.py's programs: the hole at 3*10*sr + 12345,
    # the gaps at 8, 18 and 27 s
    sr = 8000
    clip = np.arange(12 * sr, dtype=np.float32) + 1.0
    damaged, (gs, ge) = tbench.windowed_program(clip, sr)
    assert (gs, ge) == (3 * 10 * sr + 12345, 3 * 10 * sr + 12345 + 4000)
    assert damaged.shape == (60 * sr,) and np.all(damaged[gs:ge] == 0)
    assert np.count_nonzero(damaged == 0) == 4000
    damaged, spans = tbench.unet_stream_program(clip, sr)
    assert spans == [(s * sr, s * sr + 3 * sr // 10) for s in (8, 18, 27)]
    assert damaged.shape == (30 * sr,)
    assert np.count_nonzero(damaged == 0) == 3 * (3 * sr // 10)


def test_run_engines_tiny_holds_every_engines_gate():
    res = tbench.run_engines(synth_music_clip(1, 8000, 2.0), 8000, "cpu",
                             unet_epochs=2, adapt_epochs=1)
    for _, method, metric, _, _ in ENGINES_GATES:
        assert isinstance(res[method][metric], float), (method, metric)
    for method, metric in (("windowed_ar", "passthrough_exact"),
                           ("streaming_ar", "chunk_invariant"),
                           ("streaming_unet", "chunk_invariant"),
                           ("streaming_unet", "filled"), ("windowed_ar", "filled"),
                           ("streaming_ar", "filled")):
        assert res[method][metric] == 1.0, (method, metric)


def test_main_prints_one_json_line_with_bench_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("BENCH_INPUT", raising=False)
    monkeypatch.setenv("BENCH_ASSETS", str(tmp_path / "assets"))
    suites = []

    def fake_suite(tag, input_file, assets, cfg, params, device):
        suites.append((tag, os.path.basename(input_file), assets, cfg.train_steps,
                       params, device.type))
        res = _with_walls({k: GOOD[k] for k in ("part0", "part1", "part2")})
        return {**res, "total_s": 1.0}

    def fake_engines(clip, sr, device):
        assert sr == 44100 and len(clip) == 10 * sr and device.type == "cpu"
        return _broken(("engines", "streaming_unet", "rtf_warm"), 2.5)["engines"]

    monkeypatch.setattr(tbench, "run_suite", fake_suite)
    monkeypatch.setattr(tbench, "run_engines", fake_engines)
    monkeypatch.setattr(tbench, "load_or_pretrain_prior", lambda cfg, path, dev: "prior")
    assert tbench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == JSON_KEYS
    assert (line["metric"], line["unit"], line["input"], line["device"]) == (
        "suite_wall_clock_s", "s", "synthetic:1", "cpu")
    assert [t for t, *_ in suites] == ["warmup", "measured"]
    assert all(s[1:] == ("synthetic_1.wav", str(tmp_path / "assets"), 1500, "prior", "cpu")
               for s in suites)
    assert line["quality_regressions"] == [
        {"part": "engines", "method": "streaming_unet", "metric": "rtf_warm",
         "bound": 3.0, "kind": "min", "measured": 2.5}]
    assert len(line["quality_not_evaluated"]) == len(PARTS_GATES) == 24
    ours = jbench.comparable_seconds(_with_walls(GOOD))
    assert line["value"] == round(ours, 2)
    with open(jbench.BASELINE_FILE) as f:
        ref_s = json.load(f)["comparable_suite_wall_s"]
    assert line["vs_baseline"] == round(ref_s / ours, 2)
    for tag in ("[measured]", "[metrics] part0", "[metrics] part2", "[quality] FAIL",
                "not the reference clip"):
        assert tag in err


def test_main_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main([])


def test_prior_is_the_committed_one_else_on_clip_pretraining(tmp_path, monkeypatch,
                                                             capsys):
    from audio_inpainting_torch.io import save_wav_int16

    path = save_wav_int16(synth_music_clip(1, 16000, 10.0), 16000, str(tmp_path / "clip.wav"))
    got = tbench.load_or_pretrain_prior(DiffusionConfig(), path, "cpu")
    want = load_params(PRIOR_DIR, "cpu")
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert "[prior] corpus checkpoint loaded" in capsys.readouterr().err
    small = DiffusionConfig(train_steps=2, batch=2, patch=16, base_channels=8)
    monkeypatch.setattr(tbench, "PRIOR_DIR", str(tmp_path / "missing"))
    adapted = tbench.load_or_pretrain_prior(small, path, "cpu")
    err = capsys.readouterr().err
    assert "falling back to on-clip adaptation" in err and "[pretrain]" in err
    assert all(bool(torch.isfinite(v).all()) for v in adapted.values())
