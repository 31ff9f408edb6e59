"""The port's I/O, synthesis, detectors and masks against the JAX package's."""

import numpy as np
import pytest
import torch

import audio_inpainting_tpu.corrupt as jcorrupt
import audio_inpainting_tpu.io.wav as jwav
from audio_inpainting_torch import corrupt as tcorrupt
from audio_inpainting_torch.io import wav as twav
from audio_inpainting_tpu.corrupt.synth import synth_music_clip as jsynth

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)


def _damaged(n=16000, seed=0):
    """Sine + noise with three zeroed spans and one near-silent span."""
    rng = np.random.RandomState(seed)
    x = (0.5 * np.sin(np.arange(n) * 0.05) + 0.05 * rng.randn(n)).astype(np.float32)
    x[1000:1400] = 0.0
    x[5000:5050] = 0.0
    x[9000:9600] *= 1e-3
    x[-300:] = 0.0
    return x


@pytest.mark.parametrize("kind", ["int16", "int32", "float32", "stereo16"])
def test_write_read_wav_byte_equal(tmp_path, kind):
    rng = np.random.RandomState(1)
    data = {
        "int16": (rng.randn(1001) * 8000).astype(np.int16),
        "int32": (rng.randn(500) * 1e8).astype(np.int32),
        "float32": rng.randn(777).astype(np.float32),
        "stereo16": (rng.randn(300, 2) * 8000).astype(np.int16),
    }[kind]
    jp, tp = tmp_path / "j.wav", tmp_path / "t.wav"
    jwav.write_wav(str(jp), 22050, data)
    twav.write_wav(str(tp), 22050, data)
    assert jp.read_bytes() == tp.read_bytes()
    jsr, jd = jwav.read_wav(str(jp))
    tsr, td = twav.read_wav(str(jp))
    assert jsr == tsr == 22050 and td.dtype == jd.dtype
    np.testing.assert_array_equal(td, jd)
    tsr, tn = twav.load_mono_normalized(str(jp))
    np.testing.assert_array_equal(tn, jwav.load_mono_normalized(str(jp))[1])


@pytest.mark.parametrize("clip", [1.0, 0.99])
def test_save_wav_int16_byte_equal(tmp_path, clip):
    x = (np.random.RandomState(2).randn(2000) * 0.7).astype(np.float32)
    jp = jwav.save_wav_int16(x, 16000, str(tmp_path / "a" / "j.wav"), clip)
    tp = twav.save_wav_int16(x, 16000, str(tmp_path / "b" / "t.wav"), clip)
    assert open(jp, "rb").read() == open(tp, "rb").read()


@pytest.mark.parametrize("seed,style", [(0, None), (3, "percussive"),
                                        (5, "drone")])
def test_synth_music_clip_bit_equal(seed, style):
    a = jsynth(seed, 8000, 0.5, style)
    b = tcorrupt.synth_music_clip(seed, 8000, 0.5, style)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threshold,min_len", [(0.01, 100), (1e-4, 40),
                                               (1e-4, 1000)])
def test_find_gaps_exactly_equal(threshold, min_len):
    x = _damaged()
    assert (tcorrupt.find_gaps(x, threshold, min_len)
            == jcorrupt.find_gaps(x, threshold, min_len))
    assert tcorrupt.find_main_gap(x, threshold) == jcorrupt.find_main_gap(x, threshold)


def test_silence_mask_and_silent_frame_columns_exactly_equal():
    x = _damaged()
    np.testing.assert_array_equal(
        tcorrupt.silence_mask(x, 1e-3, device="cpu").numpy(),
        np.asarray(jcorrupt.silence_mask(x, 1e-3)))
    n_frames = 1 + len(x) // 256
    for thr, frac in [(1e-4, 0.9), (0.01, 0.8)]:
        np.testing.assert_array_equal(
            tcorrupt.silent_frame_columns(x, n_frames, 256, thr, frac,
                                          device="cpu"),
            jcorrupt.silent_frame_columns(x, n_frames, 256, thr, frac))
    mask = np.abs(x) > 1e-4
    np.testing.assert_array_equal(
        tcorrupt.mask_to_bad_columns(mask, n_frames, 256, device="cpu"),
        jcorrupt.mask_to_bad_columns(mask, n_frames, 256))


@pytest.mark.parametrize("seed,n", [(0, 44100), (7, 20000)])
def test_random_dropout_mask_contract(seed, n):
    """torch.Generator is not jax.random's stream: hold the mask to the
    generator's contract, which the JAX mask also meets."""
    gen = torch.Generator().manual_seed(seed)
    mask = tcorrupt.random_dropout_mask(gen, n, 0.25, 50, 400).numpy()
    assert mask.shape == (n,) and mask.dtype == bool
    lost = ~mask
    # gap count formula: at most n*ratio/max_len*2 runs (overlaps merge)
    num_gaps = int(n * 0.25 / 400 * 2)
    runs = tcorrupt.find_gaps(mask.astype(np.float32), 0.5, 0)
    assert 0 < len(runs) <= num_gaps
    # every run is at least min_len, and at most num_gaps * max_len samples
    assert min(e - s for s, e in runs) >= 50
    assert lost.sum() <= num_gaps * 399
    # same seed, same mask; another seed, another mask
    again = tcorrupt.random_dropout_mask(torch.Generator().manual_seed(seed), n)
    np.testing.assert_array_equal(again.numpy(), mask)
    other = tcorrupt.random_dropout_mask(torch.Generator().manual_seed(seed + 1), n)
    assert not np.array_equal(other.numpy(), mask)


def test_deterministic_masks_equal():
    tm, tg = tcorrupt.contiguous_gap_mask(800, 0.2)
    jm, jg = jcorrupt.contiguous_gap_mask(800, 0.2)
    np.testing.assert_array_equal(tm, jm)
    assert tg == jg
    assert (tcorrupt.center_gap_bounds(441000, 44100)
            == jcorrupt.center_gap_bounds(441000, 44100))
