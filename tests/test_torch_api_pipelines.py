"""The port's facade, pipelines, CLI and linear method against the JAX
package's, plus the port's import hygiene."""

import ast
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.api as japi
import audio_inpainting_tpu.methods.diffusion as jdiff
import audio_inpainting_tpu.methods.linear as jlinear
import audio_inpainting_tpu.methods.neural as jneural
import audio_inpainting_tpu.pipelines.part0 as jpart0
import audio_inpainting_tpu.pipelines.part2 as jpart2
from audio_inpainting_tpu.corrupt import training_stripes as jax_training_stripes
from audio_inpainting_tpu.models.diffusion_unet import DiffusionUNet as JaxDiffusionUNet
from audio_inpainting_tpu.models.packed_unet import (PackedDiscriminator,
                                                     PackedGeneratorUNet,
                                                     PackedSimpleUNet)
import audio_inpainting_torch.corrupt as tcorrupt
import audio_inpainting_torch.methods.ar as tar
import audio_inpainting_torch.methods.diffusion as tdiff
import audio_inpainting_torch.methods.neural as tneural
import audio_inpainting_torch.ops.griffin_lim as tgl
from audio_inpainting_torch import api as tapi
from audio_inpainting_torch.cli.main import main as tmain
from audio_inpainting_torch.convert import flax_to_state_dict
from audio_inpainting_torch.corrupt import find_gaps, random_dropout_mask, synth_music_clip
from audio_inpainting_torch.io import load_mono_normalized, read_wav, save_wav_int16
from audio_inpainting_torch.io import render
from audio_inpainting_torch.methods import linear as tlinear
from audio_inpainting_torch.pipelines import asset_path, run_part0, run_part2

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _jax_draws(seed, p, shape, device):
    """Stand-in for the port's texture draw: the JAX package's own pass-p
    draw, normal(fold_in(PRNGKey(seed), p)), so both packages add the same
    noise."""
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(seed), p), shape)), device=device)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tar, "_draw_eps", _jax_draws)


def _dropout_clip(sr=8000, seconds=2.0, seed=0):
    clean = synth_music_clip(seed, sr, seconds)
    mask = random_dropout_mask(torch.Generator().manual_seed(seed), len(clean))
    return clean, (clean * mask.numpy()).astype(np.float32)


def _agreement_snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


def test_linear_interp_masked_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3000).astype(np.float32)
    mask = rng.rand(3000) > 0.3
    mask[:7] = False              # clamped ends
    mask[-5:] = False
    got = tlinear.linear_interp_masked(x, mask, device="cpu").numpy()
    np.testing.assert_allclose(
        got, np.asarray(jlinear.linear_interp_masked(jnp.asarray(x), mask)),
        atol=1e-6)
    np.testing.assert_allclose(got, tlinear.linear_interp_masked_host(x, mask),
                               atol=1e-6)


def test_linear_fill_gap_matches_jax():
    x = np.random.RandomState(1).randn(5000).astype(np.float32)
    got = tlinear.linear_fill_gap(x, 1000, 3500, device="cpu").numpy()
    want = np.asarray(jlinear.linear_fill_gap(jnp.asarray(x), 1000, 3500))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[:1000], x[:1000])


@pytest.mark.parametrize("method", ["linear", "ar"])
def test_restore_matches_jax(method, jax_noise):
    _, damaged = _dropout_clip()
    got = tapi.restore(damaged, 8000, method, device="cpu")
    want = np.asarray(japi.restore(damaged, 8000, method))
    assert got.dtype == np.float32 and got.shape == damaged.shape
    if method == "linear":
        np.testing.assert_array_equal(got, want)
        return
    outside = np.ones(len(damaged), bool)
    for s, e in find_gaps(damaged, 0.01, 100):
        outside[s:e] = False
    np.testing.assert_array_equal(got[outside], damaged[outside])
    assert _agreement_snr(want[~outside], got[~outside]) >= 60.0


def test_restore_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(1000, np.float32)
    for method in ("ar", "nmf", "gp", "unet", "gan", "diffusion"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.restore(x, 8000, method, original=x)


def _jax_init(kind, seed, attempt, shape):
    """The JAX package's U-Net/GAN init (neural.py:272, :520-522), fp32, as
    state dicts, through its own jitted init."""
    key = jax.random.PRNGKey(seed)
    if attempt:
        key = jax.random.fold_in(key, attempt)
    x = jnp.zeros((1, *shape, 1), jnp.float32)
    if kind == "unet":
        return [flax_to_state_dict(jneural._jit_init(PackedSimpleUNet(), key, x)["params"])]
    kg, kd = jax.random.split(key)
    g = jneural._jit_init_train(PackedGeneratorUNet(), kg, x)
    d = jneural._jit_init_train(PackedDiscriminator(), kd, x)
    return [flax_to_state_dict(g["params"], g["batch_stats"]),
            flax_to_state_dict(d["params"], d["batch_stats"])]


def _jax_stripes(generator, n_frames, intact):
    """The JAX facade's stripes for seed 0 (api.py:135)."""
    return np.asarray(jax_training_stripes(jax.random.PRNGKey(0), n_frames, intact))


HOLES = [(6000, 9000), (15000, 15500)]
# The neural fills take the phase of the damaged STFT, which inside a hole
# is the angle of rounding noise and differs between the two packages'
# STFTs; so the facades are compared outside the frames that reach into a
# hole (sample by sample) and by the fill's level inside the holes.
OUTSIDE_AGREEMENT_DB = 60.0
FILL_LEVEL_DB = 0.3


def _holed_clip(seed=3, sr=8000, seconds=2.5):
    x = synth_music_clip(seed, sr, seconds)
    damaged = x.copy()
    for s, e in HOLES:
        damaged[s:e] = 0.0
    return x, damaged


def _assert_fill_matches(want, got):
    hole = np.zeros(len(want), bool)
    for s, e in HOLES:
        hole[s:e] = True
    near = np.convolve(hole, np.ones(1025), "same") > 0      # 1024-point frames
    assert _agreement_snr(want[~near], got[~near]) >= OUTSIDE_AGREEMENT_DB
    rms_db = 10 * np.log10(np.mean(got[hole].astype(np.float64) ** 2)
                           / np.mean(want[hole].astype(np.float64) ** 2))
    assert abs(rms_db) <= FILL_LEVEL_DB, rms_db


def test_facade_unet_matches_jax(monkeypatch):
    """Blind damage, synthetic stripes over the intact columns, 5 fp32
    epochs, with the JAX stripes and init injected. Measured: 129.7 dB
    outside the holes' frames, the fill's level within 0.06 dB (the
    composites agree to 1.1e-5 of their peak)."""
    monkeypatch.setattr(tneural, "_draw_init", _jax_init)
    monkeypatch.setattr(tcorrupt, "training_stripes", _jax_stripes)
    _, damaged = _holed_clip()
    want = np.asarray(japi.restore(damaged, 8000, "unet", epochs=5))
    got = tapi.restore(damaged, 8000, "unet", epochs=5, device="cpu")
    assert got.dtype == np.float32 and got.shape == damaged.shape
    _assert_fill_matches(want, got)


def test_facade_gan_needs_the_original():
    _, damaged = _holed_clip()
    with pytest.raises(ValueError, match="original"):
        tapi.restore(damaged, 8000, "gan", device="cpu")


# the brightness scan, and explicit gaps, which beat it
@pytest.mark.parametrize("gaps", [None, HOLES])
def test_facade_gan_matches_jax(gaps, monkeypatch):
    """3 fp32 epochs with the JAX init injected. Measured: 77.8 dB
    (brightness scan: dark cells outside the holes are filled too) and
    129.5 dB (explicit gaps) outside the holes' frames, the fill's level
    within 0.03 and 0.18 dB."""
    monkeypatch.setattr(tneural, "_draw_init", _jax_init)
    clean, damaged = _holed_clip()
    want = np.asarray(japi.restore(damaged, 8000, "gan", gaps=gaps, original=clean,
                                   epochs=3))
    got = tapi.restore(damaged, 8000, "gan", gaps=gaps, original=clean, epochs=3,
                       device="cpu")
    assert got.shape == damaged.shape and np.isfinite(got).all()
    _assert_fill_matches(want, got)


# a per-clip DDPM small enough for the CPU; the JAX package trains it in
# one program of up to 250 steps (its default scan_chunk)
DIFFUSION_KW = {"train_steps": 2, "batch": 2, "patch": 16, "sample_steps": 2,
                "base_channels": 8}
JAX_CHUNK = 250


def _jax_diffusion_draws(monkeypatch):
    """The port's Griffin-Lim phase and per-clip DDPM draws replaced by the
    JAX package's, re-derived from its keys (tests/test_torch_diffusion.py
    holds each one alone)."""
    def phase(seed, shape):
        return torch.tensor(np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seed), shape, minval=-jnp.pi, maxval=jnp.pi)))

    def keys(seed):
        k_train, k_sample, k_init = jax.random.split(jax.random.PRNGKey(seed), 3)
        return k_train, k_sample, k_init

    def init(seed, run, base):
        params, _ = jdiff._jit_ddpm_init(JaxDiffusionUNet(base=base), keys(seed)[2],
                                         jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)))
        return flax_to_state_dict(params)

    def train(seed, run, step, cfg, shape):
        done = step // JAX_CHUNK * JAX_CHUNK
        n = min(JAX_CHUNK, cfg.train_steps - done)
        k = jax.random.split(jax.random.fold_in(keys(seed)[0], done), n)[step - done]
        k1, k2, k3, k4 = jax.random.split(k, 4)
        (h, w), p, b = shape, cfg.patch, cfg.batch
        return tuple(torch.tensor(np.asarray(a)) for a in (
            jax.random.randint(k1, (b,), 0, h - p), jax.random.randint(k2, (b,), 0, w - p),
            jax.random.randint(k3, (b,), 0, 1000),
            jax.random.normal(k4, (b, p, p, 1)).transpose(0, 3, 1, 2)))

    def sample(seed, shape, n_steps):
        k_init, k = jax.random.split(keys(seed)[1])
        yield torch.tensor(np.asarray(jax.random.normal(k_init, shape)))
        for _ in range(n_steps):
            k, k1 = jax.random.split(k)
            yield torch.tensor(np.asarray(jax.random.normal(k1, shape)))

    monkeypatch.setattr(tgl, "_draw_phase", phase)
    monkeypatch.setattr(tdiff, "_draw_init", init)
    monkeypatch.setattr(tdiff, "_draw_train", train)
    monkeypatch.setattr(tdiff, "_draw_sample", sample)


# the codec's near-black scan, and explicit gaps, which beat it
@pytest.mark.parametrize("gaps", [None, HOLES])
def test_facade_diffusion_matches_jax(gaps, monkeypatch):
    """Per-clip training (2 steps), 2 DDIM steps, Griffin-Lim and the
    composite, with the JAX draws injected. The samples the JAX facade
    leaves as they were are the input in the port too; the rest agree to
    >= 60 dB (measured 109.6 dB scanned, 97.1 dB explicit)."""
    _jax_diffusion_draws(monkeypatch)
    _, damaged = _holed_clip()
    want = np.asarray(japi.restore(damaged, 8000, "diffusion", gaps=gaps, **DIFFUSION_KW))
    got = tapi.restore(damaged, 8000, "diffusion", gaps=gaps, device="cpu", **DIFFUSION_KW)
    assert got.dtype == np.float32 and got.shape == damaged.shape
    changed = want != damaged
    assert changed.any()
    np.testing.assert_array_equal(got[~changed], damaged[~changed])
    assert _agreement_snr(want[changed], got[changed]) >= 60.0


def _stub_jax_heavy_legs(monkeypatch):
    """The JAX pipelines also run legs these tests do not compare (GP, NMF,
    GAN, waveform figures); stub them so the AR, linear and diffusion legs
    run as they are, quickly. tests/test_torch_part1.py compares the GP
    and NMF legs."""
    monkeypatch.setattr(jpart2, "nmf_inpaint_columns", lambda mag, *a, **k: mag)
    monkeypatch.setattr(jpart2, "gan_train_restore",
                        lambda norm, *a, **k: (norm, None))
    monkeypatch.setattr(jpart0, "gp_restore", lambda sig, *a, **k:
                        (sig.copy(), np.zeros_like(sig)))
    monkeypatch.setattr(jpart0, "nmf_inpaint_iterative", lambda mag, *a, **k: mag)
    for viz in ("gp_waveform_viz", "ar_waveform_viz", "ar_texture_waveform_viz",
                "nmf_waveform_viz"):
        monkeypatch.setattr(jpart0, viz, lambda *a, **k: None)


def _check_artifacts(assets, part, methods, sr):
    for m in methods:
        wav_sr, data = read_wav(asset_path(assets, part, m))
        assert wav_sr == sr and data.dtype == np.int16
        with open(asset_path(assets, part, m, "image"), "rb") as f:
            assert f.read(8) == PNG_SIGNATURE


def _assert_metrics_close(got, want, legs):
    # same input, same fit up to float32 rounding, same injected noise
    for leg in legs:
        for key, val in got[leg].items():
            if key.endswith("db") or key.endswith("db_mean"):
                assert abs(val - want[leg][key]) <= 0.05, (leg, key, val,
                                                           want[leg][key])


def test_run_part2_matches_jax(tmp_path, monkeypatch, jax_noise):
    """The linear, AR and diffusion legs (per-clip, 2 training and 2 DDIM
    steps, the JAX draws injected) within 0.05 dB (the diffusion leg
    measured equal to 3e-5 dB)."""
    _stub_jax_heavy_legs(monkeypatch)
    _jax_diffusion_draws(monkeypatch)
    sr = 8000
    clip = str(tmp_path / "clip.wav")
    save_wav_int16(synth_music_clip(1, sr, 3.0, "chords"), sr, clip)
    got = run_part2(clip, str(tmp_path / "torch"), seed=0, gan_epochs=1,
                    diffusion_cfg=tdiff.DiffusionConfig(**DIFFUSION_KW), device="cpu")
    want = jpart2.run_part2(clip, str(tmp_path / "jax"), seed=0, gan_epochs=1,
                            diffusion_cfg=jdiff.DiffusionConfig(**DIFFUSION_KW))
    assert got["gap"] == want["gap"] and got["detected_gap"] == want["detected_gap"]
    _assert_metrics_close(got, want, ["linear", "ar", "diffusion"])
    assert got["diffusion"]["pretrained"] is want["diffusion"]["pretrained"] is False
    _check_artifacts(str(tmp_path / "torch"), "part2",
                     ["damaged", "original", "linear", "ar", "diffusion"], sr)


def test_run_part0_matches_jax(tmp_path, monkeypatch, jax_noise):
    _stub_jax_heavy_legs(monkeypatch)
    got = run_part0(None, str(tmp_path / "torch"), seed=0, device="cpu")
    want = jpart0.run_part0(None, str(tmp_path / "jax"), seed=0)
    assert got["gap"] == want["gap"]
    _assert_metrics_close(got, want, ["ar", "ar_texture"])
    _check_artifacts(str(tmp_path / "torch"), "part0",
                     ["ar", "ar_corrupted", "ar_original", "ar_texture",
                      "ar_texture_corrupted", "ar_texture_original"], 16000)


def test_cli_restore_roundtrip(tmp_path):
    _, damaged = _dropout_clip(seconds=1.0, seed=2)
    src, out = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    save_wav_int16(damaged, 8000, src)
    assert tmain(["restore", src, out, "--method", "ar", "--device", "cpu"]) == 0
    sr, loaded = load_mono_normalized(src)
    expected = str(tmp_path / "expected.wav")
    save_wav_int16(tapi.restore(loaded, sr, "ar", device="cpu"), sr, expected)
    assert open(out, "rb").read() == open(expected, "rb").read()


def test_spectrogram_png_without_matplotlib(tmp_path, monkeypatch):
    """The GPU machine has no matplotlib: the stdlib writer draws the file."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import fails
    x = synth_music_clip(0, 8000, 1.0)
    path = render.save_spectrogram_png(x, 8000, str(tmp_path / "s" / "spec.png"))
    raw = open(path, "rb").read()
    assert raw[:8] == PNG_SIGNATURE
    w, h = int.from_bytes(raw[16:20], "big"), int.from_bytes(raw[20:24], "big")
    assert (h, w) == (513, 1 + (8000 - 1024) // 512)
    idat_len = int.from_bytes(raw[33:37], "big")
    pixels = zlib.decompress(raw[41:41 + idat_len])
    assert len(pixels) == h * (1 + 3 * w)


def test_unet_panels_png_without_matplotlib(tmp_path, monkeypatch):
    """The U-Net figure on the GPU machine: three panels in one PNG from
    the stdlib writer, no PDF."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import fails
    rng = np.random.RandomState(0)
    mags = [rng.rand(20, 30).astype(np.float32) for _ in range(3)]
    path = render.unet_panels_viz(*mags, str(tmp_path / "p" / "cmp.png"))
    raw = open(path, "rb").read()
    assert raw[:8] == PNG_SIGNATURE
    w, h = int.from_bytes(raw[16:20], "big"), int.from_bytes(raw[20:24], "big")
    assert (h, w) == (20, 3 * 30 + 2 * 4)
    assert not (tmp_path / "p" / "cmp.pdf").exists()


def _port_sources():
    return sorted((REPO / "audio_inpainting_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_no_jax_import_in_port_sources():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax",
                                                  "orbax", "sklearn"), (path, name)
                assert "audio_inpainting_tpu" not in name, (path, name)


def test_port_modules_import_without_the_jax_package():
    """A fresh interpreter (this one has jax loaded by the test setup)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import audio_inpainting_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.startswith('audio_inpainting_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
