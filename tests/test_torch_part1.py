"""The port's Part 1 pipeline, the NMF, GP and GAN legs of Parts 0 and 2,
the facade's nmf and gp branches and the CLI's pipeline commands, against
the JAX package's, on the CPU.

Both packages get the same random numbers: the JAX package's frame mask,
texture noise, NMF init, GP restart draws and U-Net/GAN init weights are
injected into the port, and the Griffin-Lim phase and DDIM draws of
Part 2's diffusion leg. The JAX pipelines also draw waveform figures,
which the port does not; those are stubbed. Deterministic legs agree
within 0.05 dB (SNR, local SNR, LSD), the diffusion leg too; the U-Net and
GAN legs at 2 bf16 epochs within GAN_DB_TOL. The GP legs are held by quality within
GP_MARGIN_DB: their fits may part where float32 rounding branches the line
search (tests/test_torch_gp.py).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.api as japi
import audio_inpainting_tpu.methods.diffusion as jdiff
import audio_inpainting_tpu.methods.neural as jneural
import audio_inpainting_tpu.pipelines.part0 as jpart0
import audio_inpainting_tpu.pipelines.part1 as jpart1
import audio_inpainting_tpu.pipelines.part2 as jpart2
from audio_inpainting_tpu.corrupt import random_frame_mask as jax_random_frame_mask
from audio_inpainting_tpu.utils.checkpoint import load_params as jax_load_params
from audio_inpainting_tpu.models.packed_unet import (PackedDiscriminator,
                                                     PackedGeneratorUNet,
                                                     PackedSimpleUNet)
import audio_inpainting_torch.methods.ar as tar
import audio_inpainting_torch.methods.diffusion as tdiff
import audio_inpainting_torch.methods.gp as tgp
import audio_inpainting_torch.methods.neural as tneural
import audio_inpainting_torch.methods.nmf as tnmf
import audio_inpainting_torch.ops.griffin_lim as tgl
import audio_inpainting_torch.pipelines.part1 as tpart1
from audio_inpainting_torch import api as tapi
from audio_inpainting_torch.cli.main import main as tmain
from audio_inpainting_torch.convert import flax_to_state_dict
from audio_inpainting_torch.corrupt import synth_music_clip
from audio_inpainting_torch.io import read_wav, save_wav_int16
from audio_inpainting_torch.pipelines import asset_path, run_part0, run_part1, run_part2
from audio_inpainting_torch.utils import load_params

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JAX_PRIOR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "checkpoints", "diffusion_prior")
DB_TOL = 0.05
# the GAN leg at 2 bf16 epochs: measured gaps 0.07 dB (SNR), 0.45 dB
# (local SNR), 0.37 dB (LSD). bf16 rounding: at init the generator's bf16
# forward differs by up to 0.036 between the JAX package's own plain and
# packed classes, by 0.015 between the port and the plain class and by
# 0.035 between the port and the packed class the pipeline runs (in fp32
# all three agree to 2e-5)
GAN_DB_TOL = 1.0
# local SNR / SNR a GP leg of the port may fall short of the JAX package's
GP_MARGIN_DB = 3.0


def _jax_eps(seed, p, shape, device):
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(seed), p), shape)), device=device)


def _jax_wh(seed, f, t, k, device):
    kw, kh = jax.random.split(jax.random.PRNGKey(seed))
    return (torch.tensor(np.asarray(jnp.abs(jax.random.normal(kw, (f, k)))), device=device),
            torch.tensor(np.asarray(jnp.abs(jax.random.normal(kh, (k, t)))), device=device))


def _jax_restarts(seed, n, device):
    return torch.tensor(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (n, 5))), device=device)


def _jax_frame_mask(seed, n_freq, n_frames, mask_ratio, device):
    return torch.tensor(np.asarray(jax_random_frame_mask(
        jax.random.PRNGKey(seed), n_freq, n_frames, mask_ratio=mask_ratio)),
        device=device)


def _jax_init(kind, seed, attempt, shape, dtype):
    """The JAX package's U-Net/GAN init (neural.py:272, :520-522), as state
    dicts, through its own jitted init (compiled once per model and shape
    by the JAX pipeline run)."""
    key = jax.random.PRNGKey(seed)
    if attempt:
        key = jax.random.fold_in(key, attempt)
    x = jnp.zeros((1, *shape, 1), jnp.float32)
    if kind == "unet":
        return [flax_to_state_dict(jneural._jit_init(PackedSimpleUNet(dtype=dtype),
                                                     key, x)["params"])]
    kg, kd = jax.random.split(key)
    g = jneural._jit_init_train(PackedGeneratorUNet(dtype=dtype), kg, x)
    d = jneural._jit_init_train(PackedDiscriminator(dtype=dtype), kd, x)
    return [flax_to_state_dict(g["params"], g["batch_stats"]),
            flax_to_state_dict(d["params"], d["batch_stats"])]


def _jax_phase(seed, shape):
    return torch.tensor(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), shape, minval=-jnp.pi, maxval=jnp.pi)))


def _jax_sample(seed, shape, n_steps):
    """The DDIM draws of diffusion_inpaint_image(key=seed) (diffusion.py:278,
    :177-189)."""
    k_init, k = jax.random.split(jax.random.split(jax.random.PRNGKey(seed), 3)[1])
    yield torch.tensor(np.asarray(jax.random.normal(k_init, shape)))
    for _ in range(n_steps):
        k, k1 = jax.random.split(k)
        yield torch.tensor(np.asarray(jax.random.normal(k1, shape)))


@pytest.fixture
def jax_draws(monkeypatch):
    """Every random draw of the port replaced by the JAX package's (the
    pipelines' U-Net and GAN run bf16 convs)."""
    monkeypatch.setattr(tar, "_draw_eps", _jax_eps)
    monkeypatch.setattr(tgl, "_draw_phase", _jax_phase)
    monkeypatch.setattr(tdiff, "_draw_sample", _jax_sample)
    monkeypatch.setattr(tnmf, "_draw_wh", _jax_wh)
    monkeypatch.setattr(tgp, "_draw_restarts", _jax_restarts)
    monkeypatch.setattr(tpart1, "_draw_frame_mask", _jax_frame_mask)
    monkeypatch.setattr(tneural, "_draw_init",
                        functools.partial(_jax_init, dtype=jnp.bfloat16))


@pytest.fixture
def jax_stubs(monkeypatch):
    """The JAX pipelines' figures, which are not ported yet."""
    for viz in ("gp_waveform_viz", "ar_waveform_viz", "ar_texture_waveform_viz",
                "nmf_waveform_viz"):
        monkeypatch.setattr(jpart0, viz, lambda *a, **k: None)


def _clip(tmp_path, seed=1, sr=16000, seconds=3.0):
    path = str(tmp_path / "clip.wav")
    save_wav_int16(synth_music_clip(seed, sr, seconds, "chords"), sr, path)
    return path


def _check_artifacts(assets, part, methods, sr):
    for m in methods:
        wav_sr, data = read_wav(asset_path(assets, part, m))
        assert wav_sr == sr and data.dtype == np.int16 and len(data)
        with open(asset_path(assets, part, m, "image"), "rb") as f:
            assert f.read(8) == PNG_SIGNATURE


def _assert_legs_close(got, want, legs, tol=DB_TOL):
    for leg in legs:
        for key, val in got[leg].items():
            if key.endswith("db"):
                assert np.isfinite(val) and abs(val - want[leg][key]) <= tol, (
                    leg, key, val, want[leg][key])


def _assert_gp_legs(got, want, legs):
    """By quality: no worse than the JAX package's by more than the margin."""
    for leg in legs:
        for key in ("snr_db", "local_snr_db"):
            assert got[leg][key] >= want[leg][key] - GP_MARGIN_DB, (
                leg, key, got[leg][key], want[leg][key])


def test_run_part1_matches_jax(tmp_path, jax_draws, jax_stubs):
    clip = _clip(tmp_path)
    want = jpart1.run_part1(clip, str(tmp_path / "jax"), seed=0, unet_epochs=2)
    got = run_part1(clip, str(tmp_path / "torch"), seed=0, unet_epochs=2,
                    device="cpu")
    assert got["n_gaps"] == want["n_gaps"] > 0
    assert got["nmf"]["bad_cols"] == want["nmf"]["bad_cols"] > 0
    _assert_legs_close(got, want, ["damaged", "linear", "ar", "nmf", "unet"])
    _check_artifacts(str(tmp_path / "torch"), "part1",
                     ["damaged", "original", "linear", "ar", "nmf", "unet"], 16000)
    with open(os.path.join(tmp_path, "torch", "part1", "spectrogram_comparison.png"),
              "rb") as f:
        assert f.read(8) == PNG_SIGNATURE


def test_run_part0_gp_and_nmf_legs_match_jax(tmp_path, jax_draws, jax_stubs):
    got = run_part0(None, str(tmp_path / "torch"), seed=0, device="cpu")
    want = jpart0.run_part0(None, str(tmp_path / "jax"), seed=0)
    assert list(got) == list(want)
    _assert_legs_close(got, want, ["ar", "ar_texture", "nmf"])
    _assert_gp_legs(got, want, ["gp", "gp_synthetic"])
    _check_artifacts(str(tmp_path / "torch"), "part0",
                     ["gp", "gp_corrupted", "gp_original", "nmf",
                      "nmf_corrupted", "nmf_original"], 16000)


def test_run_part2_nmf_leg_matches_jax(tmp_path, jax_draws, jax_stubs):
    """The NMF leg, the GAN leg at 2 bf16 epochs (retry not armed) and the
    diffusion leg from the committed corpus prior (2 DDIM steps), as the
    CLI runs it (measured within 0.0022 dB)."""
    clip = _clip(tmp_path, seed=2, sr=8000)
    want = jpart2.run_part2(clip, str(tmp_path / "jax"), seed=0, gan_epochs=2,
                            diffusion_cfg=jdiff.DiffusionConfig(sample_steps=2),
                            diffusion_params=jax_load_params(JAX_PRIOR))
    got = run_part2(clip, str(tmp_path / "torch"), seed=0, gan_epochs=2,
                    diffusion_cfg=tdiff.DiffusionConfig(sample_steps=2),
                    diffusion_params=load_params(tdiff.PRIOR_DIR, "cpu"), device="cpu")
    assert got["gan"]["attempts"] == 1
    assert got["diffusion"]["pretrained"] is want["diffusion"]["pretrained"] is True
    _assert_legs_close(got, want, ["linear", "ar", "nmf", "diffusion"])
    _assert_legs_close(got, want, ["gan"], GAN_DB_TOL)
    _check_artifacts(str(tmp_path / "torch"), "part2", ["nmf", "gan", "diffusion"], 8000)


def _agreement_snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


# blind detection, and explicit gaps through the column criterion
@pytest.mark.parametrize("gaps", [None, [(6000, 9000), (15000, 15500)]])
def test_restore_nmf_matches_jax(gaps, jax_draws):
    sr = 8000
    x = synth_music_clip(3, sr, 2.5)
    damaged = x.copy()
    for s, e in [(6000, 9000), (15000, 15500)]:
        damaged[s:e] = 0.0
    got = tapi.restore(damaged, sr, "nmf", gaps=gaps, device="cpu")
    want = np.asarray(japi.restore(damaged, sr, "nmf", gaps=gaps))
    assert got.dtype == np.float32 and got.shape == damaged.shape
    assert _agreement_snr(want, got) >= 60.0


def test_restore_gp_matches_jax(jax_draws):
    """The facade's gp branch on a Part 0 segment (0.05 s at 16 kHz)."""
    _, seg = jpart0.synthetic_signal(0.05, seed=3)
    gs, ge = 320, 480
    damaged = seg.copy()
    damaged[gs:ge] = 0.0
    got = tapi.restore(damaged, 16000, "gp", gaps=[(gs, ge)], device="cpu")
    want = np.asarray(japi.restore(damaged, 16000, "gp", gaps=[(gs, ge)]))
    np.testing.assert_array_equal(got[:gs], damaged[:gs])
    np.testing.assert_array_equal(got[ge:], damaged[ge:])
    local = _agreement_snr(seg[gs:ge], got[gs:ge])
    assert local >= _agreement_snr(seg[gs:ge], want[gs:ge]) - GP_MARGIN_DB


def test_cli_part1_roundtrip(tmp_path, capsys):
    clip = _clip(tmp_path, seed=4, sr=8000, seconds=2.0)
    assert tmain(["part1", "--input", clip, "--assets-dir", str(tmp_path / "cli"),
                  "--unet-epochs", "2", "--device", "cpu", "--json"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["part1"]
    direct = run_part1(clip, str(tmp_path / "direct"), seed=0, unet_epochs=2,
                       device="cpu")
    assert printed["n_gaps"] == direct["n_gaps"]
    for leg in ("damaged", "linear", "ar", "nmf", "unet"):
        for key in ("snr_db", "lsd_db"):
            assert printed[leg][key] == direct[leg][key]
        path = asset_path("", "part1", leg)
        assert (open(str(tmp_path / "cli") + "/" + path, "rb").read()
                == open(str(tmp_path / "direct") + "/" + path, "rb").read())


def test_cli_diffusion_checkpoint_resolution(tmp_path, capsys):
    """Part 2's diffusion weights on the command line: the committed prior
    by default (with a notice), 'none' for per-clip training, and a named
    directory that does not exist fails before any leg runs."""
    from audio_inpainting_torch.cli.main import _diffusion_checkpoint

    assert _diffusion_checkpoint(None) == tdiff.PRIOR_DIR
    assert "corpus prior" in capsys.readouterr().err
    assert _diffusion_checkpoint("none") is None
    assert _diffusion_checkpoint(str(tmp_path)) == str(tmp_path)
    missing = str(tmp_path / "missing")
    for cmd in ("part2", "all"):
        with pytest.raises(FileNotFoundError, match="missing"):
            tmain([cmd, "--input", "unused.wav", "--assets-dir", str(tmp_path / "a"),
                   "--diffusion-checkpoint", missing, "--device", "cpu"])
    assert not (tmp_path / "a").exists()
