"""The port's Riffusion path (models/sd/pipeline.py and
methods/diffusion.py's ``resize_image`` and ``riffusion_restore_audio``)
against the JAX package's, on the CPU, at the ``tiny()`` widths.

Both packages get the same weights (the JAX modules' parameters drawn
with numpy and carried across by ``convert.sd_flax_to_state_dict``), the
same prompt context (the stand-in text encoder of tests/test_sd.py) and
the same random numbers: the JAX package's posterior sample, latent noise
and Griffin-Lim phase are injected into the port's ``_draw_*`` seams.
Bounds: the latents before decode within 1e-4 of their peak (measured
4.3e-6), the image within 1 uint8 level (measured equal), ``resize_image``
bit-equal to PIL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import audio_inpainting_tpu.methods.diffusion as jdiff
from audio_inpainting_tpu.models.sd import pipeline as jpipe
from audio_inpainting_tpu.models.sd.unet2d import UNet2DCondition as JaxUNet
from audio_inpainting_tpu.models.sd.unet2d import UNetConfig as JaxUNetConfig
from audio_inpainting_tpu.models.sd.vae import AutoencoderKL as JaxVAE
from audio_inpainting_tpu.models.sd.vae import VAEConfig as JaxVAEConfig
import audio_inpainting_torch.methods.diffusion as tdiff
import audio_inpainting_torch.models.sd.pipeline as tpipe
import audio_inpainting_torch.ops.griffin_lim as tgl
from audio_inpainting_torch.models.sd import (AutoencoderKL, InpaintConfig, UNet2DCondition,
                                              UNetConfig, VAEConfig, load_module,
                                              riffusion_inpaint_image, sd_flax_to_state_dict)

torch.set_num_threads(1)

H = 32                     # the tests' SD canvas
STEPS = 4
LATENT_RTOL = 1e-4         # of the latents' peak
# the restored waveforms, port against JAX: measured 77.7 dB (the images
# are equal; Griffin-Lim's 32 float32 iterations part the waveforms)
RESTORE_AGREEMENT_DB = 60.0


def _jax_params(model, *args, seed):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        a = rng.randn(*s.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(s.shape[:-1]))
        return 1.0 + 0.1 * a if name == "scale" else 0.1 * a

    return jax.tree_util.tree_map_with_path(leaf, shapes)


class _FakeTokenizer:
    """tests/test_sd.py's stand-in: 7 token ids per text."""

    model_max_length = 77

    def __call__(self, texts, **kw):
        class R:
            input_ids = np.zeros((len(texts), 7), np.int32)
        return R()


class _FakeTextEncoder:
    """tests/test_sd.py's stand-in: a seeded context of the ids' shape."""

    def __init__(self, dim):
        self.dim = dim

    def __call__(self, ids):
        class R:
            pass
        r = R()
        r.last_hidden_state = np.random.default_rng(3).normal(
            size=(ids.shape[0], ids.shape[1], self.dim)).astype(np.float32)
        return r


@pytest.fixture(scope="module")
def bundles():
    """(JAX bundle, port bundle) of the same tiny weights."""
    ucfg, vcfg = JaxUNetConfig.tiny(), JaxVAEConfig.tiny()
    up = _jax_params(JaxUNet(ucfg), np.zeros((1, 16, 16, 4), np.float32),
                     np.zeros((1,), np.float32),
                     np.zeros((1, 7, ucfg.cross_attention_dim), np.float32), seed=0)
    vp = _jax_params(JaxVAE(vcfg), np.zeros((1, H, H, 3), np.float32),
                     jax.random.PRNGKey(1), seed=1)
    text = {"text_encoder": _FakeTextEncoder(ucfg.cross_attention_dim),
            "tokenizer": _FakeTokenizer()}
    jb = {"unet_params": up, "vae_params": vp, "unet_cfg": ucfg, "vae_cfg": vcfg, **text}
    tb = {"unet_params": load_module(UNet2DCondition, UNetConfig.tiny(),
                                     sd_flax_to_state_dict(up), "cpu"),
          "vae_params": load_module(AutoencoderKL, VAEConfig.tiny(),
                                    sd_flax_to_state_dict(vp), "cpu"),
          "unet_cfg": UNetConfig.tiny(), "vae_cfg": VAEConfig.tiny(), **text}
    return jb, tb


def _jax_keys(seed):
    """riffusion_inpaint_image's keys (pipeline.py:136, :86): the
    posterior's k_enc and the latent noise's split(k_loop)[0]."""
    k_enc, k_loop = jax.random.split(jax.random.PRNGKey(seed))
    return k_enc, jax.random.split(k_loop)[0]


def _nhwc_normal(key, shape):
    n, c, h, w = shape
    return torch.tensor(np.asarray(jax.random.normal(key, (n, h, w, c)))).permute(0, 3, 1, 2)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tpipe, "_draw_posterior",
                        lambda seed, shape: _nhwc_normal(_jax_keys(seed)[0], shape))
    monkeypatch.setattr(tpipe, "_draw_noise",
                        lambda seed, shape: _nhwc_normal(_jax_keys(seed)[1], shape))
    monkeypatch.setattr(tgl, "_draw_phase", lambda seed, shape: torch.tensor(np.asarray(
        jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=-jnp.pi, maxval=jnp.pi))))


@pytest.fixture
def spy_latents(monkeypatch):
    """Keeps what the port's _denoise_loop returns."""
    seen = []
    loop = tpipe._denoise_loop

    def spy(*args, **kw):
        seen.append(loop(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(tpipe, "_denoise_loop", spy)
    return seen


def _image_and_mask():
    img = np.random.default_rng(4).integers(0, 256, size=(H, H, 3)).astype(np.uint8)
    mask = np.zeros((H, H), np.uint8)
    mask[:, 12:20] = 255
    return img, mask


def _jax_latents(jb, img, mask, seed):
    """The JAX pipeline's latents before decode, by its own functions."""
    cfg = jpipe.InpaintConfig(steps=STEPS, unet=jb["unet_cfg"], vae=jb["vae_cfg"])
    k_enc, k_loop = jax.random.split(jax.random.PRNGKey(seed))
    lat0 = jpipe._encode_image(jb["vae_params"], jnp.asarray(img, jnp.float32)[None] / 127.5
                               - 1.0, k_enc, cfg)
    hole = (mask.astype(np.float32) / 255.0).reshape(H // 2, 2, H // 2, 2).max(axis=(1, 3))
    ctx = jnp.asarray(jpipe.encode_prompt(jb["tokenizer"], jb["text_encoder"], jpipe.PROMPT))
    return np.asarray(jpipe._denoise_loop(jb["unet_params"], lat0,
                                          jnp.asarray(hole)[None, :, :, None], ctx, k_loop, cfg))


def test_inpaint_image_matches_jax(bundles, jax_draws, spy_latents):
    jb, tb = bundles
    img, mask = _image_and_mask()
    got = riffusion_inpaint_image(tb, img, mask, cfg=InpaintConfig(steps=STEPS), key=0)
    want = jpipe.riffusion_inpaint_image(jb, img, mask, cfg=jpipe.InpaintConfig(steps=STEPS),
                                         key=0)
    assert got.shape == (H, H, 3) and got.dtype == np.uint8
    lat = spy_latents[0].permute(0, 2, 3, 1).numpy()
    want_lat = _jax_latents(jb, img, mask, 0)
    assert np.abs(lat - want_lat).max() <= LATENT_RTOL * np.abs(want_lat).max()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_inpaint_keeps_clean_latents_outside_the_hole(bundles, spy_latents, monkeypatch):
    """After the final PLMS step the latents outside the hole are the clean
    image latents exactly; inside they were rewritten. (The port's own
    draws: the contract holds for any noise.)"""
    _, tb = bundles
    img, mask = _image_and_mask()
    clean = []
    encode = tpipe._encode_image

    def keep_encode(*a, **kw):
        clean.append(encode(*a, **kw))
        return clean[-1]

    monkeypatch.setattr(tpipe, "_encode_image", keep_encode)
    riffusion_inpaint_image(tb, img, mask, cfg=InpaintConfig(steps=3), key=7)
    lat, clean = spy_latents[0][0], clean[0][0]
    keep = torch.ones(H // 2, H // 2, dtype=torch.bool)
    keep[:, 6:10] = False
    assert torch.equal(lat[:, keep], clean[:, keep])
    assert bool(torch.isfinite(lat).all())
    assert float((lat[:, ~keep] - clean[:, ~keep]).abs().max()) > 1e-6


def test_inpaint_only_strength_one(bundles):
    _, tb = bundles
    img, mask = _image_and_mask()
    with pytest.raises(NotImplementedError):
        riffusion_inpaint_image(tb, img, mask, cfg=InpaintConfig(steps=STEPS, strength=0.5))


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("shape, size", [
    ((1025, 862), (512, 512)),     # Part 2's spectrogram image onto the SD canvas
    ((512, 512), (862, 1025)),     # and back
    ((1025, 16), (H, H)),          # the end-to-end test's image onto its canvas
    ((H, H), (16, 1025)),
])
def test_resize_image_bit_equal_to_pil(mode, shape, size):
    rng = np.random.default_rng(shape[0] + size[0])
    full = shape + ((3,) if mode == "RGB" else ())
    # a smooth image with noise: bicubic ringing overshoots at the edges
    img = np.clip(np.cumsum(rng.normal(size=full), axis=0) * 4 + 128
                  + rng.normal(size=full) * 30, 0, 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size))
    np.testing.assert_array_equal(tdiff.resize_image(img, size), want)
    np.testing.assert_array_equal(tdiff.resize_image(img, size), jdiff.resize_image(img, size))


def _damaged_clip():
    """tests/test_sd.py's clip: 1 s at 8 kHz of noise and a 300 Hz tone,
    a hole of 3,000 samples (longer than n_fft, so whole columns are
    silent)."""
    sr = 8000
    rng = np.random.default_rng(5)
    t = np.arange(sr)
    x = (0.3 * rng.standard_normal(sr) + 0.5 * np.sin(2 * np.pi * 300 * t / sr)).astype(
        np.float32)
    dmg = x.copy()
    dmg[2500:5500] = 0.0
    return sr, dmg, (2500, 5500)


def test_riffusion_restore_audio_tiny_against_jax(bundles, jax_draws):
    """Audio in -> audio out through codec, SD inpaint, Griffin-Lim, the
    energy calibration and the time-domain composite; the contract of
    tests/test_sd.py's end-to-end test, and agreement with the JAX package
    at >= 60 dB on the same bundle and draws."""
    jb, tb = bundles
    sr, dmg, (gs, ge) = _damaged_clip()
    out = tdiff.riffusion_restore_audio(dmg, sr, bundle=tb, steps=STEPS, image_size=H,
                                        device="cpu")
    assert out.shape == dmg.shape and out.dtype == np.float32
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[: gs - 2048], dmg[: gs - 2048], atol=1e-6)
    np.testing.assert_allclose(out[ge + 2048:], dmg[ge + 2048:], atol=1e-6)
    assert np.abs(out[3700:4700]).max() > 1e-4
    want = jdiff.riffusion_restore_audio(dmg, sr, bundle=jb, steps=STEPS, image_size=H)
    err = float(np.sum((out.astype(np.float64) - want) ** 2))
    assert 10 * np.log10(float(np.sum(want.astype(np.float64) ** 2)) / max(err, 1e-30)) \
        >= RESTORE_AGREEMENT_DB


def test_riffusion_restore_audio_needs_a_checkpoint(tmp_path):
    sr, dmg, _ = _damaged_clip()
    with pytest.raises(FileNotFoundError):
        tdiff.riffusion_restore_audio(dmg, sr, device="cpu")
    with pytest.raises(FileNotFoundError):
        tdiff.riffusion_restore_audio(dmg, sr, checkpoint_root=str(tmp_path / "missing"),
                                      device="cpu")


def test_sd_entry_points_want_a_gpu_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sr, dmg, _ = _damaged_clip()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdiff.riffusion_restore_audio(dmg, sr, checkpoint_root=str(tmp_path))
    from audio_inpainting_torch.models.sd import load_riffusion

    with pytest.raises(RuntimeError, match="CUDA"):
        load_riffusion(str(tmp_path), load_text=False)
