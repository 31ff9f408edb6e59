"""The port's diffusion method (methods/diffusion.py), its U-Net
(models/diffusion_unet.py), Griffin-Lim (ops/griffin_lim.py), checkpoint
format (utils/checkpoint.py) and committed prior, against the JAX
package's, on the CPU.

Both packages get the same random numbers: the JAX package's phase, init,
training and sampling draws are injected into the port's ``_draw_*``
seams, re-derived from the JAX keys as its functions derive them. The
bounds are stated beside each test with what was measured.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import audio_inpainting_tpu.methods.diffusion as jdiff
from audio_inpainting_tpu.models.diffusion_unet import DiffusionUNet as JaxDiffusionUNet
from audio_inpainting_tpu.ops.griffin_lim import griffin_lim as jax_griffin_lim
from audio_inpainting_tpu.ops.stft import stft as jax_stft
from audio_inpainting_tpu.ops.stft import torch_stft_config as jax_torch_stft_config
from audio_inpainting_tpu.utils.checkpoint import load_params as jax_load_params
import audio_inpainting_torch.methods.diffusion as tdiff
import audio_inpainting_torch.models.diffusion_unet as tunet
import audio_inpainting_torch.ops.griffin_lim as tgl
from audio_inpainting_torch.convert import flax_to_state_dict
from audio_inpainting_torch.corrupt import synth_music_clip
from audio_inpainting_torch.ops.stft import _pad_reflect_repeated, stft, torch_stft_config
from audio_inpainting_torch.utils import load_params, save_params

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

PRIOR_ORBAX = str(Path(__file__).resolve().parent.parent / "checkpoints" / "diffusion_prior")
# the JAX configs: 2 training steps per JAX program, so one compiled
# program serves every training test (the port has no such field)
CHUNK = 2
JCFG = jdiff.DiffusionConfig(train_steps=4, batch=2, patch=16, sample_steps=6,
                             base_channels=8, scan_chunk=CHUNK)
TCFG = tdiff.DiffusionConfig(train_steps=4, batch=2, patch=16, sample_steps=6,
                             base_channels=8)
JCFG_PRIOR = jdiff.DiffusionConfig(sample_steps=4)
TCFG_PRIOR = tdiff.DiffusionConfig(sample_steps=4)
IMG_SHAPE = (40, 48)


# ------------------------------------------------------ the JAX draws -------


def _jax_phase(seed, shape):
    """griffin_lim.py:88, uniform in [-pi, pi) from PRNGKey(seed)."""
    return torch.tensor(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), shape, minval=-jnp.pi, maxval=jnp.pi)))


def _jax_run_keys(seed, run):
    """(k_init, k_train) of a per-clip run (diffusion.py:278: train, sample,
    init) or a corpus run (:229: init, train)."""
    key = jax.random.PRNGKey(seed)
    if run == "clip":
        k_train, _, k_init = jax.random.split(key, 3)
        return k_init, k_train
    return tuple(jax.random.split(key))


def _jax_init(seed, run, base):
    params, _ = jdiff._jit_ddpm_init(JaxDiffusionUNet(base=base), _jax_run_keys(seed, run)[0],
                                     jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)))
    return flax_to_state_dict(params)


def _jax_train(seed, run, step, cfg, shape):
    """Step ``step``'s draws as _train_chunk derives them: the chunk's key
    is fold_in(k_train, first step of the chunk), split into one key per
    step, each split into four (diffusion.py:141-149, :161)."""
    done = step // CHUNK * CHUNK
    n = min(CHUNK, cfg.train_steps - done)
    k = jax.random.split(jax.random.fold_in(_jax_run_keys(seed, run)[1], done), n)[step - done]
    k1, k2, k3, k4 = jax.random.split(k, 4)
    (h, w), p, b = shape, cfg.patch, cfg.batch
    return tuple(torch.tensor(np.asarray(a)) for a in (
        jax.random.randint(k1, (b,), 0, h - p), jax.random.randint(k2, (b,), 0, w - p),
        jax.random.randint(k3, (b,), 0, 1000),
        jax.random.normal(k4, (b, p, p, 1)).transpose(0, 3, 1, 2)))


def _jax_sample(seed, shape, n_steps):
    """_ddim_repaint's draws from k_sample = split(PRNGKey(seed), 3)[1]
    (diffusion.py:177-189)."""
    k_init, k = jax.random.split(jax.random.split(jax.random.PRNGKey(seed), 3)[1])
    yield torch.tensor(np.asarray(jax.random.normal(k_init, shape)))
    for _ in range(n_steps):
        k, k1 = jax.random.split(k)
        yield torch.tensor(np.asarray(jax.random.normal(k1, shape)))


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tgl, "_draw_phase", _jax_phase)
    monkeypatch.setattr(tdiff, "_draw_init", _jax_init)
    monkeypatch.setattr(tdiff, "_draw_train", _jax_train)
    monkeypatch.setattr(tdiff, "_draw_sample", _jax_sample)


# ------------------------------------------------------------ helpers -------


def _agreement_snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_prior():
    return jax_load_params(PRIOR_ORBAX)


@functools.lru_cache(maxsize=None)
def _jax_apply(base):
    return jax.jit(JaxDiffusionUNet(base=base).apply)


def _perturbed_params(base, seed=0, scale=0.1):
    """The JAX init (the output conv starts at zero) with numpy noise added
    to every leaf, so every layer moves the output."""
    rng = np.random.RandomState(seed)
    params, _ = jdiff._jit_ddpm_init(JaxDiffusionUNet(base=base), jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*a.shape).astype(np.float32), params)


def _forward_both(params, x_nhwc, t, state=None, base=8):
    want = np.asarray(_jax_apply(base)({"params": params}, jnp.asarray(x_nhwc),
                                       jnp.asarray(t)))
    model = tdiff.new_model(state or flax_to_state_dict(params), base, "cpu")
    with torch.no_grad():
        got = model(torch.tensor(x_nhwc).permute(0, 3, 1, 2), torch.tensor(t))
    return want, got.permute(0, 2, 3, 1).numpy()


def _image(seed=0):
    rng = np.random.RandomState(seed)
    img_u8 = (rng.rand(*IMG_SHAPE) * 200 + 30).astype(np.uint8)
    mask_u8 = np.zeros(IMG_SHAPE, np.uint8)
    mask_u8[:, 20:30] = 255
    return img_u8, mask_u8


# -------------------------------------------------------------- codec -------


def test_codec_matches_jax():
    """wav_to_logspec on torch.stft against the JAX matmul STFT: measured
    0.0056 dB at most; the uint8 image then differs by 1 level on 3e-5 of
    the pixels. The host image functions are the same numpy: exact."""
    x = synth_music_clip(0, 16000, 1.0)
    want = np.asarray(jdiff.wav_to_logspec(jnp.asarray(x)))
    got = tdiff.wav_to_logspec(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (1025, 32)
    assert np.abs(got - want).max() <= 0.02
    (jimg, jmin, jmax), (timg, tmin, tmax) = (jdiff.logspec_to_image(want),
                                              tdiff.logspec_to_image(got))
    levels = np.abs(jimg.astype(int) - timg.astype(int))
    assert levels.max() <= 1 and (levels > 0).mean() <= 1e-3
    # the same input through both packages' host functions
    np.testing.assert_array_equal(tdiff.logspec_to_image(want)[0], jimg)
    np.testing.assert_array_equal(tdiff.image_to_linear_spec(jimg, jmin, jmax),
                                  jdiff.image_to_linear_spec(jimg, jmin, jmax))
    np.testing.assert_array_equal(tdiff.mask_from_image(jimg), jdiff.mask_from_image(jimg))
    assert abs(tmin - jmin) <= 0.02 and abs(tmax - jmax) <= 0.02


@pytest.mark.parametrize("n,half", [(1, 4), (2, 5), (3, 8), (7, 3), (1024, 1024),
                                    (1025, 1024)])
def test_pad_reflect_repeated_matches_numpy(n, half):
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    got = _pad_reflect_repeated(torch.tensor(x), half).numpy()
    np.testing.assert_array_equal(got, np.pad(x, (half, half), mode="reflect"))


def test_stft_of_a_signal_shorter_than_its_pad_matches_jax():
    """torch.stft's reflect pad refuses a pad as long as the signal; the
    port pads by repeated reflection, as jnp.pad does. Within 1e-5 of the
    peak magnitude."""
    x = np.random.RandomState(0).randn(1000).astype(np.float32)
    got = stft(torch.tensor(x), torch_stft_config(2048, 512)).numpy()
    want = np.asarray(jax_stft(jnp.asarray(x), jax_torch_stft_config(2048, 512)))
    assert got.shape == want.shape == (1025, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# -------------------------------------------------------- Griffin-Lim -------


@pytest.mark.parametrize("case", ["clip", "short"])
def test_griffin_lim_matches_jax(case, jax_draws):
    """32 iterations on a 1 s clip's image, and the (1025, 3) short case of
    tests/test_diffusion.py (2 iterations, length 1024, under the centre
    pad). Measured agreement: 104.5 dB and 89.8 dB (one torch thread)."""
    if case == "clip":
        x = synth_music_clip(0, 16000, 1.0)
        img, smin, smax = jdiff.logspec_to_image(np.asarray(jdiff.wav_to_logspec(jnp.asarray(x))))
        mag, kw = jdiff.image_to_linear_spec(img, smin, smax), {"n_iter": 32, "length": len(x)}
    else:
        mag, kw = np.random.RandomState(0).rand(1025, 3).astype(np.float32), {"n_iter": 2}
    want = np.asarray(jax_griffin_lim(jnp.asarray(mag), seed=3, **kw))
    got = tgl.griffin_lim(mag, seed=3, device="cpu", **kw).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _agreement_snr(want, got) >= 80.0


# ---------------------------------------------------------- the U-Net -------


@pytest.mark.parametrize("base", [8, 16])
def test_diffusion_unet_forward_matches_jax(base):
    """Converted JAX weights (perturbed so every layer counts), a batch of
    two at two times, an axis that halves to an odd size: within 1e-5 of
    the peak."""
    params = _perturbed_params(base)
    x = np.random.RandomState(1).randn(2, 36, 24, 1).astype(np.float32)
    want, got = _forward_both(params, x, np.array([3.0, 871.0], np.float32), base=base)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_diffusion_unet_forward_with_the_prior_matches_jax():
    """The committed prior (base 32): measured 8.6e-7 of the peak."""
    x = np.random.RandomState(2).randn(1, 64, 48, 1).astype(np.float32)
    want, got = _forward_both(_jax_prior(), x, np.array([437.0], np.float32),
                              state=load_params(tdiff.PRIOR_DIR, "cpu"), base=32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _swap(state, a, b):
    out = dict(state)
    for k in state:
        if k.startswith(a + "."):
            out[k], out[b + k[len(a):]] = state[b + k[len(a):]], state[k]
    return out


@pytest.mark.parametrize("trap", ["stride2_pad", "dense_order", "resblock_order",
                                  "groupnorm_eps"])
def test_diffusion_unet_flax_conventions(trap, monkeypatch):
    """Each flax convention the port keeps, against the naive torch form:
    the port matches the JAX model within 1e-5 of the peak, the naive form
    misses it by more than 1e-3 of the peak.

    stride2_pad: "SAME" at stride 2 pads (0, 1), torch's padding=1 (1, 1).
    dense_order, resblock_order: the nested calls run Dense_1 before
    Dense_0 and ResBlock_3 before ResBlock_2, not in naming order.
    groupnorm_eps: flax's 1e-6 against torch's 1e-5, on an input whose
    first GroupNorm sees a small variance (the JAX init, tiny input).
    Measured: the port within 1.5e-6 of the peak, the naive forms off by
    0.80, 0.30, 0.090 and 0.25 of it."""
    base = 8
    x = np.random.RandomState(3).randn(2, 36, 24, 1).astype(np.float32)
    t = np.array([250.0, 40.0], np.float32)
    if trap == "groupnorm_eps":
        params = jax.tree_util.tree_map(np.asarray, _perturbed_params(base, scale=0.0))
        params["_FastConv3x3_1"] = _perturbed_params(base, seed=1)["_FastConv3x3_1"]
        x = x * 1e-3
    else:
        params = _perturbed_params(base)
    want, got = _forward_both(params, x, t)
    state = flax_to_state_dict(params)
    if trap == "stride2_pad":
        monkeypatch.setattr(tunet, "_pad_same_stride2", lambda h: F.pad(h, (1, 1, 1, 1)))
    elif trap == "dense_order":
        state = _swap(state, "dense0", "dense1")
    elif trap == "resblock_order":
        state = _swap(state, "res2", "res3")
    else:
        monkeypatch.setattr(tunet, "GN_EPS", 1e-5)
    _, naive = _forward_both(params, x, t, state=state)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * peak
    assert np.abs(naive - want).max() > 1e-3 * peak


# ------------------------------------------------ training and sampling -------


def test_train_steps_match_jax(jax_draws):
    """Two Adam steps from the JAX init with the JAX draws, against one
    _train_chunk: losses measured within 1.6e-7 relative, parameters
    within 1.9e-6 (bounds 1e-5 and 2e-5)."""
    img_u8, mask_u8 = _image()
    img = img_u8.astype(np.float32) / 127.5 - 1.0
    keep = (mask_u8 == 0).astype(np.float32)
    k_init, k_train = _jax_run_keys(0, "clip")
    params, opt = jdiff._jit_ddpm_init(JaxDiffusionUNet(base=8), k_init,
                                       jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)))
    jparams, _, jlosses = jdiff._train_chunk(params, opt, jnp.asarray(img), jnp.asarray(keep),
                                             jax.random.fold_in(k_train, 0), JCFG, CHUNK)
    model = tdiff.new_model(_jax_init(0, "clip", 8), 8, "cpu")
    losses = tdiff.train_steps(model, tdiff._adam_for(model, TCFG), torch.tensor(img),
                               torch.tensor(keep), TCFG, 0, "clip", range(CHUNK)).numpy()
    jlosses = np.asarray(jlosses)
    assert np.abs(losses - jlosses).max() <= 1e-5 * np.abs(jlosses).max()
    want = flax_to_state_dict(jparams)
    for name, val in model.state_dict().items():
        assert float((val - want[name]).abs().max()) <= 2e-5, name


@pytest.mark.parametrize("weights", ["perturbed_base8", "prior"])
def test_ddim_repaint_matches_jax(weights, jax_draws):
    """DDIM with RePaint composites from the same weights and draws: 6
    steps of a base-8 model with perturbed weights (measured 1.4e-5 at
    most) and 4 steps of the committed prior (measured 1.0e-6); bound
    5e-5 (fp32 summation order, carried through the steps)."""
    img_u8, mask_u8 = _image()
    img = img_u8.astype(np.float32) / 127.5 - 1.0
    keep = (mask_u8 == 0).astype(np.float32)
    k_sample = jax.random.split(jax.random.PRNGKey(0), 3)[1]
    if weights == "prior":
        params, jcfg, tcfg, base = _jax_prior(), JCFG_PRIOR, TCFG_PRIOR, 32
    else:
        params, jcfg, tcfg, base = _perturbed_params(8, scale=0.05), JCFG, TCFG, 8
    want = np.asarray(jdiff._ddim_repaint(params, jnp.asarray(img), jnp.asarray(keep),
                                          k_sample, jcfg))
    model = tdiff.new_model(flax_to_state_dict(params), base, "cpu")
    got = tdiff.ddim_repaint(model, torch.tensor(img), torch.tensor(keep), 0, tcfg).numpy()
    assert np.abs(got - want).max() <= 5e-5
    np.testing.assert_array_equal(got[keep == 1], img[keep == 1])


def test_diffusion_inpaint_image_matches_jax(jax_draws):
    """Per-clip training (4 steps) and 6 DDIM steps from the same uint8
    image: measured identical uint8 output; bound 1 level on 1% of the
    pixels. The known pixels come back verbatim."""
    img_u8, mask_u8 = _image()
    want = jdiff.diffusion_inpaint_image(img_u8, mask_u8, JCFG, key=0)
    got = tdiff.diffusion_inpaint_image(img_u8, mask_u8, TCFG, key=0, device="cpu")
    assert got.dtype == np.uint8 and got.shape == img_u8.shape
    levels = np.abs(got.astype(int) - want.astype(int))
    assert levels.max() <= 1 and (levels > 0).mean() <= 0.01
    np.testing.assert_array_equal(got[mask_u8 == 0], img_u8[mask_u8 == 0])


def _damaged_audio():
    x = synth_music_clip(4, 16000, 1.0)
    d = x.copy()
    d[5000:9000] = 0.0           # the named damage
    d[12000:13500] = 0.0         # quiet, not named
    valid = np.ones(len(d), bool)
    valid[5000:9000] = False
    return d, valid


@pytest.mark.parametrize("explicit", [False, True])
def test_diffusion_restore_audio_matches_jax(explicit, jax_draws):
    """The committed prior, 4 DDIM steps, Griffin-Lim, calibration and the
    composite, from the image scan or from an explicit sample mask.
    Samples outside the composite window are the input, bit for bit, in
    both packages; inside it the two agree to >= 60 dB (measured 74.4 dB
    scanned, where the codec's uint8 levels differ on a few pixels, and
    92.1 dB explicit)."""
    damaged, valid = _damaged_audio()
    kw = {"sample_mask": valid} if explicit else {}
    want = jdiff.diffusion_restore_audio(damaged, 16000, JCFG_PRIOR, key=0,
                                         params=_jax_prior(), **kw)
    got = tdiff.diffusion_restore_audio(damaged, 16000, TCFG_PRIOR, key=0,
                                        params=load_params(tdiff.PRIOR_DIR, "cpu"),
                                        device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == damaged.shape
    changed = want != damaged
    assert changed.any()
    np.testing.assert_array_equal(got[~changed], damaged[~changed])
    assert _agreement_snr(want[changed], got[changed]) >= 60.0
    if explicit:             # the unnamed quiet span is left as it is
        np.testing.assert_array_equal(got[12000:13500], damaged[12000:13500])


def test_calibration_and_composite_match_jax():
    """The same numpy in both packages: exact."""
    rng = np.random.default_rng(0)
    n = 8192
    damaged = rng.normal(scale=0.1, size=n).astype(np.float32)
    damaged[2048:4096] = 0.0
    out = rng.normal(size=n).astype(np.float32)
    mask = np.zeros((64, n // 512), np.uint8)
    mask[:, 4:8] = 255
    mask[:3, 10] = 255                       # a partly dark column: kept
    for m in (mask, np.zeros_like(mask)):
        cal = tdiff._calibrate_fill_energy(damaged, out, m, 0.12)
        np.testing.assert_array_equal(cal, jdiff._calibrate_fill_energy(damaged, out, m, 0.12))
        assert cal.dtype == np.float32
        np.testing.assert_array_equal(tdiff._composite_time_domain(damaged, cal, m),
                                      jdiff._composite_time_domain(damaged, cal, m))


def test_train_spectrogram_ddpm_matches_jax(tmp_path, jax_draws, monkeypatch):
    """Corpus pretraining over two images (two steps each, with damage
    masks), then the save_params / load_params round trip: parameters
    within 2e-5 of the JAX run's (the same bound as the training test),
    and exactly what was saved comes back."""
    monkeypatch.setattr(tdiff, "STEPS_PER_IMAGE", CHUNK)
    (a, mask_a), (b, _) = _image(0), _image(1)
    masks = [mask_a, np.zeros_like(mask_a)]
    want = flax_to_state_dict(jdiff.train_spectrogram_ddpm([a, b], JCFG, key=5, masks_u8=masks))
    ckpt = str(tmp_path / "ddpm")
    got = tdiff.train_spectrogram_ddpm([a, b], TCFG, key=5, checkpoint_dir=ckpt,
                                       masks_u8=masks, device="cpu")
    for name, val in got.items():
        assert float((val - want[name]).abs().max()) <= 2e-5, name
    loaded = load_params(ckpt, "cpu")
    assert set(loaded) == set(got)
    for name, val in loaded.items():
        assert torch.equal(val, got[name]), name
    manifest = json.load(open(tmp_path / "ddpm" / "MANIFEST.json"))
    assert manifest["params"]["tensors"] == len(got)
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "missing"), "cpu")


def test_save_params_round_trip(tmp_path):
    state = {"a.weight": torch.randn(3, 4), "b.bias": torch.arange(5.0)}
    save_params(state, str(tmp_path / "p"), {"note": "x"})
    loaded = load_params(str(tmp_path / "p"), "cpu")
    assert all(torch.equal(loaded[k], v) for k, v in state.items()) and set(loaded) == set(state)
    meta = json.load(open(tmp_path / "p" / "MANIFEST.json"))
    assert meta["note"] == "x" and meta["params"]["parameters"] == 17


def test_committed_prior_equals_the_converted_orbax_prior():
    """audio_inpainting_torch/weights/diffusion_prior/params.npz is the
    Orbax prior converted by flax_to_state_dict, exactly; its manifest is
    the Orbax manifest plus the conversion note."""
    want = flax_to_state_dict(_jax_prior())
    got = load_params(tdiff.PRIOR_DIR, "cpu")
    assert set(got) == set(want) and len(got) == 82
    for name, val in got.items():
        assert torch.equal(val, want[name]), name
    assert sum(v.numel() for v in got.values()) == 1_058_337
    ours = json.load(open(f"{tdiff.PRIOR_DIR}/MANIFEST.json"))
    theirs = json.load(open(f"{PRIOR_ORBAX}/MANIFEST.json"))
    assert {k: ours[k] for k in theirs} == theirs
    assert "checkpoints/diffusion_prior" in ours["converted_from"]
