"""The port's U-Net and GAN training loops (methods/neural.py) against the
JAX package's, on the CPU, from the same initial weights: the port's
``_draw_init`` is replaced by the JAX init, converted.

Bounds, with what was measured on this input:
- losses within 1e-4 relative (measured: U-Net 2.6e-5 masked and 1.5e-5
  full over 10 epochs; GAN 1.1e-6 (D) and 2.3e-6 (G) over 5 epochs);
- the U-Net composite within 1e-4 of its peak (measured 6e-6); with
  ``valid`` and ``composite_mask`` within 5e-4 (measured 1.3e-4: the
  prediction in the real holes, which no loss reaches, is the most
  sensitive to Adam's per-parameter step normalization, which turns
  rounding differences in near-zero gradients into steps of up to lr);
- the GAN composite within 1e-3 of its peak (measured 2.8e-4 with one
  inference, 1.8e-4 with the EMA readout). The eval-mode readout reads
  the conv biases in front of each BatchNorm through the running
  statistics; their gradient is zero up to rounding, and Adam scales that
  rounding noise to steps of up to lr, differently in each package: after
  one epoch the biases differ by up to 3.5e-4, and the composite by
  ~1e-4 of its peak per epoch. Train-mode outputs (the losses) cancel
  those biases and agree to 2e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.methods.neural as jn
from audio_inpainting_tpu.models.packed_unet import (PackedDiscriminator,
                                                     PackedGeneratorUNet,
                                                     PackedSimpleUNet)
import audio_inpainting_torch.methods.neural as tn
from audio_inpainting_torch.convert import flax_to_state_dict

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

LOSS_RTOL = 1e-4
UNET_RTOL_OF_PEAK = 1e-4
UNET_HOLE_RTOL_OF_PEAK = 5e-4
GAN_RTOL_OF_PEAK = 1e-3
# bf16 runs round differently in the two packages: held by the quality of
# the fill, the masked-region SNR against the target (measured 0.18 dB at
# 50 epochs; by 100 epochs single runs part by up to 1.7 dB, as the JAX
# package's own bf16 and fp32 runs do, by 1.3 dB)
BF16_SNR_MARGIN_DB = 0.5


def _jax_init(kind, seed, attempt, shape, dtype=jnp.float32):
    """The JAX package's init (neural.py:272, :520-522), as state dicts;
    through its own jitted init, so a JAX run of the same shape and dtype
    has compiled it already."""
    key = jax.random.PRNGKey(seed)
    if attempt:
        key = jax.random.fold_in(key, attempt)
    x = jnp.zeros((1, *shape, 1), jnp.float32)
    if kind == "unet":
        return [flax_to_state_dict(jn._jit_init(PackedSimpleUNet(dtype=dtype), key,
                                                x)["params"])]
    kg, kd = jax.random.split(key)
    g = jn._jit_init_train(PackedGeneratorUNet(dtype=dtype), kg, x)
    d = jn._jit_init_train(PackedDiscriminator(dtype=dtype), kd, x)
    return [flax_to_state_dict(g["params"], g["batch_stats"]),
            flax_to_state_dict(d["params"], d["batch_stats"])]


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(tn, "_draw_init", _jax_init)


def _toy_spec(f=30, t=60, seed=0):
    """A low-rank 'spectrogram' in [0, 1] (tests/test_neural.py's)."""
    rng = np.random.RandomState(seed)
    v = np.abs(rng.randn(f, 4)) @ np.abs(rng.randn(4, t))
    return (v / v.max()).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("masked", [True, False])
def test_unet_train_restore_matches_jax(masked, jax_init):
    v = _toy_spec()
    mask = np.ones_like(v)
    mask[:, 20:30] = 0.0
    jf, jp, jl = jn.unet_train_restore(
        v, mask, jn.UNetTrainConfig(epochs=10, masked_loss=masked), key=0)
    tf, tp, tl = tn.unet_train_restore(
        v, mask, tn.UNetTrainConfig(epochs=10, masked_loss=masked), 0, device="cpu")
    assert tf.shape == tp.shape == v.shape and tl.shape == (10,)
    assert _rel(tl, jl) <= LOSS_RTOL
    assert _rel(tf, jf) <= UNET_RTOL_OF_PEAK
    assert _rel(tp, jp) <= UNET_RTOL_OF_PEAK
    np.testing.assert_array_equal(tf.numpy()[:, :20], v[:, :20])   # kept cells


def test_unet_valid_and_composite_mask_match_jax(jax_init):
    """Blind damage: real holes (columns 40-45) out of the loss by
    ``valid`` and composited by ``composite_mask``; synthetic stripes
    (columns 10-16) train and are visible again at readout."""
    v = _toy_spec(seed=3)
    keep = np.ones_like(v)
    keep[:, 40:46] = 0.0
    train = keep.copy()
    train[:, 10:17] = 0.0
    jf, jp, jl = jn.unet_train_restore(v, train, jn.UNetTrainConfig(epochs=5), key=1,
                                       valid=keep, composite_mask=keep)
    tf, tp, tl = tn.unet_train_restore(v, train, tn.UNetTrainConfig(epochs=5), 1,
                                       valid=keep, composite_mask=keep, device="cpu")
    assert _rel(tl, jl) <= LOSS_RTOL
    assert _rel(tf, jf) <= UNET_HOLE_RTOL_OF_PEAK
    np.testing.assert_array_equal(tf.numpy()[:, 10:17], v[:, 10:17])


def _gan_case(seed=7):
    v = _toy_spec(seed=seed) * 2.0 - 1.0
    mask = np.ones_like(v)
    mask[:, 40:56] = 0.0      # a contiguous, fully dark gap
    mask[3:7, 10] = 0.0       # scattered dark cells (column 10 partly)
    return v * mask - (1.0 - mask), v, mask


@functools.cache
def _jax_gan(ema_decay):
    inp, v, mask = _gan_case()
    final, (dl, gl) = jn.gan_train_restore(
        inp, v, mask, jn.GANTrainConfig(epochs=5, ema_decay=ema_decay), key=0)
    return np.asarray(final), np.asarray(dl), np.asarray(gl)


@pytest.mark.parametrize("scope", ["none", "full", "gap"])
def test_gan_train_restore_matches_jax(scope, jax_init):
    """One inference, the EMA everywhere, the EMA in the gap only. The JAX
    'gap' result is composed from its other two runs: the EMA never
    changes the training trajectory, and the gap scope takes the EMA fill
    exactly in the fully dark columns (test_neural.py pins that in JAX)."""
    inp, v, mask = _gan_case()
    cfg = tn.GANTrainConfig(epochs=5, ema_decay=0.0 if scope == "none" else 0.9,
                            ema_scope="full" if scope == "none" else scope)
    final, (dl, gl), attempts = tn.gan_train_restore(inp, v, mask, cfg, 0, device="cpu")
    one, jdl, jgl = _jax_gan(0.0)
    want = one
    if scope != "none":
        ema = _jax_gan(0.9)[0]
        gap_cols = np.broadcast_to((mask == 0).all(0), mask.shape)
        want = ema if scope == "full" else np.where(gap_cols, ema, one)
    assert attempts == 1 and final.shape == v.shape
    assert _rel(dl, jdl) <= LOSS_RTOL and _rel(gl, jgl) <= LOSS_RTOL
    assert _rel(final, want) <= GAN_RTOL_OF_PEAK
    np.testing.assert_array_equal(final.numpy()[mask == 1], inp[mask == 1])


def test_gan_empty_patchgan_map_matches_jax(jax_init):
    """A clip under the PatchGAN's receptive floor: a warning, D losses
    exactly 0, finite G losses, and the L1-only training of the JAX
    package."""
    rng = np.random.RandomState(11)
    v = rng.rand(8, 32).astype(np.float32) * 2 - 1
    mask = np.ones_like(v)
    mask[:, 12:20] = 0.0
    inp = v * mask - (1.0 - mask)
    with pytest.warns(UserWarning, match="PatchGAN"):
        final, (dl, gl), _ = tn.gan_train_restore(inp, v, mask,
                                                  tn.GANTrainConfig(epochs=5), 0,
                                                  device="cpu")
    with pytest.warns(UserWarning, match="PatchGAN"):
        jfinal, (jdl, jgl) = jn.gan_train_restore(inp, v, mask,
                                                  jn.GANTrainConfig(epochs=5), key=0)
    assert torch.equal(dl, torch.zeros(5)) and np.all(np.asarray(jdl) == 0)
    assert torch.isfinite(gl).all()
    assert _rel(gl, jgl) <= LOSS_RTOL
    assert _rel(final, jfinal) <= GAN_RTOL_OF_PEAK


@pytest.mark.parametrize("ema_decay,scope", [(0.0, "full"), (0.9, "full"), (0.9, "gap")])
def test_gan_readout_fake_matches_jax(ema_decay, scope):
    """The readout contract alone, on stand-in forwards: the bias
    correction and the gap-column rule (keep fraction < 2%)."""
    rng = np.random.RandomState(5)
    one, avg = rng.randn(2, 1, 12, 16, 1).astype(np.float32)
    msk = np.ones((1, 12, 16, 1), np.float32)
    msk[:, :, 4:7] = 0.0                  # fully dark columns
    msk[:, 2:5, 10] = 0.0                 # a partly dark column
    vld = np.ones_like(msk)
    vld[:, 10:] = 0.0                     # pad rows
    cfg_j = jn.GANTrainConfig(epochs=7, ema_decay=ema_decay, ema_scope=scope)
    cfg_t = tn.GANTrainConfig(epochs=7, ema_decay=ema_decay, ema_scope=scope)
    corr = 1.0 - ema_decay ** 7 if ema_decay else 1.0
    state = ({"w": jnp.asarray(one)}, None, None, None, None, None,
             {"w": jnp.asarray(avg * corr)})
    want = jn.gan_readout_fake(lambda p, _: p["w"], state, jnp.asarray(msk),
                               jnp.asarray(vld), cfg_j)

    def nchw(a):
        return torch.tensor(a).permute(0, 3, 1, 2)

    got = tn.gan_readout_fake(lambda p: p["w"], {"w": nchw(one)},
                              {"w": nchw(avg * corr)}, nchw(msk), nchw(vld), cfg_t)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


def test_gan_retry_trains_the_second_draw():
    """retry_l1 below any reachable hole-L1 forces the retrain, which is
    the run from init draw 1; with no hole there is nothing to judge."""
    inp, v, mask = _gan_case(seed=4)
    cfg = tn.GANTrainConfig(epochs=3, retry_l1=1e-9)
    final, (dl, _), attempts = tn.gan_train_restore(inp, v, mask, cfg, 2, device="cpu")
    second = tn.GANTrainer(inp, v, mask, cfg, 2, attempt=1, device="cpu")
    second_d = torch.stack([second.epoch()[0] for _ in range(3)])
    assert attempts == 2
    torch.testing.assert_close(final, second.restore(), atol=0, rtol=0)
    torch.testing.assert_close(dl, second_d, atol=0, rtol=0)
    first = tn.gan_train_restore(inp, v, mask, tn.GANTrainConfig(epochs=3), 2,
                                 device="cpu")[0]
    assert not torch.equal(first, final)
    holeless, _, attempts = tn.gan_train_restore(
        v, v, np.ones_like(v), tn.GANTrainConfig(epochs=2, retry_l1=0.04), 0,
        device="cpu")
    assert attempts == 1
    np.testing.assert_array_equal(holeless.numpy(), v)


def _masked_snr_db(final, v, mask):
    hole = mask == 0
    err = np.sum((np.asarray(final, np.float64)[hole] - v[hole]) ** 2)
    return 10 * np.log10(np.sum(v[hole].astype(np.float64) ** 2) / err)


def test_unet_bf16_fill_quality_matches_jax(monkeypatch):
    """bf16 convs, 50 epochs: the fill's SNR against the target within
    0.5 dB of the JAX package's, from the same init."""
    monkeypatch.setattr(tn, "_draw_init",
                        functools.partial(_jax_init, dtype=jnp.bfloat16))
    v = _toy_spec(seed=5)
    mask = np.ones_like(v)
    mask[:, 24:34] = 0.0
    jf, _, _ = jn.unet_train_restore(v, mask, jn.UNetTrainConfig(epochs=50, bf16=True),
                                     key=0)
    tf, _, tl = tn.unet_train_restore(v, mask, tn.UNetTrainConfig(epochs=50, bf16=True),
                                      0, device="cpu")
    got, want = _masked_snr_db(tf.numpy(), v, mask), _masked_snr_db(jf, v, mask)
    assert float(tl[-1]) < float(tl[0])
    assert abs(got - want) <= BF16_SNR_MARGIN_DB, (got, want)


def test_importing_the_port_selects_cudnn_deterministic_algorithms():
    """Seeded GPU training repeats itself only on cuDNN's deterministic
    algorithms (the persistent stream U-Net's chunk invariance rests on
    it), so importing the package sets the flag; a fresh interpreter
    shows what the import alone does."""
    import subprocess
    import sys

    code = ("import torch; before = torch.backends.cudnn.deterministic; "
            "import audio_inpainting_torch; "
            "print(before, torch.backends.cudnn.deterministic, "
            "torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split()
    assert out == ["False", "True", "False", "False"]
