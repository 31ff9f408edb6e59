"""The port's spectrogram models (models/unet.py), their converter
(convert.py) and the two masks they train on, against the JAX package's.

Forward parity runs the flax classes, plain and packed, and the port's
modules on the same converted weights and numpy-seeded inputs: outputs
within 1e-5 of their peak, running statistics within 1e-6 (measured: at
most 3.6e-6 of peak, in the generator's train mode, and 4.2e-7).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_inpainting_tpu.corrupt import frame_gap_mask_2d as jax_frame_gap_mask_2d
from audio_inpainting_tpu.corrupt import training_stripes as jax_training_stripes
from audio_inpainting_tpu.models import packed_unet as jpacked
from audio_inpainting_tpu.models import unet as junet
from audio_inpainting_torch.convert import flax_to_state_dict
from audio_inpainting_torch.corrupt import frame_gap_mask_2d, training_stripes
from audio_inpainting_torch.models import (BNLeaky, Discriminator, GeneratorUNet,
                                           SimpleUNet, init_flax_style,
                                           pad_to_multiple, patchgan_map_shape)
from audio_inpainting_torch.models.unet import Conv

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

OUT_RTOL_OF_PEAK = 1e-5
STATS_ATOL = 1e-6
PORT = {"SimpleUNet": SimpleUNet, "GeneratorUNet": GeneratorUNet,
        "Discriminator": Discriminator}


def _input(h, w, seed=0):
    return np.random.RandomState(seed).randn(1, h, w, 1).astype(np.float32)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def _jax_vars(name, x, train_arg):
    # eager flax (no jit): XLA compiles each primitive once per shape, which
    # these few small forwards share, cheaper than one program per variant
    model = getattr(junet, name)()
    return model.init(jax.random.PRNGKey(1), x, *((True,) if train_arg else ()))


def _assert_close_to_peak(got, want):
    err = np.abs(got - want).max()
    assert err <= OUT_RTOL_OF_PEAK * np.abs(want).max(), err


@pytest.mark.parametrize("flax_cls", [junet.SimpleUNet, jpacked.PackedSimpleUNet])
def test_simple_unet_forward_matches_flax(flax_cls):
    x = _input(32, 64)
    v = _jax_vars("SimpleUNet", jnp.asarray(x), False)
    want = np.asarray(flax_cls().apply(v, jnp.asarray(x)))[..., 0]
    model = SimpleUNet()
    model.load_state_dict(flax_to_state_dict(v["params"]))
    with torch.no_grad():
        got = model(_nchw(x))[:, 0].numpy()
    _assert_close_to_peak(got, want)


# the discriminator's packed twin packs only at W % 64 == 0; at W = 96 it
# takes the plain conv path, so the plain class covers that width
@pytest.mark.parametrize("name,flax_cls,width", [
    ("GeneratorUNet", junet.GeneratorUNet, 64),
    ("GeneratorUNet", jpacked.PackedGeneratorUNet, 64),
    ("Discriminator", junet.Discriminator, 96),
    ("Discriminator", jpacked.PackedDiscriminator, 64)])
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_models_forward_match_flax(name, flax_cls, width, train):
    x = _input(32, width, seed=width)
    v = _jax_vars(name, jnp.asarray(x), True)
    out, upd = flax_cls().apply(v, jnp.asarray(x), train, mutable=["batch_stats"])
    model = PORT[name]()
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = model(_nchw(x), train)[:, 0].numpy()
    _assert_close_to_peak(got, np.asarray(out)[..., 0])
    want_stats = flax_to_state_dict(v["params"], upd["batch_stats"])
    mine = model.state_dict()
    for key in want_stats:
        if "running" in key:
            np.testing.assert_allclose(mine[key].numpy(), want_stats[key].numpy(),
                                       atol=STATS_ATOL, rtol=0)


def test_converted_state_dict_names_every_port_tensor():
    x = jnp.zeros((1, 32, 64, 1))
    for name in PORT:
        v = _jax_vars(name, x, name != "SimpleUNet")
        sd = flax_to_state_dict(v["params"], v.get("batch_stats"))
        assert set(sd) == set(PORT[name]().state_dict()), name
        for key, t in PORT[name]().state_dict().items():
            assert sd[key].shape == t.shape, (name, key)


def test_conv_transpose_kernel_is_flipped():
    """flax's ConvTranspose does not flip its kernel and torch's
    conv_transpose2d does: the converter flips both spatial axes. Without
    the flip the two disagree by O(1)."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 6, 10, 8).astype(np.float32)
    layer = fnn.ConvTranspose(5, (2, 2), strides=(2, 2))
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"kernel": jnp.asarray(rng.randn(2, 2, 8, 5).astype(np.float32)),
                    "bias": jnp.asarray(rng.randn(5).astype(np.float32))}}
    want = np.asarray(layer.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    sd = flax_to_state_dict({"ConvTranspose_0": v["params"]})
    up = Conv(8, 5, 2, stride=2, transpose=True)
    up.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()})
    with torch.no_grad():
        got = up(_nchw(x)).numpy()
        unflipped = torch.nn.functional.conv_transpose2d(
            _nchw(x), sd["up0.weight"].flip(2, 3), sd["up0.bias"], stride=2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(unflipped - want).max() > 0.1


def test_batchnorm_running_var_is_biased():
    """flax moves the running variance towards the biased batch variance;
    nn.BatchNorm2d(momentum=0.1) takes the unbiased one, which differs
    visibly on a 35-pixel batch."""
    x = np.random.RandomState(4).randn(1, 5, 7, 3).astype(np.float32) * 1.5 + 0.3
    layer = fnn.BatchNorm(use_running_average=False, momentum=junet.BN_MOMENTUM)
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, upd = layer.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    want_var = np.asarray(upd["batch_stats"]["var"])
    want_mean = np.asarray(upd["batch_stats"]["mean"])
    bn = BNLeaky(3)
    bn(_nchw(x), True)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, atol=STATS_ATOL, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_mean, atol=STATS_ATOL, rtol=0)
    stock = torch.nn.BatchNorm2d(3, momentum=1.0 - junet.BN_MOMENTUM)
    stock(_nchw(x))
    assert np.abs(stock.running_var.detach().numpy() - want_var).max() > 1e-3


def test_init_draws_follow_lecun_normal():
    """The port's init against flax's: a normal cut at +-2 std of
    sqrt(1 / fan_in) / 0.8796, the same spread on the widest kernels."""
    model = init_flax_style(SimpleUNet(), torch.Generator().manual_seed(0))
    v = junet.SimpleUNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1)))
    flax_w = np.asarray(v["params"]["ConvBlock_2"]["Conv3x3_1"]["kernel"])
    w = model.block2.conv1.weight.detach().numpy()
    fan_in = 64 * 9
    std = np.sqrt(1.0 / fan_in)
    assert np.abs(w).max() <= 2 * std / 0.87962566 + 1e-7
    np.testing.assert_allclose(w.std(), std, rtol=0.03)
    np.testing.assert_allclose(w.std(), flax_w.std(), rtol=0.03)
    assert model.block2.conv1.bias.abs().max() == 0
    g = init_flax_style(GeneratorUNet(), torch.Generator().manual_seed(0))
    assert torch.equal(g.block0.bn0.weight, torch.ones(16))
    assert torch.equal(g.block0.bn0.running_var, torch.ones(16))
    a = SimpleUNet(generator=torch.Generator().manual_seed(5)).state_dict()
    b = SimpleUNet(generator=torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("f,t", [(516, 1728), (516, 96), (32, 64), (8, 32), (4, 32)])
def test_patchgan_map_shape_matches_flax(f, t):
    out = jax.eval_shape(
        lambda x: junet.Discriminator().init_with_output(jax.random.PRNGKey(0), x, True)[0],
        jax.ShapeDtypeStruct((1, f, t, 1), jnp.float32))
    rows, cols = patchgan_map_shape(f, t)
    assert (max(rows, 0) * max(cols, 0) == 0) == (out.size == 0)
    if out.size:
        assert (rows, cols) == out.shape[1:3]


def _zero_runs(row):
    runs, n = [], 0
    for v in list(row) + [1.0]:
        if v == 0:
            n += 1
        elif n:
            runs.append(n)
            n = 0
    return runs


# n_frames: under 4, a short clip, Part 2's length at 8 kHz, Part 1's;
# intact: all, a quarter, none. The 8 draws make a trainable cell likely,
# not certain: these seeds find one.
@pytest.mark.parametrize("n_frames", [3, 10, 94, 1723])
@pytest.mark.parametrize("intact_kind", ["all", "few", "none"])
def test_training_stripes_contract(n_frames, intact_kind):
    intact = np.ones(n_frames, bool)
    if intact_kind == "few":       # a quarter of the columns, in one run
        intact[:] = False
        intact[n_frames // 3:n_frames // 3 + max(1, n_frames // 4)] = True
    elif intact_kind == "none":
        intact[:] = False
    for seed in range(3):
        rows = {"torch": training_stripes(torch.Generator().manual_seed(seed),
                                          n_frames, intact),
                "jax": np.asarray(jax_training_stripes(jax.random.PRNGKey(seed),
                                                       n_frames, intact))}
        for row in rows.values():
            assert row.shape == (n_frames,) and row.dtype == np.float32
            assert set(np.unique(row)) <= {0.0, 1.0} and (row == 0).any()
            if n_frames < 4:
                expected = np.ones(n_frames, np.float32)
                expected[n_frames // 2] = 0
                np.testing.assert_array_equal(row, expected)
                continue
            mt = min(30, max(2, n_frames // 2))
            mn = max(1, min(5, mt - 1))
            count = max(1, int(n_frames * 0.3 / mt * 2))
            assert min(_zero_runs(row)) >= mn
            assert (row == 0).sum() <= count * (mt - 1)
            if intact_kind != "none" and n_frames >= 10:
                # a trainable cell: intact and hidden
                assert ((row == 0) & intact).any()


def test_training_stripes_is_seeded():
    intact = np.ones(200, bool)
    a = training_stripes(torch.Generator().manual_seed(1), 200, intact)
    b = training_stripes(torch.Generator().manual_seed(1), 200, intact)
    c = training_stripes(torch.Generator().manual_seed(2), 200, intact)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("n_freq,n_frames,fracs", [
    (513, 1723, (0.4, 0.6)), (7, 13, (0.4, 0.6)), (4, 100, (0.1, 0.35))])
def test_frame_gap_mask_2d_matches_jax(n_freq, n_frames, fracs):
    got = frame_gap_mask_2d(n_freq, n_frames, *fracs)
    want = np.asarray(jax_frame_gap_mask_2d(n_freq, n_frames, *fracs))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,multiple", [((513, 1723), 4), ((16, 32), 4), ((7, 9), 8)])
def test_pad_to_multiple_matches_jax(shape, multiple):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    got, pads = pad_to_multiple(torch.tensor(x), multiple)
    want, want_pads = junet.pad_to_multiple(jnp.asarray(x), multiple)
    assert pads == want_pads
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
