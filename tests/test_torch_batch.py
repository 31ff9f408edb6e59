"""The port's grouped models (models/unet.py, ``groups=G``) and batched
per-clip training (parallel/batch.py, parallel/gan_batch.py) against the
single-clip port and against the JAX package's batched restores, on the
CPU. Mirrors tests/test_batch_restore.py.

Bounds, with what was measured on these inputs:
- grouped against per-clip forwards within 1e-5 of peak (measured at most
  2.0e-6, in the generator's train mode), running statistics within 1e-6;
- batch against single in the port: losses 1e-4 relative, U-Net
  composite 1e-4 of peak (measured 4.5e-8 and 1.2e-7), GAN composite
  1e-3 of peak (measured 2.5e-4, its losses 2.9e-7: the eval readout
  reads the conv biases in front of each BatchNorm, whose Adam steps are
  rounding noise; see tests/test_torch_neural.py);
- a corpus in groups against one group, by the same bounds (measured:
  losses at most 1.6e-7, composites 1.2e-8 (U-Net) and 6.9e-5 (GAN) of
  peak);
- against JAX, per clip, the single-clip tests' bounds
  (tests/test_torch_neural.py): losses 1e-4 relative (measured 1.3e-5),
  the U-Net composite 1e-4 of peak (measured 9.5e-5; 1.2e-5 in serving's
  form, whose bound is 5e-4: a composite mask that differs from the
  training mask), the GAN's 1e-3 (measured 3.7e-4), bf16 GAN fills within
  1 dB of the JAX fills' SNR (measured 0.009 dB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.methods.neural as jn
from audio_inpainting_tpu.models.packed_unet import (PackedDiscriminator,
                                                     PackedGeneratorUNet,
                                                     PackedSimpleUNet)
from audio_inpainting_tpu.parallel import restore_clips_gan as jax_restore_clips_gan
from audio_inpainting_tpu.parallel.batch import restore_clips_unet as jax_restore_clips_unet
import audio_inpainting_torch.methods.neural as tn
from audio_inpainting_torch.convert import flax_to_state_dict
from audio_inpainting_torch.models import (Discriminator, GeneratorUNet, SimpleUNet,
                                           stack_states, unstack_states)
from audio_inpainting_torch.models.unet import Conv
from audio_inpainting_torch.parallel import (batch, clip_seeds, gan_batch,
                                             restore_clips_gan, restore_clips_unet)

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

FORWARD_RTOL_OF_PEAK = 1e-5
STATS_ATOL = 1e-6
LOSS_RTOL = 1e-4
UNET_RTOL_OF_PEAK = 1e-4
UNET_HOLE_RTOL_OF_PEAK = 5e-4
GAN_RTOL_OF_PEAK = 1e-3
BF16_FILL_DB = 1.0
G, F_, T_ = 3, 30, 60          # padded to (32, 64) inside the trainers


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _specs(g=G, f=F_, t=T_, seed=0):
    """g low-rank 'spectrograms' in [0, 1] (tests/test_neural.py's form)."""
    rng = np.random.RandomState(seed)
    v = np.einsum("gfo,got->gft", np.abs(rng.randn(g, f, 4)), np.abs(rng.randn(g, 4, t)))
    return (v / v.max(axis=(1, 2), keepdims=True)).astype(np.float32)


def _holes(g=G, f=F_, t=T_):
    """A different gap per clip, and scattered dark cells in clip 0."""
    mask = np.ones((g, f, t), np.float32)
    for i in range(g):
        mask[i, :, 20 + 6 * i:32 + 6 * i] = 0.0
    mask[0, 3:7, 10] = 0.0
    return mask


def _clip_states(cls, g=G):
    return [cls(generator=torch.Generator().manual_seed(10 + i)).state_dict()
            for i in range(g)]


def _grouped(cls, states, **kw):
    model = cls(groups=len(states), **kw)
    model.load_state_dict(stack_states(states))
    return model


def _single(cls, state, **kw):
    model = cls(**kw)
    model.load_state_dict(state)
    return model


# ------------------------------------------------------ grouped models ----


@pytest.mark.parametrize("cls,train", [(SimpleUNet, None), (GeneratorUNet, True),
                                       (GeneratorUNet, False), (Discriminator, True),
                                       (Discriminator, False)])
def test_grouped_model_equals_each_clip_alone(cls, train):
    """G nets as one grouped net: clip g's output (channel g) and its
    running statistics are those of its own net on its own input."""
    x = torch.tensor(np.random.RandomState(1).randn(1, G, 32, 64).astype(np.float32))
    states = _clip_states(cls)
    grouped = _grouped(cls, states)
    args = () if train is None else (train,)
    with torch.no_grad():
        got = grouped(x, *args)
    after = unstack_states(grouped.state_dict(), G)
    for g, state in enumerate(states):
        single = _single(cls, state)
        with torch.no_grad():
            want = single(x[:, g:g + 1], *args)
        err = float((got[:, g:g + 1] - want).abs().max())
        assert err <= FORWARD_RTOL_OF_PEAK * float(want.abs().max()), err
        for k, v in single.state_dict().items():
            torch.testing.assert_close(after[g][k], v, atol=STATS_ATOL, rtol=0)


def test_stack_states_round_trip():
    states = _clip_states(GeneratorUNet)
    back = unstack_states(stack_states(states), G)
    for a, b in zip(states, back):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("cls", [SimpleUNet, GeneratorUNet, Discriminator])
def test_groups_one_is_the_single_clip_net(cls):
    """groups=1 is today's model: the same parameters from the same draw,
    and bit for bit the same forward from a state stacked from one clip."""
    plain = cls(generator=torch.Generator().manual_seed(3))
    one = cls(generator=torch.Generator().manual_seed(3), groups=1)
    for (k, a), (_, b) in zip(plain.state_dict().items(), one.state_dict().items()):
        assert torch.equal(a, b), k
    one.load_state_dict(stack_states([plain.state_dict()]))
    x = torch.tensor(np.random.RandomState(2).randn(1, 1, 32, 64).astype(np.float32))
    args = () if cls is SimpleUNet else (True,)
    with torch.no_grad():
        assert torch.equal(plain(x, *args), one(x, *args))


def test_folding_clips_into_the_batch_pools_batchnorm():
    """The trap: G clips as a batch of N = G through one net share their
    BatchNorm statistics, and the outputs move; as groups of one batch they
    do not."""
    x = torch.tensor(np.random.RandomState(4).randn(G, 1, 32, 64).astype(np.float32))
    state = _clip_states(GeneratorUNet, 1)[0]
    single = _single(GeneratorUNet, state)
    grouped = _grouped(GeneratorUNet, [state] * G)
    with torch.no_grad():
        alone = torch.cat([_single(GeneratorUNet, state)(x[g:g + 1], True)
                           for g in range(G)])
        folded = single(x, True)
        as_groups = grouped(x.transpose(0, 1), True).transpose(0, 1)
    peak = float(alone.abs().max())
    assert float((as_groups - alone).abs().max()) <= FORWARD_RTOL_OF_PEAK * peak
    assert float((folded - alone).abs().max()) > 1e-2 * peak


def test_transpose_conv_weights_stack_on_their_input_axis():
    """The trap: ConvTranspose2d weights are (Ci, Co/groups, kh, kw). Stacked
    on the input axis (stack_states) clip g sees its own kernel; stacked on
    the output axis, the clips' kernels mix."""
    gen = torch.Generator().manual_seed(5)
    convs = [Conv(4, 3, 2, stride=2, transpose=True) for _ in range(G)]
    for c in convs:
        torch.nn.init.normal_(c.weight, generator=gen)
        torch.nn.init.normal_(c.bias, generator=gen)
    x = torch.randn(1, G * 4, 6, 8, generator=gen)
    want = torch.cat([c(x[:, 4 * g:4 * g + 4]) for g, c in enumerate(convs)], dim=1)
    grouped = Conv(4, 3, 2, stride=2, transpose=True, groups=G)
    grouped.load_state_dict(stack_states([c.state_dict() for c in convs]))
    torch.testing.assert_close(grouped(x), want, atol=1e-6, rtol=0)
    wrong = torch.cat([c.weight for c in convs], dim=1).reshape(grouped.weight.shape)
    with torch.no_grad():
        grouped.weight.copy_(wrong)
    with torch.no_grad():
        assert float((grouped(x) - want).abs().max()) > 1e-2


@pytest.mark.parametrize("kind", ["unet", "gan"])
def test_each_clip_gets_its_unscaled_gradient(kind):
    """The trap: the nets train on the SUM of the per-clip losses. One
    epoch's gradients, clip by clip, are those of the clip trained alone:
    a mean over G would scale them by 1/G, and Adam would turn the scaled
    rounding noise of the pre-BatchNorm biases into other steps."""
    v, mask = _specs(), _holes()
    seeds = [7, 8, 9]
    if kind == "unet":
        batch = tn.UNetTrainer(v, mask, tn.UNetTrainConfig(epochs=1), seeds, device="cpu")
        singles = [tn.UNetTrainer(v[g], mask[g], tn.UNetTrainConfig(epochs=1), s,
                                  device="cpu") for g, s in enumerate(seeds)]
        models = [batch.model], [[t.model] for t in singles]
    else:
        inp = (v * 2 - 1) * mask - (1 - mask)
        batch = tn.GANTrainer(inp, v * 2 - 1, mask, tn.GANTrainConfig(epochs=1), seeds,
                              device="cpu")
        singles = [tn.GANTrainer(inp[g], v[g] * 2 - 1, mask[g], tn.GANTrainConfig(epochs=1),
                                 s, device="cpu") for g, s in enumerate(seeds)]
        models = [batch.g, batch.d], [[t.g, t.d] for t in singles]
    batch.epoch()
    for t in singles:
        t.epoch()
    for m, grouped in enumerate(models[0]):
        grads = unstack_states({k: p.grad for k, p in grouped.named_parameters()}, G)
        for g, single in enumerate(models[1]):
            # one scale per net: the pre-BatchNorm biases' gradients are
            # rounding noise, which no relative bound of their own holds
            scale = max(float(p.grad.abs().max()) for p in single[m].parameters())
            for k, p in single[m].named_parameters():
                err = float((grads[g][k] - p.grad).abs().max())
                assert err <= 1e-5 * scale, (k, g, err, scale)


# ------------------------------------------------- batch against single ----


def test_restore_clips_unet_equals_unet_train_restore():
    v, mask = _specs(), _holes()
    seeds = [3, 4, 5]
    cfg = tn.UNetTrainConfig(epochs=5)
    out, loss = restore_clips_unet(v[..., None], mask[..., None], cfg, seeds, device="cpu")
    assert out.shape == (G, F_, T_, 1) and loss.shape == (G,)
    for g in range(G):
        final, _, losses = tn.unet_train_restore(v[g], mask[g], cfg, seeds[g], device="cpu")
        assert _rel(loss[g], losses[-1]) <= LOSS_RTOL
        assert _rel(out[g, ..., 0], final) <= UNET_RTOL_OF_PEAK
    keep = mask == 1
    np.testing.assert_array_equal(out[..., 0].numpy()[keep], v[keep])


def test_restore_clips_gan_equals_gan_train_restore():
    v, mask = _specs(seed=2), _holes()
    real = v * 2 - 1
    inp = real * mask - (1 - mask)
    seeds = [11, 12, 13]
    cfg = tn.GANTrainConfig(epochs=4, ema_decay=0.9, ema_scope="gap")
    out, (dl, gl) = restore_clips_gan(inp, real, mask, cfg, seeds, device="cpu")
    assert out.shape == (G, F_, T_) and dl.shape == gl.shape == (G,)
    for g in range(G):
        final, (d, gg), attempts = tn.gan_train_restore(inp[g], real[g], mask[g], cfg,
                                                        seeds[g], device="cpu")
        assert attempts == 1
        assert _rel(dl[g], d[-1]) <= LOSS_RTOL and _rel(gl[g], gg[-1]) <= LOSS_RTOL
        assert _rel(out[g], final) <= GAN_RTOL_OF_PEAK
    np.testing.assert_array_equal(out.numpy()[mask == 1], inp[mask == 1])


def test_int_seed_gives_distinct_clip_seeds():
    seeds = clip_seeds(0, 4)
    assert len(set(seeds)) == 4 and seeds == clip_seeds(0, 4)
    assert clip_seeds(0, 6)[:4] == seeds and clip_seeds(1, 4) != seeds
    assert clip_seeds([5, 5], 2) == [5, 5]
    with pytest.raises(ValueError, match="seeds"):
        clip_seeds([1, 2, 3], 2)
    v = _specs(g=2)
    mask = _holes(g=2)
    out, _ = restore_clips_unet(np.stack([v[0], v[0]])[..., None],
                                np.stack([mask[0], mask[0]])[..., None],
                                tn.UNetTrainConfig(epochs=2), 0, device="cpu")
    assert not torch.equal(out[0], out[1])      # two clips, two inits


def test_gan_retry_retrains_exactly_the_failed_clips():
    """retry_l1 below any reachable hole-L1 forces the retrain: the output
    is the grouped run of every clip's second draw. n_real=0 keeps every
    clip out of the check, so nothing retrains."""
    v, mask = _specs(seed=6), _holes()
    real = v * 2 - 1
    inp = real * mask - (1 - mask)
    seeds = [1, 2, 3]
    plain = tn.GANTrainConfig(epochs=3)
    forced = tn.GANTrainConfig(epochs=3, retry_l1=1e-9)
    first, _ = restore_clips_gan(inp, real, mask, plain, seeds, device="cpu")
    out, (dl, _) = restore_clips_gan(inp, real, mask, forced, seeds, device="cpu")
    second = tn.GANTrainer(inp, real, mask, forced, seeds, attempt=1, device="cpu")
    second_d = [second.epoch()[0] for _ in range(3)][-1]
    torch.testing.assert_close(out, second.restore(), atol=0, rtol=0)
    torch.testing.assert_close(dl, second_d, atol=0, rtol=0)
    assert not torch.equal(first, out)
    gated, _ = restore_clips_gan(inp, real, mask, forced, seeds, n_real=0, device="cpu")
    torch.testing.assert_close(gated, first, atol=0, rtol=0)
    # a threshold between the clips' hole-L1s: only the worst clip
    # retrains, alone; the others keep their first runs
    l1 = tn.GANTrainer(inp, real, mask, plain, seeds, device="cpu").hole_l1(first)
    worst = int(torch.argmax(l1))
    cut = float(torch.sort(l1)[0][-2] + torch.sort(l1)[0][-1]) / 2
    subset, _ = restore_clips_gan(inp, real, mask, tn.GANTrainConfig(epochs=3, retry_l1=cut),
                                  seeds, device="cpu")
    alone = tn.GANTrainer(inp[worst:worst + 1], real[worst:worst + 1],
                          mask[worst:worst + 1], forced, [seeds[worst]], attempt=1,
                          device="cpu")
    for _ in range(3):
        alone.epoch()
    torch.testing.assert_close(subset[worst], alone.restore()[0], atol=0, rtol=0)
    others = [g for g in range(G) if g != worst]
    torch.testing.assert_close(subset[others], first[others], atol=0, rtol=0)


def test_gan_batch_valid_of_ones_is_the_default():
    v, mask = _specs(g=2, seed=8), _holes(g=2)
    real = v * 2 - 1
    inp = real * mask - (1 - mask)
    cfg = tn.GANTrainConfig(epochs=3)
    a, _ = restore_clips_gan(inp, real, mask, cfg, 1, device="cpu")
    b, _ = restore_clips_gan(inp, real, mask, cfg, 1, valid_batch=np.ones_like(real),
                             device="cpu")
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_unet_batch_composites_over_its_own_mask():
    """Serving's scheme: train on synthetic holes, composite over the real
    ones; the composite keeps the input where composite_mask == 1."""
    v = _specs(g=2, seed=12)[..., None]
    train = np.ones_like(v)
    train[:, :, 5:9] = 0.0
    comp = np.ones_like(v)
    comp[:, :, 40:46] = 0.0
    out, _ = restore_clips_unet(v, train, tn.UNetTrainConfig(epochs=3), 0,
                                composite_mask_batch=comp, device="cpu")
    keep = comp == 1
    np.testing.assert_array_equal(out.numpy()[keep], v[keep])
    assert np.isfinite(out.numpy()).all()
    assert not np.allclose(out.numpy()[~keep], v[~keep])


def test_batch_wants_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v, mask = _specs(g=1), _holes(g=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_clips_unet(v[..., None], mask[..., None], tn.UNetTrainConfig(epochs=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_clips_gan(v, v, mask, tn.GANTrainConfig(epochs=1))


# --------------------------------------------------- groups by memory ----


@pytest.mark.parametrize("kind", ["unet", "gan", "gan_retry"])
def test_corpus_larger_than_one_group_equals_one_group(kind, monkeypatch):
    """A corpus larger than the card holds as one grouped net trains in
    groups, one after another (a cap of 2 over G = 3 clips: groups of 2 and
    1; with the forced retry its second pass too): every clip comes out as
    in the one-group run, within the batch-against-single bounds."""
    v, mask = _specs(seed=4), _holes()
    seeds = [21, 22, 23]
    if kind == "unet":
        cfg = tn.UNetTrainConfig(epochs=4)

        def run():
            return restore_clips_unet(v[..., None], mask[..., None], cfg, seeds,
                                      device="cpu")
    else:
        real = v * 2 - 1
        inp = real * mask - (1 - mask)
        cfg = tn.GANTrainConfig(epochs=3, ema_decay=0.9, ema_scope="gap",
                                retry_l1=1e-9 if kind == "gan_retry" else 0.0)

        def run():
            out, (dl, gl) = restore_clips_gan(inp, real, mask, cfg, seeds, device="cpu")
            return out, torch.stack([dl, gl])

    one_out, one_loss = run()
    assert batch.clip_groups(G, 1.0, torch.device("cpu")) == [slice(0, G)]   # no cap
    sizes, real_groups = [], batch.clip_groups

    def recorded(*args):
        groups = real_groups(*args)
        sizes.append([g.stop - g.start for g in groups])
        return groups

    monkeypatch.setattr(batch, "group_cap", lambda per_clip, device: 2)
    monkeypatch.setattr(batch, "clip_groups", recorded)
    monkeypatch.setattr(gan_batch, "clip_groups", recorded)
    out, loss = run()
    assert sizes == ([[2, 1]] * (2 if kind == "gan_retry" else 1))
    assert _rel(loss, one_loss) <= LOSS_RTOL
    assert _rel(out, one_out) <= (UNET_RTOL_OF_PEAK if kind == "unet" else GAN_RTOL_OF_PEAK)


def test_group_cap_from_free_memory(monkeypatch):
    """The cap is MEMORY_SHARE of the card's free bytes (with the
    allocator's unused cache) over a clip's, at least 1; the CPU has none.
    The groups cover the clips in order, near-equal, none over the cap."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (10e9, 80e9))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 3e9)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 1e9)
    assert batch.group_cap(1e9, cuda) == int(batch.MEMORY_SHARE * 12e9 // 1e9)
    assert batch.group_cap(1e12, cuda) == 1
    assert batch.group_cap(1e9, torch.device("cpu")) is None
    for n in (1, 5, 10, 11, 23):
        groups = batch.clip_groups(n, 1e9, cuda)
        sizes = [g.stop - g.start for g in groups]
        assert groups[0].start == 0 and groups[-1].stop == n
        assert all(a.stop == b.start for a, b in zip(groups, groups[1:]))
        assert max(sizes) <= 10 and max(sizes) - min(sizes) <= 1
        assert len(groups) == -(-n // 10)


def test_clip_bytes_is_linear_in_the_cells():
    """The footprint extrapolates what an epoch saves from two small shapes:
    at a third shape the count agrees, and bf16 saves less than fp32."""
    for kind in ("unet", "gan"):
        rate, fixed = batch._saved_rate(kind, False)
        got = batch._saved_bytes(kind, False, 96, 320)
        assert abs(got - (rate * 96 * 320 + fixed)) <= 0.01 * got, (kind, got)
        assert batch.clip_bytes(kind, True, 30, 60) < batch.clip_bytes(kind, False, 30, 60)
        assert (batch.clip_bytes(kind, False, 30, 60)
                == batch.PEAK_OVER_SAVED * (rate * 32 * 64 + fixed))
    assert batch.clip_bytes("gan", False, 30, 60) > batch.clip_bytes("unet", False, 30, 60)


# ------------------------------------------------------- against JAX ----


def _jax_init_from(keys, dtype=jnp.float32):
    """A stand-in for the port's ``_draw_init`` whose seed s draws the JAX
    package's init from ``keys[s]`` (folded with the attempt, as its
    retry folds), converted: the port's per-clip seeds are then indices
    into the JAX per-clip keys."""
    def draw(kind, seed, attempt, shape):
        key = keys[seed]
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
    return draw


@pytest.mark.parametrize("blind", [False, True])
def test_restore_clips_unet_matches_jax(blind, monkeypatch):
    """JAX's per-clip keys as a (B, 2) array; the port's seeds index them.
    blind: serving's form, synthetic stripes to train on, the real holes
    out of the loss (valid_batch) and composited (composite_mask_batch)."""
    keys = jax.random.split(jax.random.PRNGKey(4), G)
    monkeypatch.setattr(tn, "_draw_init", _jax_init_from(keys))
    v, keep = _specs(seed=1), _holes()
    kw, tol = {}, UNET_RTOL_OF_PEAK
    train = keep
    if blind:
        train = keep.copy()
        train[:, :, 5:11] = 0.0
        kw = dict(valid_batch=keep[..., None], composite_mask_batch=keep[..., None])
        tol = UNET_HOLE_RTOL_OF_PEAK
    want, wloss = jax_restore_clips_unet(v[..., None], train[..., None],
                                         jn.UNetTrainConfig(epochs=5), key=keys, **kw)
    got, loss = restore_clips_unet(v[..., None], train[..., None],
                                   tn.UNetTrainConfig(epochs=5), list(range(G)),
                                   device="cpu", **kw)
    for g in range(G):
        assert _rel(loss[g], np.asarray(wloss)[g]) <= LOSS_RTOL
        assert _rel(got[g], np.asarray(want)[g]) <= tol


def _gan_case(seed=9):
    v, mask = _specs(seed=seed), _holes()
    real = v * 2 - 1
    return real * mask - (1 - mask), real, mask


@pytest.mark.parametrize("retry", [False, True])
def test_restore_clips_gan_matches_jax(retry, monkeypatch):
    """EMA read out in the gap columns, the retry armed below any hole-L1:
    with n_real=0 no clip gates it (the first draws), else every clip
    retrains on its folded key (the second draws). One JAX config serves
    both; its discriminator is the plain flax one (packed_d=False), the
    same parameters and math as the packed twin at half its compile
    time."""
    key = jax.random.PRNGKey(7)
    monkeypatch.setattr(tn, "_draw_init", _jax_init_from(jax.random.split(key, G)))
    inp, real, mask = _gan_case()
    n_real = None if retry else 0
    jcfg = jn.GANTrainConfig(epochs=5, ema_decay=0.9, ema_scope="gap", retry_l1=1e-6,
                             packed_d=False)
    want, (wdl, wgl) = jax_restore_clips_gan(inp, real, mask, jcfg, key=key,
                                             n_real=n_real)
    tcfg = tn.GANTrainConfig(epochs=5, ema_decay=0.9, ema_scope="gap", retry_l1=1e-6)
    got, (dl, gl) = restore_clips_gan(inp, real, mask, tcfg, list(range(G)),
                                      n_real=n_real, device="cpu")
    for g in range(G):
        assert _rel(dl[g], np.asarray(wdl)[g]) <= LOSS_RTOL
        assert _rel(gl[g], np.asarray(wgl)[g]) <= LOSS_RTOL
        assert _rel(got[g], np.asarray(want)[g]) <= GAN_RTOL_OF_PEAK
    np.testing.assert_array_equal(got.numpy()[mask == 1], inp[mask == 1])


def _fill_snr_db(final, real, mask):
    hole = mask == 0
    err = np.sum((np.asarray(final, np.float64)[hole] - real[hole]) ** 2)
    return 10 * np.log10(np.sum(real[hole].astype(np.float64) ** 2) / err)


def test_restore_clips_gan_bf16_fills_match_jax(monkeypatch):
    """bf16 convs, serving's readout (EMA 0.99, gap scope): each clip's
    fill SNR within 1 dB of the JAX package's (bf16 rounds differently in
    the two packages; Part 2's bf16 GAN leg has the same bound)."""
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(tn, "_draw_init",
                        _jax_init_from(jax.random.split(key, G), jnp.bfloat16))
    inp, real, mask = _gan_case(seed=10)
    want, _ = jax_restore_clips_gan(inp, real, mask, jn.GANTrainConfig(
        epochs=5, bf16=True, ema_decay=0.99, ema_scope="gap", packed_d=False), key=key)
    got, _ = restore_clips_gan(inp, real, mask, tn.GANTrainConfig(
        epochs=5, bf16=True, ema_decay=0.99, ema_scope="gap"), list(range(G)),
        device="cpu")
    for g in range(G):
        a = _fill_snr_db(got[g].numpy(), real[g], mask[g])
        b = _fill_snr_db(np.asarray(want)[g], real[g], mask[g])
        assert abs(a - b) <= BF16_FILL_DB, (g, a, b)
