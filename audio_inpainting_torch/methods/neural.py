"""Self-supervised per-clip neural inpainting: U-Net and GAN training loops.

The port of audio_inpainting_tpu/methods/neural.py. Reference behavior:

- U-Net, random mask (main5_UNet_mask.py:158-193): Adam lr=1e-3, MSE on the
  masked region only, 400 epochs over the single clip's normalized
  magnitude; composite ``input + pred*(1-mask)``.
- U-Net, deterministic gap (main5_UNet_gap.py:133-168): the loss over the
  whole spectrogram (an overfit demonstration), 600 epochs.
- GAN (main_gan_gap.py:117-158): D with BCE on [real | composited fake
  (detached)], G loss = 0.99*L1(masked) + 0.01*adv(BCE on the composite),
  Adam lr=2e-4 betas=(0.5, 0.999), 1500 epochs; min-max [-1, 1] normalized
  magnitudes; trains against the ground-truth clip's spectrogram.

PyTorch runs each epoch eagerly, op by op (the JAX package ran 100 epochs
per device program with ``lax.scan``). ``UNetTrainer`` and ``GANTrainer``
hold one training run, so a caller can step it epoch by epoch.

A trainer takes one clip, (F, T), or a group of G clips of one shape,
(G, F, T): G independent nets as one grouped net (models/unet.py,
``groups=G``), one set of launches per epoch. Each clip keeps its own
loss and denominator, and the nets train on the SUM of the per-clip
losses, never their mean: Adam is element-wise, so one Adam over the
grouped tensors is G independent Adams only while each clip's gradient is
unscaled (a 1/G would change the steps that Adam takes from rounding
noise, e.g. of the conv biases in front of each BatchNorm).

Spectrograms pad F to a multiple of 4 and T to a multiple of 32, as in the
JAX package (whose packed layout needs the 32): the pad cells enter the
BatchNorm statistics and the receptive field of the edge columns, so the
pad changes the result and is kept. Pad values: 0 for the U-Net input, -1
(silence in [-1, 1]) for the GAN, 1 (kept) for masks.

The initial weights come from ``_draw_init``, a seeded CPU generator, so
every device starts from the same numbers; the tests replace it with the
JAX package's init.

Each trainer is one training run (``utils.profiling.new_run``): its
build, each epoch and its readout open the spans ``unet.build``,
``unet.epoch``, ``unet.readout`` (``gan.*`` for the GAN) with the run's id
and ``clips``, the group size G; ``_gan_run`` opens ``gan.run`` with its
``attempt``. They are recorded only while a profiler session is active.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..device import as_f32
from ..models import (Discriminator, GeneratorUNet, SimpleUNet, patchgan_map_shape,
                      stack_states)
from ..utils.profiling import new_run, span


@dataclass(frozen=True)
class UNetTrainConfig:
    """The JAX package's UNetTrainConfig without its TPU-only fields
    (``scan_chunk``, epochs per device program, and ``flat_opt``, a
    flattened Adam; here Adam is ``torch.optim.Adam``)."""

    epochs: int = 400
    lr: float = 1e-3
    masked_loss: bool = True   # True: MSE on the masked region only
    bf16: bool = False         # bf16 conv compute (params/loss stay fp32)


@dataclass(frozen=True)
class GANTrainConfig:
    """The JAX package's GANTrainConfig without its TPU-only fields
    (``scan_chunk``, ``flat_opt``, ``packed_d`` and ``vmap_d``: layouts and
    batching of the TPU programs)."""

    epochs: int = 1500
    lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    l1_weight: float = 0.99
    adv_weight: float = 0.01
    bf16: bool = False         # bf16 conv compute (params/loss stay fp32)
    # Retrain once on a second seeded draw if the hole-L1 of the composite
    # against the real spectrogram exceeds this: the JAX package's measured
    # signature of mode collapse (healthy draws <= 0.031, collapsed >= 0.040
    # in norm units). 0 = off.
    retry_l1: float = 0.0
    # Weight-space EMA of the generator params, ema <- d*ema + (1-d)*params
    # after every G update, zero-initialized and bias-corrected at readout
    # (ema / (1 - d^epochs)). Only the final inference reads it. 0 = off.
    ema_decay: float = 0.0
    # Where the EMA readout replaces the single-inference fill: "full"
    # everywhere; "gap" only in fully dark columns (keep fraction < 2%).
    ema_scope: str = "full"


_MODELS = {"unet": (SimpleUNet,), "gan": (GeneratorUNet, Discriminator)}


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.bf16 else torch.float32


def _clips(x: torch.Tensor) -> torch.Tensor:
    """(G, F, T); one clip (F, T) is a group of one."""
    return x[None] if x.dim() == 2 else x


def _group_size(x) -> int:
    """G of an (F, T) or (G, F, T) array or tensor."""
    shape = np.shape(x)
    return 1 if len(shape) == 2 else shape[0]


def _nchw(clips: torch.Tensor) -> torch.Tensor:
    """(G, F, T) -> (1, G, F, T): clip g in channel g, never in the batch
    dimension (models/unet.py)."""
    return clips[None]


def _pad4(x: torch.Tensor, value: float = 0.0
          ) -> tuple[torch.Tensor, tuple[int, int]]:
    """F up to a multiple of 4 (two pools), T up to a multiple of 32, over
    the last two axes; the original (f, t) comes back."""
    f, t = x.shape[-2:]
    return F.pad(x, (0, (-t) % 32, 0, (-f) % 4), value=value), (f, t)


def _seeds(seed, groups: int) -> list[int]:
    """Per-clip init seeds: an int for one clip, else one seed per clip."""
    seeds = [seed] if isinstance(seed, int) else [int(s) for s in seed]
    if len(seeds) != groups:
        raise ValueError(f"{len(seeds)} seeds for {groups} clips")
    return seeds


def _per_clip(x: torch.Tensor, single: bool) -> torch.Tensor:
    """A per-clip result in the trainer input's form: clip 0's alone for
    one (F, T) clip."""
    return x[0] if single else x


def _valid4(f: int, t: int, device) -> torch.Tensor:
    """1 over the original (f, t) extent, 0 over the pad margin: the pad
    cells neither enter a loss nor its denominator."""
    vld = torch.zeros(f + (-f) % 4, t + (-t) % 32, device=device)
    vld[:f, :t] = 1.0
    return vld


def _draw_init(kind: str, seed: int, attempt: int,
               shape: tuple[int, int]) -> list[dict[str, torch.Tensor]]:
    """Initial weights of ``kind`` ("unet": [SimpleUNet]; "gan":
    [GeneratorUNet, Discriminator]) as CPU state dicts: draw ``attempt``
    (0 first, 1 the GAN's retry) of a CPU generator seeded with ``seed``,
    the same numbers on every device. ``shape`` is the padded (F, T); the
    JAX init the tests put here needs it, this one does not."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(attempt + 1):
        models = [cls(generator=gen) for cls in _MODELS[kind]]
    return [m.state_dict() for m in models]


def _init_models(kind: str, cfg, seeds: list[int], attempt: int,
                 shape: tuple[int, int], device, states=None) -> list[nn.Module]:
    """The models of ``kind`` grouped over len(seeds) clips, clip g from
    ``_draw_init(kind, seeds[g], attempt, shape)``, or from ``states``
    (one state dict per model, grouped already)."""
    # the constructors' own draws are replaced by _draw_init's, or by the
    # given state dicts; a fresh generator leaves torch's global one untouched
    models = [cls(_dtype(cfg), generator=torch.Generator(), groups=len(seeds))
              for cls in _MODELS[kind]]
    if states is None:
        per_clip = [_draw_init(kind, s, attempt, shape) for s in seeds]
        states = [stack_states(list(clip_states)) for clip_states in zip(*per_clip)]
    for model, state in zip(models, states):
        model.load_state_dict(state)
    return [m.to(device) for m in models]


def _adam(model: nn.Module, lr: float, betas: tuple[float, float],
          device: torch.device) -> torch.optim.Adam:
    # optax.adam's hyper-parameters (eps 1e-8 outside the square root);
    # the fused multi-tensor kernel on the GPU
    return torch.optim.Adam(model.parameters(), lr=lr, betas=betas, eps=1e-8,
                            fused=device.type == "cuda")


# ---------------------------------------------------------------- U-Net ----


class UNetTrainer:
    """One per-clip U-Net training run, of one clip or of a group:
    ``epoch()`` takes one Adam step, ``restore()`` composites. Arguments as
    for ``unet_train_restore``, each (F, T) or (G, F, T); ``seed`` an int
    for one clip, else one per clip. ``init_state``, a SimpleUNet state dict, replaces the
    seeded init of one clip (a carried net, methods/unet_stream.py)."""

    def __init__(self, mag_norm, mask, cfg: UNetTrainConfig = UNetTrainConfig(),
                 seed=0, valid=None, composite_mask=None, device=None,
                 init_state=None):
        self.run, self.clips = new_run(), _group_size(mag_norm)
        with span("unet.build", run=self.run, clips=self.clips):
            mag_norm = as_f32(mag_norm, device)
            dev = mag_norm.device
            self.single = mag_norm.dim() == 2
            tgt, (self.f0, self.t0) = _pad4(_clips(mag_norm))
            # pad = kept: out of the masked loss
            msk, _ = _pad4(_clips(as_f32(mask, dev)), 1.0)
            vld = _valid4(self.f0, self.t0, dev).expand_as(tgt)
            if valid is not None:
                vld = vld * _pad4(_clips(as_f32(valid, dev)))[0]
            self.cfg = cfg
            self.tgt_clips = tgt
            self.inp = _nchw(tgt * msk)
            self.tgt = _nchw(tgt)
            self.vld = _nchw(vld)
            self.inv = (1.0 - _nchw(msk)) * self.vld
            # a clip whose every column is damaged has sum(valid) == 0: the
            # loss is then 0 with zero gradients, not 0/0
            self.denom = self.vld.sum(dim=(0, 2, 3)).clamp_min(1.0)
            self.cmsk = (msk if composite_mask is None
                         else _pad4(_clips(as_f32(composite_mask, dev)), 1.0)[0])
            seeds = _seeds(seed, tgt.shape[0])
            (self.model,) = _init_models("unet", cfg, seeds, 0, tuple(tgt.shape[1:]), dev,
                                         None if init_state is None else [init_state])
            self.opt = _adam(self.model, cfg.lr, (0.9, 0.999), dev)

    def epoch(self) -> torch.Tensor:
        """One Adam step; returns the loss before it, per clip (G,) (a
        device scalar for one (F, T) clip)."""
        with span("unet.epoch", run=self.run, clips=self.clips):
            self.opt.zero_grad()
            out = self.model(self.inp)
            if self.cfg.masked_loss:
                diff = out * self.inv - self.tgt * self.inv
            else:
                diff = (out - self.tgt) * self.vld
            loss = (diff ** 2).sum(dim=(0, 2, 3)) / self.denom
            loss.sum().backward()
            self.opt.step()
            return _per_clip(loss.detach(), self.single)

    @torch.no_grad()
    def restore(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(composite, prediction), each (G, F, T) ((F, T) for one clip).
        The eval forward sees the composite-masked input: only the real
        damage hidden, synthetic training stripes visible again as
        context."""
        with span("unet.readout", run=self.run, clips=self.clips):
            seen = self.tgt_clips * self.cmsk
            pred = self.model(_nchw(seen))[0]
            final = seen + pred * (1.0 - self.cmsk)
            return (_per_clip(final[:, :self.f0, :self.t0], self.single),
                    _per_clip(pred[:, :self.f0, :self.t0], self.single))


def unet_train_restore(mag_norm, mask, cfg: UNetTrainConfig = UNetTrainConfig(),
                       seed: int = 0, valid=None, composite_mask=None,
                       device=None):
    """Train SimpleUNet on one clip's normalized magnitude and composite.

    mag_norm, mask: (F, T); mask 1 = kept. Returns (final (F, T), prediction
    (F, T), losses (epochs,)), on the device of ``mag_norm`` when it is a
    tensor and ``device`` is None, else on ``device`` (cuda by default).

    valid (optional (F, T), 1 = real content): cells whose target may enter
    the loss. For blind damage the caller passes the detected keep mask
    here, since the real holes have no target, while synthetic training
    stripes in ``mask`` carry the learning signal. composite_mask (optional
    (F, T)): the mask of the final composite when it differs from the
    training mask.
    """
    trainer = UNetTrainer(mag_norm, mask, cfg, seed, valid, composite_mask, device)
    losses = [trainer.epoch() for _ in range(cfg.epochs)]
    final, pred = trainer.restore()
    return final, pred, (torch.stack(losses) if losses
                         else torch.zeros(0, device=final.device))


# ------------------------------------------------------------------ GAN ----


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean BCE over each clip's own PatchGAN map: (1, G, h, w) -> (G,)."""
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target), reduction="none").mean(dim=(0, 2, 3))


class GANTrainer:
    """One per-clip GAN training run, of one clip or of a group: ``epoch()``
    runs one D step and one G step, ``restore()`` the final inference.
    Arguments as for ``gan_train_restore``, each (F, T) or (G, F, T);
    ``seed`` an int for one clip, else one per clip; ``attempt`` picks the init draw (1:
    the retry). ``valid`` (optional, 1 = real content) takes cells out of
    the L1 term, its denominator and the readout's column rule.

    The epoch order is the reference's: one G forward, reused; a D step on
    real, then on the detached composite (D's running statistics chain
    through both); D's optimizer step; then the G step through the updated
    D (its third forward, whose statistics the next epoch starts from),
    whose gradient reaches G's params only.

    Where the PatchGAN map is empty (a padded input under ~32x32 cells) D
    is skipped, with a warning: the adversarial term is 0 exactly, as the
    JAX package's empty-map BCE is, whose zero gradients leave D's params
    as they were.
    """

    def __init__(self, input_norm, real_norm, mask,
                 cfg: GANTrainConfig = GANTrainConfig(), seed=0,
                 attempt: int = 0, device=None, valid=None):
        self.run, self.clips = new_run(), _group_size(input_norm)
        with span("gan.build", run=self.run, clips=self.clips):
            input_norm = as_f32(input_norm, device)
            dev = input_norm.device
            self.single = input_norm.dim() == 2
            inp, (self.f0, self.t0) = _pad4(_clips(input_norm), -1.0)
            vld = _valid4(self.f0, self.t0, dev).expand_as(inp)
            if valid is not None:
                vld = vld * _pad4(_clips(as_f32(valid, dev)))[0]
            self.inp = _nchw(inp)
            self.real = _nchw(_pad4(_clips(as_f32(real_norm, dev)), -1.0)[0])
            self.msk = _nchw(_pad4(_clips(as_f32(mask, dev)), 1.0)[0])   # pad = kept
            self.vld = _nchw(vld)
            self.cfg = cfg
            self.inv = 1.0 - self.msk
            self.rec_inv = self.inv * self.vld    # L1 only over the valid extent
            self.rec_denom = self.vld.sum(dim=(0, 2, 3))
            shape = tuple(inp.shape[1:])
            map_shape = patchgan_map_shape(*shape)
            self.d_live = min(map_shape) > 0
            if not self.d_live:
                warnings.warn(
                    f"clip {shape[0]}x{shape[1]} is too small for the PatchGAN "
                    f"discriminator (logits map {map_shape} is empty); the "
                    "adversarial term is 0 and the generator trains on the L1 "
                    "term only", stacklevel=2)
            seeds = _seeds(seed, inp.shape[0])
            self.g, self.d = _init_models("gan", cfg, seeds, attempt, shape, dev)
            self.g_params = list(self.g.parameters())
            self.g_opt = _adam(self.g, cfg.lr, (cfg.b1, cfg.b2), dev)
            self.d_opt = _adam(self.d, cfg.lr, (cfg.b1, cfg.b2), dev)
            self.ema = ([torch.zeros_like(p) for p in self.g_params]
                        if cfg.ema_decay > 0.0 else None)

    def epoch(self) -> tuple[torch.Tensor, torch.Tensor]:
        """One epoch; returns (d_loss, g_loss) per clip, each (G,) (device
        scalars for one (F, T) clip)."""
        with span("gan.epoch", run=self.run, clips=self.clips):
            cfg = self.cfg
            fake = self.g(self.inp, True)
            completed = self.inp * self.msk + fake * self.inv
            if self.d_live:
                d_loss = 0.5 * (_bce(self.d(self.real, True), 1.0)
                                + _bce(self.d(completed.detach(), True), 0.0))
                self.d_opt.zero_grad()
                d_loss.sum().backward()
                self.d_opt.step()
                adv = _bce(self.d(completed, True), 1.0)
            else:
                d_loss = adv = fake.new_zeros(fake.shape[1])
            rec = ((fake * self.rec_inv - self.real * self.rec_inv).abs().sum(dim=(0, 2, 3))
                   / self.rec_denom)
            g_loss = cfg.l1_weight * rec + cfg.adv_weight * adv
            self.g_opt.zero_grad()
            g_loss.sum().backward(inputs=self.g_params)
            self.g_opt.step()
            if self.ema is not None:
                with torch.no_grad():
                    torch._foreach_mul_(self.ema, cfg.ema_decay)
                    torch._foreach_add_(self.ema, self.g_params, alpha=1.0 - cfg.ema_decay)
            return (_per_clip(d_loss.detach(), self.single),
                    _per_clip(g_loss.detach(), self.single))

    @torch.no_grad()
    def _eval(self, params: dict[str, torch.Tensor]) -> torch.Tensor:
        return functional_call(self.g, params, (self.inp, False))

    def restore(self) -> torch.Tensor:
        """The composite of the final eval-mode inference, (G, F, T) ((F, T)
        for one clip)."""
        with span("gan.readout", run=self.run, clips=self.clips):
            params = dict(self.g.named_parameters())
            ema = None if self.ema is None else dict(zip(params, self.ema))
            fake = gan_readout_fake(self._eval, params, ema, self.msk, self.vld, self.cfg)
            final = self.inp * self.msk + fake * (1.0 - self.msk)
            return _per_clip(final[0, :, :self.f0, :self.t0], self.single)

    @torch.no_grad()
    def hole_l1(self, final: torch.Tensor) -> torch.Tensor:
        """Mean |final - real| over each clip's valid hole cells, the
        mode-collapse signature, per clip ((G,), a scalar for one clip);
        0 where the mask hides nothing. ``final`` as ``restore`` returns
        it."""
        hole = (self.inv * self.vld)[0, :, :self.f0, :self.t0]
        real = self.real[0, :, :self.f0, :self.t0]
        err = ((_clips(final) - real) * hole).abs().sum(dim=(1, 2))
        return _per_clip(err / hole.sum(dim=(1, 2)).clamp_min(1e-9), self.single)


def gan_readout_fake(eval_fn, params: dict, ema: dict | None,
                     msk: torch.Tensor, vld: torch.Tensor,
                     cfg: GANTrainConfig) -> torch.Tensor:
    """The GAN readout contract. ``eval_fn(params) -> fake`` is the
    eval-mode forward (running statistics); msk/vld are (1, 1, F, T).

    ema_decay=0: one forward of the final params (reference
    main_gan_gap.py:150-153). ema_decay>0: the bias-corrected EMA weights;
    with ema_scope="gap" their fill only in the fully dark columns and the
    single-inference fill elsewhere.
    """
    if cfg.ema_decay <= 0.0:
        return eval_fn(params)
    corr = 1.0 - cfg.ema_decay ** cfg.epochs
    fake = eval_fn({k: e / corr for k, e in ema.items()})
    if cfg.ema_scope == "gap":
        fake_one = eval_fn(params)
        hole_col = ((1.0 - msk) * vld).sum(dim=2, keepdim=True)
        vld_col = vld.sum(dim=2, keepdim=True)
        fake = torch.where(hole_col > 0.98 * vld_col.clamp_min(1.0), fake, fake_one)
    return fake


def _gan_run(input_norm, real_norm, mask, cfg: GANTrainConfig, seed, attempt: int,
             device, valid=None):
    """One training run: (trainer, composite, (d_losses, g_losses)), the
    losses stacked over the epochs."""
    with span("gan.run", attempt=attempt):
        trainer = GANTrainer(input_norm, real_norm, mask, cfg, seed, attempt, device, valid)
        hist = [trainer.epoch() for _ in range(cfg.epochs)]
        final = trainer.restore()
    empty = final.new_zeros((0, *final.shape[:-2]))
    return trainer, final, (torch.stack([d for d, _ in hist]) if hist else empty,
                            torch.stack([g for _, g in hist]) if hist else empty)


def gan_train_restore(input_norm, real_norm, mask,
                      cfg: GANTrainConfig = GANTrainConfig(), seed: int = 0,
                      device=None):
    """Train the GAN pair on one clip and return the composited magnitude.

    input_norm, real_norm in [-1, 1]; mask 1 = kept (all (F, T)). Returns
    (final_norm (F, T), (d_losses, g_losses), attempts): the losses of the
    kept run, and attempts 2 where ``retry_l1`` made it retrain on the
    second draw, else 1. Runs where ``as_f32`` puts ``input_norm``.
    """
    trainer, final, hist = _gan_run(input_norm, real_norm, mask, cfg, seed, 0, device)
    if cfg.retry_l1 > 0.0 and float(trainer.hole_l1(final)) > cfg.retry_l1:
        _, final, hist = _gan_run(input_norm, real_norm, mask, cfg, seed, 1, device)
        return final, hist, 2
    return final, hist, 1
