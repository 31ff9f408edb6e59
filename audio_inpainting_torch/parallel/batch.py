"""Batched multi-clip U-Net restoration: one independent U-Net per clip.

The port of audio_inpainting_tpu/parallel/batch.py. The reference restores
one clip per process; a corpus wants many. The JAX package trained the
clips one after another on each chip (``lax.map`` inside ``shard_map``,
since XLA refused the grouped 1x1 head). On one GPU the point is the
opposite: the G clips' nets are one grouped net (models/unet.py,
``groups=G``), so each epoch is one set of launches for all of them.
Every clip trains exactly as ``methods.neural.unet_train_restore`` would
train it alone: the same trainer (``UNetTrainer``), its own loss and
denominator, its own Adam.

A grouped net's activations grow with G, so a corpus larger than the card
holds trains in several groups, one after another (``clip_groups``): as
many clips a group as the card's free memory takes at the per-clip
footprint (``clip_bytes``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import as_f32
from ..methods.neural import UNetTrainConfig, UNetTrainer, _seeds
from ..models import Discriminator, GeneratorUNet, SimpleUNet
from .mesh import Ranks, gather, ranks_on, shard_range

# The share of the card's free memory that one group's training may take.
MEMORY_SHARE = 0.9
# A training epoch's peak device memory over the bytes its forwards save
# for the backward: the gradients in flight during the backward, the
# trainer's inputs and masks, cuDNN's workspaces. chip_smoke.py (phase
# serve) holds each model's measured peak under it at G up to 8.
PEAK_OVER_SAVED = 2.5


def clip_seed(seed: int, index: int) -> int:
    """Clip ``index``'s seed under a run's ``seed``: the pair mixed by
    numpy's SeedSequence, standing in for the JAX package's per-clip keys
    (``split``/``fold_in`` of ``PRNGKey(seed)``). It depends on the pair
    alone, not on the number of clips."""
    state = np.random.SeedSequence([seed & (2**64 - 1), index]).generate_state(1, np.uint64)
    return int(state[0] >> 1)


def clip_seeds(seed, n: int) -> list[int]:
    """``n`` per-clip seeds: distinct ones derived from an int ``seed``
    (``clip_seed``), or the given sequence of ``n`` seeds."""
    if isinstance(seed, (int, np.integer)):
        return [clip_seed(int(seed), i) for i in range(n)]
    return _seeds(seed, n)


def _saved_bytes(kind: str, bf16: bool, f: int, t: int) -> int:
    """Bytes that one clip's training epoch of ``kind`` ("unet", "gan")
    saves for its backward at (f, t): the epoch's forwards (the GAN's
    generator, then its discriminator on the real, the detached and the
    live composite) on the CPU, each saved storage counted once."""
    dt = torch.bfloat16 if bf16 else torch.float32
    saved = {}

    def pack(x):
        saved[x.untyped_storage().data_ptr()] = x     # kept alive: no reuse
        return x

    x = torch.rand(1, 1, f, t, generator=torch.Generator())
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        if kind == "unet":
            SimpleUNet(dt, torch.Generator())(x)
        else:
            g, d = GeneratorUNet(dt, torch.Generator()), Discriminator(dt, torch.Generator())
            fake = g(x, True)
            for y in (x, fake.detach(), fake):
                d(y, True)
    return sum(v.untyped_storage().nbytes() for v in saved.values())


@functools.lru_cache(maxsize=None)
def _saved_rate(kind: str, bf16: bool) -> tuple[float, float]:
    """(bytes a cell, fixed bytes) of ``_saved_bytes``, from two small
    shapes: the activations grow with the cells, the saved weights do
    not."""
    (c1, s1), (c2, s2) = ((f * t, _saved_bytes(kind, bf16, f, t))
                          for f, t in ((32, 64), (64, 128)))
    rate = (s2 - s1) / (c2 - c1)
    return rate, s1 - rate * c1


def clip_bytes(kind: str, bf16: bool, f: int, t: int) -> float:
    """Device bytes that one clip's training of ``kind`` takes at (f, t),
    padded as the trainers pad it: PEAK_OVER_SAVED times what its epoch
    saves for the backward."""
    rate, fixed = _saved_rate(kind, bf16)
    return PEAK_OVER_SAVED * (rate * (f + (-f) % 4) * (t + (-t) % 32) + fixed)


def group_cap(per_clip: float, device: torch.device) -> int | None:
    """The most clips that one grouped net may hold on ``device``:
    MEMORY_SHARE of the card's free memory (with what torch's allocator
    holds unused) over ``per_clip`` bytes, at least 1. None on the CPU,
    which has no cap."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return max(1, int(MEMORY_SHARE * free // per_clip))


def clip_groups(n: int, per_clip: float, device: torch.device) -> list[slice]:
    """Clips 0..n-1 as consecutive groups of near-equal size, as few as
    ``group_cap`` allows: one group when all n fit."""
    cap = group_cap(per_clip, device)
    k = 1 if cap is None else -(-n // cap)
    bounds = np.linspace(0, n, k + 1).round().astype(int)
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _from_nhwc(x, device) -> torch.Tensor:
    """(B, F, T, 1) -> (B, F, T) float32 on ``device``."""
    x = as_f32(x, device)
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError(f"want a (B, F, T, 1) batch, got {tuple(x.shape)}")
    return x[..., 0]


def restore_clips_unet(mag_norm_batch, mask_batch,
                       cfg: UNetTrainConfig = UNetTrainConfig(), seed=0,
                       valid_batch=None, composite_mask_batch=None, device=None,
                       ranks: Ranks | None = None):
    """Restore a batch of clips' normalized magnitudes, one U-Net per clip.

    mag_norm_batch, mask_batch: (B, F, T, 1), any F/T: padded internally
    to F % 4 and T % 32 (mag 0, mask 1, valid 0, composite mask 1) and
    trimmed on return, like the single-clip ``unet_train_restore``. Mask
    1 = kept. seed: an int (distinct per-clip seeds, ``clip_seeds``) or
    one seed per clip (e.g. the same seed for every clip, to match B
    single-clip calls). valid_batch (optional, same shape, 1 = real
    content): cells whose target may enter the loss, numerator and
    denominator. composite_mask_batch (optional): the mask of the final
    composite ``x + pred * (1 - m)`` (the eval forward sees
    ``mag * m``) when it differs from the training mask: serving trains
    on synthetic stripes over intact content and composites over the real
    damage (pipelines/serve.py). device: cuda unless "cpu" is named.
    The clips train in as few groups as the card's memory allows
    (``clip_groups``). ranks (parallel/mesh.py; default one rank on
    ``device``): the clips split over the ranks' ``dp`` axis (B must
    divide by it), each rank training its slice on its own device, the
    clip seeds those of the whole batch; the outputs are gathered.

    Returns (composited (B, F, T, 1), per-clip loss of the last epoch (B,),
    None without epochs), on ``device``.
    """
    ranks = ranks_on(ranks, device)
    dev = ranks.device
    mag, msk = _from_nhwc(mag_norm_batch, dev), _from_nhwc(mask_batch, dev)
    vld = None if valid_batch is None else _from_nhwc(valid_batch, dev)
    cmsk = None if composite_mask_batch is None else _from_nhwc(composite_mask_batch, dev)
    mine = shard_range(mag.shape[0], ranks)
    seeds = clip_seeds(seed, mag.shape[0])[mine]
    mag, msk, vld, cmsk = (None if a is None else a[mine] for a in (mag, msk, vld, cmsk))
    finals, losses = [], []
    for grp in clip_groups(mag.shape[0], clip_bytes("unet", cfg.bf16, *mag.shape[1:]),
                           dev):
        trainer = UNetTrainer(mag[grp], msk[grp], cfg, seeds[grp],
                              valid=None if vld is None else vld[grp],
                              composite_mask=None if cmsk is None else cmsk[grp])
        loss = None
        for _ in range(cfg.epochs):
            loss = trainer.epoch()
        finals.append(trainer.restore()[0])
        losses.append(loss)
        del trainer
    loss = None if losses[0] is None else gather(torch.cat(losses), ranks)
    return gather(torch.cat(finals)[..., None], ranks), loss
