"""Batched multi-clip GAN restoration (serving mode).

The port of audio_inpainting_tpu/parallel/gan_batch.py: one independent
generator/discriminator pair per clip, the G pairs trained as one grouped
pair (models/unet.py, ``groups=G``): one D step and one G step per epoch
for all clips, in ``GANTrainer``'s order, each clip with its own losses,
EMA and readout (the gap scope's column sums per clip).

The mode-collapse retry retrains the clips whose hole-L1 exceeds
``retry_l1`` in one second grouped pass on their second init draws. The
JAX package padded that subset to a power-of-two multiple of its mesh, to
bound the programs XLA compiles; here exactly the failed clips retrain,
with the same outputs.

Both passes train in as few groups as the card's memory allows
(``batch.clip_groups``).
"""

from __future__ import annotations

import torch

from ..device import as_f32
from ..methods.neural import GANTrainConfig, _gan_run
from .batch import clip_bytes, clip_groups, clip_seeds
from .mesh import Ranks, gather, ranks_on, shard_range


def restore_clips_gan(norm_batch, real_batch, mask_batch,
                      cfg: GANTrainConfig = GANTrainConfig(), seed=0,
                      valid_batch=None, n_real: int | None = None, device=None,
                      ranks: Ranks | None = None):
    """Restore a batch of clips' [-1, 1] magnitudes, one GAN pair per clip.

    norm_batch, real_batch, mask_batch: (G, F, T); mask 1 = kept; padded
    internally to F % 4 and T % 32 (magnitudes -1, mask 1). seed: an int
    (distinct per-clip seeds, ``clip_seeds``) or one seed per clip.
    valid_batch (optional, (G, F, T), 1 = real content): each clip's true
    extent when the caller pre-pads unequal lengths; other cells leave the
    L1 term and its denominator. n_real (optional): only the first n_real
    clips are real; the rest never gate the retry. device: cuda unless
    "cpu" is named. ranks (parallel/mesh.py; default one rank on
    ``device``): the clips split over the ranks' ``dp`` axis (G must
    divide by it), each rank training its slice, and retrying its own
    failed clips, on its own device; the clip seeds those of the whole
    batch; the outputs are gathered.

    Returns (composited (G, F, T), (d_loss_last (G,), g_loss_last (G,))),
    the losses None without epochs: ``gan_train_restore``'s contract,
    batched.
    """
    ranks = ranks_on(ranks, device)
    dev = ranks.device
    norm, real, msk = (as_f32(a, dev) for a in (norm_batch, real_batch, mask_batch))
    vld = None if valid_batch is None else as_f32(valid_batch, dev)
    mine = shard_range(norm.shape[0], ranks)
    seeds = clip_seeds(seed, norm.shape[0])[mine]
    norm, real, msk, vld = (None if a is None else a[mine] for a in (norm, real, msk, vld))
    if n_real is not None:
        n_real = min(max(n_real - mine.start, 0), norm.shape[0])
    per_clip = clip_bytes("gan", cfg.bf16, *norm.shape[1:])

    def run(ids: list[int], attempt: int):
        """Clips ``ids`` trained on init draw ``attempt``, group by group:
        (composites, last D losses, last G losses, hole-L1s), each over
        ``ids``; the losses None without epochs, the hole-L1s without a
        retry."""
        parts = []
        for grp in clip_groups(len(ids), per_clip, dev):
            sub = torch.as_tensor(ids[grp], device=dev)
            trainer, out, (dl, gl) = _gan_run(
                norm[sub], real[sub], msk[sub], cfg, [seeds[i] for i in ids[grp]],
                attempt, dev, None if vld is None else vld[sub])
            parts.append((out, dl[-1] if len(dl) else None, gl[-1] if len(gl) else None,
                          trainer.hole_l1(out) if cfg.retry_l1 > 0.0 else None))
            del trainer
        return [None if p[0] is None else torch.cat(p) for p in zip(*parts)]

    out, dl, gl, l1 = run(list(range(norm.shape[0])), 0)
    if cfg.retry_l1 > 0.0:
        l1 = l1.cpu()
        if n_real is not None:
            l1[n_real:] = 0.0          # padding duplicates never gate a retry
        bad = torch.nonzero(l1 > cfg.retry_l1).flatten().tolist()
        if bad:
            out2, dl2, gl2, _ = run(bad, 1)
            idx = torch.as_tensor(bad, device=dev)
            out[idx] = out2
            if dl is not None:
                dl[idx], gl[idx] = dl2, gl2
    if dl is not None:
        dl, gl = gather(dl, ranks), gather(gl, ranks)
    return gather(out, ranks), (dl, gl)
