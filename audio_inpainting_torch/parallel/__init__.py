"""Batched per-clip restoration: G clips, each with its own net, trained
as one grouped net (one set of launches per epoch) on one GPU."""

from .batch import clip_seeds, restore_clips_unet
from .gan_batch import restore_clips_gan

__all__ = ["clip_seeds", "restore_clips_gan", "restore_clips_unet"]
