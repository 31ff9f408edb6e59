"""Persistent per-stream U-Net: one net carried across a stream's windows.

The port of audio_inpainting_tpu/methods/unet_stream.py. Training a fresh
net for every damaged window of a stream repeats what the previous window
already learned about the program's timbre. This module keeps ONE net per
stream: the first damaged window trains the full budget from the seeded
init (main5_UNet_mask.py:158-193: Adam lr=1e-3, MSE on hidden columns
only), and every later window starts from the carried weights, with fresh
Adam moments, for the smaller ``adapt_epochs``. The U-Net's conv weights do
not depend on the input size, so one net serves every window size the
stream plans.

Each window runs the facade's unet branch (api.py) with the carried
weights: the STFT, ``adapt_epochs`` eager epochs of ``UNetTrainer``, the
composite and the iSTFT. The JAX package fuses those into one device
program per window and inits on a canonical shape so that one compiled
init serves every window size; here ``neural._draw_init`` does not depend
on the shape, so the seeded init is the same for every window anyway.

The carried net NEVER trains on real hole columns: the loss falls only on
columns that are intact (``mask_to_bad_columns``) AND synthetically hidden
(``training_stripes``), the facade's self-supervision scheme, so weight
persistence cannot leak hole silence across windows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..corrupt import mask_to_bad_columns, training_stripes
from ..device import resolve_device
from ..ops import istft, magphase, polar, stft, torch_stft_config
from .neural import UNetTrainConfig, UNetTrainer


class PersistentUNetStream:
    """Carries one U-Net across a stream's damage windows (module doc).

    ``cfg_kwargs`` flow into UNetTrainConfig (``epochs`` is the COLD
    first-window budget). The carried state is the net's weights, a state
    dict on ``device``; Adam moments restart per window.
    """

    def __init__(self, seed: int = 0, adapt_epochs: int = 100, device=None,
                 **cfg_kwargs):
        self.scfg = torch_stft_config(1024, 256)
        self.cfg = UNetTrainConfig(**cfg_kwargs)
        # the adaptation budget never exceeds the cold budget (a warm
        # window should cost less than the from-scratch one)
        self.adapt_epochs = max(1, min(int(adapt_epochs), self.cfg.epochs))
        self.seed = seed
        self.device = resolve_device(device)
        self.state: dict[str, torch.Tensor] | None = None

    def restore_window(self, sub: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Restore one window (mask True = valid sample). The first call
        trains cfg.epochs from the seeded init; later calls adapt the
        carried net for adapt_epochs. Returns the restored window."""
        dev = self.device
        audio = torch.tensor(np.asarray(sub, np.float32), device=dev)
        mag, phase = magphase(stft(audio, self.scfg))
        n_cols = mag.shape[1]
        bad = mask_to_bad_columns(mask, n_cols, self.scfg.hop, device=dev)
        keep = torch.as_tensor(~bad, dtype=torch.float32,
                               device=dev)[None, :].expand(mag.shape)
        # the stripes the facade draws for the same window and seed
        syn = training_stripes(torch.Generator().manual_seed(self.seed),
                               n_cols, ~bad)
        train_mask = keep * torch.as_tensor(syn, device=dev)[None, :]
        mag_max = mag.max().clamp_min(1e-12)    # all-silent window: no NaN
        trainer = UNetTrainer(mag / mag_max, train_mask, self.cfg, self.seed,
                              valid=keep, composite_mask=keep,
                              init_state=self.state)
        n_epochs = self.cfg.epochs if self.state is None else self.adapt_epochs
        for _ in range(n_epochs):
            trainer.epoch()
        final, _ = trainer.restore()
        self.state = {k: v.detach().clone()
                      for k, v in trainer.model.state_dict().items()}
        return istft(polar(final * mag_max, phase), self.scfg,
                     len(sub)).cpu().numpy()

    def warm_window(self, sub: np.ndarray, mask: np.ndarray) -> None:
        """Run this window size's cold AND adapt paths on a throwaway net,
        leaving the stream's carried weights untouched: the unet leg of
        StreamRestorer.warmup()."""
        saved = self.state
        try:
            self.state = None
            self.restore_window(sub, mask)    # cold, full budget
            self.restore_window(sub, mask)    # adapt budget
        finally:
            self.state = saved
