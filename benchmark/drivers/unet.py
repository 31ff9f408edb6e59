"""Requests through the port's per-clip U-Net, in the order its entry points
call the port's public functions.

- ``serve``: ``run_serve``'s unet batch (pipelines/serve.py ``_analyze``
  per clip, ``_restore_batch``'s glue, ``restore_clips_unet``'s trainer
  for the one group that ``clip_groups`` forms), without the WAV reads and
  writes.
- ``facade``: ``restore(damaged, sr, method="unet", seed=...)``
  (api.py), one clip, a fresh trainer per request.

Every epoch is ``UNetTrainer.epoch()``; the entry's own loop over the
epochs is the harness's.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_inpainting_torch.corrupt import silent_frame_columns, training_stripes
from audio_inpainting_torch.methods.neural import UNetTrainConfig, UNetTrainer
from audio_inpainting_torch.ops import istft, magphase, polar, stft, torch_stft_config
from audio_inpainting_torch.parallel.batch import clip_bytes, clip_groups, clip_seeds

from . import base


class Job(base.Job):
    def __init__(self, driver, req):
        super().__init__(driver, req)
        if driver.entry == "serve":
            self._serve()
        elif driver.entry == "facade":
            self._facade()
        else:
            raise ValueError(f"the unet driver has no entry {driver.entry!r}")

    def _serve(self):
        d, dev = self.driver, self.driver.device
        cfg = torch_stft_config(d.config["stft"]["n_fft"], d.config["stft"]["hop"])
        with d.span("analysis"):
            clips = []
            for x in self.req.damaged:
                mag, phase = magphase(stft(torch.tensor(x, device=dev), cfg))
                bad = np.zeros(mag.shape[1], bool)
                bad[silent_frame_columns(x, mag.shape[1], cfg.hop, threshold=1e-4,
                                         silent_fraction=0.9, device=dev)] = True
                clips.append((mag.cpu().numpy(), phase, bad))
            f, t = clips[0][0].shape
            t_pad = t + (-t) % 32
            mags = np.stack([np.pad(m, ((0, (-f) % 4), (0, t_pad - t))) for m, _, _ in clips])
            keep = np.stack([np.pad(~b, (0, t_pad - t), constant_values=True)
                             for _, _, b in clips]).astype(np.float32)
            masks = np.broadcast_to(keep[:, None, :], mags.shape).copy()
            masks[:, f:] = 1.0
            peak = np.maximum(mags.max(axis=(1, 2), keepdims=True), 1e-12)
            norm = (mags / peak).astype(np.float32)
            seeds = clip_seeds(self.req.seed, len(clips))
            syn = np.ones_like(masks)
            for i, s in enumerate(seeds):
                syn[i, :, :t] = training_stripes(torch.Generator().manual_seed(s), t,
                                                 masks[i, 0, :t] > 0)[None, :]
            valid = np.zeros_like(masks)
            valid[:, :f, :t] = 1.0
            valid *= masks
        with d.span("trainer_build"):
            g = len(clips)
            groups = clip_groups(g, clip_bytes("unet", d.train_cfg.bf16, *norm.shape[1:]), dev)
            if groups != [slice(0, g)]:
                raise RuntimeError(f"serve would train {g} clips in groups {groups}, "
                                   f"not the one group of {g} that this cell measures")
            self.trainer = UNetTrainer(
                torch.as_tensor(norm, device=dev), torch.as_tensor(masks * syn, device=dev),
                d.train_cfg, seeds,
                valid=torch.as_tensor(valid, device=dev),
                composite_mask=torch.as_tensor(masks, device=dev))
        n = self.req.damaged.shape[1]
        self._host = lambda final: final.cpu().numpy() * peak
        self._synth = lambda final: np.stack([
            istft(polar(torch.as_tensor(final[i, :m.shape[0], :m.shape[1]], device=dev),
                        phase), cfg, n).cpu().numpy()
            for i, (m, phase, _) in enumerate(clips)])

    def _facade(self):
        d, dev = self.driver, self.driver.device
        cfg = torch_stft_config(d.config["stft"]["n_fft"], d.config["stft"]["hop"])
        (x,) = self.req.damaged
        seed = self.req.seed
        with d.span("analysis"):
            mag, phase = magphase(stft(torch.tensor(x, device=dev), cfg))
            mag_max = mag.max().clamp_min(1e-12)
            bad = np.zeros(mag.shape[1], bool)
            bad[silent_frame_columns(x, mag.shape[1], cfg.hop, threshold=0.01,
                                     silent_fraction=0.8, device=dev)] = True
            keep = torch.as_tensor(~bad, dtype=torch.float32, device=dev)[None, :].expand(mag.shape)
            syn = training_stripes(torch.Generator().manual_seed(seed), mag.shape[1], ~bad)
            train_mask = keep * torch.as_tensor(syn, device=dev)[None, :]
        with d.span("trainer_build"):
            self.trainer = UNetTrainer(mag / mag_max, train_mask, d.train_cfg, seed,
                                       valid=keep, composite_mask=keep)

        self._host = lambda final: final
        self._synth = lambda final: istft(polar(final * mag_max, phase), cfg,
                                          len(x)).cpu().numpy()[None]

    def epoch(self):
        return self.trainer.epoch()

    def finish(self) -> np.ndarray:
        with self.driver.span("readout"):
            final = self._host(self.trainer.restore()[0])
        with self.driver.span("synthesis"):
            return self._synth(final)

    def nets(self):
        return {"": (self.trainer.model, self.trainer.opt)}


class Driver(base.Driver):
    Job = Job

    def __init__(self, config, traffic, device, span=None):
        super().__init__(config, traffic, device, span)
        self.train_cfg = UNetTrainConfig(
            epochs=traffic["epochs"], lr=config["optimizer"]["lr"], masked_loss=True,
            bf16=config["conv_dtype"] == "bfloat16")
