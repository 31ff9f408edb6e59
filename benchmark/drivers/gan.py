"""Requests through the port's per-clip GAN, in the order its entry points
call the port's public functions.

- ``part2``: Part 2's GAN leg (pipelines/part2.py, step 4) on one clip
  with its clean original: min-max [-1, 1] magnitudes, the mask
  ``norm > -0.95``, ``GANTrainer`` on the first init draw, the readout
  through the gap-scoped weight EMA, the iSTFT with the damaged phase.
  The mode-collapse retry (``gan_train_restore``'s second run) is the
  entry's own and is not run.

Every epoch is ``GANTrainer.epoch()``; the entry's own loop over the
epochs is the harness's.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_inpainting_torch.methods.neural import GANTrainConfig, GANTrainer
from audio_inpainting_torch.ops import istft, magphase, polar, stft, torch_stft_config

from . import base


class Job(base.Job):
    def __init__(self, driver, req):
        super().__init__(driver, req)
        if req.original is None:
            raise ValueError("the gan driver trains against the clean originals: "
                             "the traffic must give them")
        if driver.entry != "part2":
            raise ValueError(f"the gan driver has no entry {driver.entry!r}")
        self._part2()

    def _part2(self):
        d, dev = self.driver, self.driver.device
        cfg = torch_stft_config(d.config["stft"]["n_fft"], d.config["stft"]["hop"])
        (x,), (clean,) = self.req.damaged, self.req.original
        with d.span("analysis"):
            mag_d, phase_d = magphase(stft(torch.tensor(x, device=dev), cfg))
            lo, hi = mag_d.min(), mag_d.max()
            norm = (mag_d - lo) / (hi - lo) * 2.0 - 1.0
            keep = (norm > d.config["keep_threshold"]).to(torch.float32)
            real_mag, _ = magphase(stft(torch.tensor(clean, device=dev), cfg))
            real = (real_mag - lo) / (hi - lo) * 2.0 - 1.0
        with d.span("trainer_build"):
            self.trainer = GANTrainer(norm, real, keep, d.train_cfg, self.req.seed)
        self._host = lambda final: final
        self._synth = lambda final: istft(polar((final + 1.0) / 2.0 * (hi - lo) + lo, phase_d),
                                          cfg, len(x)).cpu().numpy()[None]

    def epoch(self):
        return self.trainer.epoch()

    def finish(self) -> np.ndarray:
        with self.driver.span("readout"):
            final = self._host(self.trainer.restore())
        with self.driver.span("synthesis"):
            return self._synth(final)

    def nets(self):
        t = self.trainer
        return {"g.": (t.g, t.g_opt), "d.": (t.d, t.d_opt)}

    def ema(self):
        t = self.trainer
        if t.ema is None:
            return None
        return {f"g.{name}": e for (name, _), e in zip(t.g.named_parameters(), t.ema)}


class Driver(base.Driver):
    Job = Job

    def __init__(self, config, traffic, device, span=None):
        super().__init__(config, traffic, device, span)
        o, loss, ema = config["optimizer"], config["loss"], config.get("ema") or {}
        self.train_cfg = GANTrainConfig(
            epochs=traffic["epochs"], lr=o["lr"], b1=o["betas"][0], b2=o["betas"][1],
            l1_weight=loss["l1_weight"], adv_weight=loss["adv_weight"],
            bf16=config["conv_dtype"] == "bfloat16", ema_decay=ema.get("decay", 0.0),
            ema_scope=ema.get("scope", "full"))
