"""Requests through the port's Riffusion path, one denoising evaluation at a
time.

- ``riffusion``: ``riffusion_restore_audio``'s three parts, as it calls
  them (methods/diffusion.py): ``riffusion_analysis`` (the log-spectrogram
  image, its mask and the square canvas), the masked-latent sampler
  (models/sd/pipeline.py ``InpaintSampler``: ``start`` encodes the canvas
  and draws, each ``epoch`` is one ``step``, ``finish`` decodes), and
  ``riffusion_synthesis`` (resize back, Griffin-Lim, the fill's energy,
  the composite), the request's seed keying the draws.

The bundle is built once, at the first request, as ``load_riffusion``
builds it from a checkpoint: the port's ``load_module`` over a state dict,
here the weights drawn from that request's seed (``sd_inputs``), with the
prompt's encoding drawn likewise in the bundle's ``context`` in place of
CLIP. A request runs ``steps + 1`` evaluations (PLMS evaluates twice at
its second timestep), which the traffic's ``epochs`` must equal; an
evaluation asked of a request whose sample is done starts the request's
sample again.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_inpainting_torch.methods import diffusion
from audio_inpainting_torch.models import sd
from audio_inpainting_torch.models.sd import InpaintSampler

from .. import sd_inputs
from . import base


class Job(base.Job):
    def __init__(self, driver, req):
        super().__init__(driver, req)
        if driver.entry != "riffusion":
            raise ValueError(f"the riffusion driver has no entry {driver.entry!r}")
        (x,) = req.damaged
        d = driver
        with d.span("analysis"):
            self.analysis = diffusion.riffusion_analysis(x, d.config["sampler"]["canvas"], d.device)
        self._start()

    def _start(self):
        d, a = self.driver, self.analysis
        with d.span("trainer_build"):
            self.sampler = InpaintSampler.start(d.bundle, a.canvas, a.canvas_mask,
                                                d.bundle["context"], self.req.seed, d.inpaint)

    def epoch(self):
        if self.sampler.done:
            self._start()
        return self.sampler.step()

    def finish(self) -> np.ndarray:
        d = self.driver
        with d.span("readout"):
            rgb = self.sampler.finish()
        with d.span("synthesis"):
            audio = diffusion.riffusion_synthesis(self.analysis, rgb, self.req.seed,
                                                  fill_energy_ratio=d.config["fill_energy_ratio"],
                                                  device=d.device)
        return audio[None]

    def losses(self, ret) -> np.ndarray:
        return ret.detach().double().cpu().reshape(1, -1).numpy()

    def states(self, clone: bool = True) -> list[dict]:
        s, p = self.sampler, self.sampler.plms
        keep = (lambda t: None if t is None else t.clone()) if clone else (lambda t: t)
        return [{"latents": keep(s.latents), "ets": [keep(e) for e in p.ets],
                 "counter": p.counter, "cur_sample": keep(p.cur_sample), "index": s.index,
                 "weights_seed": self.driver.weights_seed}]


class Driver(base.Driver):
    Job = Job

    def __init__(self, config, traffic, device, span=None):
        super().__init__(config, traffic, device, span)
        steps = config["sampler"]["steps"]
        if traffic["epochs"] != steps + 1:
            raise ValueError(f"a request runs {steps + 1} evaluations ({steps} PLMS steps); "
                             f"the traffic asks {traffic['epochs']}")
        u, v, s = config["unet"], config["vae"], config["scheduler"]
        self.unet_cfg = sd.UNetConfig(
            in_channels=u["in_channels"], out_channels=u["out_channels"],
            block_out_channels=tuple(u["block_out_channels"]),
            layers_per_block=u["layers_per_block"], cross_attention_dim=u["cross_attention_dim"],
            attention_head_dim=u["attention_head_dim"], norm_groups=u["norm_num_groups"],
            down_types=tuple(u["down_block_types"]), up_types=tuple(u["up_block_types"]),
            flip_sin_to_cos=u["flip_sin_to_cos"], freq_shift=u["freq_shift"])
        self.vae_cfg = sd.VAEConfig(
            in_channels=v["in_channels"], out_channels=v["out_channels"],
            latent_channels=v["latent_channels"], block_out_channels=tuple(v["block_out_channels"]),
            layers_per_block=v["layers_per_block"], norm_groups=v["norm_num_groups"],
            scaling_factor=v["scaling_factor"])
        self.inpaint = sd.InpaintConfig(
            steps=steps, guidance_scale=config["sampler"]["guidance_scale"],
            strength=config["sampler"]["strength"], unet=self.unet_cfg, vae=self.vae_cfg,
            sched=sd.SchedulerConfig(
                num_train_timesteps=s["num_train_timesteps"], beta_start=s["beta_start"],
                beta_end=s["beta_end"], steps_offset=s["steps_offset"],
                set_alpha_to_one=s["set_alpha_to_one"]))
        self.bundle, self.weights_seed = None, None

    def _module(self, cls, cfg, part: str):
        with torch.device("meta"):
            shapes = {k: tuple(t.shape) for k, t in cls(cfg).state_dict().items()}
        return sd.load_module(cls, cfg, sd_inputs.state(shapes, self.weights_seed, part,
                                                        self.device), self.device)

    def start(self, req):
        if self.bundle is None:
            self.weights_seed = req.seed
            c = self.config["context"]
            self.bundle = {"unet_params": self._module(sd.UNet2DCondition, self.unet_cfg, "unet"),
                           "vae_params": self._module(sd.AutoencoderKL, self.vae_cfg, "vae"),
                           "unet_cfg": self.unet_cfg, "vae_cfg": self.vae_cfg,
                           "context": sd_inputs.context(req.seed, c["length"], c["width"],
                                                        self.device)}
        return self.Job(self, req)
