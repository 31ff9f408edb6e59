"""Riffusion / SD masked-latent inpainting.

The port of audio_inpainting_tpu/models/sd/pipeline.py. It mirrors the
reference's ``StableDiffusionInpaintPipeline('riffusion/riffusion-model-v1')``
call (main_diffusion_gap.py:58-67: prompt "high quality audio, ambient
sound, seamless transition", 50 steps, strength 1.0). Riffusion is a plain
SD v1 fine-tune with a 4-channel UNet, so diffusers runs the masked-latent
algorithm: pure-noise init (strength 1.0), classifier-free guidance at 7.5,
PLMS denoising, and after every step the region outside the mask is
replaced by the original image's latents noised to the next step's level
(clean at the final step).

Both CFG branches go through one UNet forward at batch 2. The JAX package
compiles the 51-evaluation loop into one program; here it is a Python
loop of eager steps, ``InpaintSampler``, which a caller can also drive one
evaluation at a time. The spans ``sd.encode``, ``sd.step`` and
``sd.decode`` (utils/profiling.py) mark the VAE calls and each
evaluation. The random draws (the posterior sample and the
latent noise) come from seeded CPU generators behind ``_draw_posterior``
and ``_draw_noise``, copied to the device, so every device sees the same
numbers; the tests replace them with the JAX package's draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ...device import host_to_device, seeded_generator
from ...utils.profiling import span
from .scheduler import (SchedulerConfig, add_noise, alphas_cumprod, plms_init,
                        plms_step, plms_timesteps)
from .unet2d import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig, sample_latent

PROMPT = "high quality audio, ambient sound, seamless transition"


@dataclass(frozen=True)
class InpaintConfig:
    steps: int = 50                  # reference num_inference_steps=50
    guidance_scale: float = 7.5      # diffusers default (reference omits it)
    strength: float = 1.0            # reference strength=1.0
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    sched: SchedulerConfig = field(default_factory=SchedulerConfig)


def encode_prompt(tokenizer, text_encoder, prompt: str) -> torch.Tensor:
    """(2, 77, ctx_dim) float32 on the text encoder's device — row 0
    unconditional, row 1 the prompt."""
    toks = tokenizer([""] + [prompt], padding="max_length",
                     max_length=tokenizer.model_max_length, truncation=True,
                     return_tensors="pt")
    ids = torch.as_tensor(toks.input_ids)
    dev = getattr(text_encoder, "device", None)
    with torch.no_grad():
        out = text_encoder(ids if dev is None else ids.to(dev)).last_hidden_state
    return torch.as_tensor(out, dtype=torch.float32)


def _draw_posterior(seed: int, shape: tuple[int, ...]) -> torch.Tensor:
    """The VAE posterior's standard-normal sample, a CPU tensor (1, 4, h, w)."""
    return torch.randn(shape, generator=seeded_generator(seed, 0))


def _draw_noise(seed: int, shape: tuple[int, ...]) -> torch.Tensor:
    """The latent noise of the loop, a CPU tensor (1, 4, h, w)."""
    return torch.randn(shape, generator=seeded_generator(seed, 1))


@torch.no_grad()
def _encode_image(vae: AutoencoderKL, img: torch.Tensor, seed: int,
                  cfg: InpaintConfig) -> torch.Tensor:
    """[-1, 1] NCHW image -> scaled latents (sampled posterior)."""
    with span("sd.encode", height=img.shape[2], width=img.shape[3]):
        mean, logvar = vae.encode(img)
        eps = host_to_device(_draw_posterior(seed, tuple(mean.shape)), img.device)
        return sample_latent(mean, logvar, eps) * cfg.vae.scaling_factor


@torch.no_grad()
def _decode_latents(vae: AutoencoderKL, latents: torch.Tensor,
                    cfg: InpaintConfig) -> torch.Tensor:
    with span("sd.decode", height=latents.shape[2], width=latents.shape[3]):
        img = vae.decode(latents / cfg.vae.scaling_factor)
        return (img / 2.0 + 0.5).clamp(0.0, 1.0)


def _rgb_u8(img: torch.Tensor) -> np.ndarray:
    """A decoded (1, 3, H, W) image in [0, 1] as uint8 RGB (H, W, 3)."""
    return torch.round(img[0] * 255.0).permute(1, 2, 0).to(torch.uint8).cpu().numpy()


def _config_for(bundle: dict, cfg: InpaintConfig) -> InpaintConfig:
    """``cfg`` with the bundle's UNet and VAE configurations."""
    if cfg.strength != 1.0:
        raise NotImplementedError(
            "only strength=1.0 (the reference's value) is supported; "
            "partial-strength would start the PLMS table mid-way")
    return InpaintConfig(steps=cfg.steps, guidance_scale=cfg.guidance_scale,
                         strength=cfg.strength,
                         unet=bundle.get("unet_cfg", cfg.unet),
                         vae=bundle.get("vae_cfg", cfg.vae), sched=cfg.sched)


def _prepare(vae: AutoencoderKL, image_rgb_u8: np.ndarray, mask_u8: np.ndarray,
             key: int, cfg: InpaintConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The canvas's clean latents (1, 4, h, w) and the latent hole mask
    (1, 1, h, w), 1 = inpaint: a latent cell is as damaged as the most
    damaged pixel of its block."""
    dev = next(vae.parameters()).device
    img = torch.tensor(np.asarray(image_rgb_u8), dtype=torch.float32,
                       device=dev).permute(2, 0, 1)[None] / 127.5 - 1.0
    latents0 = _encode_image(vae, img, key, cfg)
    n_down = 2 ** (len(cfg.vae.block_out_channels) - 1)
    h, w = mask_u8.shape[0] // n_down, mask_u8.shape[1] // n_down
    hole = np.asarray(mask_u8, np.float32) / 255.0
    hole = hole.reshape(h, n_down, w, n_down).max(axis=(1, 3))  # any-damaged
    return latents0, torch.tensor(hole, device=dev)[None, None]


class InpaintSampler:
    """The masked-latent inpaint loop, one evaluation at a time.

    ``start`` encodes the canvas and draws the posterior sample and the
    latent noise; each ``step`` is one evaluation: the UNet at batch 2 for
    both CFG branches, the guidance, ``plms_step`` and the composite that
    snaps the region outside the hole to the original latents noised to
    the next evaluation's level (clean after the last); ``finish`` decodes
    the latents. ``len(table)`` evaluations (steps + 1 for PLMS) make a
    sample. ``_denoise_loop`` and ``riffusion_inpaint_image`` run this
    loop, so a caller that drives it step by step computes what they do.

    State: ``latents``, the PLMS history ``plms`` and ``index``, the next
    evaluation's entry of ``table``.
    """

    def __init__(self, unet: UNet2DCondition, init_latents: torch.Tensor,
                 hole_mask: torch.Tensor, context: torch.Tensor, seed: int,
                 cfg: InpaintConfig, vae: AutoencoderKL | None = None):
        """init_latents: (1, 4, h, w) clean image latents. hole_mask:
        (1, 1, h, w) 1 = inpaint. context: (2, L, dim) [uncond; cond]."""
        self.unet, self.vae, self.cfg = unet, vae, cfg
        self.init_latents, self.hole_mask, self.context = init_latents, hole_mask, context
        self.acp = alphas_cumprod(cfg.sched)
        self.table = [int(t) for t in plms_timesteps(cfg.steps, cfg.sched)]
        self.noise = host_to_device(_draw_noise(seed, tuple(init_latents.shape)),
                                    init_latents.device)
        # strength 1.0 -> start from the fully-noised image latents, which at
        # t=timesteps[0] is statistically pure noise (diffusers semantics)
        self.latents = add_noise(init_latents, self.noise, self.table[0], self.acp)
        self.plms = plms_init()
        self.index = 0

    @classmethod
    def start(cls, bundle: dict, image_rgb_u8: np.ndarray, mask_u8: np.ndarray,
              context: torch.Tensor, key: int = 0,
              cfg: InpaintConfig = InpaintConfig()) -> "InpaintSampler":
        """A sampler over a square RGB uint8 canvas, inpainting where
        ``mask_u8`` == 255, on the device of the bundle's modules (a
        ``load_riffusion`` dict or one with the same module keys)."""
        cfg = _config_for(bundle, cfg)
        vae = bundle["vae_params"]
        latents0, hole_mask = _prepare(vae, image_rgb_u8, mask_u8, key, cfg)
        return cls(bundle["unet_params"], latents0, hole_mask,
                   context.to(latents0.device), key, cfg, vae)

    @property
    def done(self) -> bool:
        return self.index >= len(self.table)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One evaluation; returns the guided noise estimate (1, 4, h, w)."""
        if self.done:
            raise RuntimeError(f"the sampler has run all {len(self.table)} evaluations")
        cfg, i = self.cfg, self.index
        t = self.table[i]
        with span("sd.step", index=i, t=t):
            latents = self.latents
            eps_both = self.unet(torch.cat([latents, latents]),
                                 torch.full((2,), float(t), device=latents.device),
                                 self.context)
            eps_u, eps_c = eps_both[0:1], eps_both[1:2]
            eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
            self.plms, latents = plms_step(self.plms, latents, eps, t, cfg.steps, self.acp,
                                           cfg.sched)
            # masked-latent composite: outside the hole, snap to the original
            # latents noised to the NEXT evaluation's level (clean at the end)
            proper = (self.init_latents if i == len(self.table) - 1
                      else add_noise(self.init_latents, self.noise, self.table[i + 1], self.acp))
            self.latents = (1.0 - self.hole_mask) * proper + self.hole_mask * latents
            self.index = i + 1
        return eps

    def finish(self) -> np.ndarray:
        """The latents decoded: uint8 RGB (H, W, 3)."""
        return _rgb_u8(_decode_latents(self.vae, self.latents, self.cfg))


def _denoise_loop(unet: UNet2DCondition, init_latents: torch.Tensor,
                  hole_mask: torch.Tensor, context: torch.Tensor, seed: int,
                  cfg: InpaintConfig) -> torch.Tensor:
    """The PLMS inpaint loop (``InpaintSampler``'s evaluations, one UNet
    forward at batch 2 each); returns the latents before decode.

    init_latents: (1, 4, h, w) clean image latents. hole_mask: (1, 1, h, w)
    1 = inpaint. context: (2, L, dim) [uncond; cond].
    """
    sampler = InpaintSampler(unet, init_latents, hole_mask, context, seed, cfg)
    while not sampler.done:
        sampler.step()
    return sampler.latents


def riffusion_inpaint_image(bundle: dict, image_rgb_u8: np.ndarray,
                            mask_u8: np.ndarray, prompt: str = PROMPT,
                            cfg: InpaintConfig = InpaintConfig(),
                            key: int = 0) -> np.ndarray:
    """Inpaint a square RGB uint8 image (512x512 in the reference) where
    mask_u8 == 255, on the device of the bundle's modules.

    bundle: the dict from loader.load_riffusion; a ``context`` entry, a
    precomputed prompt encoding (2, 77, dim), stands in for its tokenizer
    and text encoder (``prompt`` is then not read). Returns uint8 RGB.
    """
    cfg = _config_for(bundle, cfg)
    unet, vae = bundle["unet_params"], bundle["vae_params"]
    latents0, hole_mask = _prepare(vae, image_rgb_u8, mask_u8, key, cfg)
    context = bundle.get("context")
    if context is None:
        context = encode_prompt(bundle["tokenizer"], bundle["text_encoder"], prompt)
    context = context.to(latents0.device)
    latents = _denoise_loop(unet, latents0, hole_mask, context, key, cfg)
    return _rgb_u8(_decode_latents(vae, latents, cfg))
