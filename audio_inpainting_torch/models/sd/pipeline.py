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
loop of eager steps. The random draws (the posterior sample and the
latent noise) come from seeded CPU generators behind ``_draw_posterior``
and ``_draw_noise``, copied to the device, so every device sees the same
numbers; the tests replace them with the JAX package's draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ...device import host_to_device, seeded_generator
from .scheduler import (SchedulerConfig, add_noise, alphas_cumprod, plms_init,
                        plms_step, plms_timesteps)
from .unet2d import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig

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
    mean, logvar = vae.encode(img)
    eps = host_to_device(_draw_posterior(seed, tuple(mean.shape)), img.device)
    return (mean + torch.exp(0.5 * logvar) * eps) * cfg.vae.scaling_factor


@torch.no_grad()
def _decode_latents(vae: AutoencoderKL, latents: torch.Tensor,
                    cfg: InpaintConfig) -> torch.Tensor:
    img = vae.decode(latents / cfg.vae.scaling_factor)
    return (img / 2.0 + 0.5).clamp(0.0, 1.0)


@torch.no_grad()
def _denoise_loop(unet: UNet2DCondition, init_latents: torch.Tensor,
                  hole_mask: torch.Tensor, context: torch.Tensor, seed: int,
                  cfg: InpaintConfig) -> torch.Tensor:
    """The PLMS inpaint loop, one UNet forward at batch 2 per evaluation.

    init_latents: (1, 4, h, w) clean image latents. hole_mask: (1, 1, h, w)
    1 = inpaint. context: (2, L, dim) [uncond; cond].
    """
    dev = init_latents.device
    acp = alphas_cumprod(cfg.sched)
    table = [int(t) for t in plms_timesteps(cfg.steps, cfg.sched)]
    noise = host_to_device(_draw_noise(seed, tuple(init_latents.shape)), dev)
    # strength 1.0 -> start from the fully-noised image latents, which at
    # t=timesteps[0] is statistically pure noise (diffusers semantics)
    latents = add_noise(init_latents, noise, table[0], acp)
    state = plms_init()
    for i, t in enumerate(table):
        eps_both = unet(torch.cat([latents, latents]),
                        torch.full((2,), float(t), device=dev), context)
        eps_u, eps_c = eps_both[0:1], eps_both[1:2]
        eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
        state, latents = plms_step(state, latents, eps, t, cfg.steps, acp,
                                   cfg.sched)
        # masked-latent composite: outside the hole, snap to the original
        # latents noised to the NEXT evaluation's level (clean at the end)
        proper = (init_latents if i == len(table) - 1
                  else add_noise(init_latents, noise, table[i + 1], acp))
        latents = (1.0 - hole_mask) * proper + hole_mask * latents
    return latents


def riffusion_inpaint_image(bundle: dict, image_rgb_u8: np.ndarray,
                            mask_u8: np.ndarray, prompt: str = PROMPT,
                            cfg: InpaintConfig = InpaintConfig(),
                            key: int = 0) -> np.ndarray:
    """Inpaint a square RGB uint8 image (512x512 in the reference) where
    mask_u8 == 255, on the device of the bundle's modules.

    bundle: the dict from loader.load_riffusion. Returns uint8 RGB.
    """
    if cfg.strength != 1.0:
        raise NotImplementedError(
            "only strength=1.0 (the reference's value) is supported; "
            "partial-strength would start the PLMS table mid-way")
    cfg = InpaintConfig(steps=cfg.steps, guidance_scale=cfg.guidance_scale,
                        strength=cfg.strength,
                        unet=bundle.get("unet_cfg", cfg.unet),
                        vae=bundle.get("vae_cfg", cfg.vae), sched=cfg.sched)
    unet, vae = bundle["unet_params"], bundle["vae_params"]
    dev = next(unet.parameters()).device
    img = torch.tensor(np.asarray(image_rgb_u8), dtype=torch.float32,
                       device=dev).permute(2, 0, 1)[None] / 127.5 - 1.0
    latents0 = _encode_image(vae, img, key, cfg)

    n_down = 2 ** (len(cfg.vae.block_out_channels) - 1)
    h, w = mask_u8.shape[0] // n_down, mask_u8.shape[1] // n_down
    hole = np.asarray(mask_u8, np.float32) / 255.0
    hole = hole.reshape(h, n_down, w, n_down).max(axis=(1, 3))  # any-damaged
    hole_mask = torch.tensor(hole, device=dev)[None, None]

    context = encode_prompt(bundle["tokenizer"], bundle["text_encoder"],
                            prompt).to(dev)
    latents = _denoise_loop(unet, latents0, hole_mask, context, key, cfg)
    out = _decode_latents(vae, latents, cfg)
    return torch.round(out[0] * 255.0).permute(1, 2, 0).to(torch.uint8).cpu().numpy()
