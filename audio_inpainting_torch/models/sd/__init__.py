"""Stable Diffusion / Riffusion (reference main_diffusion_gap.py).

The port of audio_inpainting_tpu/models/sd/: UNet2DCondition +
AutoencoderKL + PLMS scheduler + masked-latent inpaint pipeline, with a
loader for local diffusers-layout checkpoints (the weights are not in the
repository; tests/golden/sd_v1_manifest.json holds the full-width key and
shape layout the modules reproduce). The JAX package's flax params carry
across through ``sd_flax_to_state_dict``.
"""

from ...convert import flax_to_torch_key, sd_flax_to_state_dict
from .loader import (load_module, load_riffusion, load_torch_weights,
                     match_checkpoint, read_safetensors)
from .pipeline import (PROMPT, InpaintConfig, InpaintSampler, encode_prompt,
                       riffusion_inpaint_image)
from .scheduler import (SchedulerConfig, add_noise, alphas_cumprod,
                        ddim_step, ddim_timesteps, plms_init, plms_step,
                        plms_timesteps)
from .unet2d import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig, sample_latent

__all__ = [
    "AutoencoderKL", "InpaintConfig", "InpaintSampler", "PROMPT", "SchedulerConfig",
    "UNet2DCondition", "UNetConfig", "VAEConfig", "add_noise",
    "alphas_cumprod", "ddim_step", "ddim_timesteps", "encode_prompt",
    "flax_to_torch_key", "load_module", "load_riffusion",
    "load_torch_weights", "match_checkpoint", "plms_init", "plms_step",
    "plms_timesteps", "read_safetensors", "riffusion_inpaint_image",
    "sd_flax_to_state_dict",
]
