"""The port's models: the spectrogram U-Net, GAN and diffusion U-Net here;
Stable Diffusion v1 / Riffusion in models/sd/ (imported as
``audio_inpainting_torch.models.sd``)."""

from .diffusion_unet import DiffusionUNet, ResBlock, timestep_embedding
from .unet import (BN_MOMENTUM, BNLeaky, Discriminator, GeneratorUNet,
                   SimpleUNet, init_flax_style, pad_to_multiple,
                   patchgan_map_shape, stack_states, unstack_states)

__all__ = [
    "BN_MOMENTUM",
    "BNLeaky",
    "DiffusionUNet",
    "Discriminator",
    "GeneratorUNet",
    "ResBlock",
    "SimpleUNet",
    "init_flax_style",
    "pad_to_multiple",
    "patchgan_map_shape",
    "stack_states",
    "timestep_embedding",
    "unstack_states",
]
