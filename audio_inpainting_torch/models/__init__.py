from .unet import (BN_MOMENTUM, BatchNorm, Discriminator, GeneratorUNet,
                   SimpleUNet, init_flax_style, pad_to_multiple,
                   patchgan_map_shape)

__all__ = [
    "BN_MOMENTUM",
    "BatchNorm",
    "Discriminator",
    "GeneratorUNet",
    "SimpleUNet",
    "init_flax_style",
    "pad_to_multiple",
    "patchgan_map_shape",
]
