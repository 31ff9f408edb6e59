"""AutoencoderKL, the Stable Diffusion v1 VAE.

The port of audio_inpainting_tpu/models/sd/vae.py (flax, NHWC) as NCHW
``nn.Module``s whose attribute tree spells diffusers' torch keys
(tests/golden/sd_v1_manifest.json: 248 tensors). Every norm has eps 1e-6;
the mid-block attention has one head at scale 1/sqrt(c) and the modern
keys ``group_norm``, ``to_q``/``to_k``/``to_v``, ``to_out.0`` (the loader
takes the legacy names too); the downsampler pads (0, 1) on H and W and
runs a VALID stride-2 conv; the upsampler is nearest at 2x.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.nn.functional as F
from torch import nn

from .unet2d import Block, attention


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215  # SD v1 latent scale

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                         norm_groups=4)


class VAEResnet(nn.Module):
    """ResnetBlock2D without time embedding (VAE flavor)."""

    def __init__(self, cin: int, cout: int, groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial positions (VAE mid block)."""

    def __init__(self, c: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c), nn.Dropout(0.0)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.to_out[0](attention(self.to_q(y), self.to_k(y), self.to_v(y), 1))
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class VAEDownsample(nn.Module):
    """Stride-2 conv after the VAE's asymmetric (0, 1) pad."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _run_block(block: Block, h):
    for resnet in block.resnets:
        h = resnet(h)
    for sampler in block.samplers:
        h = sampler(h)
    return h


def _mid(ch: int, groups: int) -> Block:
    return Block([VAEResnet(ch, ch, groups), VAEResnet(ch, ch, groups)],
                 [VAEAttention(ch, groups)])


def _run_mid(mid: Block, h):
    h = mid.resnets[0](h)
    h = mid.attentions[0](h)
    return mid.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs, g = cfg.block_out_channels, cfg.norm_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        blocks, cur = [], chs[0]
        for i, ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VAEResnet(cur, ch, g))
                cur = ch
            sampler = VAEDownsample(ch) if i < len(chs) - 1 else None
            blocks.append(Block(resnets, sampler=sampler, kind="downsamplers"))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid(cur, g)
        self.conv_norm_out = nn.GroupNorm(g, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = _run_block(block, h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid(rev[0], g)
        blocks, cur = [], rev[0]
        for i, ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VAEResnet(cur, ch, g))
                cur = ch
            sampler = VAEUpsample(ch) if i < len(rev) - 1 else None
            blocks.append(Block(resnets, sampler=sampler, kind="upsamplers"))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            h = _run_block(block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """NCHW. encode -> (mean, logvar) latent moments; decode latents."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
