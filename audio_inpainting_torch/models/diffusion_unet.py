"""The time-conditioned spectrogram-image U-Net of the diffusion method.

The port of audio_inpainting_tpu/models/diffusion_unet.py (flax, NHWC) as
an NCHW ``nn.Module``: GroupNorm(8) + SiLU residual blocks, a sinusoidal
time embedding through a 128-wide MLP, three resolutions at base, 2x base
and 4x base channels, stride-2 3x3 convs down, 2x2 ConvTranspose up, skips
concatenated as [upsampled, encoder]. Fully convolutional: it trains on
small patches and samples at any multiple of 4. All of it runs in fp32.

Submodules are named after the flax tree, lower-cased, so conversion is a
table (``convert.flax_to_state_dict``): ``ResBlock_4/_FastConv3x3_1/kernel``
is ``res4.fconv1.weight``. flax names a module when it is built and the
model builds the outer call of a nested pair first, so the data passes
``dense1`` before ``dense0`` and ``res3`` before ``res2``. Two more flax
conventions are kept: "SAME" padding of a stride-2 3x3 conv on an even map
pads 0 rows before and 1 after (torch's padding=1 would pad 1 and 1), and
GroupNorm's epsilon is 1e-6 (torch's default is 1e-5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .unet import Conv, init_flax_style

GN_GROUPS = 8
GN_EPS = 1e-6      # flax nn.GroupNorm's default


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding (B, dim) of float t (B,) in [0, 1000)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    ang = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _group_norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, c, eps=GN_EPS)


def _pad_same_stride2(x: torch.Tensor) -> torch.Tensor:
    """flax's "SAME" pad of a 3x3, stride-2 conv: per spatial axis of
    length n the total is max((ceil(n/2) - 1) * 2 + 3 - n, 0), the smaller
    half before: (0, 1) on an even axis, (1, 1) on an odd one."""
    pads = []
    for n in (x.shape[3], x.shape[2]):            # F.pad lists the last axis first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ResBlock(nn.Module):
    """GroupNorm-SiLU-conv, plus the projected time embedding, then
    GroupNorm-SiLU-conv; a 1x1 conv on the skip where the width changes."""

    def __init__(self, cin: int, cout: int, temb_dim: int = 128):
        super().__init__()
        self.gn0 = _group_norm(cin)
        self.fconv0 = Conv(cin, cout, 3, padding=1)
        self.dense0 = nn.Linear(temb_dim, cout)
        self.gn1 = _group_norm(cout)
        self.fconv1 = Conv(cout, cout, 3, padding=1)
        self.conv0 = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.fconv0(F.silu(self.gn0(x)))
        h = h + self.dense0(F.silu(temb))[:, :, None, None]
        h = self.fconv1(F.silu(self.gn1(h)))
        if self.conv0 is not None:
            x = self.conv0(x)
        return x + h


class DiffusionUNet(nn.Module):
    """Epsilon predictor: (N, 1, H, W) at time t (N,) -> (N, 1, H, W);
    H and W multiples of 4. The output conv starts at zero."""

    def __init__(self, base: int = 32, temb_dim: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        c1, c2, c3 = base, base * 2, base * 4
        self.temb_dim = temb_dim
        self.dense0 = nn.Linear(temb_dim, temb_dim)
        self.dense1 = nn.Linear(temb_dim, temb_dim)
        self.fconv0 = Conv(1, c1, 3, padding=1)
        self.res0 = ResBlock(c1, c1, temb_dim)
        self.conv0 = Conv(c1, c2, 3, stride=2)
        self.res1 = ResBlock(c2, c2, temb_dim)
        self.conv1 = Conv(c2, c3, 3, stride=2)
        self.res2 = ResBlock(c3, c3, temb_dim)
        self.res3 = ResBlock(c3, c3, temb_dim)
        self.up0 = Conv(c3, c2, 2, stride=2, transpose=True)
        self.res4 = ResBlock(2 * c2, c2, temb_dim)
        self.up1 = Conv(c2, c1, 2, stride=2, transpose=True)
        self.res5 = ResBlock(2 * c1, c1, temb_dim)
        self.gn0 = _group_norm(c1)
        self.fconv1 = Conv(c1, 1, 3, padding=1)
        init_flax_style(self, generator)
        with torch.no_grad():
            self.fconv1.weight.zero_()

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(t, self.temb_dim)
        temb = self.dense0(F.silu(self.dense1(temb)))
        h1 = self.res0(self.fconv0(x), temb)
        h2 = self.res1(self.conv0(_pad_same_stride2(h1)), temb)
        d2 = self.conv1(_pad_same_stride2(h2))
        b = self.res2(self.res3(d2, temb), temb)
        h2u = self.res4(torch.cat([self.up0(b), h2], dim=1), temb)
        h1u = self.res5(torch.cat([self.up1(h2u), h1], dim=1), temb)
        return self.fconv1(F.silu(self.gn0(h1u)))
