"""Spectrogram U-Net / GAN models as torch ``nn.Module``s, NCHW.

The port of audio_inpainting_tpu/models/unet.py (flax, NHWC):

- SimpleUNet: 2-level U-Net; a block is 2x (Conv3x3 + ReLU); channels
  1 -> 16 -> 32 -> 64 bottleneck; ConvTranspose(k2, s2) ups; skips
  concatenated as [encoder, upsampled]; a 1x1 final conv.
- GeneratorUNet: the same topology with BatchNorm + LeakyReLU(0.2) blocks
  and a tanh output.
- Discriminator: three strided 4x4 convs (16/32/64 channels, BatchNorm
  after the 2nd and 3rd) and a 4x4 VALID head; returns logits.

Inputs are (N, 1, F, T) with F and T multiples of 4 (two 2x pools).
``dtype=torch.bfloat16`` runs the convs in bf16; parameters, BatchNorm, the
final conv (the Discriminator's head) and everything after stay fp32, as
in the JAX package.

``groups=G`` holds G independent nets in one module: the input is
(1, G, F, T), clip g in channel g, and every conv (the 1x1 head too) runs
with ``groups=G``, so G clips train in one set of launches. Channels are
clip-major: clip g's C channels are g*C .. g*C + C - 1 of each tensor,
parameters included (``stack_states``). Never fold the clips into the
batch dimension N instead: BatchNorm would pool its statistics over the
clips. With N = 1, flax's BatchNorm rule gives each clip's channels their
own statistics, as the single-clip net does.

Submodules are named after the flax module tree, lower-cased: flax's
``ConvBlock_3/Conv3x3_1/kernel`` is ``block3.conv1.weight`` here
(``convert.flax_to_state_dict``). Parameters start as flax's
``lecun_normal`` draws (``init_flax_style``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_leaky import bn_leaky_train

# BatchNorm running-average momentum of every BN of the models, flax's
# convention: running = BN_MOMENTUM * running + (1 - BN_MOMENTUM) * batch
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# the negative slope of every LeakyReLU of the GAN's nets
LEAKY_SLOPE = 0.2
# flax's variance_scaling "truncated_normal": std of a unit normal cut at
# +-2, by which the target std is divided
_TRUNC_STD = 0.87962566103423978


class Conv(nn.Module):
    """A conv with fp32 parameters computed in ``dtype``.

    weight is OIHW (flax's HWIO kernel, permuted). ``transpose=True`` makes
    it a ConvTranspose with weight (Ci, Co, kh, kw) and stride = kernel
    size: flax's ``nn.ConvTranspose(co, (2, 2), strides=(2, 2))``, whose
    kernel torch takes spatially flipped (convert.py flips it).

    ``cin`` and ``cout`` count one clip's channels; ``groups`` clips hold
    G times as many. Both forms stack the clips on the weight's first axis:
    Conv2d's (G*Co, Ci, kh, kw), ConvTranspose2d's (G*Ci, Co, kh, kw)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32,
                 transpose: bool = False, groups: int = 1):
        super().__init__()
        shape = (groups * cin, cout, k, k) if transpose else (groups * cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(groups * cout))
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype, self.transpose = dtype, transpose
        # flax's fan_in: kh * kw * C_in for both forms, per clip
        self.fan_in = cin * k * k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w, b = self.weight.to(dt), self.bias.to(dt)
        if self.transpose:
            return F.conv_transpose2d(x.to(dt), w, b, stride=self.stride,
                                      groups=self.groups)
        return F.conv2d(x.to(dt), w, b, stride=self.stride, padding=self.padding,
                        groups=self.groups)


class BNLeaky(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW channels, always in fp32, then the
    LeakyReLU(LEAKY_SLOPE) that follows every BatchNorm of the GAN's nets:
    the pair as one module, since the kernels compute them together.

    Train mode normalizes with the batch statistics and moves the running
    averages towards them by 1 - BN_MOMENTUM, with the *biased* batch
    variance (nn.BatchNorm2d would take the unbiased one): on a CUDA tensor
    by the hand-written kernels of ``ops/bn_leaky.py``, elsewhere by plain
    torch ops. Eval mode normalizes with the running averages. ``groups``
    clips hold ``channels`` each; with N = 1 every clip's channel has its
    own statistics."""

    def __init__(self, channels: int, groups: int = 1):
        super().__init__()
        channels *= groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            return bn_leaky_train(x, self.weight, self.bias, self.running_mean,
                                  self.running_var, BN_MOMENTUM, BN_EPS, LEAKY_SLOPE)
        x = F.batch_norm(x.to(torch.float32), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, BN_EPS)
        return F.leaky_relu(x, LEAKY_SLOPE)


class ConvBlock(nn.Module):
    """2x (Conv3x3 + ReLU)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype, groups: int = 1):
        super().__init__()
        self.conv0 = Conv(cin, cout, 3, padding=1, dtype=dtype, groups=groups)
        self.conv1 = Conv(cout, cout, 3, padding=1, dtype=dtype, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv1(F.relu(self.conv0(x))))


class BNLeakyConvBlock(nn.Module):
    """2x (Conv3x3 + BatchNorm + LeakyReLU(0.2)); the output is fp32."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype, groups: int = 1):
        super().__init__()
        self.conv0 = Conv(cin, cout, 3, padding=1, dtype=dtype, groups=groups)
        self.bn0 = BNLeaky(cout, groups)
        self.conv1 = Conv(cout, cout, 3, padding=1, dtype=dtype, groups=groups)
        self.bn1 = BNLeaky(cout, groups)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.bn1(self.conv1(self.bn0(self.conv0(x), train)), train)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2)


def _cat(skip: torch.Tensor, up: torch.Tensor, groups: int) -> torch.Tensor:
    """[encoder, upsampled] on channels, in the wider of the two dtypes,
    per clip: clip g's encoder channels, then its upsampled ones (a plain
    concatenation would hand clip g's next conv another clip's channels)."""
    dt = torch.promote_types(skip.dtype, up.dtype)
    n, _, h, w = skip.shape
    return torch.cat([skip.to(dt).reshape(n, groups, -1, h, w),
                      up.to(dt).reshape(n, groups, -1, h, w)], dim=2).reshape(n, -1, h, w)


class SimpleUNet(nn.Module):
    """(N, G, F, T) -> (N, G, F, T) for ``groups`` = G nets; F, T multiples
    of 4."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, groups: int = 1):
        super().__init__()
        g = self.groups = groups
        self.block0 = ConvBlock(1, 16, dtype, g)
        self.block1 = ConvBlock(16, 32, dtype, g)
        self.block2 = ConvBlock(32, 64, dtype, g)
        self.up0 = Conv(64, 32, 2, stride=2, dtype=dtype, transpose=True, groups=g)
        self.block3 = ConvBlock(64, 32, dtype, g)
        self.up1 = Conv(32, 16, 2, stride=2, dtype=dtype, transpose=True, groups=g)
        self.block4 = ConvBlock(32, 16, dtype, g)
        self.conv0 = Conv(16, 1, 1, groups=g)
        init_flax_style(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        e1 = self.block0(x)
        e2 = self.block1(_pool(e1))
        b = self.block2(_pool(e2))
        d2 = self.block3(_cat(e2, self.up0(b), g))
        d1 = self.block4(_cat(e1, self.up1(d2), g))
        return self.conv0(d1.to(torch.float32))


class GeneratorUNet(nn.Module):
    """GAN generator: the SimpleUNet topology with BatchNorm/LeakyReLU
    blocks and a tanh output."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, groups: int = 1):
        super().__init__()
        g = self.groups = groups
        self.block0 = BNLeakyConvBlock(1, 16, dtype, g)
        self.block1 = BNLeakyConvBlock(16, 32, dtype, g)
        self.block2 = BNLeakyConvBlock(32, 64, dtype, g)
        self.up0 = Conv(64, 32, 2, stride=2, dtype=dtype, transpose=True, groups=g)
        self.block3 = BNLeakyConvBlock(64, 32, dtype, g)
        self.up1 = Conv(32, 16, 2, stride=2, dtype=dtype, transpose=True, groups=g)
        self.block4 = BNLeakyConvBlock(32, 16, dtype, g)
        self.conv0 = Conv(16, 1, 1, groups=g)
        init_flax_style(self, generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        g = self.groups
        e1 = self.block0(x, train)
        e2 = self.block1(_pool(e1), train)
        b = self.block2(_pool(e2), train)
        d2 = self.block3(_cat(e2, self.up0(b), g), train)
        d1 = self.block4(_cat(e1, self.up1(d2), g), train)
        return torch.tanh(self.conv0(d1))


class Discriminator(nn.Module):
    """Strided-conv PatchGAN discriminator. Returns LOGITS: the loss is BCE
    from logits (the reference's Sigmoid + BCELoss survives saturation only
    through torch's log clamp)."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, groups: int = 1):
        super().__init__()
        g = groups
        self.conv0 = Conv(1, 16, 4, stride=2, padding=1, dtype=dtype, groups=g)
        self.conv1 = Conv(16, 32, 4, stride=2, padding=1, dtype=dtype, groups=g)
        self.bn0 = BNLeaky(32, g)
        self.conv2 = Conv(32, 64, 4, stride=2, padding=1, dtype=dtype, groups=g)
        self.bn1 = BNLeaky(64, g)
        self.conv3 = Conv(64, 1, 4, groups=g)
        init_flax_style(self, generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = F.leaky_relu(self.conv0(x), LEAKY_SLOPE)
        x = self.bn0(self.conv1(x), train)
        return self.conv3(self.bn1(self.conv2(x), train))


def patchgan_map_shape(f: int, t: int) -> tuple[int, int]:
    """The Discriminator's logits map (rows, columns) for an (f, t) input;
    a side <= 0 means the map is empty (the input is under the PatchGAN's
    receptive floor)."""
    for _ in range(3):                       # 4x4, stride 2, padding 1
        f, t = (f - 2) // 2 + 1, (t - 2) // 2 + 1
    return f - 3, t - 3                      # 4x4 VALID head


@torch.no_grad()
def init_flax_style(model: nn.Module,
                    generator: torch.Generator | None = None) -> nn.Module:
    """flax's initial values: conv and dense kernels ``lecun_normal`` (a
    normal cut at +-2 std, std = sqrt(1 / fan_in) / 0.8796, fan_in =
    kh * kw * C_in for a conv, in_features for a dense layer), biases 0,
    BatchNorm and GroupNorm scale 1 and bias 0, running mean 0 and variance
    1. Draws from ``generator`` (torch's default when None)."""
    for mod in model.modules():
        fan_in = (mod.fan_in if isinstance(mod, Conv)
                  else mod.in_features if isinstance(mod, nn.Linear) else None)
        if fan_in is not None:
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, (BNLeaky, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BNLeaky):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    return model


def stack_states(states: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """G single-clip state dicts of one model class as the state dict of
    its ``groups=G`` form: every tensor concatenated on its first axis,
    clip-major. That axis is the output channel of a Conv2d weight, the
    INPUT channel of a ConvTranspose2d weight ((G*Ci, Co, kh, kw)), and the
    channel of a bias or a BatchNorm tensor."""
    return {k: torch.cat([s[k] for s in states]) for k in states[0]}


def unstack_states(state: dict[str, torch.Tensor],
                   groups: int) -> list[dict[str, torch.Tensor]]:
    """``stack_states``'s inverse: the ``groups`` single-clip state dicts."""
    parts = {k: v.chunk(groups) for k, v in state.items()}
    return [{k: p[g] for k, p in parts.items()} for g in range(groups)]


def pad_to_multiple(x: torch.Tensor, multiple: int = 4
                    ) -> tuple[torch.Tensor, tuple[int, int]]:
    """Pad (F, T) with zeros up to multiples of ``multiple``; return the
    pad amounts."""
    f, t = x.shape
    pf, pt = (-f) % multiple, (-t) % multiple
    return F.pad(x, (0, pt, 0, pf)), (pf, pt)
