"""UNet2DCondition, the Stable Diffusion v1 denoiser.

The port of audio_inpainting_tpu/models/sd/unet2d.py (flax, NHWC) as NCHW
``nn.Module``s. The attribute tree spells diffusers' torch keys directly,
so ``state_dict()`` of the full-width model is the checkpoint's layout
(tests/golden/sd_v1_manifest.json: 686 tensors) and a checkpoint loads
without renaming: ``nn.ModuleList`` gives ``down_blocks.{i}.resnets.{j}``,
``to_out`` is [Linear, Dropout] (keys ``to_out.0``), ``ff.net`` is [GEGLU,
Dropout, Linear] (``net.0.proj``, ``net.2``), and ``proj_in``/``proj_out``
are 1x1 convs as riffusion-v1-era checkpoints store them.

Conventions kept from the JAX package: ``attention_head_dim`` is the
number of heads (SD v1's naming), each of width ``ch // heads``; GroupNorm
eps 1e-5 in the resnets and the output norm, 1e-6 in Transformer2D's
norm; LayerNorm eps 1e-5; the timestep embedding puts cos first and
divides its exponent by ``half - freq_shift``; GEGLU's gate is flax's
tanh-approximated gelu; skips are concatenated [h, skip]; upsampling is
nearest at 2x. Attention is a plain matmul, a float32 softmax at scale
1/sqrt(dim_head) and a matmul, as the JAX package writes it (no Pallas
kernel there either).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sd_conv3x3
from ...utils.profiling import span


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8          # heads per attention layer
    norm_groups: int = 32
    # block types, outermost first (SD v1: cross-attn in all but the last)
    down_types: tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_types: tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D")
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(block_out_channels=(8, 16), layers_per_block=1,
                          cross_attention_dim=16, attention_head_dim=2,
                          norm_groups=4,
                          down_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                          up_types=("UpBlock2D", "CrossAttnUpBlock2D"))


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 1e4):
    """Sinusoidal timestep embedding (N, dim) of t (N,), diffusers
    convention."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = t[:, None].to(torch.float32) * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


def routes(c_in: int, hw: int, c_out: int) -> bool:
    """Whether a ``Conv3x3`` of c_in -> c_out channels over hw = H * W
    pixels takes the hand-written kernel on the card. From the kernel's
    time against cuDNN's at each such shape of the UNet at the CFG batch
    (PERF.md, the kernels' table): 1.2-3.3x faster at every c_in and
    c_out where H * W <= 32 * 32, and level at 64 * 64, where cuDNN's
    fp32 GEMMs already fill the card. So H * W alone decides."""
    return hw <= 32 * 32


def takes_kernel(shape, c_out: int, *, cuda: bool, fp32: bool, needs_grad: bool) -> bool:
    """Whether ``Conv3x3`` runs an input of ``shape`` (N, C, H, W) by the
    kernel (ops/sd_conv3x3.py): a CUDA fp32 tensor, no autograd graph to
    build, a shape that ``routes`` takes and the kernel tiles."""
    if not cuda or not fp32 or needs_grad or len(shape) != 4:
        return False
    n, c, h, w = shape
    return routes(c, h * w, c_out) and sd_conv3x3.takes(n, c, h, w)


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, cout, 3, padding=1)`` (the same parameters and
    keys), whose forward runs the hand-written kernel where
    ``takes_kernel`` says so, and F.conv2d otherwise: on the CPU always."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x):
        grad = torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad
                                            or self.bias.requires_grad)
        if takes_kernel(x.shape, self.out_channels, cuda=x.is_cuda,
                        fp32=x.dtype == torch.float32 and self.weight.dtype == torch.float32,
                        needs_grad=grad):
            return sd_conv3x3.sd_conv3x3(x, self.weight, self.bias)
        return super().forward(x)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-5)
        self.conv1 = Conv3x3(cin, cout)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-5)
        self.conv2 = Conv3x3(cout, cout)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def attention(q, k, v, heads: int):
    """softmax(q k^T / sqrt(d)) v over ``heads`` heads: q (B, Lq, H*d), k
    and v (B, Lk, H*d) -> (B, Lq, H*d). The scores and the softmax are
    float32. Each call is the span ``sd.attention``, with its shape as
    attributes."""
    b, lq, inner = q.shape
    d = inner // heads

    def split(x):
        return x.reshape(b, x.shape[1], heads, d).transpose(1, 2)

    with span("sd.attention", batch=b, heads=heads, q_tokens=lq, k_tokens=k.shape[1],
              head_dim=d):
        q, k, v = split(q), split(k), split(v)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        probs = scores.to(torch.float32).softmax(dim=-1).to(q.dtype)
        return torch.matmul(probs, v).transpose(1, 2).reshape(b, lq, inner)


class Attention(nn.Module):
    """Multi-head attention, diffusers parameter layout (to_q/k/v/out.0)."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Dropout(0.0)])

    def forward(self, x, context=None):
        context = x if context is None else context
        out = attention(self.to_q(x), self.to_k(context), self.to_v(context),
                        self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Dropout(0.0),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, context_dim, heads, dim_head)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, context_dim: int, heads: int, groups: int = 32):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, context_dim, heads, ch // heads)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.transformer_blocks[0](y, context)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv3x3(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Block(nn.Module):
    """One resolution of a U-Net: ``resnets``, ``attentions`` (empty where
    the block has none) and a ``downsamplers`` or ``upsamplers`` list of
    one sampler, or none (kept in ``samplers`` for the forward pass)."""

    def __init__(self, resnets, attentions=(), sampler=None, kind: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        self.samplers = [] if sampler is None else [sampler]
        if sampler is not None:
            self.add_module(kind, nn.ModuleList(self.samplers))


class UNet2DCondition(nn.Module):
    """Input (N, in_channels, H, W) NCHW, timesteps (N,), context
    (N, L, cross_attention_dim) -> (N, out_channels, H, W)."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        chs = cfg.block_out_channels
        ch0, temb_dim, g = chs[0], chs[0] * 4, cfg.norm_groups
        heads, ctx = cfg.attention_head_dim, cfg.cross_attention_dim
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb_dim)

        skips, cur, down = [ch0], ch0, []
        for i, (btype, ch) in enumerate(zip(cfg.down_types, chs)):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(cur, ch, temb_dim, g))
                cur = ch
                if btype == "CrossAttnDownBlock2D":
                    attns.append(Transformer2D(ch, ctx, heads, g))
                skips.append(ch)
            sampler = None
            if i < len(chs) - 1:
                sampler = Downsample2D(ch)
                skips.append(ch)
            down.append(Block(resnets, attns, sampler, "downsamplers"))
        self.down_blocks = nn.ModuleList(down)

        self.mid_block = Block([ResnetBlock2D(cur, cur, temb_dim, g),
                                 ResnetBlock2D(cur, cur, temb_dim, g)],
                                [Transformer2D(cur, ctx, heads, g)])

        up = []
        for i, (btype, ch) in enumerate(zip(cfg.up_types, reversed(chs))):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(cur + skips.pop(), ch, temb_dim, g))
                cur = ch
                if btype == "CrossAttnUpBlock2D":
                    attns.append(Transformer2D(ch, ctx, heads, g))
            sampler = Upsample2D(ch) if i < len(chs) - 1 else None
            up.append(Block(resnets, attns, sampler, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, x, timesteps, context):
        cfg = self.cfg
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb)

        h = self.conv_in(x)
        skips = [h]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if len(block.attentions):
                    h = block.attentions[j](h, context)
                skips.append(h)
            for sampler in block.samplers:
                h = sampler(h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, temb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    h = block.attentions[j](h, context)
            for sampler in block.samplers:
                h = sampler(h)

        return self.conv_out(F.silu(self.conv_norm_out(h)))


def conv3x3_calls(cfg: UNetConfig, batch: int, height: int, width: int) -> dict:
    """{((N, C, H, W), C_out): calls} of the ``Conv3x3`` convolutions in one
    forward of ``UNet2DCondition(cfg)`` on (batch, in_channels, height,
    width) latents, by a forward on the meta device."""
    with torch.device("meta"):
        model = UNet2DCondition(cfg)
    calls: dict = {}

    def count(mod, args, out):
        key = (tuple(args[0].shape), mod.out_channels)
        calls[key] = calls.get(key, 0) + 1

    for mod in model.modules():
        if isinstance(mod, Conv3x3):
            mod.register_forward_hook(count)
    with torch.no_grad():
        model(torch.empty((batch, cfg.in_channels, height, width), device="meta"),
              torch.empty(batch, device="meta"),
              torch.empty((batch, 1, cfg.cross_attention_dim), device="meta"))
    return calls
