"""Stable Diffusion v1 / Riffusion masked-latent inpainting of a damaged
clip, in plain PyTorch and NumPy: the SD kind's reference
(``checks/denoising.py``).

Written from diffusers' equations (``UNet2DConditionModel``,
``AutoencoderKL``, ``PNDMScheduler`` with ``skip_prk_steps``, the legacy
4-channel path of ``StableDiffusionInpaintPipeline``) and from the
reference script's codec (main_diffusion_gap.py:22-74), as functions over
diffusers-keyed state dicts (``unet_shapes``, ``vae_shapes``). It imports
nothing of the port. Float32, with TF32 off unless the precision asks for
it.

Departures from the published description, each a convention of the port
that the reference follows, so that it judges the port's arithmetic and
not its choices:

- GEGLU's gate is the tanh-approximated GELU (flax's default); diffusers
  uses the exact one.
- The timestep embedding puts cos first and divides its exponent by
  ``half - freq_shift``, as SD v1's config (``flip_sin_to_cos``,
  ``freq_shift`` 0) has diffusers do.
- The noise table: ``alphas_cumprod`` is taken in float64 and rounded once
  to float32 (diffusers takes it in float32); each coefficient is a
  float32 number.
- At strength 1.0 the loop starts from the clean latents noised to the
  first timestep; diffusers starts from the noise alone.
- The latent mask: a latent cell takes the largest value of its block of
  the resized mask over 255 (as damaged as its most damaged pixel);
  diffusers binarises at 0.5 and resizes by nearest neighbour.
- The canvas is pixels / 127.5 - 1; diffusers takes 2 x / 255 - 1.
- The draws: the posterior sample and the latent noise from CPU
  generators seeded by (seed, 0) and (seed, 1) through numpy's
  SeedSequence; Griffin-Lim's initial phase uniform in [-pi, pi) from a
  CPU generator seeded by the seed (torchaudio draws rand x 2 pi), its
  normalisation by |a| clamped at 1e-16 (torchaudio adds 1e-16).
- The prompt's CLIP encoding is drawn from the seed (``sd_inputs``: the
  configuration's ``reduced``), as are the weights.
- After Griffin-Lim, the fill is scaled to 0.12 of the energy around the
  hole and crossfaded into the damaged clip over its wholly damaged
  columns (the port's documented post-processing; the script returns the
  whole Griffin-Lim waveform).

The PIL bicubic resize of the canvas is Pillow's 8-bit resample (22
fractional bits, a horizontal pass then a vertical one), written out
here as products of integer-valued float64 matrices, exact in float64.

Precision (``prec``): "fp32", TF32 off; "tf32", TF32 on (the control on
the card); "bf16", every weight and the input of every convolution and
linear layer rounded to bfloat16 (the control where there is no TF32);
"fp64", the weights, the loop's tensors and the decode in float64 (how
far a sound float32 computation may stand from the float32 reference).
The attention is computed head by head, so that the (Lq, Lk) scores of
one head are held at a time (134 MB at 4,096 tokens and batch 2).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import sd_inputs
from .nets import precision
from .stft import istft, stft

_PRECISION_BITS = 22


# ------------------------------------------------------------ weights -----

def _resnet_shapes(out: dict, name: str, cin: int, cout: int, temb: int | None) -> None:
    out[f"{name}.norm1.weight"] = out[f"{name}.norm1.bias"] = (cin,)
    out[f"{name}.conv1.weight"], out[f"{name}.conv1.bias"] = (cout, cin, 3, 3), (cout,)
    if temb is not None:
        out[f"{name}.time_emb_proj.weight"] = (cout, temb)
        out[f"{name}.time_emb_proj.bias"] = (cout,)
    out[f"{name}.norm2.weight"] = out[f"{name}.norm2.bias"] = (cout,)
    out[f"{name}.conv2.weight"], out[f"{name}.conv2.bias"] = (cout, cout, 3, 3), (cout,)
    if cin != cout:
        out[f"{name}.conv_shortcut.weight"] = (cout, cin, 1, 1)
        out[f"{name}.conv_shortcut.bias"] = (cout,)


def _transformer_shapes(out: dict, name: str, c: int, ctx: int) -> None:
    out[f"{name}.norm.weight"] = out[f"{name}.norm.bias"] = (c,)
    out[f"{name}.proj_in.weight"], out[f"{name}.proj_in.bias"] = (c, c, 1, 1), (c,)
    b = f"{name}.transformer_blocks.0"
    for attn, kv in (("attn1", c), ("attn2", ctx)):
        out[f"{b}.{attn}.to_q.weight"] = (c, c)
        out[f"{b}.{attn}.to_k.weight"] = out[f"{b}.{attn}.to_v.weight"] = (c, kv)
        out[f"{b}.{attn}.to_out.0.weight"], out[f"{b}.{attn}.to_out.0.bias"] = (c, c), (c,)
    for k in (1, 2, 3):
        out[f"{b}.norm{k}.weight"] = out[f"{b}.norm{k}.bias"] = (c,)
    out[f"{b}.ff.net.0.proj.weight"], out[f"{b}.ff.net.0.proj.bias"] = (8 * c, c), (8 * c,)
    out[f"{b}.ff.net.2.weight"], out[f"{b}.ff.net.2.bias"] = (c, 4 * c), (c,)
    out[f"{name}.proj_out.weight"], out[f"{name}.proj_out.bias"] = (c, c, 1, 1), (c,)


def unet_shapes(u: dict) -> dict[str, tuple]:
    """{key: shape} of UNet2DConditionModel's state dict at the widths of
    the configuration's ``unet``."""
    chs, layers, ctx = u["block_out_channels"], u["layers_per_block"], u["cross_attention_dim"]
    ch0, temb = chs[0], 4 * chs[0]
    out = {"conv_in.weight": (ch0, u["in_channels"], 3, 3), "conv_in.bias": (ch0,),
           "time_embedding.linear_1.weight": (temb, ch0), "time_embedding.linear_1.bias": (temb,),
           "time_embedding.linear_2.weight": (temb, temb), "time_embedding.linear_2.bias": (temb,)}
    skips, cur = [ch0], ch0
    for i, (kind, ch) in enumerate(zip(u["down_block_types"], chs)):
        for j in range(layers):
            _resnet_shapes(out, f"down_blocks.{i}.resnets.{j}", cur, ch, temb)
            cur = ch
            if kind.startswith("CrossAttn"):
                _transformer_shapes(out, f"down_blocks.{i}.attentions.{j}", ch, ctx)
            skips.append(ch)
        if i < len(chs) - 1:
            out[f"down_blocks.{i}.downsamplers.0.conv.weight"] = (ch, ch, 3, 3)
            out[f"down_blocks.{i}.downsamplers.0.conv.bias"] = (ch,)
            skips.append(ch)
    _resnet_shapes(out, "mid_block.resnets.0", cur, cur, temb)
    _transformer_shapes(out, "mid_block.attentions.0", cur, ctx)
    _resnet_shapes(out, "mid_block.resnets.1", cur, cur, temb)
    for i, (kind, ch) in enumerate(zip(u["up_block_types"], reversed(chs))):
        for j in range(layers + 1):
            _resnet_shapes(out, f"up_blocks.{i}.resnets.{j}", cur + skips.pop(), ch, temb)
            cur = ch
            if kind.startswith("CrossAttn"):
                _transformer_shapes(out, f"up_blocks.{i}.attentions.{j}", ch, ctx)
        if i < len(chs) - 1:
            out[f"up_blocks.{i}.upsamplers.0.conv.weight"] = (ch, ch, 3, 3)
            out[f"up_blocks.{i}.upsamplers.0.conv.bias"] = (ch,)
    out["conv_norm_out.weight"] = out["conv_norm_out.bias"] = (ch0,)
    out["conv_out.weight"] = (u["out_channels"], ch0, 3, 3)
    out["conv_out.bias"] = (u["out_channels"],)
    return out


def _vae_mid_shapes(out: dict, name: str, c: int) -> None:
    _resnet_shapes(out, f"{name}.resnets.0", c, c, None)
    a = f"{name}.attentions.0"
    out[f"{a}.group_norm.weight"] = out[f"{a}.group_norm.bias"] = (c,)
    for p in ("to_q", "to_k", "to_v", "to_out.0"):
        out[f"{a}.{p}.weight"], out[f"{a}.{p}.bias"] = (c, c), (c,)
    _resnet_shapes(out, f"{name}.resnets.1", c, c, None)


def vae_shapes(v: dict) -> dict[str, tuple]:
    """{key: shape} of AutoencoderKL's state dict at the widths of the
    configuration's ``vae``."""
    chs, layers, lat = v["block_out_channels"], v["layers_per_block"], v["latent_channels"]
    out = {"encoder.conv_in.weight": (chs[0], v["in_channels"], 3, 3),
           "encoder.conv_in.bias": (chs[0],)}
    cur = chs[0]
    for i, ch in enumerate(chs):
        for j in range(layers):
            _resnet_shapes(out, f"encoder.down_blocks.{i}.resnets.{j}", cur, ch, None)
            cur = ch
        if i < len(chs) - 1:
            out[f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"] = (ch, ch, 3, 3)
            out[f"encoder.down_blocks.{i}.downsamplers.0.conv.bias"] = (ch,)
    _vae_mid_shapes(out, "encoder.mid_block", cur)
    out["encoder.conv_norm_out.weight"] = out["encoder.conv_norm_out.bias"] = (cur,)
    out["encoder.conv_out.weight"], out["encoder.conv_out.bias"] = (2 * lat, cur, 3, 3), (2 * lat,)
    rev = list(reversed(chs))
    out["decoder.conv_in.weight"], out["decoder.conv_in.bias"] = (rev[0], lat, 3, 3), (rev[0],)
    _vae_mid_shapes(out, "decoder.mid_block", rev[0])
    cur = rev[0]
    for i, ch in enumerate(rev):
        for j in range(layers + 1):
            _resnet_shapes(out, f"decoder.up_blocks.{i}.resnets.{j}", cur, ch, None)
            cur = ch
        if i < len(rev) - 1:
            out[f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"] = (ch, ch, 3, 3)
            out[f"decoder.up_blocks.{i}.upsamplers.0.conv.bias"] = (ch,)
    out["decoder.conv_norm_out.weight"] = out["decoder.conv_norm_out.bias"] = (cur,)
    out["decoder.conv_out.weight"] = (v["out_channels"], cur, 3, 3)
    out["decoder.conv_out.bias"] = (v["out_channels"],)
    out["quant_conv.weight"], out["quant_conv.bias"] = (2 * lat, 2 * lat, 1, 1), (2 * lat,)
    out["post_quant_conv.weight"], out["post_quant_conv.bias"] = (lat, lat, 1, 1), (lat,)
    return out


# ------------------------------------------------------------- layers -----

class Model:
    """The UNet's and the VAE's weights (``sd_inputs.state`` of the seed),
    the prompt's encoding, and the layers over them at ``prec``."""

    def __init__(self, config: dict, seed: int, device, prec: str = "fp32"):
        self.config, self.prec, self.device = config, prec, torch.device(device)
        self.dtype = torch.float64 if prec == "fp64" else torch.float32
        self.u, self.v = config["unet"], config["vae"]
        self.w = {**sd_inputs.state(unet_shapes(self.u), seed, "unet", device),
                  **{f"vae.{k}": t for k, t in
                     sd_inputs.state(vae_shapes(self.v), seed, "vae", device).items()}}
        if prec == "bf16":
            self.w = {k: t.bfloat16().float() for k, t in self.w.items()}
        self.w = {k: t.to(self.dtype) for k, t in self.w.items()}
        c = config["context"]
        self.context = sd_inputs.context(seed, c["length"], c["width"], device).to(self.dtype)

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.bfloat16().float() if self.prec == "bf16" else x

    def conv(self, name: str, x, stride: int = 1, padding: int = 1):
        return F.conv2d(self._in(x), self.w[f"{name}.weight"], self.w[f"{name}.bias"], stride,
                        padding)

    def linear(self, name: str, x):
        return F.linear(self._in(x), self.w[f"{name}.weight"], self.w.get(f"{name}.bias"))

    def group_norm(self, name: str, x, groups: int, eps: float):
        return F.group_norm(x, groups, self.w[f"{name}.weight"], self.w[f"{name}.bias"], eps)

    def layer_norm(self, name: str, x):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"], 1e-5)


def heads_attention(q, k, v, heads: int):
    """diffusers' Attention core: softmax(q k^T d^-0.5) v for each head of
    width d, head by head. q (B, Lq, H d), k and v (B, Lk, H d)."""
    d = q.shape[-1] // heads
    out = torch.empty_like(q)
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        scores = torch.bmm(q[..., cols], k[..., cols].transpose(1, 2)) * d ** -0.5
        out[..., cols] = torch.bmm(scores.softmax(dim=-1), v[..., cols])
    return out


def _attn(m: Model, name: str, x, context, heads: int):
    context = x if context is None else context
    out = heads_attention(m.linear(f"{name}.to_q", x), m.linear(f"{name}.to_k", context),
                          m.linear(f"{name}.to_v", context), heads)
    return m.linear(f"{name}.to_out.0", out)


def _resnet(m: Model, name: str, x, temb, groups: int, eps: float):
    """ResnetBlock2D: GroupNorm, SiLU, 3x3 conv, plus the projected time
    embedding, again, and the (1x1-projected) input."""
    h = m.conv(f"{name}.conv1", F.silu(m.group_norm(f"{name}.norm1", x, groups, eps)))
    if temb is not None:
        h = h + m.linear(f"{name}.time_emb_proj", F.silu(temb))[:, :, None, None]
    h = m.conv(f"{name}.conv2", F.silu(m.group_norm(f"{name}.norm2", h, groups, eps)))
    if f"{name}.conv_shortcut.weight" in m.w:
        x = m.conv(f"{name}.conv_shortcut", x, padding=0)
    return x + h


def _transformer(m: Model, name: str, x, context, heads: int, groups: int):
    """Transformer2DModel (1x1-conv projections) over one
    BasicTransformerBlock: self-attention, cross-attention, GEGLU."""
    b, c, hh, ww = x.shape
    y = m.conv(f"{name}.proj_in", m.group_norm(f"{name}.norm", x, groups, 1e-6), padding=0)
    y = y.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    blk = f"{name}.transformer_blocks.0"
    y = y + _attn(m, f"{blk}.attn1", m.layer_norm(f"{blk}.norm1", y), None, heads)
    y = y + _attn(m, f"{blk}.attn2", m.layer_norm(f"{blk}.norm2", y), context, heads)
    hidden, gate = m.linear(f"{blk}.ff.net.0.proj", m.layer_norm(f"{blk}.norm3", y)).chunk(2, -1)
    y = y + m.linear(f"{blk}.ff.net.2", hidden * F.gelu(gate, approximate="tanh"))
    y = y.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    return m.conv(f"{name}.proj_out", y, padding=0) + x


def timestep_embedding(t: torch.Tensor, dim: int, freq_shift: float = 0.0):
    """[cos, sin] of t x exp(-ln(10^4) k / (dim / 2 - freq_shift)), k < dim / 2."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=t.dtype, device=t.device)
                      / (half - freq_shift))
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def unet(m: Model, x, t, context):
    """UNet2DConditionModel's forward: x (N, 4, h, w), t (N,), context
    (N, L, 768) -> the noise estimate (N, 4, h, w)."""
    u = m.u
    chs, layers, groups, heads = (u["block_out_channels"], u["layers_per_block"],
                                  u["norm_num_groups"], u["attention_head_dim"])
    temb = timestep_embedding(t, chs[0], u["freq_shift"])
    temb = m.linear("time_embedding.linear_2", F.silu(m.linear("time_embedding.linear_1", temb)))
    h = m.conv("conv_in", x)
    skips = [h]
    for i, kind in enumerate(u["down_block_types"]):
        for j in range(layers):
            h = _resnet(m, f"down_blocks.{i}.resnets.{j}", h, temb, groups, 1e-5)
            if kind.startswith("CrossAttn"):
                h = _transformer(m, f"down_blocks.{i}.attentions.{j}", h, context, heads, groups)
            skips.append(h)
        if i < len(chs) - 1:
            h = m.conv(f"down_blocks.{i}.downsamplers.0.conv", h, stride=2)
            skips.append(h)
    h = _resnet(m, "mid_block.resnets.0", h, temb, groups, 1e-5)
    h = _transformer(m, "mid_block.attentions.0", h, context, heads, groups)
    h = _resnet(m, "mid_block.resnets.1", h, temb, groups, 1e-5)
    for i, kind in enumerate(u["up_block_types"]):
        for j in range(layers + 1):
            h = _resnet(m, f"up_blocks.{i}.resnets.{j}", torch.cat([h, skips.pop()], dim=1), temb,
                        groups, 1e-5)
            if kind.startswith("CrossAttn"):
                h = _transformer(m, f"up_blocks.{i}.attentions.{j}", h, context, heads, groups)
        if i < len(chs) - 1:
            h = m.conv(f"up_blocks.{i}.upsamplers.0.conv", F.interpolate(h, scale_factor=2.0,
                                                                          mode="nearest"))
    return m.conv("conv_out", F.silu(m.group_norm("conv_norm_out", h, groups, 1e-5)))


def _vae_mid(m: Model, name: str, h, groups: int):
    h = _resnet(m, f"{name}.resnets.0", h, None, groups, 1e-6)
    b, c, hh, ww = h.shape
    a = f"{name}.attentions.0"
    y = m.group_norm(f"{a}.group_norm", h, groups, 1e-6).reshape(b, c, hh * ww).transpose(1, 2)
    y = heads_attention(m.linear(f"{a}.to_q", y), m.linear(f"{a}.to_k", y),
                        m.linear(f"{a}.to_v", y), 1)
    y = m.linear(f"{a}.to_out.0", y)
    h = y.transpose(1, 2).reshape(b, c, hh, ww) + h
    return _resnet(m, f"{name}.resnets.1", h, None, groups, 1e-6)


def vae_encode(m: Model, img):
    """AutoencoderKL's encoder and quant_conv: (1, 3, H, W) in [-1, 1] ->
    the posterior's mean and log-variance (clamped to [-30, 20])."""
    v, g = m.v, m.v["norm_num_groups"]
    chs, layers = v["block_out_channels"], v["layers_per_block"]
    h = m.conv("vae.encoder.conv_in", img)
    for i in range(len(chs)):
        for j in range(layers):
            h = _resnet(m, f"vae.encoder.down_blocks.{i}.resnets.{j}", h, None, g, 1e-6)
        if i < len(chs) - 1:
            h = m.conv(f"vae.encoder.down_blocks.{i}.downsamplers.0.conv", F.pad(h, (0, 1, 0, 1)),
                       stride=2, padding=0)
    h = _vae_mid(m, "vae.encoder.mid_block", h, g)
    h = F.silu(m.group_norm("vae.encoder.conv_norm_out", h, g, 1e-6))
    h = m.conv("vae.encoder.conv_out", h)
    mean, logvar = m.conv("vae.quant_conv", h, padding=0).chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)


def vae_decode(m: Model, z):
    """post_quant_conv and AutoencoderKL's decoder: latents / scale -> the
    image in about [-1, 1]."""
    v, g = m.v, m.v["norm_num_groups"]
    chs, layers = v["block_out_channels"], v["layers_per_block"]
    h = m.conv("vae.decoder.conv_in", m.conv("vae.post_quant_conv", z, padding=0))
    h = _vae_mid(m, "vae.decoder.mid_block", h, g)
    for i in range(len(chs)):
        for j in range(layers + 1):
            h = _resnet(m, f"vae.decoder.up_blocks.{i}.resnets.{j}", h, None, g, 1e-6)
        if i < len(chs) - 1:
            h = m.conv(f"vae.decoder.up_blocks.{i}.upsamplers.0.conv",
                       F.interpolate(h, scale_factor=2.0, mode="nearest"))
    h = F.silu(m.group_norm("vae.decoder.conv_norm_out", h, g, 1e-6))
    return m.conv("vae.decoder.conv_out", h)


# ---------------------------------------------------------- scheduler -----

def alphas_cumprod(s: dict) -> torch.Tensor:
    """Scaled-linear betas (float64, rounded once to float32)."""
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, s["num_train_timesteps"],
                        dtype=np.float64) ** 2
    return torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32)


def plms_timesteps(steps: int, s: dict) -> list[int]:
    """PNDMScheduler.set_timesteps with skip_prk_steps: the grid, its
    second-to-last entry taken twice, descending (steps + 1 entries)."""
    ratio = s["num_train_timesteps"] // steps
    grid = (np.arange(0, steps) * ratio).round().astype(np.int64) + s["steps_offset"]
    return [int(t) for t in np.concatenate([grid[:-1], grid[-2:-1], grid[-1:]])[::-1]]


def _f(x: torch.Tensor) -> float:
    return float(x.to(torch.float32))


def add_noise(original, noise, t: int, acp):
    return _f(acp[t] ** 0.5) * original + _f((1 - acp[t]) ** 0.5) * noise


def plms_step(st: dict, sample, eps, t: int, steps: int, acp, s: dict) -> dict:
    """PNDMScheduler.step_plms (skip_prk_steps) on the state ``st``
    (``ets``, ``counter``, ``cur_sample``); returns the new state, with the
    previous sample under ``latents``."""
    ratio = s["num_train_timesteps"] // steps
    ets, counter, cur = list(st["ets"]), st["counter"], st["cur_sample"]
    prev_t = t - ratio
    if counter != 1:
        ets = ets[-3:] + [eps]
    else:
        prev_t, t = t, t + ratio
    if len(ets) == 1 and counter == 0:
        e, cur = eps, sample
    elif len(ets) == 1 and counter == 1:
        e, sample = (eps + ets[-1]) / 2, cur
    elif len(ets) == 2:
        e = (3 * ets[-1] - ets[-2]) / 2
    elif len(ets) == 3:
        e = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
    else:
        e = (1 / 24) * (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] - 9 * ets[-4])
    a_t = acp[t]
    a_prev = acp[prev_t] if prev_t >= 0 else acp[0]     # set_alpha_to_one False
    b_t, b_prev = 1 - a_t, 1 - a_prev
    coeff = (a_prev / a_t) ** 0.5
    denom = a_t * b_prev ** 0.5 + (a_t * b_t * a_prev) ** 0.5
    prev = _f(coeff) * sample - _f(a_prev - a_t) * e / _f(denom)
    return {"latents": prev, "ets": ets, "counter": counter + 1, "cur_sample": cur}


# ------------------------------------------------------------ sampler -----

def _seeded_cpu(*entropy: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(np.random.SeedSequence(list(entropy))
                                             .generate_state(1)[0]))


def n_evaluations(config: dict) -> int:
    return config["sampler"]["steps"] + 1


def prepare(m: Model, a: dict, seed: int) -> dict:
    """The loop's fixed inputs for the analysed clip ``a``: the canvas's
    clean latents (the posterior sampled with the (seed, 0) draw, times
    the VAE's scale), the latent hole mask, the (seed, 1) latent noise and
    the noise table; and its start state (index 0)."""
    cfg, dev = m.config, m.device
    img = torch.tensor(a["canvas"], dtype=m.dtype, device=dev).permute(2, 0, 1)[None]
    with torch.no_grad(), precision(m.prec):
        mean, logvar = vae_encode(m, img / 127.5 - 1.0)
    post = torch.randn(tuple(mean.shape), generator=_seeded_cpu(seed, 0)).to(dev, m.dtype)
    latents0 = (mean + torch.exp(0.5 * logvar) * post) * m.v["scaling_factor"]
    f = 2 ** (len(m.v["block_out_channels"]) - 1)
    s = a["canvas_mask"].shape[0]
    hole = a["canvas_mask"].astype(np.float32) / 255.0
    hole = hole.reshape(s // f, f, s // f, f).max(axis=(1, 3))
    noise = torch.randn(tuple(latents0.shape), generator=_seeded_cpu(seed, 1)).to(dev, m.dtype)
    table = plms_timesteps(cfg["sampler"]["steps"], cfg["scheduler"])
    acp = alphas_cumprod(cfg["scheduler"])
    fixed = {"latents0": latents0, "noise": noise, "table": table, "acp": acp,
             "hole": torch.tensor(hole, device=dev, dtype=m.dtype)[None, None]}
    fixed["start"] = {"latents": add_noise(latents0, noise, table[0], acp), "ets": [],
                      "counter": 0, "cur_sample": None, "index": 0}
    return fixed


@torch.no_grad()
def evaluate(m: Model, fixed: dict, st: dict) -> tuple[torch.Tensor, dict]:
    """One evaluation from the state ``st``: the UNet on [latents; latents]
    with [uncond; cond], the guidance, the PLMS step and the masked-latent
    composite (the region outside the hole set to the clean latents noised
    to the next evaluation's level, clean after the last). Returns the
    guided estimate and the new state."""
    cfg = m.config
    table, acp, i = fixed["table"], fixed["acp"], st["index"]
    t, lat = table[i], st["latents"].to(m.dtype)
    with precision(m.prec):
        both = unet(m, torch.cat([lat, lat]), torch.full((2,), float(t), device=m.device,
                                                         dtype=m.dtype), m.context)
    uncond, cond = both.chunk(2)
    eps = uncond + cfg["sampler"]["guidance_scale"] * (cond - uncond)
    new = plms_step(st, lat, eps, t, cfg["sampler"]["steps"], acp, cfg["scheduler"])
    proper = (fixed["latents0"] if i == len(table) - 1
              else add_noise(fixed["latents0"], fixed["noise"], table[i + 1], acp))
    new["latents"] = (1.0 - fixed["hole"]) * proper + fixed["hole"] * new["latents"]
    new["index"] = i + 1
    return eps, new


@torch.no_grad()
def decode(m: Model, latents) -> np.ndarray:
    """The latents to uint8 RGB (H, W, 3): decode, x / 2 + 0.5 clamped to
    [0, 1], x 255 rounded."""
    with precision(m.prec):
        img = vae_decode(m, latents.to(m.dtype) / m.v["scaling_factor"])
    img = (img / 2 + 0.5).clamp(0, 1)
    return torch.round(img[0] * 255.0).permute(1, 2, 0).to(torch.uint8).cpu().numpy()


# ------------------------------------------------ analysis, synthesis -----

def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel, a = -0.5."""
    a, x = -0.5, np.abs(x)
    return np.where(x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                    np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) Pillow's fixed-point bicubic taps: each output's taps
    over [xmin, xmax), normalised to sum 1, times 2^22 rounded half away
    from zero."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    k = np.zeros((n_out, n_in))
    for i in range(n_out):
        centre = (i + 0.5) * scale
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), n_in)
        w = _bicubic((np.arange(lo, hi) - centre + 0.5) / fscale)
        if w.sum() != 0:
            w = w / w.sum()
        w = w * (1 << _PRECISION_BITS)
        k[i, lo:hi] = np.where(w < 0, np.trunc(w - 0.5), np.trunc(w + 0.5))
    return k


def _resample(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    k = _resample_matrix(img.shape[axis], n_out)
    acc = np.moveaxis(np.tensordot(k, img.astype(np.float64), axes=([1], [axis])), 0, axis)
    out = np.floor((acc + (1 << (_PRECISION_BITS - 1))) / (1 << _PRECISION_BITS))
    return np.clip(out, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's bicubic resize of a uint8 (H, W) or (H, W, C) image to
    ``size`` = (width, height): the horizontal pass, then the vertical,
    each only where its size changes."""
    width, height = size
    if img.shape[1] != width:
        img = _resample(img, width, 1)
    if img.shape[0] != height:
        img = _resample(img, height, 0)
    return img


def analyse(x: np.ndarray, config: dict, device) -> dict:
    """The reference's codec on the damaged clip ``x``: the power
    spectrogram in dB (20 log10 of it, floored at 1e-5, less 20, clamped at
    -100), min-max to uint8 and flipped up-down; the mask of pixels under
    10; both resized onto the canvas, the image as RGB."""
    n_fft, hop, size = config["stft"]["n_fft"], config["stft"]["hop"], config["sampler"]["canvas"]
    power = stft(torch.from_numpy(x).to(device), n_fft, hop).abs() ** 2.0
    db = (20.0 * torch.log10(power.clamp_min(1e-5)) - 20.0).clamp_min(-100.0).cpu().numpy()
    lo, hi = float(db.min()), float(db.max())
    image = np.flipud(((db - lo) / max(hi - lo, 1e-12) * 255.0).astype(np.uint8))
    mask = np.where(image < 10, 255, 0).astype(np.uint8)
    return {"x": x, "image": image, "lo": lo, "hi": hi, "mask": mask,
            "canvas": resize(np.repeat(image[:, :, None], 3, axis=2), (size, size)),
            "canvas_mask": resize(mask, (size, size))}


def griffin_lim(mag: torch.Tensor, n_fft: int, hop: int, n_iter: int, momentum: float,
                length: int, seed: int) -> torch.Tensor:
    """torchaudio's GriffinLim (power 1) from the seeded initial phase."""
    phase = torch.rand(tuple(mag.shape), generator=torch.Generator().manual_seed(seed))
    angles = torch.polar(torch.ones_like(mag), (phase * (2.0 * math.pi) - math.pi).to(mag.device))
    prev = torch.zeros_like(angles)
    for _ in range(n_iter):
        rebuilt = stft(istft(mag * angles, n_fft, hop, length), n_fft, hop)[:, :mag.shape[1]]
        angles = rebuilt - prev * (momentum / (1 + momentum))
        angles = angles / angles.abs().clamp_min(1e-16)
        prev = rebuilt
    return istft(mag * angles, n_fft, hop, length)


def _damaged_columns(mask: np.ndarray) -> np.ndarray:
    return np.flatnonzero((mask == 255).mean(axis=0) > 0.95)


def synthesise(rgb: np.ndarray, a: dict, config: dict, seed: int, device) -> np.ndarray:
    """The inpainted canvas ``rgb`` back to the clip's audio: resized to
    the image, grey (the channels' mean, rounded), the image kept outside
    the mask, the dB image to linear magnitude, Griffin-Lim, the fill's
    energy set to ``fill_energy_ratio`` of its surroundings', and
    crossfaded into the damaged clip over the wholly damaged columns."""
    x, image, mask = a["x"], a["image"], a["mask"]
    hop, n = config["stft"]["hop"], len(x)
    grey = np.asarray(resize(rgb, image.shape[::-1]), np.float32).mean(axis=2)
    filled = np.where(mask == 255, np.rint(np.clip(grey, 0, 255)).astype(np.uint8), image)
    db = np.flipud(filled.astype(np.float32)).copy() / 255.0 * (a["hi"] - a["lo"]) + a["lo"]
    mag = torch.tensor(np.power(10.0, (db + 20.0) / 20.0), dtype=torch.float32, device=device)
    g = config["griffin_lim"]
    out = griffin_lim(mag, config["stft"]["n_fft"], hop, g["n_iter"], g["momentum"], n,
                      seed).cpu().numpy()
    cols = _damaged_columns(mask)
    if cols.size == 0:
        return x
    gs, ge = int(cols.min()) * hop, min(n, (int(cols.max()) + 1) * hop)
    around = np.concatenate([x[max(0, gs - (ge - gs)):gs], x[ge:ge + (ge - gs)]])
    e_around = float(np.mean(around ** 2)) if around.size else 0.0
    e_fill = float(np.mean(out[gs:ge] ** 2))
    out = out * np.float32(np.sqrt(config["fill_energy_ratio"] * e_around / max(e_fill, 1e-12)))
    covered = np.zeros(n, np.float32)
    for c in cols:
        covered[max(0, c * hop - 2 * hop):min(n, c * hop + 2 * hop)] = 1.0
    xfade = 2 * hop
    weight = np.convolve(covered, np.ones(xfade, np.float32) / xfade, mode="same")
    return np.asarray(x * (1.0 - weight) + out * weight, np.float32)
