"""FLOPs of the SD kind's model calls from the configuration's widths, and
the roofline bound of one attention call.

Counted as ``torch.utils.flop_counter`` counts them, which the tests hold
at full width on meta tensors: a convolution 2 N Co Ci k^2 Ho Wo, a linear
layer 2 M K N (its bias not counted), each of attention's two batched
products 2 B H Lq Lk d. Norms, activations, the softmax, upsampling,
concatenation and elementwise work are not counted, so a share of the
peak is a floor. One CFG evaluation is the UNet at batch 2; the encode
and the decode are the VAE at batch 1 on the canvas.

The attention bound is the function's own floor, whatever implements it:
the larger of its two products' FLOPs at the float32 peak and the bytes
of q, k and v read once and its output written once at HBM's rate.
"""

from __future__ import annotations

from .counting import H100_PEAKS

FLOAT32_BYTES = 4


def _conv(n: int, cin: int, cout: int, k: int, hw: int) -> int:
    return 2 * n * cout * cin * k * k * hw


def _linear(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def _attention(b: int, heads: int, lq: int, lk: int, d: int) -> int:
    return 2 * 2 * b * heads * lq * lk * d


def _resnet(n: int, cin: int, cout: int, hw: int, temb: int | None) -> int:
    f = _conv(n, cin, cout, 3, hw) + _conv(n, cout, cout, 3, hw)
    if temb is not None:
        f += _linear(n, temb, cout)
    if cin != cout:
        f += _conv(n, cin, cout, 1, hw)
    return f


def _transformer(n: int, c: int, hw: int, ctx_len: int, ctx: int, heads: int) -> int:
    tokens = n * hw
    f = 2 * _conv(n, c, c, 1, hw)                                      # proj_in, proj_out
    f += 4 * _linear(tokens, c, c) + _attention(n, heads, hw, hw, c // heads)   # attn1
    f += 2 * _linear(tokens, c, c) + 2 * _linear(n * ctx_len, ctx, c)          # attn2
    f += _attention(n, heads, hw, ctx_len, c // heads)
    return f + _linear(tokens, c, 8 * c) + _linear(tokens, 4 * c, c)           # GEGLU, out


def unet_flops(u: dict, n: int, h: int, w: int, ctx_len: int) -> int:
    """One UNet2DConditionModel forward at batch n on (h, w) latents."""
    chs, layers, ctx, heads = (u["block_out_channels"], u["layers_per_block"],
                               u["cross_attention_dim"], u["attention_head_dim"])
    ch0, temb = chs[0], 4 * chs[0]
    f = _linear(n, ch0, temb) + _linear(n, temb, temb) + _conv(n, u["in_channels"], ch0, 3, h * w)
    skips, cur = [ch0], ch0
    for i, (kind, ch) in enumerate(zip(u["down_block_types"], chs)):
        for _ in range(layers):
            f += _resnet(n, cur, ch, h * w, temb)
            cur = ch
            if kind.startswith("CrossAttn"):
                f += _transformer(n, ch, h * w, ctx_len, ctx, heads)
            skips.append(ch)
        if i < len(chs) - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            f += _conv(n, ch, ch, 3, h * w)
            skips.append(ch)
    f += 2 * _resnet(n, cur, cur, h * w, temb) + _transformer(n, cur, h * w, ctx_len, ctx, heads)
    for i, (kind, ch) in enumerate(zip(u["up_block_types"], reversed(chs))):
        for _ in range(layers + 1):
            f += _resnet(n, cur + skips.pop(), ch, h * w, temb)
            cur = ch
            if kind.startswith("CrossAttn"):
                f += _transformer(n, ch, h * w, ctx_len, ctx, heads)
        if i < len(chs) - 1:
            h, w = 2 * h, 2 * w
            f += _conv(n, ch, ch, 3, h * w)
    return f + _conv(n, ch0, u["out_channels"], 3, h * w)


def _vae_mid(c: int, hw: int) -> int:
    return 2 * _resnet(1, c, c, hw, None) + 4 * _linear(hw, c, c) + _attention(1, 1, hw, hw, c)


def latent_size(config: dict) -> int:
    return config["sampler"]["canvas"] // 2 ** (len(config["vae"]["block_out_channels"]) - 1)


def step_flops(config: dict) -> int:
    """One CFG evaluation: the UNet at batch 2."""
    s = latent_size(config)
    return unet_flops(config["unet"], 2, s, s, config["context"]["length"])


def encode_flops(config: dict) -> int:
    """AutoencoderKL's encoder and quant_conv on the canvas."""
    v, size = config["vae"], config["sampler"]["canvas"]
    chs, layers, lat = v["block_out_channels"], v["layers_per_block"], v["latent_channels"]
    hw = size * size
    f, cur = _conv(1, v["in_channels"], chs[0], 3, hw), chs[0]
    for i, ch in enumerate(chs):
        for _ in range(layers):
            f += _resnet(1, cur, ch, hw, None)
            cur = ch
        if i < len(chs) - 1:
            size //= 2
            hw = size * size
            f += _conv(1, ch, ch, 3, hw)
    f += _vae_mid(cur, hw) + _conv(1, cur, 2 * lat, 3, hw)
    return f + _conv(1, 2 * lat, 2 * lat, 1, hw)


def decode_flops(config: dict) -> int:
    """post_quant_conv and AutoencoderKL's decoder from the latents."""
    v, size = config["vae"], latent_size(config)
    rev = list(reversed(v["block_out_channels"]))
    layers, lat = v["layers_per_block"], v["latent_channels"]
    hw = size * size
    f = _conv(1, lat, lat, 1, hw) + _conv(1, lat, rev[0], 3, hw) + _vae_mid(rev[0], hw)
    cur = rev[0]
    for i, ch in enumerate(rev):
        for _ in range(layers + 1):
            f += _resnet(1, cur, ch, hw, None)
            cur = ch
        if i < len(rev) - 1:
            size *= 2
            hw = size * size
            f += _conv(1, ch, ch, 3, hw)
    return f + _conv(1, cur, v["out_channels"], 3, hw)


def peak_flops(config: dict) -> float:
    return H100_PEAKS[config["dtype"]]


def attention_bound_s(batch: int, heads: int, q_tokens: int, k_tokens: int,
                      head_dim: int) -> float:
    """The roofline bound of one float32 attention call, in seconds."""
    flops = _attention(batch, heads, q_tokens, k_tokens, head_dim)
    nbytes = FLOAT32_BYTES * batch * heads * head_dim * (2 * q_tokens + 2 * k_tokens)
    return max(flops / H100_PEAKS["float32"], nbytes / H100_PEAKS["hbm"])
