"""The port's Stable Diffusion modules (models/sd/: scheduler, UNet2DCondition,
AutoencoderKL, loader) against the JAX package's, on the CPU, at the
``tiny()`` widths, plus the full-width key/shape manifest.

Both packages get the same weights: the JAX modules' parameters are
drawn with numpy from a seed on their ``eval_shape`` tree and carried
across by ``convert.sd_flax_to_state_dict``. The bounds: UNet and VAE
within 1e-5 of the output's peak (measured ~1e-6, float32 sums taken in
another order); PLMS within 1e-6 of the trajectory's peak.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_inpainting_tpu.models.sd import pipeline as jpipe
from audio_inpainting_tpu.models.sd import scheduler as jsched
from audio_inpainting_tpu.models.sd.loader import load_riffusion as jax_load_riffusion
from audio_inpainting_tpu.models.sd.unet2d import Attention as JaxAttention
from audio_inpainting_tpu.models.sd.unet2d import UNet2DCondition as JaxUNet
from audio_inpainting_tpu.models.sd.unet2d import UNetConfig as JaxUNetConfig
from audio_inpainting_tpu.models.sd.vae import AutoencoderKL as JaxVAE
from audio_inpainting_tpu.models.sd.vae import VAEConfig as JaxVAEConfig
from audio_inpainting_torch.models.sd import (AutoencoderKL, UNet2DCondition, UNetConfig,
                                              VAEConfig, encode_prompt, flax_to_torch_key,
                                              load_module, load_riffusion, load_torch_weights,
                                              match_checkpoint, read_safetensors,
                                              sd_flax_to_state_dict)
from audio_inpainting_torch.models.sd import scheduler as tsched
from audio_inpainting_torch.models.sd.unet2d import Attention, Transformer2D
from audio_inpainting_torch.models.sd.vae import VAEAttention

torch.set_num_threads(1)

MANIFEST = Path(__file__).resolve().parent / "golden" / "sd_v1_manifest.json"
FORWARD_RTOL = 1e-5     # of the output's peak
PLMS_RTOL = 1e-6        # of the trajectory's peak


def jax_params(model, *args, seed=0):
    """Parameters of a flax module from its eval_shape tree, drawn with
    numpy: kernels at 1/sqrt(fan-in), biases small, norm scales near 1."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        a = rng.randn(*s.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nchw(a):
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def err_of_peak(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ scheduler -----


@pytest.mark.parametrize("steps", [4, 10, 50])
def test_plms_timetable_equals_jax(steps):
    np.testing.assert_array_equal(tsched.plms_timesteps(steps), jsched.plms_timesteps(steps))
    np.testing.assert_array_equal(tsched.ddim_timesteps(steps), jsched.ddim_timesteps(steps))
    np.testing.assert_array_equal(tsched.alphas_cumprod().numpy(),
                                  np.asarray(jsched.alphas_cumprod()))


@pytest.mark.parametrize("steps", [10, 50])
def test_plms_sequence_distinct_eps_matches_jax(steps):
    """Every eps distinct, so each multistep coefficient shows; the
    counter==1 correction and the duplicated timetable entry are on the
    path. Measured: bit-equal at 10 steps, 2e-7 of peak at 50."""
    acp_j, acp_t = jsched.alphas_cumprod(), tsched.alphas_cumprod()
    rng = np.random.default_rng(steps)
    x0 = rng.standard_normal((2, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x0), torch.tensor(x0)
    sj, st = jsched.plms_init(x0.shape), tsched.plms_init()
    traj_j, traj_t = [], []
    for t in jsched.plms_timesteps(steps):
        e = rng.standard_normal((2, 3)).astype(np.float32)
        sj, xj = jsched.plms_step(sj, xj, jnp.asarray(e), jnp.int32(t), steps, acp_j)
        st, xt = tsched.plms_step(st, xt, torch.tensor(e), int(t), steps, acp_t)
        traj_j.append(np.asarray(xj))
        traj_t.append(xt.numpy())
    assert st.counter == len(traj_t) and len(st.ets) == 4
    assert err_of_peak(np.stack(traj_t), np.stack(traj_j)) <= PLMS_RTOL


def test_plms_golden_scalar_sequence_matches_jax():
    """The golden sequence of tests/test_sd.py (x = 0.5, eps = cos(0.7 i),
    10 steps), step by step within 1e-6."""
    acp_j, acp_t = jsched.alphas_cumprod(), tsched.alphas_cumprod()
    xj, xt = jnp.float32(0.5), torch.tensor(0.5)
    sj, st = jsched.plms_init(()), tsched.plms_init()
    for i, t in enumerate(jsched.plms_timesteps(10)):
        eps = np.float32(np.cos(0.7 * i))
        sj, xj = jsched.plms_step(sj, xj, jnp.float32(eps), jnp.int32(t), 10, acp_j)
        st, xt = tsched.plms_step(st, xt, torch.tensor(eps), int(t), 10, acp_t)
        assert abs(float(xt) - float(xj)) <= 1e-6, (i, t)


@pytest.mark.parametrize("t", [981, 501, 21, 1])
def test_add_noise_and_ddim_step_match_jax(t):
    acp_j, acp_t = jsched.alphas_cumprod(), tsched.alphas_cumprod()
    rng = np.random.default_rng(t)
    x, e = (rng.standard_normal((2, 5)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tsched.add_noise(torch.tensor(x), torch.tensor(e), t, acp_t).numpy(),
        np.asarray(jsched.add_noise(jnp.asarray(x), jnp.asarray(e), jnp.int32(t), acp_j)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tsched.ddim_step(torch.tensor(x), torch.tensor(e), t, 50, acp_t).numpy(),
        np.asarray(jsched.ddim_step(jnp.asarray(x), jnp.asarray(e), jnp.int32(t), 50, acp_j)),
        rtol=1e-6, atol=1e-6)


# --------------------------------------------------------- UNet and VAE -----


@pytest.fixture(scope="module")
def tiny_unet():
    cfg = JaxUNetConfig.tiny()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981.0, 21.0], np.float32)
    ctx = rng.standard_normal((2, 7, cfg.cross_attention_dim)).astype(np.float32)
    params = jax_params(JaxUNet(cfg), x, t, ctx, seed=1)
    return params, x, t, ctx


@pytest.fixture(scope="module")
def tiny_vae():
    img = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(np.float32)
    return jax_params(JaxVAE(JaxVAEConfig.tiny()), img, jax.random.PRNGKey(1), seed=3), img


def test_unet_forward_matches_jax(tiny_unet):
    params, x, t, ctx = tiny_unet
    want = np.asarray(jax.jit(JaxUNet(JaxUNetConfig.tiny()).apply)({"params": params}, x, t, ctx))
    unet = load_module(UNet2DCondition, UNetConfig.tiny(), sd_flax_to_state_dict(params), "cpu")
    with torch.no_grad():
        got = nhwc(unet(nchw(x), torch.tensor(t), torch.tensor(ctx)))
    assert err_of_peak(got, want) <= FORWARD_RTOL


def test_vae_encode_decode_match_jax(tiny_vae):
    params, img = tiny_vae
    jvae = JaxVAE(JaxVAEConfig.tiny())
    mean, logvar = jax.jit(lambda p, x: jvae.apply({"params": p}, x, method=JaxVAE.encode))(
        params, img)
    dec = jax.jit(lambda p, z: jvae.apply({"params": p}, z, method=JaxVAE.decode))(params, mean)
    vae = load_module(AutoencoderKL, VAEConfig.tiny(), sd_flax_to_state_dict(params), "cpu")
    with torch.no_grad():
        t_mean, t_logvar = vae.encode(nchw(img))
        t_dec = vae.decode(nchw(mean))
    for got, want in ((t_mean, mean), (t_logvar, logvar), (t_dec, dec)):
        assert err_of_peak(nhwc(got), want) <= FORWARD_RTOL


# the numpy oracles of tests/test_sd_golden.py, copied: per-head loops in
# float64, the Dense kernels in flax's (in, out) layout


def _groupnorm_oracle(x, gamma, beta, groups, eps):
    b, h, w, c = x.shape
    x64 = x.astype(np.float64).reshape(b, h, w, groups, c // groups)
    mu = x64.mean(axis=(1, 2, 4), keepdims=True)
    var = x64.var(axis=(1, 2, 4), keepdims=True)
    y = ((x64 - mu) / np.sqrt(var + eps)).reshape(b, h, w, c)
    return y * gamma[None, None, None, :] + beta[None, None, None, :]


def _attention_oracle(x, ctx, p, heads, dim_head):
    q = x @ p["to_q"]["kernel"]
    k = ctx @ p["to_k"]["kernel"]
    v = ctx @ p["to_v"]["kernel"]
    if "bias" in p["to_q"]:
        q, k, v = q + p["to_q"]["bias"], k + p["to_k"]["bias"], v + p["to_v"]["bias"]
    outs = []
    for h in range(heads):
        sl = slice(h * dim_head, (h + 1) * dim_head)
        qh, kh, vh = (t[..., sl].astype(np.float64) for t in (q, k, v))
        scores = qh @ kh.transpose(0, 2, 1) / np.sqrt(dim_head)
        scores -= scores.max(axis=-1, keepdims=True)
        w = np.exp(scores)
        w /= w.sum(axis=-1, keepdims=True)
        outs.append(w @ vh)
    merged = np.concatenate(outs, axis=-1)
    return merged @ p["to_out_0"]["kernel"] + p["to_out_0"]["bias"]


def _flax_view(module) -> dict:
    """The projections of a port attention module in flax's layout."""
    out = {}
    for name in ("to_q", "to_k", "to_v", "to_out_0"):
        lin = module.to_out[0] if name == "to_out_0" else getattr(module, name)
        out[name] = {"kernel": lin.weight.detach().numpy().T}
        if lin.bias is not None:
            out[name]["bias"] = lin.bias.detach().numpy()
    return out


def _randomize(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return module


def test_unet_attention_matches_numpy_oracle():
    heads, dim_head = 2, 4
    model = _randomize(Attention(8, 6, heads, dim_head), 1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 3, 6)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(ctx)).numpy()
    want = _attention_oracle(x, ctx, _flax_view(model), heads, dim_head)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the same weights as flax's Attention computes them
    jparams = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
               for k, v in _flax_view(model).items()}
    jgot = JaxAttention(heads, dim_head).apply({"params": jparams}, x, ctx)
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=2e-5, atol=2e-5)


def test_vae_attention_matches_numpy_oracle():
    groups = 4
    model = _randomize(VAEAttention(8, groups), 3)
    x = np.random.default_rng(2).standard_normal((1, 4, 6, 8)).astype(np.float32)
    with torch.no_grad():
        got = nhwc(model(nchw(x)))
    b, h, w, c = x.shape
    gn = _groupnorm_oracle(x, model.group_norm.weight.detach().numpy(),
                           model.group_norm.bias.detach().numpy(), groups, 1e-6)
    flat = gn.reshape(b, h * w, c)
    want = _attention_oracle(flat, flat, _flax_view(model), 1, c).reshape(b, h, w, c) + x
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_port_norm_epsilons():
    """GroupNorm eps 1e-5 in the UNet's resnets and output norm, 1e-6 in
    Transformer2D's norm and everywhere in the VAE; LayerNorm 1e-5; and
    the norm itself against the float64 oracle at both."""
    unet, vae = UNet2DCondition(UNetConfig.tiny()), AutoencoderKL(VAEConfig.tiny())
    for name, mod in unet.named_modules():
        if isinstance(mod, torch.nn.GroupNorm):
            want = 1e-6 if ".attentions." in name else 1e-5
            assert mod.eps == want, name
        if isinstance(mod, torch.nn.LayerNorm):
            assert mod.eps == 1e-5, name
    assert all(m.eps == 1e-6 for m in vae.modules() if isinstance(m, torch.nn.GroupNorm))
    assert isinstance(unet.down_blocks[0].attentions[0], Transformer2D)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((1, 3, 5, 8)) * 3.0).astype(np.float32)
    for eps in (1e-5, 1e-6):
        gn = _randomize(torch.nn.GroupNorm(4, 8, eps=eps), 5)
        with torch.no_grad():
            got = nhwc(gn(nchw(x)))
        want = _groupnorm_oracle(x, gn.weight.detach().numpy(), gn.bias.detach().numpy(), 4, eps)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------- manifest -----


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_full_width_state_dict_equals_manifest(which):
    """Full-width modules built on the meta device (no weights made) have
    exactly the frozen SD-v1 keys and shapes: 686 UNet, 248 VAE tensors."""
    with open(MANIFEST) as f:
        frozen = json.load(f)[which]
    with torch.device("meta"):
        model = UNet2DCondition() if which == "unet" else AutoencoderKL()
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert got == frozen
    assert len(got) == {"unet": 686, "vae": 248}[which]


@pytest.mark.parametrize("path, want", [
    (("down_blocks_0_resnets_0", "conv1", "kernel"), "down_blocks.0.resnets.0.conv1.weight"),
    (("down_blocks_0_attentions_1", "transformer_blocks_0", "attn2", "to_out_0", "kernel"),
     "down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_out.0.weight"),
    (("down_blocks_0_attentions_0", "transformer_blocks_0", "ff", "net_0", "proj", "bias"),
     "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.bias"),
    (("time_embedding", "linear_1", "kernel"), "time_embedding.linear_1.weight"),
    (("mid_block_resnets_1", "norm2", "scale"), "mid_block.resnets.1.norm2.weight"),
    (("mid_block_attentions_0", "group_norm", "bias"), "mid_block.attentions.0.group_norm.bias"),
    (("encoder", "down_blocks_1_downsamplers_0", "conv", "bias"),
     "encoder.down_blocks.1.downsamplers.0.conv.bias"),
    (("quant_conv", "kernel"), "quant_conv.weight"),
])
def test_flax_to_torch_key(path, want):
    assert flax_to_torch_key(path) == want


# --------------------------------------------------------------- loader -----


def _write(d: Path, state: dict, fmt: str):
    d.mkdir(parents=True)
    if fmt == "bin":
        torch.save(state, d / "diffusion_pytorch_model.bin")
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in state.items()},
                  str(d / "diffusion_pytorch_model.safetensors"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_matches_library(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(0)
    state = {"a.weight": torch.randn((3, 5, 1, 1), generator=gen).to(dtype),
             "b.bias": torch.randn((7,), generator=gen).to(dtype),
             "scalar": torch.randn((), generator=gen).to(dtype)}
    save_file(state, str(tmp_path / "m.safetensors"), metadata={"format": "pt"})
    got, want = read_safetensors(str(tmp_path / "m.safetensors")), load_file(
        str(tmp_path / "m.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_riffusion_roundtrip(tmp_path, tiny_unet, tiny_vae, fmt):
    """A tiny checkpoint in the diffusers layout loads back exactly; a
    missing root raises FileNotFoundError."""
    states = {"unet": sd_flax_to_state_dict(tiny_unet[0]),
              "vae": sd_flax_to_state_dict(tiny_vae[0])}
    for sub, state in states.items():
        _write(tmp_path / sub, state, fmt)
    bundle = load_riffusion(str(tmp_path), UNetConfig.tiny(), VAEConfig.tiny(),
                            load_text=False, device="cpu")
    assert bundle["text_encoder"] is None and bundle["tokenizer"] is None
    for sub in ("unet", "vae"):
        got = bundle[f"{sub}_params"].state_dict()
        assert got.keys() == states[sub].keys()
        for k, v in states[sub].items():
            assert torch.equal(got[k], v), k
    with pytest.raises(FileNotFoundError):
        load_riffusion(str(tmp_path / "missing"), UNetConfig.tiny(), VAEConfig.tiny(),
                       load_text=False, device="cpu")


def test_loader_legacy_vae_attention_aliases(tmp_path, tiny_vae):
    state = sd_flax_to_state_dict(tiny_vae[0])
    legacy = {}
    for k, v in state.items():
        for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                         ("to_out.0", "proj_attn")):
            if f"attentions.0.{new}." in k:
                k = k.replace(new, old)
                if v.ndim == 2:
                    v = v[:, :, None, None]        # legacy 1x1-conv layout
                break
        legacy[k] = v
    assert any(k.endswith("proj_attn.weight") for k in legacy)
    _write(tmp_path / "vae", legacy, "safetensors")
    vae = load_module(AutoencoderKL, VAEConfig.tiny(),
                      load_torch_weights(str(tmp_path / "vae")), "cpu")
    for k, v in vae.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_loader_strict_raises_on_missing_and_unused(tiny_vae):
    state = sd_flax_to_state_dict(tiny_vae[0])
    with torch.device("meta"):
        model = AutoencoderKL(VAEConfig.tiny())
    missing = dict(state)
    del missing[next(iter(missing))]
    with pytest.raises(KeyError):
        match_checkpoint(missing, model, strict=True)
    assert len(match_checkpoint(missing, model, strict=False)) == len(state) - 1
    extra = {**state, "bogus.weight": torch.zeros(1)}
    with pytest.raises(KeyError):
        match_checkpoint(extra, model, strict=True)
    with pytest.raises(KeyError):
        load_module(AutoencoderKL, VAEConfig.tiny(), extra, "cpu")


def _write_tiny_text_layout(root: Path, dim: int):
    """A tiny transformers CLIP text encoder and tokenizer in the layout
    load_riffusion reads (as tests/test_sd.py writes them)."""
    from transformers import CLIPTextConfig, CLIPTextModel, CLIPTokenizer

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in "abcdefghijklmnopqrstuvwxyz ,":
        vocab[ch if ch != " " else "Ġ"] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    torch.manual_seed(0)
    cfg = CLIPTextConfig(vocab_size=len(vocab), hidden_size=dim, intermediate_size=2 * dim,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=77)
    CLIPTextModel(cfg).save_pretrained(str(root / "text_encoder"))
    tdir = root / "tokenizer"
    tdir.mkdir()
    (tdir / "vocab.json").write_text(json.dumps(vocab))
    (tdir / "merges.txt").write_text("#version: 0.2\n")
    CLIPTokenizer(str(tdir / "vocab.json"), str(tdir / "merges.txt"),
                  model_max_length=77).save_pretrained(str(tdir))


def test_load_riffusion_text_leg_against_flax_clip(tmp_path, tiny_unet, tiny_vae):
    """load_text=True: transformers' torch CLIPTextModel gives the prompt
    context; the JAX package loads the same checkpoint as a
    FlaxCLIPTextModel. The two agree within 1e-5 of the context's peak
    (measured ~1e-7)."""
    for sub, params in (("unet", tiny_unet[0]), ("vae", tiny_vae[0])):
        _write(tmp_path / sub, sd_flax_to_state_dict(params), "safetensors")
    _write_tiny_text_layout(tmp_path, JaxUNetConfig.tiny().cross_attention_dim)
    bundle = load_riffusion(str(tmp_path), UNetConfig.tiny(), VAEConfig.tiny(),
                            load_text=True, device="cpu")
    assert bundle["tokenizer"].model_max_length == 77
    ctx = encode_prompt(bundle["tokenizer"], bundle["text_encoder"], "ambient sound")
    assert ctx.shape == (2, 77, 16) and ctx.dtype == torch.float32
    assert bool(torch.isfinite(ctx).all()) and float((ctx[0] - ctx[1]).abs().max()) > 1e-6
    jbundle = jax_load_riffusion(str(tmp_path), JaxUNetConfig.tiny(), JaxVAEConfig.tiny(),
                                 load_text=True)
    want = jpipe.encode_prompt(jbundle["tokenizer"], jbundle["text_encoder"], "ambient sound")
    assert err_of_peak(ctx.numpy(), want) <= 1e-5
