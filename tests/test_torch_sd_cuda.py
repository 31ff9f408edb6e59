"""The port's Stable Diffusion path on the GPU against the same functions on
the CPU: the safetensors reader onto the card, the UNet2DCondition and
AutoencoderKL forwards, and riffusion_inpaint_image, with the same
weights and draws (seeded CPU generators), fp32 with TF32 off. At
``tiny()`` widths; these tests need a GPU and skip without one. Then the
UNet's 3x3 convolution kernel (ops/sd_conv3x3.py) at every shape the
full-width model routes to it, against F.conv2d in float64, and one
full-width InpaintSampler step through it against the same step on
F.conv2d.

The bounds are the CPU tests' against the JAX package
(tests/test_torch_sd.py, tests/test_torch_riffusion.py): forwards within
1e-5 of the output's peak, the inpaint's latents within 1e-4 of their
peak and its image within 1 uint8 level.

The GPU machine has no JAX, and tests/conftest.py imports it, so this
file imports no JAX and runs there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_sd_cuda.py
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from audio_inpainting_torch.models import sd
from audio_inpainting_torch.models.sd import pipeline, unet2d
from audio_inpainting_torch.ops import sd_conv3x3

torch.set_num_threads(1)

FORWARD_RTOL = 1e-5
LATENT_RTOL = 1e-4
# the 3x3 kernel against float64, of the sum of |terms| at each output:
# fp32 chains of at most a few thousand FMAs a slice, then the slices,
# round by about sqrt(length) x 2^-24 ~ 3e-6 of it; an indexing fault
# reads O(1)
CONV_RTOL_OF_TERMS = 1e-5
# one CFG evaluation through the kernel against the same on F.conv2d: the
# denoising check's own limits for a step taken from the port's state
# (benchmark/limits/riffusion-sd1-512.json), a float32 reordering reading
# 1e-5-3e-5 and 1e-7-3e-6 there
STEP_EPS_GAP = 3e-4
STEP_LATENT_GAP = 3e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(cls, cfg, seed):
    """Seeded float32 CPU weights for ``cls(cfg)``: kernels at 1/sqrt(fan-in),
    norm weights near 1, biases small."""
    with torch.device("meta"):
        model = cls(cfg)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, ref in model.state_dict().items():
        a = torch.randn(ref.shape, generator=gen)
        if ref.ndim >= 2:
            a /= float(np.sqrt(ref[0].numel()))
        else:
            a = 1.0 + 0.05 * a if key.endswith("weight") else 0.02 * a
        out[key] = a
    return out


def _peak_err(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.requires_cuda
def test_safetensors_onto_the_card(cuda, tmp_path):
    """A checkpoint read by the port's reader and loaded by load_riffusion
    on the card holds the written tensors exactly."""
    states = {"unet": _state(sd.UNet2DCondition, sd.UNetConfig.tiny(), 0),
              "vae": _state(sd.AutoencoderKL, sd.VAEConfig.tiny(), 1)}
    for sub, state in states.items():
        (tmp_path / sub).mkdir()
        torch.save(state, tmp_path / sub / "diffusion_pytorch_model.bin")
    bundle = sd.load_riffusion(str(tmp_path), sd.UNetConfig.tiny(), sd.VAEConfig.tiny(),
                               load_text=False, device=cuda)
    for sub, state in states.items():
        got = bundle[f"{sub}_params"].state_dict()
        assert all(v.device.type == "cuda" and torch.equal(v.cpu(), state[k])
                   for k, v in got.items())


@pytest.mark.requires_cuda
def test_unet_and_vae_forward_gpu_vs_cpu(cuda):
    gen = torch.Generator().manual_seed(2)
    x, t = torch.randn((2, 4, 16, 16), generator=gen), torch.tensor([981.0, 21.0])
    ctx = torch.randn((2, 7, 16), generator=gen)
    img = torch.rand((1, 3, 32, 32), generator=gen) * 2 - 1
    ustate = _state(sd.UNet2DCondition, sd.UNetConfig.tiny(), 3)
    vstate = _state(sd.AutoencoderKL, sd.VAEConfig.tiny(), 4)
    out = []
    for d in (cuda, torch.device("cpu")):
        unet = sd.load_module(sd.UNet2DCondition, sd.UNetConfig.tiny(), ustate, d)
        vae = sd.load_module(sd.AutoencoderKL, sd.VAEConfig.tiny(), vstate, d)
        with torch.no_grad():
            mean, logvar = vae.encode(img.to(d))
            out.append((unet(x.to(d), t.to(d), ctx.to(d)), mean, logvar,
                        vae.decode(mean)))
    for got, want in zip(*out):
        assert _peak_err(got, want) <= FORWARD_RTOL


@pytest.mark.requires_cuda
def test_inpaint_gpu_vs_cpu(cuda, monkeypatch):
    class Tokenizer:
        model_max_length = 77

        def __call__(self, texts, **kw):
            return type("R", (), {"input_ids": torch.zeros((len(texts), 7), dtype=torch.long)})

    class TextEncoder:
        def __call__(self, ids):
            ctx = np.random.default_rng(3).normal(size=(ids.shape[0], ids.shape[1], 16))
            return type("R", (), {"last_hidden_state": torch.tensor(ctx, dtype=torch.float32)})

    ucfg, vcfg = sd.UNetConfig.tiny(), sd.VAEConfig.tiny()
    ustate, vstate = _state(sd.UNet2DCondition, ucfg, 5), _state(sd.AutoencoderKL, vcfg, 6)
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
    mask = np.zeros((32, 32), np.uint8)
    mask[:, 12:20] = 255
    seen, loop = [], pipeline._denoise_loop
    monkeypatch.setattr(pipeline, "_denoise_loop",
                        lambda *a, **k: seen.append(loop(*a, **k)) or seen[-1])
    images = []
    for d in (cuda, torch.device("cpu")):
        bundle = {"unet_params": sd.load_module(sd.UNet2DCondition, ucfg, ustate, d),
                  "vae_params": sd.load_module(sd.AutoencoderKL, vcfg, vstate, d),
                  "unet_cfg": ucfg, "vae_cfg": vcfg, "tokenizer": Tokenizer(),
                  "text_encoder": TextEncoder()}
        images.append(sd.riffusion_inpaint_image(bundle, img, mask,
                                                 cfg=sd.InpaintConfig(steps=4), key=0))
    assert seen[0].device.type == "cuda"
    assert _peak_err(seen[0], seen[1]) <= LATENT_RTOL
    assert np.abs(images[0].astype(int) - images[1]).max() <= 1


def _routed(cfg, batch, side):
    """The UNet's Conv3x3 shapes at (batch, side^2) latents that take the
    kernel on the card: [((N, C, H, W), C_out)]."""
    return [k for k in unet2d.conv3x3_calls(cfg, batch, side, side)
            if unet2d.takes_kernel(*k, cuda=True, fp32=True, needs_grad=False)]


def _conv_inputs(shape, c_out, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    w = torch.randn((c_out, shape[1], 3, 3), generator=g) / float(np.sqrt(9 * shape[1]))
    b = 0.02 * torch.randn(c_out, generator=g)
    return x.to(device), w.to(device), b.to(device)


@pytest.mark.requires_cuda
def test_conv3x3_kernel_against_float64(cuda):
    """At every routed shape of the full-width UNet at the CFG batch: the
    kernel, and its plain version with the same slices, within
    CONV_RTOL_OF_TERMS of F.conv2d in float64; two calls give the same
    bits; each call is two launches."""
    shapes = _routed(sd.UNetConfig(), 2, 64)
    assert len(shapes) == 12
    for i, (shape, c_out) in enumerate(shapes):
        x, w, b = _conv_inputs(shape, c_out, cuda, seed=i)
        before = sd_conv3x3.LAUNCHES
        y = sd_conv3x3.sd_conv3x3(x, w, b)
        again = sd_conv3x3.sd_conv3x3(x, w, b)
        torch.cuda.synchronize()
        assert sd_conv3x3.LAUNCHES - before == 4
        assert torch.equal(y, again), shape
        x64, w64, b64 = x.double(), w.double(), b.double()
        want = F.conv2d(x64, w64, b64, padding=1)
        terms = F.conv2d(x64.abs(), w64.abs(), b64.abs(), padding=1)
        _, _, slices, per = sd_conv3x3._plan(*shape, c_out, x.get_device())
        plain = sd_conv3x3.sd_conv3x3_ref(x, w, b, slices, per)
        for got in (y, plain):
            assert float(((got.double() - want).abs() / terms).max()) <= CONV_RTOL_OF_TERMS, shape


@pytest.mark.requires_cuda
def test_conv3x3_module_routes_on_the_card(cuda):
    """A routed Conv3x3 launches the kernel twice a call without a graph to
    build and not at all where autograd needs one; a 64^2 input stays on
    F.conv2d; every result agrees with F.conv2d."""
    conv = unet2d.Conv3x3(1280, 640).to(cuda)
    for shape, routed in (((2, 1280, 32, 32), True), ((2, 1280, 64, 64), False)):
        x = torch.randn(shape, device=cuda)
        want = F.conv2d(x, conv.weight, conv.bias, padding=1)
        for grad, launches in ((False, 2 * routed), (True, 0)):
            before = sd_conv3x3.LAUNCHES
            with torch.set_grad_enabled(grad):
                got = conv(x)
            torch.cuda.synchronize()
            assert sd_conv3x3.LAUNCHES - before == launches
            assert got.requires_grad == grad
            assert _peak_err(got, want) <= FORWARD_RTOL


@pytest.mark.requires_cuda
def test_conv3x3_kernel_raises_on_cuda_tensors_it_does_not_take(cuda):
    x, w, b = _conv_inputs((2, 64, 16, 16), 32, cuda)
    refused = [(x.double(), w.double(), b.double()),              # dtype
               (x[:, :, :12, :12].contiguous(), w, b),             # not tiled by 128 pixels
               (x[:, :62].contiguous(), w[:, :62].contiguous(), b),  # C not a multiple of 4
               (x.transpose(2, 3), w, b),                          # not contiguous
               (x, w.cpu(), b)]                                    # weight off the card
    for args in refused:
        before = sd_conv3x3.LAUNCHES
        with pytest.raises((TypeError, ValueError)):
            sd_conv3x3.sd_conv3x3(*args)
        assert sd_conv3x3.LAUNCHES == before


@pytest.mark.requires_cuda
def test_inpaint_step_through_the_kernel(cuda, monkeypatch):
    """One full-width CFG evaluation (InpaintSampler.step) with the 3x3
    convs routed to the kernel against the same step with every conv on
    F.conv2d, from the same state: the guided estimate and the latents
    within the denoising check's limits for such a step; 72 launches."""
    unet = sd.load_module(sd.UNet2DCondition, sd.UNetConfig(),
                          _state(sd.UNet2DCondition, sd.UNetConfig(), 7), cuda)
    g = torch.Generator().manual_seed(8)
    init = torch.randn((1, 4, 64, 64), generator=g).to(cuda)
    hole = torch.zeros((1, 1, 64, 64), device=cuda)
    hole[..., 24:40] = 1.0
    ctx = torch.randn((2, 77, 768), generator=g).to(cuda)
    cfg = sd.InpaintConfig(steps=50)
    out = {}
    for name, routes in (("kernel", unet2d.routes), ("cudnn", lambda *a: False)):
        monkeypatch.setattr(unet2d, "routes", routes)
        sampler = sd.InpaintSampler(unet, init, hole, ctx, 3, cfg)
        before = sd_conv3x3.LAUNCHES
        eps = sampler.step()
        torch.cuda.synchronize()
        out[name] = (eps, sampler.latents, sd_conv3x3.LAUNCHES - before)
    (eps_k, lat_k, launches_k), (eps_c, lat_c, launches_c) = out["kernel"], out["cudnn"]
    assert (launches_k, launches_c) == (72, 0)
    assert _peak_err(eps_k, eps_c) <= STEP_EPS_GAP
    assert _peak_err(lat_k, lat_c) <= STEP_LATENT_GAP
