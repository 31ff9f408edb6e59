"""The port's Stable Diffusion path on the GPU against the same functions on
the CPU: the safetensors reader onto the card, the UNet2DCondition and
AutoencoderKL forwards, and riffusion_inpaint_image, with the same
weights and draws (seeded CPU generators), fp32 with TF32 off. At
``tiny()`` widths; these tests need a GPU and skip without one.

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

from audio_inpainting_torch.models import sd
from audio_inpainting_torch.models.sd import pipeline

torch.set_num_threads(1)

FORWARD_RTOL = 1e-5
LATENT_RTOL = 1e-4


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
