"""The port's stepwise SD sampler (models/sd/pipeline.py ``InpaintSampler``)
and the Riffusion path's analysis and synthesis (methods/diffusion.py)
against the benchmark's plain PyTorch reference (benchmark/reference/
sd.py), on the CPU at the ``tiny()`` widths, with the same seeded weights
(benchmark/sd_inputs.py), prompt encoding and draws.

Tolerances, each of the reference's largest magnitude:
- a UNet forward, the VAE's encode and decode: 1e-5. Both sides are
  float32 with other summation orders (the reference takes attention head
  by head, scales the scores before the softmax and uses diffusers' PLMS
  coefficients); measured 4e-7 to 7e-7.
- the sampler's first three evaluations: 3e-4 for the guided estimate and
  the latents. Each evaluation feeds the next, the guidance multiplies the
  two branches' difference by 7.5 and a UNet on random weights amplifies
  its input's rounding; measured 9e-6 after one evaluation and 7e-5 (the
  estimate) and 2e-5 (the latents) after three.
- ``riffusion_restore_audio`` against the reference's analysis, sampler,
  decode and synthesis: 1e-5 of the audio's peak. The canvas, the decoded
  uint8 image and Griffin-Lim's input agree bit for bit at this size
  (measured 0); one uint8 level of one pixel in the hole would read about
  1e-3.
Also: the stepwise loop equals ``_denoise_loop`` and
``riffusion_inpaint_image`` bit for bit; the reference's process loads
nothing of the port or of JAX; ``benchmark/counting_sd.py``'s closed
forms equal ``torch.utils.flop_counter`` at full width on meta tensors.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import audio_inpainting_torch.methods.diffusion as tdiff
from audio_inpainting_torch.models import sd
from audio_inpainting_torch.models.sd import pipeline
from benchmark import counting_sd, gen, sd_inputs
from benchmark.reference import sd as ref

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "configs", "riffusion_sd1.json")) as fh:
    FULL = json.load(fh)
SEED = 2**31 + 19
FORWARD_RTOL = 1e-5
LOOP_RTOL = 3e-4
AUDIO_RTOL = 1e-5
STEPS = 3


def tiny_config() -> dict:
    """The configuration at the port's UNetConfig.tiny() and
    VAEConfig.tiny() widths, a 32^2 canvas and 3 steps."""
    c = copy.deepcopy(FULL)
    u, v = sd.UNetConfig.tiny(), sd.VAEConfig.tiny()
    c["unet"].update(block_out_channels=list(u.block_out_channels),
                     layers_per_block=u.layers_per_block,
                     cross_attention_dim=u.cross_attention_dim,
                     attention_head_dim=u.attention_head_dim, norm_num_groups=u.norm_groups,
                     down_block_types=list(u.down_types), up_block_types=list(u.up_types))
    c["vae"].update(block_out_channels=list(v.block_out_channels),
                    layers_per_block=v.layers_per_block, norm_num_groups=v.norm_groups)
    c["sampler"].update(steps=STEPS, canvas=32)
    c["context"].update(width=u.cross_attention_dim)
    return c


CFG = tiny_config()


def _port_bundle(seed: int) -> dict:
    out = {"unet_cfg": sd.UNetConfig.tiny(), "vae_cfg": sd.VAEConfig.tiny(),
           "context": sd_inputs.context(seed, 77, CFG["context"]["width"], "cpu")}
    for key, cls, cfg, part in (("unet_params", sd.UNet2DCondition, out["unet_cfg"], "unet"),
                                ("vae_params", sd.AutoencoderKL, out["vae_cfg"], "vae")):
        with torch.device("meta"):
            shapes = {k: tuple(t.shape) for k, t in cls(cfg).state_dict().items()}
        out[key] = sd.load_module(cls, cfg, sd_inputs.state(shapes, seed, part, "cpu"), "cpu")
    return out


@pytest.fixture(scope="module")
def pair():
    """(the port's bundle, the reference's model) of the same weights."""
    return _port_bundle(SEED), ref.Model(CFG, SEED, "cpu")


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _clip():
    """A 1 s clip at 8 kHz with a centred 0.5 s hole, as the traffic makes
    it (gen.py)."""
    traffic = {"clips_per_request": 1, "sample_rate": 8000, "clip_seconds": 1.0,
               "damage": {"kind": "centre_hole", "half_seconds": 0.25}, "originals": False}
    return gen.make_request(traffic, CFG, SEED, 0)


def test_the_reference_keys_are_the_checkpoints():
    with open(os.path.join(ROOT, "tests", "golden", "sd_v1_manifest.json")) as fh:
        manifest = json.load(fh)
    assert {k: list(s) for k, s in ref.unet_shapes(FULL["unet"]).items()} == manifest["unet"]
    assert {k: list(s) for k, s in ref.vae_shapes(FULL["vae"]).items()} == manifest["vae"]


def test_unet_vae_forwards_match_the_reference(pair):
    bundle, model = pair
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 4, 8, 8), generator=g)
    t = torch.tensor([981.0, 981.0])
    img = torch.rand((1, 3, 32, 32), generator=g) * 2 - 1
    z = torch.randn((1, 4, 16, 16), generator=g)
    with torch.no_grad():
        assert _gap(bundle["unet_params"](x, t, bundle["context"]),
                    ref.unet(model, x, t, model.context)) <= FORWARD_RTOL
        mean, logvar = bundle["vae_params"].encode(img)
        want_mean, want_logvar = ref.vae_encode(model, img)
        assert _gap(mean, want_mean) <= FORWARD_RTOL
        assert _gap(logvar, want_logvar) <= FORWARD_RTOL
        assert _gap(bundle["vae_params"].decode(z), ref.vae_decode(model, z)) <= FORWARD_RTOL


def test_the_reference_resizes_as_pil_and_the_port():
    rng = np.random.default_rng(3)
    for shape, size in (((1025, 862, 3), (512, 512)), ((512, 512, 3), (862, 1025)),
                        ((1025, 16), (32, 32))):
        img = np.clip(np.cumsum(rng.normal(size=shape), axis=0) * 4 + 128
                      + rng.normal(size=shape) * 30, 0, 255).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize(size))
        np.testing.assert_array_equal(ref.resize(img, size), want)
        np.testing.assert_array_equal(tdiff.resize_image(img, size), want)


def test_the_sampler_follows_the_reference_for_three_evaluations(pair):
    bundle, model = pair
    req = _clip()
    a = tdiff.riffusion_analysis(req.damaged[0], 32, "cpu")
    want = ref.analyse(req.damaged[0], CFG, "cpu")
    np.testing.assert_array_equal(a.canvas, want["canvas"])
    np.testing.assert_array_equal(a.canvas_mask, want["canvas_mask"])
    sampler = sd.InpaintSampler.start(bundle, a.canvas, a.canvas_mask, bundle["context"],
                                      req.seed, sd.InpaintConfig(steps=STEPS))
    fixed = ref.prepare(model, want, req.seed)
    st = fixed["start"]
    assert _gap(sampler.latents, st["latents"]) <= LOOP_RTOL
    for _ in range(3):
        eps = sampler.step()
        want_eps, st = ref.evaluate(model, fixed, st)
        assert _gap(eps, want_eps) <= LOOP_RTOL
        assert _gap(sampler.latents, st["latents"]) <= LOOP_RTOL
    assert sampler.index == st["index"] == 3


def test_riffusion_restore_audio_matches_the_reference(pair):
    """The whole path, analysis, sampler and synthesis, with the bundle's
    precomputed context in place of a tokenizer and text encoder."""
    bundle, model = pair
    req = _clip()
    out = tdiff.riffusion_restore_audio(req.damaged[0], 8000, steps=STEPS, key=req.seed,
                                        bundle=bundle, image_size=32, device="cpu")
    a = ref.analyse(req.damaged[0], CFG, "cpu")
    fixed = ref.prepare(model, a, req.seed)
    st = fixed["start"]
    while st["index"] < len(fixed["table"]):
        _, st = ref.evaluate(model, fixed, st)
    want = ref.synthesise(ref.decode(model, st["latents"]), a, CFG, req.seed, "cpu")
    assert out.dtype == np.float32 and out.shape == want.shape
    assert np.abs(out - want).max() <= AUDIO_RTOL * np.abs(want).max()


def test_the_stepwise_loop_is_the_denoise_loop_and_the_inpaint_bit_for_bit(pair, monkeypatch):
    bundle, _ = pair
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
    mask = np.zeros((32, 32), np.uint8)
    mask[:, 12:20] = 255
    cfg = sd.InpaintConfig(steps=STEPS)
    sampler = sd.InpaintSampler.start(bundle, img, mask, bundle["context"], 5, cfg)
    latents0, hole = sampler.init_latents.clone(), sampler.hole_mask.clone()
    estimates = []
    while not sampler.done:
        estimates.append(sampler.step())
    assert len(estimates) == STEPS + 1
    with pytest.raises(RuntimeError, match="all 4 evaluations"):
        sampler.step()
    full_cfg = pipeline._config_for(bundle, cfg)
    looped = pipeline._denoise_loop(bundle["unet_params"], latents0, hole, bundle["context"], 5,
                                    full_cfg)
    assert torch.equal(looped, sampler.latents)
    seen = []
    loop = pipeline._denoise_loop
    monkeypatch.setattr(pipeline, "_denoise_loop",
                        lambda *a, **k: seen.append(loop(*a, **k)) or seen[-1])
    image = sd.riffusion_inpaint_image(bundle, img, mask, cfg=cfg, key=5)
    assert torch.equal(seen[0], sampler.latents)
    np.testing.assert_array_equal(image, sampler.finish())


def test_a_bundle_context_stands_in_for_the_text_encoder(pair):
    bundle, _ = pair
    ctx = bundle["context"]

    class Tokenizer:
        model_max_length = 77

        def __call__(self, texts, **kw):
            return type("R", (), {"input_ids": np.zeros((len(texts), 77), np.int64)})

    class TextEncoder:
        def __call__(self, ids):
            return type("R", (), {"last_hidden_state": ctx.clone()})

    text = {k: v for k, v in bundle.items() if k != "context"}
    text.update(tokenizer=Tokenizer(), text_encoder=TextEncoder())
    req = _clip()
    a = tdiff.riffusion_restore_audio(req.damaged[0], 8000, steps=STEPS, key=3, bundle=bundle,
                                      image_size=32, device="cpu")
    b = tdiff.riffusion_restore_audio(req.damaged[0], 8000, steps=STEPS, key=3, bundle=text,
                                      image_size=32, device="cpu")
    np.testing.assert_array_equal(a, b)


def test_the_references_process_loads_nothing_of_the_port_or_jax():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import numpy as np, torch\n"
            "from benchmark.reference import sd as ref\n"
            "from benchmark import run\n"
            "cfg = json.loads(%r)\n"
            "m = ref.Model(cfg, 5, 'cpu')\n"
            "x = np.random.default_rng(0).standard_normal(8000).astype(np.float32)\n"
            "x[3000:5000] = 0\n"
            "a = ref.analyse(x, cfg, 'cpu')\n"
            "fixed = ref.prepare(m, a, 5)\n"
            "eps, st = ref.evaluate(m, fixed, fixed['start'])\n"
            "ref.synthesise(ref.decode(m, st['latents']), a, cfg, 5, 'cpu')\n"
            "print(run.forbidden_modules(), sorted({n.split('.')[0] for n in sys.modules}"
            " & {'audio_inpainting_torch'}))\n") % (ROOT, json.dumps(CFG))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def _flops(fn, *args) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"), FlopCounterMode(display=False) as fc:
        fn(*(torch.zeros(a) if isinstance(a, tuple) else a for a in args))
    return fc.get_total_flops()


def test_the_closed_form_flops_are_the_flop_counters_at_full_width():
    with torch.device("meta"):
        unet, vae = sd.UNet2DCondition(), sd.AutoencoderKL()
    step = _flops(unet, (2, 4, 64, 64), (2,), (2, 77, 768))
    encode = _flops(vae.encode, (1, 3, 512, 512))
    decode = _flops(vae.decode, (1, 4, 64, 64))
    assert (step, encode, decode) == (counting_sd.step_flops(FULL),
                                      counting_sd.encode_flops(FULL),
                                      counting_sd.decode_flops(FULL))
    assert [round(f / 1e8) / 10 for f in (step, encode, decode)] == [1606.5, 1116.7, 2514.5]
    # and at the tiny widths, which reach the closed forms' other branches
    with torch.device("meta"):
        unet, vae = sd.UNet2DCondition(sd.UNetConfig.tiny()), sd.AutoencoderKL(sd.VAEConfig.tiny())
    assert _flops(unet, (2, 4, 16, 16), (2,), (2, 77, 16)) == counting_sd.step_flops(CFG)
    assert _flops(vae.encode, (1, 3, 32, 32)) == counting_sd.encode_flops(CFG)
    assert _flops(vae.decode, (1, 4, 16, 16)) == counting_sd.decode_flops(CFG)


def test_the_attention_bound_by_hand():
    """Self-attention at 64^2 latents, batch 2, 8 heads of 40: 42.9 GFLOP
    at 67 TFLOP/s (0.64 ms) over 41.9 MB at 3.35 TB/s (12.5 us)."""
    flops = 4 * 2 * 8 * 4096 * 4096 * 40
    assert counting_sd.attention_bound_s(2, 8, 4096, 4096, 40) == pytest.approx(flops / 67e12)
    nbytes = 4 * 2 * 8 * 40 * (2 * 4096 + 2 * 77)
    assert counting_sd.attention_bound_s(2, 8, 4096, 77, 40) == pytest.approx(
        max(4 * 2 * 8 * 4096 * 77 * 40 / 67e12, nbytes / 3.35e12))
