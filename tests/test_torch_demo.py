"""The port's figures (io/viz.py), the demo page (demo/app.py), the CLI's
``check`` and ``demo``, Part 0's figure wiring and
``extras.run_generate_part1``, on the CPU, beside the JAX package's.

The gradio front-end runs under a stub module that records the component
graph and the callbacks (as tests/test_demo_gradio.py does for the JAX
package); the live API's ``serve`` is replaced, so no socket is opened.
"""

import os
import sys
import types

import jax
import numpy as np
import pytest

import audio_inpainting_tpu.pipelines.extras as jextras
from audio_inpainting_tpu.corrupt import random_dropout_mask as jax_dropout_mask
from audio_inpainting_tpu.demo import app as japp
from audio_inpainting_torch.cli.main import main as tmain
from audio_inpainting_torch.corrupt import synth_music_clip
from audio_inpainting_torch.demo import app
from audio_inpainting_torch.io import read_wav, save_wav_int16, viz
from audio_inpainting_torch.pipelines import extras, part0
from audio_inpainting_torch.pipelines.registry import (ASSET_REGISTRY, DEMO_LABELS,
                                                       VIZ_ARTIFACTS)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class _Component:
    def __init__(self, *a, **kw):
        self.args = a
        self.kw = kw


class _Ctx:
    def __init__(self, *a, **kw):
        self.kw = kw

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _make_stub():
    launched, radios = [], []

    class Blocks(_Ctx):
        def launch(self, **kw):
            launched.append(kw)

    class Radio(_Component):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.handlers = []
            radios.append(self)

        def change(self, fn, inputs=None, outputs=None):
            self.handlers.append((fn, inputs, outputs))

    g = types.ModuleType("gradio")
    g.Blocks, g.Tabs, g.TabItem, g.Row, g.Column, g.Radio = (Blocks, _Ctx, _Ctx, _Ctx, _Ctx,
                                                             Radio)
    for name in ("Markdown", "Textbox", "Audio", "Image"):
        setattr(g, name, type(name, (_Component,), {}))
    return g, launched, radios


@pytest.fixture
def assets(tmp_path):
    """A demo_assets dir where some artifacts exist (part1/ar, part2/gan)
    and the rest are missing."""
    for part, method in (("part1", "ar"), ("part2", "gan")):
        for kind in ("audio", "image"):
            p = tmp_path / ASSET_REGISTRY[part][method][kind]
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"x")
    return str(tmp_path)


def test_gradio_tabs_labels_and_callbacks(assets, monkeypatch):
    stub, launched, radios = _make_stub()
    monkeypatch.setitem(sys.modules, "gradio", stub)
    app._launch_gradio(assets, share=False)
    assert launched == [{"share": False}]
    parts = ["part0", "part1", "part2"]
    assert len(radios) == len(parts)
    for part, radio in zip(parts, radios):
        labels = [lbl for _, lbl in DEMO_LABELS[part]]
        assert radio.kw["choices"] == labels and radio.kw["value"] == labels[0]
        (fn, _, outputs), = radio.handlers
        assert len(outputs) == 3
    # the callbacks run after the tab loop ended, each for its own part
    for part, radio in zip(parts, radios):
        fn = radio.handlers[0][0]
        for key, label in DEMO_LABELS[part]:
            audio, comment, image = fn(label)
            assert (audio, image) == app.get_media_paths(assets, part, key)
            assert comment == app.COMMENTS.get((part, key), "")
    for i, part, key in ((1, "part1", "ar"), (2, "part2", "gan")):
        audio, _, image = radios[i].handlers[0][0](dict(DEMO_LABELS[part])[key])
        assert audio is not None and image is not None


def test_gradio_launch_starts_live_api_on_7861(assets, monkeypatch):
    stub, launched, _ = _make_stub()
    monkeypatch.setitem(sys.modules, "gradio", stub)
    served = []
    monkeypatch.setattr("audio_inpainting_torch.demo.live.serve",
                        lambda assets_dir, port, device: served.append((port, device)))
    app.launch(assets, share=True, device="cpu")
    assert launched == [{"share": True}]
    for _ in range(50):
        if served:
            break
        import time

        time.sleep(0.05)
    assert served == [(7861, "cpu")]


def test_static_launch_without_gradio(assets, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)        # import fails
    served = []
    monkeypatch.setattr("audio_inpainting_torch.demo.live.serve",
                        lambda assets_dir, port, device: served.append((assets_dir, port,
                                                                        device)))
    app.launch(assets, device="cpu")
    assert served == [(assets, 7860, "cpu")]
    with open(os.path.join(assets, "index.html")) as f:
        assert f.read() == app.render_static_html(assets)


def test_static_gallery_includes_live_panel(assets):
    h = app.render_static_html("demo_assets")
    assert "/api/restore" in h and "id='live'" in h
    for m in ("ar", "linear", "nmf", "unet", "diffusion"):
        assert f"value='{m}'" in h
    assert "window_s" in h
    # the page and the commentary are the JAX package's, file for file
    assert app.render_static_html(assets) == japp.render_static_html(assets)
    assert app.COMMENTS == japp.COMMENTS


def test_cli_demo_passes_its_options(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(app, "launch", lambda *a, **k: calls.append((a, k)))
    assert tmain(["demo", "--assets-dir", str(tmp_path), "--share", "--device", "cpu"]) == 0
    assert calls == [((str(tmp_path),), {"share": True, "device": "cpu"})]


def test_cli_check(tmp_path, capsys):
    rels = [rel for methods in ASSET_REGISTRY.values() for kinds in methods.values()
            for rel in kinds.values()]
    for rel in rels:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"x")
    assert tmain(["check", "--assets-dir", str(tmp_path)]) == 0
    assert "asset contract complete" in capsys.readouterr().out
    os.remove(tmp_path / rels[7])
    assert tmain(["check", "--assets-dir", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "MISSING 1 artifacts" in out and rels[7] in out


@pytest.mark.parametrize("argv, code", [(["check"], 1), (["--help"], 0)])
def test_console_entry_exits_with_main_code(tmp_path, monkeypatch, capsys, argv, code):
    # the audio-inpainting-torch script of pyproject.toml's [project.scripts]
    from audio_inpainting_torch.cli.main import entry

    if argv == ["check"]:
        argv = ["check", "--assets-dir", str(tmp_path)]      # empty: every artifact missing
    monkeypatch.setattr(sys, "argv", ["audio-inpainting-torch", *argv])
    with pytest.raises(SystemExit) as exit_:
        entry()
    assert exit_.value.code == code
    out = capsys.readouterr().out
    assert ("MISSING" in out) if code else ("usage:" in out)
    with open(os.path.join(os.path.dirname(__file__), "..", "pyproject.toml")) as f:
        assert 'audio-inpainting-torch = "audio_inpainting_torch.cli.main:entry"' in f.read()


def _figure_calls(tmp_path):
    n, sr, gap = 800, 16000, (320, 480)
    t = np.arange(n, dtype=np.float32) / sr
    x = np.sin(2 * np.pi * 200 * t).astype(np.float32)
    seg = x[gap[0]:gap[1]]
    mag = np.abs(np.random.default_rng(0).normal(size=(257, 9)))
    return {
        "gp": lambda p: viz.gp_waveform_viz(t, x, x, np.full(len(seg), 0.1), gap, p),
        "ar": lambda p: viz.ar_waveform_viz(t, x, x, seg, seg[::-1], gap, p, order=30),
        "ar_texture": lambda p: viz.ar_texture_waveform_viz(t, x, x, gap, p),
        "nmf": lambda p: viz.nmf_waveform_viz(x, x, gap, sr, mag, p),
    }


@pytest.mark.parametrize("figure", ["gp", "ar", "ar_texture", "nmf"])
def test_figure_png_and_none_without_matplotlib(tmp_path, monkeypatch, figure):
    draw = _figure_calls(tmp_path)[figure]
    path = str(tmp_path / "f" / f"{figure}.png")
    assert draw(path) == path
    with open(path, "rb") as f:
        assert f.read(8) == PNG_SIGNATURE
    monkeypatch.setitem(sys.modules, "matplotlib", None)    # import fails
    other = str(tmp_path / "g" / f"{figure}.png")
    assert draw(other) is None and not os.path.exists(other)


def test_part0_writes_its_figures(tmp_path, monkeypatch):
    """run_part0 draws the four waveform figures (five files: the GP's on
    the segment and on the synthetic signal); the GP fit and the NMF are
    stubbed, their numbers are tests/test_torch_part1.py's."""
    monkeypatch.setattr(part0, "gp_restore",
                        lambda sig, *a, **k: (sig.copy(), np.full(160, 0.1, np.float32)))
    monkeypatch.setattr(part0, "nmf_inpaint_iterative", lambda mag, *a, **k: mag)
    part0.run_part0(None, str(tmp_path), seed=0, device="cpu")
    figures = [rel for rel in VIZ_ARTIFACTS if rel.startswith("part0/")]
    assert len(figures) == 5
    for rel in figures:
        with open(tmp_path / rel, "rb") as f:
            assert f.read(8) == PNG_SIGNATURE, rel


def test_run_generate_part1_matches_jax(tmp_path, monkeypatch):
    """The JAX package's dropout mask injected: the damaged and original
    WAVs byte-equal, the linear fill within one int16 step, the metrics
    within 0.01 dB."""
    sr = 8000
    clip = str(tmp_path / "clip.wav")
    save_wav_int16(synth_music_clip(0, sr, 2.0), sr, clip)
    monkeypatch.setattr(extras, "_draw_mask", lambda seed, n, ratio: np.asarray(
        jax_dropout_mask(jax.random.PRNGKey(seed), n, mask_ratio=ratio)))
    got = extras.run_generate_part1(clip, str(tmp_path / "torch"), seed=3, device="cpu")
    want = jextras.run_generate_part1(clip, str(tmp_path / "jax"), seed=3)
    assert got["lost_fraction"] == want["lost_fraction"] > 0.1
    for key in ("damaged_snr_db", "linear_snr_db"):
        assert abs(got[key] - want[key]) <= 0.01, key
    for name in ("damaged_random", "fixed_linear_random", "original"):
        (sr_t, a), (sr_j, b) = (read_wav(str(tmp_path / d / f"{name}.wav"))
                                for d in ("torch", "jax"))
        assert sr_t == sr_j == sr
        step = 1 if name == "fixed_linear_random" else 0
        assert np.abs(a.astype(int) - b.astype(int)).max() <= step, name
        with open(tmp_path / "torch" / f"spec_{name}.png", "rb") as f:
            assert f.read(8) == PNG_SIGNATURE
