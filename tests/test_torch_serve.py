"""The port's batch serving (pipelines/serve.py) and the CLI's ``serve`` and
``score`` against the JAX package's, on the CPU. Mirrors
tests/test_serve.py and tests/test_score_cli.py.

The U-Net serve is held to the JAX serve with the JAX stripes and init
injected: the batched composites within 5e-4 of their peak (the bound of
tests/test_torch_neural.py for a composite mask that differs from the
training mask), and the WAVs sample by sample outside the frames that
reach into a hole (>= 60 dB). Inside a hole the fill takes the phase of
the damaged STFT, the angle of rounding noise, which differs between the
packages' STFTs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.methods.neural as jn
import audio_inpainting_tpu.pipelines.serve as jserve
from audio_inpainting_tpu.models.packed_unet import PackedSimpleUNet
import audio_inpainting_torch.methods.neural as tn
import audio_inpainting_torch.pipelines.serve as tserve
from audio_inpainting_tpu.cli.main import main as jmain
from audio_inpainting_torch.cli.main import main as tmain
from audio_inpainting_torch.convert import flax_to_state_dict
from audio_inpainting_torch.io import load_mono_normalized, save_wav_int16
from audio_inpainting_torch.parallel.batch import clip_seeds

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

OUTSIDE_AGREEMENT_DB = 60.0
COMPOSITE_RTOL_OF_PEAK = 5e-4
GAP = (1000, 3000)


def _jax_unet_init(keys):
    """A stand-in for the port's ``_draw_init`` (U-Net only): seed s draws
    the JAX package's init from ``keys[s]``, converted."""
    def draw(kind, seed, attempt, shape):
        x = jnp.zeros((1, *shape, 1), jnp.float32)
        return [flax_to_state_dict(jn._jit_init(PackedSimpleUNet(), keys[seed],
                                                x)["params"])]
    return draw


def _make_corpus(tmp_path, sr=8000, n=2):
    """Short tone clips with a silent dropout; unequal lengths
    (tests/test_serve.py's corpus)."""
    rng = np.random.RandomState(0)
    din = tmp_path / "in"
    dorig = tmp_path / "orig"
    din.mkdir()
    dorig.mkdir()
    names = []
    for i in range(n):
        dur = sr // 2 + i * 1024          # unequal lengths
        t = np.arange(dur)
        x = (0.6 * np.sin(2 * np.pi * (220 + 60 * i) * t / sr)
             + 0.05 * rng.randn(dur)).astype(np.float32)
        x /= np.abs(x).max()
        dmg = x.copy()
        dmg[GAP[0]:GAP[1]] = 0.0
        name = f"clip{i}.wav"
        save_wav_int16(dmg, sr, str(din / name))
        save_wav_int16(x, sr, str(dorig / name))
        names.append(name)
    return din, dorig, names, sr


def test_serve_unet_restores_every_clip(tmp_path):
    din, _, names, sr = _make_corpus(tmp_path)
    dout = tmp_path / "out"
    res = tserve.run_serve(str(din), str(dout), method="unet", epochs=30, seed=0,
                           device="cpu")
    assert res["clips"] == len(names)
    for name in names:
        sr_i, dmg = load_mono_normalized(str(din / name))
        sr_o, out = load_mono_normalized(str(dout / name))
        assert sr_o == sr_i and len(out) == len(dmg)
        assert np.isfinite(out).all()
        assert res["files"][name]["damaged_cols"] > 0      # the dropout found
        n_keep = sr // 16       # the intact prefix survives the round trip
        assert float(np.sqrt(np.mean((out[:n_keep] - dmg[:n_keep]) ** 2))) < 0.1


def test_serve_unet_matches_jax(tmp_path, monkeypatch):
    """run_serve(method="unet") of both packages on the same corpus, with
    the JAX serve's stripes (fold_in of the clip index) and per-clip init
    keys (split of PRNGKey(seed)) injected into the port: the batched
    composites, and the WAVs outside the holes' frames."""
    import audio_inpainting_tpu.parallel.batch as jbatch
    import audio_inpainting_torch.parallel as tparallel

    din, _, names, sr = _make_corpus(tmp_path)
    seed = 1
    keys = jax.random.split(jax.random.PRNGKey(seed), len(names))
    monkeypatch.setattr(tn, "_draw_init", _jax_unet_init(
        {s: keys[i] for i, s in enumerate(clip_seeds(seed, len(names)))}))
    monkeypatch.setattr(tserve, "_synthetic_train_masks", jserve._synthetic_train_masks)
    composites = []
    for module in (jbatch, tparallel):
        real = module.restore_clips_unet

        def spy(*a, _real=real, **k):
            out = _real(*a, **k)
            composites.append(np.asarray(out[0]))
            return out

        monkeypatch.setattr(module, "restore_clips_unet", spy)
    jserve.run_serve(str(din), str(tmp_path / "want"), method="unet", epochs=5, seed=seed)
    tserve.run_serve(str(din), str(tmp_path / "got"), method="unet", epochs=5, seed=seed,
                     device="cpu")
    want_c, got_c = composites
    assert np.abs(got_c - want_c).max() <= COMPOSITE_RTOL_OF_PEAK * np.abs(want_c).max()
    for name in names:
        _, want = load_mono_normalized(str(tmp_path / "want" / name))
        _, got = load_mono_normalized(str(tmp_path / "got" / name))
        hole = np.zeros(len(want), bool)
        hole[GAP[0]:GAP[1]] = True
        near = np.convolve(hole, np.ones(1025), "same") > 0   # 1024-point frames
        err = np.sum((want[~near].astype(np.float64) - got[~near]) ** 2)
        assert 10 * np.log10(np.sum(want[~near].astype(np.float64) ** 2)
                             / max(err, 1e-30)) >= OUTSIDE_AGREEMENT_DB


def test_serve_gan_needs_and_uses_the_originals(tmp_path):
    din, dorig, names, sr = _make_corpus(tmp_path)
    dout = tmp_path / "out_gan"
    with pytest.raises(ValueError, match="originals"):
        tserve.run_serve(str(din), str(dout), method="gan", epochs=4, device="cpu")
    res = tserve.run_serve(str(din), str(dout), method="gan", epochs=4,
                           originals_dir=str(dorig), seed=0, device="cpu")
    for name in names:
        _, out = load_mono_normalized(str(dout / name))
        assert np.isfinite(out).all()
    assert res["method"] == "gan"


def test_serve_gan_is_restore_clips_gan(tmp_path, monkeypatch):
    """The GAN branch hands restore_clips_gan serving's config: bf16, the
    gap-scoped EMA at 0.99, the retry only at the full 1500-epoch budget,
    every clip real (no ``n_real``: serving pads no duplicates); and the
    clips' true extents as valid."""
    import audio_inpainting_torch.parallel as tparallel

    calls = []
    real = tparallel.restore_clips_gan

    def spy(norm, rnorm, masks, cfg, seed, **kw):
        calls.append((norm.shape, cfg, seed, kw))
        return real(norm, rnorm, masks, cfg, seed, **kw)

    monkeypatch.setattr(tparallel, "restore_clips_gan", spy)
    din, dorig, names, _ = _make_corpus(tmp_path)
    tserve.run_serve(str(din), str(tmp_path / "o"), method="gan", epochs=2,
                     originals_dir=str(dorig), seed=3, device="cpu")
    (shape, cfg, seed, kw), = calls
    assert shape[0] == len(names) and shape[1] % 4 == 0 and shape[2] % 32 == 0
    assert (cfg.bf16, cfg.ema_decay, cfg.ema_scope, cfg.retry_l1) == (True, 0.99, "gap", 0.0)
    assert seed == 3 and "n_real" not in kw
    assert kw["valid_batch"][0].sum() < kw["valid_batch"][1].sum()   # unequal lengths


def test_serve_windowed_long_files(tmp_path):
    """--window-s serving: each clip restores only windows around its
    damage; every output written, the holes filled."""
    din, dout = tmp_path / "in", tmp_path / "out"
    din.mkdir()
    sr = 8000
    originals, gaps = {}, (12_000, 12_600)
    for k in range(2):
        t = np.arange(4 * sr)
        x = (0.6 * np.sin(2 * np.pi * (1.5 + k) * t / sr)).astype(np.float32)
        d = x.copy()
        d[gaps[0]:gaps[1]] = 0.0
        save_wav_int16(d, sr, str(din / f"c{k}.wav"))
        originals[f"c{k}.wav"] = x
    res = tserve.run_serve(str(din), str(dout), method="linear", window_s=0.5,
                           device="cpu")
    assert res["window_s"] == 0.5 and len(res["files"]) == 2
    for name, clean in originals.items():
        _, y = load_mono_normalized(str(dout / name))
        _, d = load_mono_normalized(str(din / name))
        g = slice(*gaps)
        assert np.abs(y[g]).max() > 0.01
        assert (np.mean((y[g] - clean[g] / np.abs(clean).max()) ** 2)
                < np.mean((d[g] - clean[g] / np.abs(clean).max()) ** 2))


def test_serve_windowed_unet_batches_the_windows(tmp_path, monkeypatch):
    """--window-s with unet: restore_windowed with batch_windows=True."""
    import audio_inpainting_torch.methods.windowed as twin

    seen = []
    real = twin.restore_windowed

    def spy(x, sr, **kw):
        seen.append(kw)
        return real(x, sr, **kw)

    monkeypatch.setattr(twin, "restore_windowed", spy)
    din, _, names, _ = _make_corpus(tmp_path)
    tserve.run_serve(str(din), str(tmp_path / "o"), method="unet", epochs=2,
                     window_s=0.5, device="cpu")
    assert len(seen) == len(names)
    assert all(kw["batch_windows"] and kw["epochs"] == 2 for kw in seen)


def test_serve_command(tmp_path, capsys):
    din, _, names, _ = _make_corpus(tmp_path)
    dout = tmp_path / "out_cli"
    rc = tmain(["serve", str(din), str(dout), "--method", "unet",
                "--epochs", "10", "--json", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)["serve"]
    assert out["clips"] == len(names) and set(out["files"]) == set(names)
    for name in names:
        assert (dout / name).exists()


@pytest.mark.parametrize("method", ["linear", "ar"])
def test_serve_facade_methods(tmp_path, method):
    """The other methods restore clip by clip through the facade: each
    output is the facade's restore of that clip."""
    from audio_inpainting_torch import restore

    din, _, names, sr = _make_corpus(tmp_path)
    dout = tmp_path / f"out_{method}"
    res = tserve.run_serve(str(din), str(dout), method=method, device="cpu")
    assert res["method"] == method
    for name in names:
        _, x = load_mono_normalized(str(din / name))
        save_wav_int16(restore(x, sr, method=method, device="cpu"), sr,
                       str(tmp_path / "facade.wav"))
        assert (dout / name).read_bytes() == (tmp_path / "facade.wav").read_bytes()


def test_serve_skips_unreadable_files(tmp_path):
    din, _, names, _ = _make_corpus(tmp_path)
    (din / "broken.wav").write_bytes(b"not a riff file at all")
    dout = tmp_path / "out_skip"
    res = tserve.run_serve(str(din), str(dout), method="linear", device="cpu")
    assert len(res["skipped"]) == 1
    assert res["skipped"][0]["file"] == "broken.wav"
    for name in names:
        assert (dout / name).exists()


def test_serve_gan_skips_a_clip_without_original(tmp_path):
    din, dorig, names, _ = _make_corpus(tmp_path)
    (dorig / names[1]).unlink()                      # second original gone
    dout = tmp_path / "out_gan_missing"
    res = tserve.run_serve(str(din), str(dout), method="gan", epochs=3,
                           originals_dir=str(dorig), device="cpu")
    assert (dout / names[0]).exists()
    assert not (dout / names[1]).exists()
    assert any(s["file"] == names[1] for s in res["skipped"])


def test_serve_devices_validation(tmp_path):
    din, _, names, _ = _make_corpus(tmp_path)
    with pytest.raises(ValueError):
        tserve.run_serve(str(din), str(tmp_path / "x"), method="linear", devices=0,
                         device="cpu")
    # more devices than one GPU: clamped, still works
    res = tserve.run_serve(str(din), str(tmp_path / "out_many"), method="linear",
                           devices=10_000, device="cpu")
    assert res["clips"] == len(names)


def test_serve_wants_a_gpu_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    din, _, _, _ = _make_corpus(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run_serve(str(din), str(tmp_path / "o"), method="linear")


def test_synthetic_train_masks_short_clips_always_trainable():
    """Every clip gets >= 1 trainable cell (intact AND hidden), and no
    stripe spills into the batch padding (tests/test_serve.py's case)."""
    t_pad = 64
    frame_counts = [2, 5, 17, 40, 64]       # all below the ~50-frame cliff
    clips = [(None, None, np.zeros((9, t)), None, None) for t in frame_counts]
    masks = np.ones((len(clips), 9, t_pad), np.float32)
    masks[3, :, :20] = 0.0                   # clip 3: leading real damage
    syn = tserve._synthetic_train_masks(0, clips, masks)
    assert syn.shape == masks.shape
    for i, t in enumerate(frame_counts):
        trainable = (syn[i, :, :t] == 0) & (masks[i, :, :t] == 1)
        assert trainable.any(), f"clip {i} (t={t}) has no trainable cell"
        assert (syn[i, :, t:] == 1).all()
    # per-clip draws: the same clip under another index draws anew
    same = [(None, None, np.zeros((9, 64)), None, None)] * 2
    two = tserve._synthetic_train_masks(0, same, np.ones((2, 9, 64), np.float32))
    assert not np.array_equal(two[0], two[1])


def test_random_frame_mask_min_segments():
    from audio_inpainting_torch.corrupt import random_frame_mask

    # reference semantics: 40 frames -> int(40*0.3/30*2) = 0 stripes
    m0 = random_frame_mask(torch.Generator().manual_seed(0), 4, 40).numpy()
    assert (m0 == 1).all()
    # with the floor: at least one stripe
    m1 = random_frame_mask(torch.Generator().manual_seed(0), 4, 40,
                           min_segments=1).numpy()
    assert (m1 == 0).any()


def test_score_cli_matches_jax(tmp_path, capsys):
    """score: SNR/LSD of restored WAVs against the originals of the same
    names; a restored file without an original says so. The same rows as
    the JAX CLI's, to their two decimals (tests/test_score_cli.py)."""
    sr = 8000
    t = np.arange(sr)
    ref = (0.5 * np.sin(2 * np.pi * 220 * t / sr)).astype(np.float32)
    got = ref + 0.01 * np.sin(2 * np.pi * 700 * t / sr).astype(np.float32)
    dorig, drest = tmp_path / "orig", tmp_path / "rest"
    dorig.mkdir()
    drest.mkdir()
    save_wav_int16(ref, sr, str(dorig / "a.wav"))
    save_wav_int16(got, sr, str(drest / "a.wav"))
    save_wav_int16(got, sr, str(drest / "unmatched.wav"))

    assert tmain(["score", str(drest), str(dorig), "--json", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    row = out["score"]["a.wav"]
    assert 30 < row["snr_db"] < 45        # ~1% additive tone
    assert row["samples"] == sr
    assert out["score"]["unmatched.wav"] == "no original"
    assert jmain(["score", str(drest), str(dorig), "--json"]) == 0
    want = json.loads(capsys.readouterr().out)["score"]
    assert want["unmatched.wav"] == "no original"
    for key in ("snr_db", "lsd_db"):
        assert abs(row[key] - want["a.wav"][key]) <= 0.01, key
    assert tmain(["score", str(drest), str(dorig), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert text.startswith("== score ==") and "no original" in text
