"""The port's live-restore HTTP API (audio_inpainting_torch/demo/live.py):
real requests over a loopback server, restoring an actual damaged clip
through the facade on the CPU. Mirrors tests/test_live_api.py (all but
its gallery test, whose static page the port does not have), and holds
the responses to the facade's bytes and to the JAX package's API."""

import http.server
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import audio_inpainting_tpu.demo.live as jlive
from audio_inpainting_torch import api as tapi
from audio_inpainting_torch.demo.live import (RestoreError, make_handler,
                                              parse_params, restore_wav_bytes)
from audio_inpainting_torch.io import (load_mono_normalized, read_wav,
                                       save_wav_int16)

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)


def _damaged_clip(tmp_path, sr=8000, dur=4000, gap=(1000, 1400)):
    # 1.5 Hz: the 400-sample gap spans <0.1 period near the crest, so a
    # straight-line fill is a genuine improvement over the zero fill (a
    # fast tone's gap covers whole periods, where linear interp can't win).
    t = np.arange(dur)
    x = 0.7 * np.sin(2 * np.pi * 1.5 * t / sr).astype(np.float32)
    dmg = x.copy()
    dmg[gap[0]:gap[1]] = 0.0
    path = str(tmp_path / "damaged.wav")
    save_wav_int16(dmg, sr, path)
    return path, x / np.abs(x).max(), dmg, sr, gap


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    assets = tmp_path_factory.mktemp("assets")
    (assets / "hello.txt").write_text("static ok")
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                          make_handler(str(assets), "cpu"))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    thread.join(timeout=5)


def _post(url, body, **kw):
    req = urllib.request.Request(url, data=body, method="POST", **kw)
    return urllib.request.urlopen(req, timeout=600)


def test_parse_params_validation():
    assert parse_params("method=ar&seed=3") == {"method": "ar", "seed": 3}
    assert parse_params("")["method"] == "ar"
    with pytest.raises(RestoreError):
        parse_params("method=gan")            # needs the clean original
    with pytest.raises(RestoreError):
        parse_params("method=banana")
    with pytest.raises(RestoreError):
        parse_params("verbose=1")             # unknown param fails loudly
    with pytest.raises(RestoreError):
        parse_params("seed=abc")


def test_restore_wav_bytes_rejects_garbage():
    with pytest.raises(RestoreError):
        restore_wav_bytes(b"not a wav at all", method="linear", device="cpu")


def test_live_restore_linear_end_to_end(server, tmp_path):
    path, clean, dmg, sr, gap = _damaged_clip(tmp_path)
    with open(path, "rb") as f:
        body = f.read()
    resp = _post(f"{server}/api/restore?method=linear&threshold=0.01", body)
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "audio/wav"
    out = tmp_path / "restored.wav"
    out.write_bytes(resp.read())
    sr2, restored = load_mono_normalized(str(out))
    assert sr2 == sr and len(restored) == len(clean)
    # the hole must be filled: restored gap energy > 0, error vs clean
    # smaller than the damaged clip's
    g = slice(*gap)
    assert np.abs(restored[g]).max() > 0.01
    _, dmg_n = load_mono_normalized(path)
    assert (np.mean((restored[g] - clean[g]) ** 2)
            < np.mean((dmg_n[g] - clean[g]) ** 2))


def test_live_restore_ar_param_passthrough(server, tmp_path):
    path, clean, dmg, sr, gap = _damaged_clip(tmp_path)
    with open(path, "rb") as f:
        body = f.read()
    resp = _post(f"{server}/api/restore?method=ar&order=8&seed=1", body)
    assert resp.status == 200
    sr2, data = read_wav_bytes(resp.read(), tmp_path)
    assert sr2 == sr and len(data) == len(clean)


def read_wav_bytes(body, tmp_path):
    p = tmp_path / "resp.wav"
    p.write_bytes(body)
    return read_wav(str(p))


def test_live_api_errors(server, tmp_path):
    path, *_ = _damaged_clip(tmp_path)
    with open(path, "rb") as f:
        body = f.read()
    # gan refused with a clear message
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{server}/api/restore?method=gan", body)
    assert e.value.code == 400
    assert "ground truth" in json.loads(e.value.read())["error"]
    # param not valid for the method -> 400 (not a 500)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{server}/api/restore?method=ar&train_steps=1", body)
    assert e.value.code == 400
    # empty body
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{server}/api/restore?method=linear", b"")
    assert e.value.code == 400
    # unknown POST route
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{server}/api/nope", body)
    assert e.value.code == 404


def test_methods_listing_and_static(server):
    with urllib.request.urlopen(f"{server}/api/methods", timeout=60) as r:
        listing = json.loads(r.read())
    assert "linear" in listing["methods"] and "gan" not in listing["methods"]
    with urllib.request.urlopen(f"{server}/hello.txt", timeout=60) as r:
        assert r.read() == b"static ok"


def test_windowed_restore_via_api(server, tmp_path):
    """window_s routes to the windowed long-clip path: clean samples pass
    through, the hole is filled from a window around it."""
    path, clean, dmg, sr, gap = _damaged_clip(tmp_path)
    with open(path, "rb") as f:
        body = f.read()
    resp = _post(
        f"{server}/api/restore?method=linear&window_s=0.2&threshold=0.01",
        body)
    assert resp.status == 200
    sr2, data = read_wav_bytes(resp.read(), tmp_path)
    x = data.astype(np.float32) / 32767.0
    g = slice(*gap)
    assert np.abs(x[g]).max() > 0.01
    _, dmg_n = load_mono_normalized(path)
    assert (np.mean((x[g] - clean[g]) ** 2)
            < np.mean((dmg_n[g] - clean[g]) ** 2))


def test_gp_long_upload_allowed_with_window(server, tmp_path):
    """The GP O(n^3) guard moves to the WINDOW size when window_s is given:
    a long upload restores fine windowed, still refused un-windowed."""
    sr, n = 8000, 30_000
    t = np.arange(n)
    x = (0.6 * np.sin(2 * np.pi * 1.5 * t / sr)).astype(np.float32)
    x[12_000:12_150] = 0.0
    p = tmp_path / "long_gp.wav"
    save_wav_int16(x, sr, str(p))
    resp = _post(f"{server}/api/restore?method=gp&window_s=0.15", p.read_bytes())
    assert resp.status == 200
    # a window_s that still exceeds 20000 samples is refused with the hint
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{server}/api/restore?method=gp&window_s=3.0", p.read_bytes())
    assert e.value.code == 400
    assert "window_s" in json.loads(e.value.read())["error"]


def test_gp_rejects_long_uploads(server, tmp_path):
    """GP is O(n^3) — a full-length upload would hold the restore lock for
    hours; the API refuses over 20k samples with a 400."""
    sr = 44100
    x = (0.5 * np.sin(np.arange(sr) * 0.05)).astype(np.float32)
    p = tmp_path / "long.wav"
    save_wav_int16(x, sr, str(p))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{server}/api/restore?method=gp", p.read_bytes())
    assert e.value.code == 400
    assert "20000" in json.loads(e.value.read())["error"]


def test_parse_params_bounds():
    """Whitelisted params are range-checked before any compute: a negative
    seed or a 2e9-epoch budget must die at parse time, not inside lax.scan
    (or after holding the restore lock for days)."""
    for bad in ("seed=-1", "epochs=0", "epochs=20001", "train_steps=0",
                "order=0", "order=1001", "threshold=1.5", "threshold=-0.1"):
        with pytest.raises(RestoreError) as e:
            parse_params(bad)
        assert "out of range" in str(e.value)
    # boundary values are accepted
    assert parse_params("epochs=20000")["epochs"] == 20000
    assert parse_params("threshold=1.0")["threshold"] == 1.0


def test_parse_gaps():
    from audio_inpainting_torch.demo.live import parse_gaps

    assert parse_gaps("1000-2000") == [(1000, 2000)]
    assert parse_gaps("1000-2000,5000-5200") == [(1000, 2000), (5000, 5200)]
    for bad in ("1000", "a-b", "2000-1000", "-5-2", "1000-1000"):
        with pytest.raises(RestoreError):
            parse_gaps(bad)
    assert parse_params("gaps=10-20&method=linear")["gaps"] == [(10, 20)]


def test_live_restore_with_explicit_gaps(server, tmp_path):
    """gaps= skips blind detection: only the named span is rewritten."""
    path, clean, dmg, sr, gap = _damaged_clip(tmp_path)
    with open(path, "rb") as f:
        body = f.read()
    resp = _post(
        f"{server}/api/restore?method=linear&gaps={gap[0]}-{gap[1]}", body)
    assert resp.status == 200
    sr2, data = read_wav_bytes(resp.read(), tmp_path)
    x = data.astype(np.float32) / 32767.0
    assert np.abs(x[slice(*gap)]).max() > 0.01


def test_diffusion_budget_alias_ambiguity():
    """epochs and train_steps alias the same diffusion budget; sending both
    is refused rather than silently picking one."""
    with pytest.raises(RestoreError) as e:
        restore_wav_bytes(b"\x00" * 64, method="diffusion", device="cpu",
                          epochs=5, train_steps=5)
    assert e.value.status == 400 and "not both" in str(e.value)


def test_chunked_upload_rejected_411(server):
    """Chunked transfer-encoding has no Content-Length; the handler replies
    411 instead of treating the body as empty."""
    import http.client

    host = server.split("//", 1)[1]
    conn = http.client.HTTPConnection(host, timeout=60)
    try:
        conn.request("POST", "/api/restore?method=linear", body=iter([b"x"]),
                     headers={"Transfer-Encoding": "chunked"})
        resp = conn.getresponse()
        assert resp.status == 411
        assert "chunked" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_bad_content_length_rejected_400(server):
    import http.client

    host = server.split("//", 1)[1]
    conn = http.client.HTTPConnection(host, timeout=60)
    try:
        conn.putrequest("POST", "/api/restore?method=linear")
        conn.putheader("Content-Length", "banana")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "Content-Length" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_error_response_reaches_client_with_unread_body(server, tmp_path):
    """An early 400 (bad params) with a large unsent-yet body: the handler
    drains before replying so the client gets the JSON error, not a RST."""
    path, *_ = _damaged_clip(tmp_path)
    body = open(path, "rb").read() * 64  # ~512 KB, well past socket buffers
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{server}/api/restore?method=banana", body)
    assert e.value.code == 400
    assert "banana" in json.loads(e.value.read())["error"]


def test_oversize_body_rejected_413(server):
    """A Content-Length over 100 MB is refused before reading the body."""
    req = urllib.request.Request(f"{server}/api/restore?method=linear",
                                 data=b"x", method="POST",
                                 headers={"Content-Length": str(200 << 20)})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 413


def test_gp_window_doubling_bounded(server, tmp_path):
    """A damage span too big for the requested GP window makes plan_windows
    double the window past the 20000-sample O(n^3) ceiling — the server
    must refuse with a 400 BEFORE any GP fit runs, not let the doubled
    window smuggle an enormous kernel solve under the restore lock."""
    sr, n = 8000, 120_000
    t = np.arange(n)
    x = (0.6 * np.sin(2 * np.pi * 1.5 * t / sr)).astype(np.float32)
    x[30_000:70_000] = 0.0              # 40k-sample hole
    p = tmp_path / "big_hole.wav"
    save_wav_int16(x, sr, str(p))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{server}/api/restore?method=gp&window_s=0.5"
              f"&gaps=30000-70000", p.read_bytes())
    assert e.value.code == 400
    assert "window" in json.loads(e.value.read())["error"]


def _facade_bytes(body, tmp_path, windowed=False, **kw):
    """What the API must answer: the WAV through the int16 chain, the
    facade (or the windowed engine), and the int16 WAV writer."""
    from audio_inpainting_torch.methods.windowed import restore_windowed

    src, dst = tmp_path / "facade_in.wav", tmp_path / "facade_out.wav"
    src.write_bytes(body)
    sr, x = load_mono_normalized(str(src))
    fn = restore_windowed if windowed else tapi.restore
    save_wav_int16(fn(x, sr, device="cpu", **kw), sr, str(dst))
    return dst.read_bytes()


@pytest.mark.parametrize("query,kw", [
    ("method=ar&seed=2", dict(method="ar", seed=2)),
    ("method=linear", dict(method="linear")),
    ("method=ar&window_s=0.2", dict(method="ar", window_s=0.2, windowed=True)),
])
def test_live_response_is_the_facade_bytes(server, tmp_path, query, kw):
    path, *_ = _damaged_clip(tmp_path)
    body = open(path, "rb").read()
    resp = _post(f"{server}/api/restore?{query}", body)
    assert resp.read() == _facade_bytes(body, tmp_path, **kw)


def test_live_linear_matches_jax(tmp_path):
    """The same upload through both packages' restore_wav_bytes: the
    linear fill is numpy interpolation in both, so the int16 samples agree
    to one step."""
    path, *_ = _damaged_clip(tmp_path)
    body = open(path, "rb").read()
    got = restore_wav_bytes(body, method="linear", device="cpu", threshold=0.01)
    want = jlive.restore_wav_bytes(body, method="linear", threshold=0.01)
    sr_g, g = read_wav_bytes(got, tmp_path)
    sr_w, w = read_wav_bytes(want, tmp_path)
    assert sr_g == sr_w and g.shape == w.shape
    assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1


def test_live_wants_a_gpu_unless_told(tmp_path, monkeypatch):
    """A handler made for the card answers 500 without one; it never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, *_ = _damaged_clip(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_wav_bytes(open(path, "rb").read(), method="ar")
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                          make_handler(str(tmp_path), "cuda"))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{srv.server_address[1]}/api/restore?method=ar",
                  open(path, "rb").read())
        assert e.value.code == 500 and "CUDA" in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()
        thread.join(timeout=5)
    assert not thread.is_alive()
