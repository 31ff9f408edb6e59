"""Live-restore HTTP API: POST a damaged WAV, receive the restored WAV.

The port of audio_inpainting_tpu/demo/live.py. The reference demo serves
only precomputed artifacts (demo.py:6-63, "no DSP at request time"); this
module is a live restoration service over the uniform ``restore()``
facade (api.py) and the windowed engine, on the stdlib's HTTP server, on
the GPU unless the handler is made for another device. The
directory-batch path for bulk work is the ``serve`` CLI (cli/main.py);
this is the single-request interactive counterpart.

Endpoints
---------
GET  /api/methods
    JSON description of the available methods and their query parameters.
POST /api/restore?method=ar&seed=0&threshold=1e-4[&epochs=N]
    Body: RIFF WAV bytes (any channel count / int16 or float — the
    canonical load path mono-mixes and peak-normalizes, io/wav.py).
    Response: 200 with the restored clip as int16 RIFF WAV bytes, or a
    4xx/5xx JSON error. ``gan`` is rejected: the reference GAN trains
    against the ground-truth clip (main_gan_gap.py:103-108), which a
    damaged-only upload cannot provide.

Files under the assets directory are served as they are (GET), so one
server can host a static gallery beside the API.
"""

from __future__ import annotations

import http.server
import json
import os
import tempfile
import threading
import urllib.parse

# One restore at a time on the card: a neural restore trains for seconds to
# minutes on the one GPU; interleaving them buys nothing and risks running
# out of device memory.
_RESTORE_LOCK = threading.Lock()

#: method -> (allowed, note). gan is refused with the reason below.
METHODS = {
    "linear": "fastest; straight-line fill over detected dropouts",
    "ar": "bidirectional autoregressive fill with texture injection",
    "nmf": "masked NMF spectrogram factorization over silent columns",
    "gp": "Gaussian-process posterior fill (short clips only — O(n^3))",
    "unet": "per-clip self-supervised spectrogram U-Net (epochs=400)",
    "diffusion": "DDPM/RePaint spectrogram fill (train_steps per clip "
                 "unless a pretrained checkpoint is configured)",
}

# Query parameters forwarded into restore(); everything else is rejected so
# typos fail loudly instead of silently running defaults.
_FLOAT_PARAMS = {"threshold", "window_s"}
_INT_PARAMS = {"seed", "epochs", "order", "train_steps"}

# Inclusive bounds per parameter. The server binds all interfaces and runs
# one restore at a time under _RESTORE_LOCK, so an unbounded training budget
# (epochs=2e9) would hold the lock for days and starve every other client —
# the same reasoning as the gp length guard below. Caps are ~13x the largest
# reference budget (GAN 1500 epochs, main_gan_gap.py:174), generous for
# experimentation but bounded; negative values would crash the trainers.
_PARAM_BOUNDS = {
    "seed": (0, 2**31 - 1),
    "epochs": (1, 20000),
    "train_steps": (1, 20000),
    "order": (1, 1000),
    "threshold": (0.0, 1.0),
    # windowed mode: restore fixed windows around the damage only (long
    # files); 60 s windows already exceed anything the methods were tuned on
    "window_s": (0.05, 60.0),
}


class RestoreError(ValueError):
    """Client error with an HTTP status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def parse_params(query: str) -> dict:
    """Validate /api/restore query params -> kwargs for restore_wav_bytes."""
    q = urllib.parse.parse_qs(query, keep_blank_values=True)
    out: dict = {}
    for key, vals in q.items():
        val = vals[-1]
        try:
            if key == "method":
                out["method"] = val
            elif key == "gaps":
                out["gaps"] = parse_gaps(val)
            elif key in _FLOAT_PARAMS:
                out[key] = float(val)
            elif key in _INT_PARAMS:
                out[key] = int(val)
            else:
                raise RestoreError(400, f"unknown parameter {key!r}")
        except ValueError as e:
            if isinstance(e, RestoreError):
                raise
            raise RestoreError(400, f"bad value for {key!r}: {val!r}")
        if key in _PARAM_BOUNDS:
            lo, hi = _PARAM_BOUNDS[key]
            if not lo <= out[key] <= hi:
                raise RestoreError(
                    400, f"{key}={out[key]} out of range [{lo}, {hi}]")
    method = out.setdefault("method", "ar")
    if method == "gan":
        raise RestoreError(
            400, "method 'gan' needs the clean original clip (the reference "
                 "GAN trains against ground truth, main_gan_gap.py:103-108); "
                 "use the `serve` CLI with --originals for batch GAN runs")
    if method not in METHODS:
        raise RestoreError(400, f"unknown method {method!r}; "
                                f"one of {sorted(METHODS)}")
    return out


def parse_gaps(val: str) -> list:
    """`gaps=1000-2000,5000-5200` -> [(1000, 2000), (5000, 5200)].

    Explicit damaged spans (sample indices) skip the blind threshold
    detection — useful when the damage location is known and the clip has
    naturally quiet passages the detector would rewrite. Bounds beyond the
    clip's end are clamped downstream (both restore_windowed and the facade
    methods clamp to the clip extent)."""
    gaps = []
    for part in val.split(","):
        s, sep, e = part.partition("-")
        if not sep or not s.strip().isdigit() or not e.strip().isdigit():
            raise RestoreError(
                400, f"bad gaps syntax {part!r}; want start-end[,start-end]")
        lo, hi = int(s), int(e)
        if not 0 <= lo < hi:
            raise RestoreError(400, f"bad gap bounds {part!r}")
        gaps.append((lo, hi))
    if len(gaps) > 10000:
        raise RestoreError(400, "over 10000 gaps")
    return gaps


def restore_wav_bytes(body: bytes, method: str = "ar", device=None,
                      **params) -> bytes:
    """Decode WAV bytes, restore with the facade, re-encode int16 WAV.

    Round-trips through the canonical io/wav load/save path (tempfiles) so
    the int16-chain semantics match the file-based pipelines exactly.
    device: where the restore runs, cuda unless "cpu" is named.
    """
    from .. import api
    from ..io.wav import load_mono_normalized, save_wav_int16

    # restore()'s facade kwargs: epochs -> the diffusion config's field name.
    # Both spellings at once is ambiguous — fail loudly rather than pick one.
    if method == "diffusion" and "epochs" in params:
        if "train_steps" in params:
            raise RestoreError(
                400, "diffusion takes either epochs or train_steps (aliases "
                     "for the same budget), not both")
        params["train_steps"] = params.pop("epochs")

    with tempfile.TemporaryDirectory() as td:
        in_path = os.path.join(td, "in.wav")
        with open(in_path, "wb") as f:
            f.write(body)
        try:
            sr, damaged = load_mono_normalized(in_path)
        except Exception as e:
            raise RestoreError(400, f"body is not a decodable WAV: {e}")
        if len(damaged) == 0:
            raise RestoreError(400, "WAV decodes to zero samples")
        window_s = params.pop("window_s", None)
        gp_extent = (len(damaged) if window_s is None
                     else min(len(damaged), int(window_s * sr)))
        if method == "gp" and gp_extent > 20000:
            # GP posterior is O(n^3); the reference confines it to 0.05 s
            # windows (main1_gp.py:46-49). A full-length upload would hold
            # the restore lock for hours. window_s bounds the fit instead.
            raise RestoreError(
                400, f"gp works on up to 20000 samples (got {gp_extent}); "
                     "crop first, pick another method, or pass a window_s "
                     "under 20000/sr to restore around the damage only")
        try:
            with _RESTORE_LOCK:
                if window_s is not None:
                    from ..methods.windowed import restore_windowed

                    # the 20000-sample GP ceiling must bind the ACTUAL
                    # planned windows: an oversized damage group doubles the
                    # base window (plan_windows), so checking window_s*sr
                    # alone would let a huge span smuggle an O(n^3) fit past
                    # the guard and hold _RESTORE_LOCK for hours
                    restored = restore_windowed(
                        damaged, sr, method=method, window_s=window_s,
                        max_window=20000 if method == "gp" else None,
                        device=device, **params)
                else:
                    restored = api.restore(damaged, sr, method=method,
                                           device=device, **params)
        except RestoreError:
            raise
        except ValueError as e:
            # facade/windowed ValueErrors are input-contract messages
            # (oversized GP window, method preconditions) — client errors
            raise RestoreError(400, str(e))
        except TypeError as e:
            # a whitelisted param the chosen method's config doesn't take
            # (dataclass __init__ rejects the kwarg before any compute).
            # Any OTHER TypeError is a server-side bug — let it surface as
            # the 500 path, not a bogus "your request was wrong".
            if "unexpected keyword argument" not in str(e):
                raise
            raise RestoreError(400,
                               f"parameter invalid for method {method!r}: {e}")
        out_path = os.path.join(td, "out.wav")
        save_wav_int16(restored, sr, out_path)
        with open(out_path, "rb") as f:
            return f.read()


def make_handler(assets_dir: str, device):
    """A SimpleHTTPRequestHandler subclass serving assets + the live API,
    restoring on ``device`` ("cuda", "cpu", a torch.device)."""

    class LiveHandler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=assets_dir, **kw)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send_json(self, status: int, obj) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if urllib.parse.urlsplit(self.path).path == "/api/methods":
                self._send_json(200, {
                    "methods": METHODS,
                    "params": {"float": sorted(_FLOAT_PARAMS),
                               "int": sorted(_INT_PARAMS)},
                    "post": "/api/restore?method=<name>[&seed=..&...]"})
                return
            super().do_GET()

        def _body_length(self) -> int:
            """Declared body length; header problems are client errors."""
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                raise RestoreError(
                    411, "chunked uploads not supported; send the WAV with "
                         "a Content-Length header")
            raw = self.headers.get("Content-Length") or "0"
            try:
                return int(raw)
            except ValueError:
                raise RestoreError(400, f"bad Content-Length: {raw!r}")

        # Drain at most this much leftover body before an error response,
        # and give up if the client stalls this long mid-drain.
        _DRAIN_CAP = 256 * 1024 * 1024
        _DRAIN_TIMEOUT = 5.0

        def _drain(self, unread: int) -> None:
            """Consume leftover request body before replying with an error.

            Closing the socket with unread bytes in the kernel receive
            buffer makes Linux send RST, which can discard the queued JSON
            error on the client side ('Failed to fetch' instead of the
            actual message). Bounded two ways: past _DRAIN_CAP, or if the
            client stops sending (a lying Content-Length), stop reading and
            close after the response instead (best effort)."""
            if unread <= 0:
                return
            if unread > self._DRAIN_CAP:  # pragma: no cover - absurd body
                self.close_connection = True
                unread = self._DRAIN_CAP
            old_timeout = self.connection.gettimeout()
            self.connection.settimeout(self._DRAIN_TIMEOUT)
            try:
                while unread > 0:
                    chunk = self.rfile.read(min(unread, 1 << 20))
                    if not chunk:
                        break
                    unread -= len(chunk)
            except OSError:  # stalled or gone; respond anyway, then close
                self.close_connection = True
            finally:
                self.connection.settimeout(old_timeout)

        def do_POST(self):
            split = urllib.parse.urlsplit(self.path)
            unread = 0
            try:
                if split.path != "/api/restore":
                    raise RestoreError(
                        404, f"no POST route {split.path}")
                params = parse_params(split.query)
                length = self._body_length()
                unread = max(length, 0)
                if length <= 0:
                    raise RestoreError(400, "empty body; POST the WAV bytes")
                if length > 100 * 1024 * 1024:
                    raise RestoreError(
                        413, "body over 100 MB; restore files that size "
                             "with the `serve` CLI instead")
                body = self.rfile.read(length)
                unread = length - len(body)
                wav = restore_wav_bytes(body, device=device, **params)
            except RestoreError as e:
                self._drain(unread)
                self._send_json(e.status, {"error": str(e)})
                return
            except Exception as e:  # restore-path failure: report, keep serving
                self._drain(unread)
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(wav)))
            self.end_headers()
            self.wfile.write(wav)

    return LiveHandler


def serve(assets_dir: str, port: int = 7860, device=None) -> None:  # pragma: no cover
    """Blocking server hosting the files under ``assets_dir`` + the live
    API, restoring on ``device`` (cuda by default)."""
    server = http.server.ThreadingHTTPServer(("", port),
                                             make_handler(assets_dir, device or "cuda"))
    print(f"demo + live API at http://localhost:{port}/ "
          f"(POST /api/restore, GET /api/methods)")
    server.serve_forever()
