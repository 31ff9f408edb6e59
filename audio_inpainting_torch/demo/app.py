"""Demo layer (L5): side-by-side listening/viewing of precomputed artifacts.

The port of audio_inpainting_tpu/demo/app.py. Like the reference's demo.py,
the gallery performs no DSP at request time: it reads only the artifact
registry (pipelines/registry.py), which the pipelines and this app share.

Two front-ends:
- gradio Blocks (three tabs, a radio per method, audio + spectrogram +
  commentary), used when gradio is importable (UI parity with demo.py);
  the live restore API (demo/live.py) then runs beside it on :7861;
- otherwise a dependency-free static HTML gallery with a live-restore
  panel, served with the live API by the stdlib's HTTP server on :7860.
The live API restores on ``device`` (cuda unless "cpu" is named).
"""

from __future__ import annotations

import html
import os

from ..pipelines.registry import ASSET_REGISTRY, DEMO_LABELS

# Hard-coded commentary, reproduced from the reference demo (demo.py:104-183)
COMMENTS = {
    ("part1", "damaged"): "[Listening] Strong artifacts and dropouts.\n[Visual] Many vertical black bars in the spectrogram, indicating missing time segments.",
    ("part1", "linear"): "[Listening] Gaps are filled but sound is muffled and unnatural.\n[Visual] Missing parts are connected by straight, smooth bands, losing fine time-frequency texture.",
    ("part1", "ar"): "[Listening] Short gaps are reconstructed with clearer detail than linear.\n[Visual] Spectrogram lines across gaps look more coherent and structured.",
    ("part1", "nmf"): "[Listening] Harmonic structure is preserved but may sound slightly synthetic.\n[Visual] Spectrogram shows smoother, template-like components filling the gaps.",
    ("part1", "unet"): "[Listening] Reconstruction is close to natural.\n[Visual] U-Net restores rich horizontal textures; it is hard to see obvious repair seams.",
    ("part1", "original"): "Reference clean signal with natural harmonics and textures.",
    ("part2", "damaged"): "[Listening] A long silent hole appears in the middle.\n[Visual] A large pure-black region in the center of the spectrogram, showing complete information loss.",
    ("part2", "linear"): "[Listening] The hole is filled but the transition is dull and smeared.\n[Visual] The gap becomes smooth, low-detail bands that ignore complex patterns.",
    ("part2", "ar"): "[Listening] Temporal continuity is better, but long-term structure can drift.\n[Visual] Lines extend across the gap, yet some high-level patterns are inconsistent.",
    ("part2", "nmf"): "[Listening] Reasonable timbre but can sound repetitive.\n[Visual] The gap is filled with a few repeating spectral templates.",
    ("part2", "gan"): "[Listening] The gap is filled with plausible content but can be a bit rough.\n[Visual] The black region is replaced, but textures may look noisy or irregular.",
    ("part2", "diffusion"): "[Listening] Very natural, with smooth transitions into and out of the gap.\n[Visual] The model hallucinates highly detailed, realistic time-frequency structure.",
    ("part2", "original"): "Reference clean signal. Compare how close each model comes to this target.",
    # part0 commentary is framework-authored (the reference demo has no
    # part-0 tab; these artifacts come from its standalone scripts).
    ("part0", "gp_corrupted"): "[Listening] Several short segments are cut out of the waveform.\n[Visual] Narrow blank stripes interrupt the harmonics.",
    ("part0", "gp"): "[Listening] Gaps are filled with smooth, confident interpolations.\n[Visual] The GP posterior mean restores continuous harmonic bands with an uncertainty envelope.",
    ("part0", "ar"): "[Listening] Bidirectional AR extrapolation reconnects the waveform cleanly.\n[Visual] Local waveform structure continues through each gap.",
    ("part0", "ar_texture"): "[Listening] Like AR, with added residual-scaled noise for a livelier texture.\n[Visual] Filled regions carry natural-looking high-frequency grain.",
    ("part0", "nmf"): "[Listening] Iterative NMF re-synthesizes the missing spectrogram columns.\n[Visual] Repeating spectral templates span the holes.",
    ("part0", "gp_original"): "Reference clean signal for the part-0 scenarios.",
}

_HEADER = """# 🕵️ Signal Restorer: Audio Inpainting Showcase
Use the tabs to switch scenes and **listen + see** how different models
repair damaged audio."""


def get_media_paths(assets_dir: str, part: str, method: str):
    """Existence-guarded path lookup (None fallback), like demo.py:66-74."""
    entry = ASSET_REGISTRY[part].get(method, {})
    audio = os.path.join(assets_dir, entry["audio"]) if "audio" in entry else None
    image = os.path.join(assets_dir, entry["image"]) if "image" in entry else None
    return (audio if audio and os.path.exists(audio) else None,
            image if image and os.path.exists(image) else None)


def _launch_gradio(assets_dir: str, share: bool):  # pragma: no cover
    import gradio as gr

    with gr.Blocks() as demo:
        gr.Markdown(_HEADER)
        with gr.Tabs():
            for part, title in [("part0", "🎼 Scene 0: Classic Restorers"),
                                ("part1", "🌦️ Scene 1: Random Fragments"),
                                ("part2", "🕳️ Scene 2: 2s Temporal Hole")]:
                with gr.TabItem(title):
                    labels = dict((lbl, key) for key, lbl in DEMO_LABELS[part])
                    with gr.Row():
                        with gr.Column(scale=1):
                            radio = gr.Radio(choices=list(labels.keys()),
                                             value=list(labels.keys())[0],
                                             label="Choose method")
                            desc = gr.Textbox(label="Technical commentary", lines=4)
                        with gr.Column(scale=2):
                            audio = gr.Audio(label="👂 Audio preview", type="filepath")
                            img = gr.Image(label="👁️ Spectrogram", type="filepath",
                                           interactive=False)

                    def update(label, _part=part, _labels=labels):
                        key = _labels[label]
                        a, i = get_media_paths(assets_dir, _part, key)
                        return a, COMMENTS.get((_part, key), ""), i

                    radio.change(update, inputs=radio, outputs=[audio, desc, img])
    demo.launch(share=share)


def render_static_html(assets_dir: str) -> str:
    """Dependency-free gallery over the same registry + commentary."""
    rows = []
    for part, title in [("part0", "Scene 0: Classic Restorers"),
                        ("part1", "Scene 1: Random Fragments"),
                        ("part2", "Scene 2: 2s Temporal Hole")]:
        rows.append(f"<h2>{html.escape(title)}</h2>")
        for key, label in DEMO_LABELS[part]:
            a, i = get_media_paths(assets_dir, part, key)
            comment = html.escape(COMMENTS.get((part, key), ""))
            rows.append(f"<div class='card'><h3>{html.escape(label)}</h3>")
            if a:
                rel = os.path.relpath(a, assets_dir)
                rows.append(f"<audio controls src='{rel}'></audio>")
            if i:
                rel = os.path.relpath(i, assets_dir)
                rows.append(f"<br><img src='{rel}' width='640'>")
            rows.append(f"<pre>{comment}</pre></div>")
    body = "\n".join(rows)
    return ("<html><head><title>Audio Inpainting Showcase</title><style>"
            "body{font-family:sans-serif;max-width:900px;margin:auto}"
            ".card{border:1px solid #ccc;border-radius:8px;padding:12px;margin:12px 0}"
            "</style></head><body><h1>Signal Restorer: Audio Inpainting Showcase"
            f"</h1>{_LIVE_PANEL}{body}</body></html>")


# Browser front-end for the live-restore API (demo/live.py): upload a
# damaged WAV, pick a method, play the restored clip. The reference demo
# serves only precomputed artifacts.
_LIVE_PANEL = """
<div class='card' id='live'>
<h3>⚡ Live restore (POST /api/restore)</h3>
<input type='file' id='wav' accept='.wav,audio/wav'>
<select id='method'>
<option value='ar'>ar (bidirectional autoregressive)</option>
<option value='linear'>linear (fastest)</option>
<option value='nmf'>nmf (masked spectrogram factorization)</option>
<option value='unet'>unet (per-clip self-supervised, slow)</option>
<option value='diffusion'>diffusion (DDPM/RePaint, slow)</option>
</select>
<label>window s <input type='number' id='window_s' min='0.05' max='60'
step='0.5' style='width:4em' placeholder='off'
title='long files: restore fixed windows around the damage only'></label>
<button id='go'>Restore</button> <span id='status'></span>
<br><audio id='out' controls style='display:none;margin-top:8px'></audio>
<script>
document.getElementById('go').onclick = async () => {
  const f = document.getElementById('wav').files[0];
  const st = document.getElementById('status');
  if (!f) { st.textContent = 'pick a WAV first'; return; }
  const m = document.getElementById('method').value;
  const ws = document.getElementById('window_s').value;
  st.textContent = 'restoring with ' + m + '\\u2026 (neural methods train per clip)';
  try {
    const r = await fetch('/api/restore?method=' + m +
                          (ws ? '&window_s=' + ws : ''),
                          {method: 'POST', body: await f.arrayBuffer()});
    if (!r.ok) { st.textContent = 'error: ' + (await r.json()).error; return; }
    const a = document.getElementById('out');
    a.src = URL.createObjectURL(await r.blob());
    a.style.display = 'block';
    st.textContent = 'done';
  } catch (e) { st.textContent = 'request failed: ' + e; }
};
</script>
</div>"""


def _launch_static(assets_dir: str, port: int = 7860, device=None):  # pragma: no cover
    from .live import serve

    with open(os.path.join(assets_dir, "index.html"), "w") as f:
        f.write(render_static_html(assets_dir))

    print("static gallery (gradio not installed) + live-restore API")
    serve(assets_dir, port, device)


def launch(assets_dir: str = "demo_assets", share: bool = False, device=None):
    """Serve the demo over ``assets_dir``; the live API restores on
    ``device`` (cuda by default)."""
    try:
        import gradio  # noqa: F401
    except ImportError:
        _launch_static(assets_dir, device=device)   # gallery + live API on :7860
        return
    # gradio owns :7860; the live-restore API still runs, on :7861
    import threading

    from .live import serve

    threading.Thread(target=serve, args=(assets_dir, 7861, device),
                     daemon=True).start()
    _launch_gradio(assets_dir, share)
