"""Command-line tools of the port (``python -m audio_inpainting_torch.tools.<name>``)."""
