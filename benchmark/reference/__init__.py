"""The plain reference that decides ``correct``: PyTorch and NumPy only.

It imports nothing of ``audio_inpainting_torch`` and takes nothing that
the port made. From a request's host inputs and seed it derives again
the analysis, the masks, the nets' initial weights, each training step
and the readout; the port's outputs and state are read only to be
judged. Float32 products run without TF32 unless the control asks for a
lower precision.
"""
