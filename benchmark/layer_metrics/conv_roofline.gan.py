"""conv_roofline.gan: ``conv_roofline`` in the cells whose end-to-end rate is
``audio_per_device_s``."""

from benchmark.layer_metrics.conv_roofline import read  # noqa: F401
