"""device_idle_pct.gan: ``device_idle_pct`` in the cells whose end-to-end rate is
``audio_per_device_s``."""

from benchmark.layer_metrics.device_idle_pct import read  # noqa: F401
