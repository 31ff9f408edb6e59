"""launches_per_epoch.gan: ``launches_per_epoch`` in the cells whose end-to-end rate is
``audio_per_device_s``."""

from benchmark.layer_metrics.launches_per_epoch import read  # noqa: F401
