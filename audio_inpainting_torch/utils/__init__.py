from .checkpoint import latest_checkpoint, load_params, save_params
from .profiling import Timer, device_trace

__all__ = ["save_params", "load_params", "latest_checkpoint",
           "device_trace", "Timer"]
