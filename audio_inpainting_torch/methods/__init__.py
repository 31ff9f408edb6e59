from .linear import linear_interp_masked, linear_interp_masked_host, linear_fill_gap
from .ar import ARConfig, ar_restore_gap, ar_restore_gaps, ar_restore_gap_detailed
from .windowed import restore_windowed
from .streaming import StreamRestorer, restore_stream

__all__ = [
    "linear_interp_masked",
    "linear_interp_masked_host",
    "linear_fill_gap",
    "ARConfig",
    "ar_restore_gap",
    "ar_restore_gaps",
    "ar_restore_gap_detailed",
    "restore_windowed",
    "StreamRestorer",
    "restore_stream",
]
