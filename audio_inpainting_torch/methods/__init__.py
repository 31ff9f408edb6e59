from .linear import linear_interp_masked, linear_interp_masked_host, linear_fill_gap
from .ar import ARConfig, ar_restore_gap, ar_restore_gaps, ar_restore_gap_detailed

__all__ = [
    "linear_interp_masked",
    "linear_interp_masked_host",
    "linear_fill_gap",
    "ARConfig",
    "ar_restore_gap",
    "ar_restore_gaps",
    "ar_restore_gap_detailed",
]
