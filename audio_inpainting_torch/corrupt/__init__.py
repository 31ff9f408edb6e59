from .masks import (random_dropout_mask, random_frame_mask, contiguous_gap_mask,
                    center_gap_bounds, training_stripes, frame_gap_mask_2d)
from .detect import (
    silence_mask,
    find_main_gap,
    find_gaps,
    silent_frame_columns,
    mask_to_bad_columns,
)
from .synth import synth_music_clip

__all__ = [
    "random_dropout_mask",
    "random_frame_mask",
    "contiguous_gap_mask",
    "center_gap_bounds",
    "training_stripes",
    "frame_gap_mask_2d",
    "silence_mask",
    "find_main_gap",
    "find_gaps",
    "silent_frame_columns",
    "mask_to_bad_columns",
    "synth_music_clip",
]
