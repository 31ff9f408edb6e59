"""Batched per-clip restoration (G clips, each with its own net, trained
as one grouped net, one set of launches per epoch) and the multi-device
layer: ranks over ``torch.distributed`` (mesh.py), the shared U-Net over
data-parallel and time-split ranks (train.py, spatial.py), the
frame-parallel STFT, AR windows and GP restarts over ranks (engines.py),
and the dry run of every mode (dryrun.py)."""

from .batch import clip_seeds, restore_clips_unet
from .engines import ar_restore_windows_dp, gp_fit_predict_mesh
from .gan_batch import restore_clips_gan
from .mesh import Ranks, gather, launch, make_mesh, make_mesh_2d, shard_batch
from .spatial import (fit_shared_unet_spatial, predict_spatial, shard_spatial,
                      stft_frame_parallel)
from .train import fit_shared_unet, init_shared_unet, shared_unet_train_step

__all__ = ["Ranks", "ar_restore_windows_dp", "clip_seeds", "fit_shared_unet",
           "fit_shared_unet_spatial", "gather", "gp_fit_predict_mesh",
           "init_shared_unet", "launch", "make_mesh", "make_mesh_2d",
           "predict_spatial", "restore_clips_gan", "restore_clips_unet",
           "shard_batch", "shard_spatial", "shared_unet_train_step",
           "stft_frame_parallel"]
