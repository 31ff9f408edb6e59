"""The rank layer: one process per rank over ``torch.distributed``.

The port of audio_inpainting_tpu/parallel/mesh.py and the meshes of
parallel/spatial.py. The JAX package names a device mesh and lets XLA
insert the collectives; here every rank is a process, and the parallel
functions (parallel/train.py, spatial.py, engines.py, batch.py,
gan_batch.py, methods/windowed.py, pipelines/serve.py) run on every rank
with a ``Ranks`` and do their own collectives:

- ``launch`` starts the ranks with the ``spawn`` start method; they meet
  on a ``file://`` path in a temporary directory, and rank 0's result
  comes back. A world of one may have no process group at all
  (``Ranks.solo``): with no group, a collective is a no-op, so the same
  functions give the one-rank result in the caller's process. Whether a
  collective runs follows from whether a process group spans its axis,
  never from the world size: one rank launched on NCCL runs NCCL's
  collectives.
- ``make_mesh`` and ``make_mesh_2d`` lay a ``dp`` axis (clips, batches)
  and a ``tp`` axis (the spectrogram's time axis) over the ranks, rank
  r at (r // n_tp, r % n_tp) as in JAX's ``reshape(n_dp, n_tp)``.
- ``gather`` returns the whole of a sharded array, through the host
  (``all_gather_object``): gloo takes CUDA tensors only in ``all_reduce``
  and ``broadcast``, NCCL takes no CPU tensors, and the outputs end on
  the host anyway (numpy, WAVs). Gradients are all-reduced on the device.

The backend is the caller's choice, never swapped quietly: the default is
``nccl`` when every rank has a CUDA device of its own and ``gloo`` when
all run on the CPU. Ranks that share a card must ask for ``gloo``; NCCL
refuses two ranks on one device, so ``nccl`` there raises.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

# seconds between the parent's checks that no rank died without a word,
# and that it waits for the other ranks' reports after a failure
_POLL_S = 0.5
_GRACE_S = 5.0
# a collective that waits longer for a rank raises instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Ranks:
    """One rank's view of the world: its index, the world size, its
    device, the backend (None: no process group, ``Ranks.solo``), and its
    mesh: ``n_tp`` ranks along ``tp``, world / n_tp along ``dp``, with
    the process groups of its row and column (None: the whole world
    along ``dp``, no group along the ``tp`` of a 1-D mesh)."""

    rank: int
    world: int
    device: torch.device
    backend: str | None = None
    n_tp: int = 1
    dp_group: Any = None
    tp_group: Any = None

    @staticmethod
    def solo(device=None) -> "Ranks":
        """A world of one on ``device`` (cuda unless "cpu" is named),
        with no process group: every collective is a no-op, in the
        caller's process."""
        return Ranks(0, 1, resolve_device(device))

    @property
    def n_dp(self) -> int:
        return self.world // self.n_tp

    @property
    def dp(self) -> int:
        """This rank's index along ``dp``."""
        return self.rank // self.n_tp

    @property
    def tp(self) -> int:
        """This rank's index along ``tp``."""
        return self.rank % self.n_tp


def default_backend(devices: list[torch.device]) -> str:
    """nccl when every rank has a CUDA device of its own, gloo when all
    run on the CPU; anything else must name its backend."""
    if all(d.type == "cpu" for d in devices):
        return "gloo"
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    raise ValueError(f"ranks on {[str(d) for d in devices]}: ranks that share a "
                     "device or mix devices must name their backend (gloo)")


def rank_devices(world_size: int, devices=None) -> list[torch.device]:
    """Each rank's device: ``cuda:r`` for rank r by default; one device
    (a str or torch.device) for every rank; or one per rank. An unnamed
    CUDA index means card 0."""
    if devices is None:
        devices = [f"cuda:{r}" for r in range(world_size)]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * world_size
    devs = [torch.device(d) for d in devices]
    if len(devs) != world_size:
        raise ValueError(f"{len(devs)} devices for {world_size} ranks")
    return [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d
            for d in devs]


def check_backend(backend: str, devices: list[torch.device]) -> None:
    """Raise where ``backend`` cannot serve ranks on ``devices``."""
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("nccl runs on CUDA devices only; ranks on the CPU "
                             "take gloo")
        if len(set(devices)) != len(devices):
            raise ValueError("nccl refuses two ranks on one card; ranks that "
                             "share a card take gloo")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
    n_cuda = max((d.index + 1 for d in devices if d.type == "cuda"), default=0)
    if n_cuda and n_cuda > torch.cuda.device_count():
        raise RuntimeError(f"ranks want cuda:{n_cuda - 1}, but "
                           f"{torch.cuda.device_count()} CUDA devices are present")


def _to_host(obj):
    """Tensors of a result moved to the CPU (a CUDA tensor would cross
    processes by CUDA IPC, which outlives no rank)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, world: int, device: torch.device, backend: str,
               init_file: str, call: bytes, results) -> None:
    """A rank's process: join the group, run ``fn(ranks, *args)`` of the
    pickled (fn, args), report (rank, error or None, rank 0's result
    pickled). Plain pickles, by value: torch's multiprocessing pickler
    would send a CPU tensor as a shared-memory handle, which dies with the
    process that sent it."""
    # one thread: with more, MKL's CPU FFT moves in the last bits under load
    torch.set_num_threads(1)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT)
        try:
            fn, args = pickle.loads(call)
            out = fn(Ranks(rank, world, device, backend), *args)
            results.put((rank, None, pickle.dumps(_to_host(out)) if rank == 0 else None))
        finally:
            dist.destroy_process_group()
    except BaseException:         # reported, then the process ends
        results.put((rank, traceback.format_exc(), None))


def launch(fn, world_size: int, *, devices=None, backend: str | None = None,
           args=()):
    """Run ``fn(ranks, *args)`` on ``world_size`` ranks, one spawned
    process each, and return rank 0's result (its tensors on the CPU).

    devices: see ``rank_devices`` (default ``cuda:r`` for rank r).
    backend: "gloo" or "nccl"; default ``default_backend``. ``fn`` and
    ``args`` are pickled (``fn`` by its import path), so ``fn`` is a
    module-level function. Raises RuntimeError with the tracebacks of the
    ranks that failed, after ending the others, which may wait in a
    collective for them.
    """
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    devs = rank_devices(world_size, devices)
    backend = backend or default_backend(devs)
    check_backend(backend, devs)
    call = pickle.dumps((fn, tuple(args)))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks-")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, devs[r], backend,
                               os.path.join(tmp, "rendezvous"), call, results))
             for r in range(world_size)]
    out, failures, reported = None, {}, set()
    deadline = None
    try:
        for p in procs:
            p.start()
        while len(reported) < world_size and (deadline is None or time.time() < deadline):
            try:
                rank, error, res = results.get(timeout=_POLL_S)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if p.exitcode is not None and r not in reported and results.empty():
                        reported.add(r)
                        failures[r] = f"exited with code {p.exitcode} and no report"
            else:
                reported.add(rank)
                if error is not None:
                    failures[rank] = f"failed:\n{error}"
                elif rank == 0:
                    out = pickle.loads(res)
            if failures and deadline is None:
                # the others' reports say more than the collective that the
                # first failure broke under them: wait a little for them
                deadline = time.time() + _GRACE_S
        if failures:
            raise RuntimeError("\n".join(f"rank {r} {msg}"
                                          for r, msg in sorted(failures.items())))
        return out
    finally:
        # after a failure (or an interrupt) the others may wait in a
        # collective for ever: end them
        ended = len(reported) == world_size and not failures
        for p in procs:
            if not ended and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _new_groups(ranks: Ranks, members: list[list[int]]):
    """``dist.new_group`` for every list of ``members`` (every rank makes
    every group, in one order); the group holding this rank."""
    mine = None
    for m in members:
        g = dist.new_group(m)
        if ranks.rank in m:
            mine = g
    return mine


def make_mesh(ranks: Ranks) -> Ranks:
    """A 1-D ``dp`` mesh over every rank: clips and batches split over the
    whole world. Every rank calls it."""
    return replace(ranks, n_tp=1, dp_group=None, tp_group=None)


def make_mesh_2d(ranks: Ranks, n_dp: int, n_tp: int) -> Ranks:
    """An (n_dp, n_tp) mesh, rank r at (r // n_tp, r % n_tp), with the
    process groups of its ``dp`` column and ``tp`` row. n_dp * n_tp must
    be the world size. Every rank calls it (``dist.new_group`` is
    collective)."""
    if n_dp * n_tp != ranks.world:
        raise ValueError(f"a {n_dp} x {n_tp} mesh over {ranks.world} ranks")
    if ranks.backend is None:
        return ranks
    rows = [[d * n_tp + t for t in range(n_tp)] for d in range(n_dp)]
    cols = [[d * n_tp + t for d in range(n_dp)] for t in range(n_tp)]
    return replace(ranks, n_tp=n_tp, tp_group=_new_groups(ranks, rows),
                   dp_group=_new_groups(ranks, cols))


def shard_range(n: int, ranks: Ranks, exact: bool = True) -> slice:
    """This rank's contiguous slice of ``n`` items along ``dp``. exact:
    n must divide by the dp size (JAX's sharding asserts it); else the
    first n % n_dp ranks take one item more (``np.array_split``)."""
    q, rem = divmod(n, ranks.n_dp)
    if exact and rem:
        raise ValueError(f"{n} items do not divide over {ranks.n_dp} ranks")
    start = ranks.dp * q + min(ranks.dp, rem)
    return slice(start, start + q + (ranks.dp < rem))


def shard_batch(x, ranks: Ranks):
    """This rank's contiguous slice of the leading axis of ``x`` along
    ``dp``; the leading axis must divide by the dp size."""
    return x[shard_range(len(x), ranks)]


def pad_repeat_last(n: int, multiple: int) -> np.ndarray:
    """Indices 0..n-1, then n-1 repeated up to a multiple of ``multiple``:
    the JAX package's batch padding, whose copies the caller drops."""
    return np.concatenate([np.arange(n), np.full((-n) % multiple, n - 1)])


def split_rows(n: int, parts: int, fill: int | None = None) -> np.ndarray:
    """Indices 0..n-1 padded to a multiple of ``parts`` and cut into
    ``parts`` equal contiguous rows, (parts, k): the padding repeats the
    last index (``pad_repeat_last``), or index ``fill`` where given."""
    idx = pad_repeat_last(n, parts)
    if fill is not None:
        idx[n:] = fill
    return idx.reshape(parts, -1)


def rank_rows(n: int, ranks: Ranks, fill: int | None = None) -> np.ndarray:
    """This rank's row of ``split_rows(n, world, fill)``: its share of n
    items split over every rank."""
    return split_rows(n, ranks.world, fill)[ranks.rank]


def ranks_on(ranks: Ranks | None, device=None) -> Ranks:
    """``ranks``, or without them a world of one on ``device`` (cuda
    unless "cpu" is named). A device named beside ``ranks`` must be
    theirs."""
    if ranks is None:
        return Ranks.solo(device)
    if device is not None and torch.device(device) not in (
            ranks.device, torch.device(ranks.device.type)):
        raise ValueError(f"device {device} beside ranks on {ranks.device}")
    return ranks


def _axis_group(ranks: Ranks, axis: str | None):
    """(spanned, group, size) of ``axis`` ("dp", "tp" or None for the
    whole world): whether a process group spans it, that group (None:
    the default, whole-world one) and its size. No group spans an axis
    without a backend, nor the ``tp`` axis of a 1-D mesh."""
    if ranks.backend is None:
        return False, None, 1
    if axis == "tp":
        return ranks.tp_group is not None, ranks.tp_group, ranks.n_tp
    if axis == "dp":
        return True, ranks.dp_group, ranks.n_dp
    return True, None, ranks.world


def all_reduce_sum(t: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """Sum ``t`` over every rank, in place, on its device."""
    if ranks.backend is not None:
        dist.all_reduce(t)
    return t


def broadcast(t: torch.Tensor, src: int, ranks: Ranks) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place, on its device."""
    if ranks.backend is not None:
        dist.broadcast(t, src)
    return t


def gather_objects(obj, ranks: Ranks, axis: str | None = None) -> list:
    """Every rank's ``obj`` along ``axis`` ("dp", "tp" or None for the
    whole world), in rank order, through the host."""
    spanned, group, size = _axis_group(ranks, axis)
    if not spanned:
        return [obj]
    out = [None] * size
    dist.all_gather_object(out, obj, group=group)
    return out


def gather(x: torch.Tensor, ranks: Ranks, axis: str | None = "dp",
           dim: int = 0) -> torch.Tensor:
    """The shards of ``x`` along ``axis`` concatenated on ``dim``, through
    the host, on ``x``'s device; ``x`` itself where no process group spans
    the axis."""
    if not _axis_group(ranks, axis)[0]:
        return x
    parts = gather_objects(x.detach().cpu(), ranks, axis)
    return torch.cat(parts, dim=dim).to(x.device)
