"""The classical engines over ranks: AR windows and GP restarts.

The port of audio_inpainting_tpu/parallel/engines.py.

- ``ar_restore_windows_dp``: the batched window pass of methods/ar.py
  (``ar_restore_gaps_windows``: one fit, one kernel launch and one paste
  per pass over every window's rows) with the windows split over ranks;
  each rank runs it on its slice, through the CUDA kernel on a card.
  There is no math across windows. Every window adds the same texture
  draw of a pass (the sequential path's draw, tiled), so each pass draws
  once at the whole batch's per-window shape and every rank passes that
  draw on (``eps``): a fill does not depend on the world size.
- ``gp_fit_predict_mesh``: the GP's L-BFGS restarts split over ranks
  (methods/gp.py's batched L-BFGS on each rank's batch); the final
  losses are gathered, the winner's hyperparameters broadcast from its
  rank, and the posterior solved once on every rank. Every restart's
  trajectory is its own, so on the CPU the winner is the one-rank
  winner; on the card the gradients move with the batch (ROADMAP
  Queue 3, F3), and ``batches`` lets one rank run the ranks' batches.
"""

from __future__ import annotations

import torch

from ..device import as_f32
from ..methods import gp
from ..methods import ar
from .mesh import Ranks, broadcast, gather, gather_objects, rank_rows, split_rows


def ar_restore_windows_dp(signals, gaps_list, cfg: ar.ARConfig, ranks: Ranks,
                          seed: int = 0, *, eps=None) -> torch.Tensor:
    """``ar_restore_gaps_windows`` with the windows split over every rank:
    the same single-bucket contract, seed and ``eps`` (one
    (max_len, 2 * gpad) draw per pass). The window count is padded to a
    multiple of the world size by repeating the last window, whose copies
    are dropped. Returns the restored (W, n) windows on every rank, on its
    device. The draw and the batched pass are looked up on methods/ar.py
    when called, so what is patched there (a test's injected noise) is
    what runs."""
    cfg, _, _, gpad, max_len = ar.windows_prep(gaps_list, cfg)
    signals = as_f32(signals, ranks.device)
    if cfg.texture and eps is None:
        eps = [ar._draw_eps(seed, p, (max_len, 2 * gpad), ranks.device)
               for p in range(cfg.passes)]
    mine = rank_rows(len(gaps_list), ranks)
    out = ar.ar_restore_gaps_windows(signals[torch.as_tensor(mine, device=signals.device)],
                                  [gaps_list[i] for i in mine], cfg, seed, eps=eps,
                                  device=ranks.device)
    return gather(out, ranks, None)[:len(gaps_list)]


def gp_fit_predict_mesh(x_train, y_train, x_test, cfg: gp.GPConfig, ranks: Ranks,
                        seed: int = 0, batches: int | None = None):
    """``gp_fit_predict`` with the restarts split over every rank, padded
    to a multiple of ``batches`` with copies of the initial values (as
    the JAX package pads them), which can move the winner's index, never
    its hyperparameters. batches: the restart batches, each one L-BFGS
    run, a multiple of the world size (default: one a rank); rank r runs
    its equal consecutive share of them. ``Ranks.solo`` with ``batches``
    = N is one rank running N ranks' batches. Returns (mu, std, theta)
    on every rank, on its device."""
    n_b = batches or ranks.world
    if n_b % ranks.world:
        raise ValueError(f"{n_b} restart batches over {ranks.world} ranks")

    def fit(x, y):
        u0, loss, to_theta = gp._restarts(x, y, cfg, seed)
        per = n_b // ranks.world
        us = [gp.lbfgs_minimize(loss, u0[rows], cfg.opt_steps, cfg.max_linesearch_steps)
              for rows in split_rows(len(u0), n_b, fill=0)[ranks.rank * per:
                                                             (ranks.rank + 1) * per]]
        u = torch.cat(us)
        mine = torch.cat([gp.finite_or_inf(loss(b)) for b in us]).cpu()
        best = int(torch.argmin(torch.cat(gather_objects(mine, ranks))))
        owner, row = divmod(best, len(u))
        return to_theta(broadcast(u[row].contiguous() if owner == ranks.rank
                                  else torch.empty_like(u[0]), owner, ranks))

    return gp.fit_predict_with(fit, x_train, y_train, x_test, cfg, ranks.device)
