"""Streaming restoration: bounded-latency inpainting of unbounded streams.

The port of audio_inpainting_tpu/methods/streaming.py. Audio arrives in
chunks of ANY size (a live feed, a tape transfer, an hours-long broadcast);
restored samples are emitted as soon as they are final, and the engine
never holds more than O(window) history. Every restore runs on a window of
the base size or a power-of-two multiple of it, capped, through the
``restore`` facade, so the work is O(damage), not O(stream).

Contract
--------
- Clean samples pass through BIT-IDENTICAL, in order, exactly once.
- Output is invariant to how the stream is chunked (1-sample feeds and one
  big feed produce the same bytes): windows are planned in ABSOLUTE stream
  coordinates, and a damage group is only restored once enough context has
  arrived that its window placement, and the damage masked inside it, can
  never change.
- Latency is bounded: a clean stream is emitted within ``margin`` samples
  + the trailing sub-threshold run (a run touching the buffer end may still
  grow into damage, so it is held); a detected gap is held only until
  ``window``-scale right context arrives. Monster gaps beyond the window
  cap are restored in fixed-size tiles so even an unbounded silence cannot
  grow the buffer without bound.

    rest = StreamRestorer(sr, method="ar")          # on the GPU
    for chunk in source:
        sink(rest.feed(chunk))
    sink(rest.flush())

Two differences from the JAX package, both places where its output
depends on how the stream was chunked:
- it restores a window once the window's span has arrived, even while a
  quiet run that is still shorter than the detector's ``min_len`` lies
  inside it, masked or not depending on where the chunk ended; here such a
  window waits until the run has closed or grown into a detected span
  (``_window_settled``);
- it partitions the retained spans into groups greedily from the first
  one, so trimming old history (at chunk-dependent times) moves every
  later group boundary once groups chain, as dense dropouts make them;
  here the partition keeps its origin across the trim (``_origin``).
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .windowed import composite_weight, window_spans


class _Tape:
    """Append/drop float32 buffer with amortized-O(1) operations.

    Appends go into spare capacity (doubling growth), drops from the front
    advance an offset, and the buffer compacts only when an append would
    overflow, so per-feed buffer work is O(chunk) amortized while
    ``view()`` stays one contiguous zero-copy slice.
    """

    __slots__ = ("_arr", "_off", "_end")

    def __init__(self):
        self._arr = np.empty(1 << 16, np.float32)
        self._off = 0
        self._end = 0

    def __len__(self) -> int:
        return self._end - self._off

    def view(self) -> np.ndarray:
        return self._arr[self._off:self._end]

    def append(self, chunk: np.ndarray) -> None:
        n = len(chunk)
        if self._end + n > len(self._arr):
            live = self._end - self._off
            need = live + n
            if need * 2 <= len(self._arr):
                # in-place compaction is overlap-free BY the need*2 guard:
                # live <= len/2 while off = end - live >= len - len/2, so
                # dst [0, live) ends before src [off, ...) begins
                self._arr[:live] = self._arr[self._off:self._end]
            else:
                new = np.empty(max(len(self._arr) * 2, need * 2), np.float32)
                new[:live] = self._arr[self._off:self._end]
                self._arr = new
            self._off, self._end = 0, live
        self._arr[self._end:self._end + n] = chunk
        self._end += n

    def drop(self, n: int) -> None:
        self._off = min(self._off + n, self._end)


# Per-method default stream window. The pending latency is the window-
# placement wait (~window/2 + right context), not compute, so a method
# should not buy more window than its fill uses: linear interpolates from
# the gap's immediate endpoints, GP fits a short segment (the reference
# confines it to 0.05 s, main1_gp.py:46-49), AR uses 1000-sample contexts,
# the U-Net trains on the window's spectrogram. NMF and anything unlisted
# keep the clip-scale 10 s window (the reference factorizes the whole 10 s
# spectrogram, main4_NMF_gap.py:45-47).
DEFAULT_WINDOW_S = {"linear": 0.5, "gp": 0.5, "ar": 2.0, "unet": 2.0}


def _warm_runs(size: int, gap_len: int, n_runs: int,
               margin: int) -> list[tuple[int, int]]:
    """Damage-run layout for one synthetic warmup window: a centered
    ``gap_len`` run plus ``n_runs - 1`` single-sample fillers, spaced
    ``step`` apart so none merge. Fillers go on BOTH sides of the main
    run: for gap_len near the window size the left side alone runs out of
    room, and the window would land in a smaller gap-count bucket than the
    one asked for."""
    s0 = max((size - gap_len) // 2, 1)
    e0 = min(s0 + gap_len, size)
    runs = [(s0, e0)]
    # tightest non-merging spacing: runs separated by >= 2*margin never
    # merge (_close_run's rule), so step-1 == 2*margin+1 keeps every
    # filler distinct while fitting the most runs beside a large gap
    step = max(2 * margin + 2, 64)
    lpos, rpos = 0, e0 + step
    while len(runs) < n_runs:
        if lpos + 1 <= s0 - 2 * margin:
            runs.append((lpos, lpos + 1))
            lpos += step
        elif rpos + 1 <= size:
            runs.append((rpos, rpos + 1))
            rpos += step
        else:
            break
    runs.sort()
    return runs


class StreamRestorer:
    """Incremental windowed restorer over the `api.restore` facade.

    sr/method/window_s/context/margin/threshold/seed/device/cfg_kwargs mean
    what they mean for methods/windowed.restore_windowed, except that
    window_s=None (the default) picks the per-method latency-tuned window
    from DEFAULT_WINDOW_S. max_doublings caps an oversized damage group's
    window at ``window * 2**max_doublings``; damage wider than the cap is
    restored in cap-sized tiles (each tile sees the rest of the span as
    damage via the foreign-gap mask), which bounds the buffer for
    arbitrarily long dropouts.

    method="unet" carries ONE net across the stream's windows by default
    (methods/unet_stream.py: the full ``epochs`` budget on the first
    window, ``adapt_epochs`` warm-started on every later one).
    ``persist=False`` trains a fresh net per window through the facade.
    """

    def __init__(self, sr: int, method: str = "linear", *,
                 window_s: float | None = None, context: int = 5000,
                 margin: int = 50, threshold: float = 1e-4, seed: int = 0,
                 max_doublings: int = 3, device=None, **cfg_kwargs):
        if window_s is None:
            window_s = DEFAULT_WINDOW_S.get(method, 10.0)
        self.device = resolve_device(device)
        self._unet = None
        if method == "unet":
            persist = cfg_kwargs.pop("persist", True)
            adapt_epochs = cfg_kwargs.pop("adapt_epochs", 100)
            if persist:
                from .unet_stream import PersistentUNetStream

                self._unet = PersistentUNetStream(
                    seed=seed, adapt_epochs=adapt_epochs, device=self.device,
                    **cfg_kwargs)
        if method == "ar":
            # the engines' policy (methods/windowed.py): bucketed shapes
            cfg_kwargs.setdefault("bucket", True)
        self.sr = sr
        self.method = method
        self.margin = int(margin)
        self.threshold = threshold
        self.seed = seed
        self.cfg_kwargs = cfg_kwargs
        self.window = max(int(round(window_s * sr)), 256)
        self.ctx = max(min(context, self.window // 8), 1)
        self.cap = self.window << max(int(max_doublings), 0)
        # tile length for spans beyond the cap: a full-cap window fits one
        # tile plus its context on each side
        self.tile = self.cap - 2 * self.ctx

        self._buf = _Tape()                    # raw input (never mutated)
        self._out = _Tape()                    # fills composited over raw
        self._base = 0                         # absolute index of _buf[0]
        self._total = 0                        # absolute samples received
        self._emit = 0                         # absolute emit watermark
        self._filled: list[tuple[int, int]] = []   # restored absolute spans
        self._ended = False
        # incremental detection state: detection cost is O(chunk) per
        # feed, not O(buffer); spans are discovered as their runs CLOSE
        # (a loud sample arrives) and carried in absolute coordinates
        self._spans: list[list[int]] = []      # closed runs > min_len, merged
        self._run_start: int | None = None     # open sub-threshold suffix
        self._min_len = 100                    # find_gaps' default, exactly
        # start of the group of the first retained span, whose earlier
        # members were trimmed (None: that span starts its group)
        self._origin: int | None = None

    # ------------------------------------------------------------- public

    def warmup(self, max_gap_s: float | None = None, *,
               max_runs: int = 32) -> int:
        """Run representative windows through the same ``_call_method``
        the live path uses, BEFORE the first ``feed()``, so that the first
        real gap pays none of the one-time costs: the CUDA kernel's build
        and load, cuDNN's first-call setup, the allocator's first blocks.
        After it a feed builds nothing (kernels.build.load misses nothing).

        The windows are those the JAX package warms (it compiles one
        program per shape): for each window size this restorer can plan
        (the base window and its doublings up to the cap) and, for AR, for
        each (gap-count, run-length) bucket, one synthetic damaged window.
        max_gap_s bounds the longest damage span the caller expects (fewer
        windows); None covers every shape up to the window cap. max_runs:
        most distinct damage runs expected per window (AR only).

        "linear" and "gp" warm nothing. Returns the number of windows run.
        Idempotent; call any time before (or between) feeds.
        """
        if self.method in ("linear", "gp"):
            return 0
        from .ar import bucket_gap_count, bucket_max_len

        span_cap = None if max_gap_s is None else max(
            int(max_gap_s * self.sr), 1)
        count = 0
        size = self.window
        while True:
            if self.method == "ar":
                run_cap = size if span_cap is None else min(size, span_cap)
                gpad = bucket_gap_count(1)
                gpad_max = bucket_gap_count(max(int(max_runs), 1))
                while gpad <= gpad_max:
                    L = bucket_max_len(1)
                    lmax = bucket_max_len(run_cap)
                    while L <= lmax:
                        count += self._warm_one(size, min(size - 1, L), gpad)
                        L *= 2
                    gpad *= 4              # the gap-count ladder steps x4
            else:
                count += self._warm_one(size, max(size // 4, 1), 1)
            if size >= self.cap:
                break
            if span_cap is not None and span_cap + 2 * self.ctx <= size:
                break          # the planner never doubles past a fit
            size *= 2
        return count

    def _warm_one(self, size: int, gap_len: int, n_runs: int) -> int:
        """Restore one synthetic window: a centered ``gap_len`` run plus
        ``n_runs - 1`` single-sample runs (so the gap-count bucket is
        ``n_runs``), on a loud deterministic carrier."""
        t = np.arange(size, dtype=np.float32)
        sub = (0.5 * np.sin(2.0 * np.pi * 220.0 / self.sr * t)
               + 0.25 * np.sin(2.0 * np.pi * 733.0 / self.sr * t)
               ).astype(np.float32)
        runs = _warm_runs(size, gap_len, n_runs, self.margin)
        mask = np.ones(size, bool)
        for s, e in runs:
            mask[s:e] = False
            sub[s:e] = 0.0
        if self._unet is not None:
            self._unet.warm_window(sub, mask)
        else:
            self._call_method(sub, runs, mask)
        return 1

    def feed(self, chunk) -> np.ndarray:
        """Append samples; return every restored sample that is now final."""
        if self._ended:
            raise RuntimeError("stream already flushed")
        chunk = np.asarray(chunk, np.float32)
        self._buf.append(chunk)
        self._out.append(chunk)
        self._scan_chunk(chunk)
        self._total += len(chunk)
        return self._advance(final=False)

    def flush(self) -> np.ndarray:
        """End of stream: restore what remains and emit everything."""
        if self._ended:
            return np.zeros(0, np.float32)
        self._ended = True
        return self._advance(final=True)

    @property
    def pending(self) -> int:
        """Samples received but not yet emitted (the current latency)."""
        return self._total - self._emit

    # ------------------------------------------------------------ engine

    def _scan_chunk(self, chunk: np.ndarray) -> None:
        """Incremental damage detection over ONE chunk (absolute start =
        self._total, pre-append). Maintains the closed-span list and the
        open trailing-run start so detection is O(chunk) per feed.
        Semantics are find_gaps' exactly: a run counts once STRICTLY longer
        than ``min_len``; nearby runs merge when separated by < 2*margin
        (the windowed engine's _merge_close rule), applied tail-wise since
        runs close in stream order."""
        if len(chunk) == 0:
            return
        a0 = self._total
        thr = max(self.threshold, 0.01)
        quiet = np.abs(chunk) < thr
        d = np.diff(quiet.astype(np.int8))
        starts = (np.flatnonzero(d == 1) + 1).tolist()
        ends = (np.flatnonzero(d == -1) + 1).tolist()
        if quiet[0]:
            starts.insert(0, 0)
        if quiet[-1]:
            ends.append(len(chunk))

        if self._run_start is not None:
            if quiet[0]:
                # the open run continues into this chunk: its start stays
                starts[0] = self._run_start - a0
            else:
                # chunk opens loud: the carried run closes at a0
                self._close_run(self._run_start, a0)
                self._run_start = None

        for s, e in zip(starts, ends):
            rs, re_ = a0 + s, a0 + e
            if re_ == a0 + len(chunk) and quiet[-1]:
                self._run_start = rs          # still open; close later
            else:
                self._close_run(rs, re_)
        if not quiet[-1]:
            self._run_start = None

    def _close_run(self, rs: int, re_: int) -> None:
        if re_ - rs <= self._min_len:
            return
        if self._spans and rs - self._spans[-1][1] < 2 * self.margin:
            self._spans[-1][1] = max(self._spans[-1][1], re_)
        else:
            self._spans.append([rs, re_])

    def _detect(self) -> tuple[list[tuple[int, int]], int]:
        """(merged absolute damage spans, absolute trailing-run start).

        The trailing run is ANY sub-threshold suffix (even under the gap
        detector's min_len): it may still grow into damage, so everything
        from it on is unsafe to finalize or emit. An open run already past
        min_len is reported as a provisional span ending at the stream
        head (so monster dropouts tile out while still growing)."""
        spans = [(s, e) for s, e in self._spans if e > self._base]
        tail_start = (self._total if self._run_start is None
                      else self._run_start)
        if (self._run_start is not None
                and self._total - self._run_start > self._min_len):
            rs = self._run_start
            if spans and rs - spans[-1][1] < 2 * self.margin:
                spans[-1] = (spans[-1][0], self._total)
            else:
                spans.append((rs, self._total))
        return spans, tail_start

    def _window_settled(self, end: int) -> bool:
        """Whether the damage masked inside a window ending at ``end`` is
        final: no open quiet run lies inside the window that may yet
        become a detected span. An open run that starts at or after
        ``end``, or that is already longer than min_len (so a provisional
        span, masked to the window's end whatever its final length), is
        harmless; a shorter one inside the window is masked or not
        depending on how long it gets, so the window waits for it."""
        rs = self._run_start
        return rs is None or rs >= end or self._total - rs > self._min_len

    def _geometry(self, s0: int, e1: int) -> tuple[int, int]:
        """Window (w0, size) for a span, absolute coords, capped doubling."""
        span = e1 - s0
        size = self.window
        while span + 2 * self.ctx > size and size < self.cap:
            size *= 2
        w0 = max(0, s0 - (size - span) // 2)
        return w0, size

    def _pieces(self, s0: int, e1: int) -> list[tuple[int, int]]:
        """Split a span beyond the cap into tiles on the ABSOLUTE tile grid
        (k*tile boundaries, not s0-relative): history trimming can truncate
        a re-detected span's left edge, and grid alignment keeps the
        remaining pieces' identities, and therefore their fills, bit-
        identical regardless of where the truncation landed."""
        if e1 - s0 + 2 * self.ctx <= self.cap:
            return [(s0, e1)]
        return [(max(s0, k * self.tile), min((k + 1) * self.tile, e1))
                for k in range(s0 // self.tile,
                               -(-e1 // self.tile))]

    def _group(self, spans: list[tuple[int, int]], tail_start: int,
               final: bool):
        """Partition spans into restore groups, the offline planner's rule
        (windowed.plan_windows): consecutive spans join a group while the
        group extent + 2*ctx still fits the BASE window, so one window
        restore serves every span inside it.

        Grouping must be CHUNK-INVARIANT, so a group only closes when its
        membership can never change: (a) the last member can no longer
        grow or merge (2*margin of loud samples follow it), and (b) no
        future span can join: every future run starts at/after
        ``tail_start`` and needs > min_len samples, so once
        ``tail_start + min_len`` ends past the group's window reach,
        membership is fixed. This waits ~window (not ~window/2) before
        restoring a lone gap; pick a smaller window_s when latency
        dominates.

        Returns [(s0, e1, members, closed)] in stream order.
        """
        out = []
        for s0, e1, members in self._partition(spans):
            if final:
                closed = True
            else:
                full = e1 - s0 + 2 * self.ctx > self.window
                no_join = full or (tail_start + self._min_len + 2 * self.ctx
                                   >= s0 + self.window)
                closed = no_join and e1 + 2 * self.margin <= tail_start
            out.append((s0, e1, members, closed))
        return out

    def _partition(self, spans: list[tuple[int, int]]) -> list[list]:
        """[s0, e1, members] groups of the spans, greedily in stream order
        from the partition's origin, as the whole stream's spans would be
        grouped: the first group starts at ``_origin`` when its first
        members were trimmed."""
        groups: list[list] = []
        for s, e in spans:
            if groups and e - groups[-1][0] + 2 * self.ctx <= self.window:
                groups[-1][1] = e
                groups[-1][2].append((s, e))
            else:
                s0 = s if groups or self._origin is None else self._origin
                groups.append([s0, e, [(s, e)]])
        return groups

    def _advance(self, final: bool) -> np.ndarray:
        spans, tail_start = self._detect()
        blockers: list[tuple[int, int]] = []

        def covered(m):
            return (m[1] <= self._emit
                    or any(fs <= m[0] and m[1] <= fe
                           for fs, fe in self._filled))

        def ready(w0, size):
            return (self._total >= w0 + size
                    and self._window_settled(w0 + size))

        for s0, e1, members, closed in self._group(spans, tail_start, final):
            if e1 - s0 + 2 * self.ctx > self.window:
                # oversized single span: capped window doubling, then
                # absolute-grid tiles (a span this large can never share a
                # group: the join rule requires fitting the base window)
                for cs, ce in self._pieces(s0, e1):
                    if covered((cs, ce)):
                        continue                 # emitted/restored = final
                    w0, size = self._geometry(cs, ce)
                    # a piece is final when its window is fully buffered AND
                    # its identity can never change: either 2*margin of loud
                    # samples follow it (no future merge can absorb it), or
                    # a full tile of known silence follows it inside an
                    # oversized span (the tile grid is absolute, so growth
                    # only appends pieces)
                    settled = (ce + 2 * self.margin <= tail_start
                               or e1 - ce >= self.tile)
                    if final or (settled and ready(w0, size)):
                        self._restore_piece([(cs, ce)], w0, size, spans)
                    else:
                        blockers.append((cs, ce))
                continue
            live = [m for m in members if not covered(m)]
            if not live:
                continue
            # window placed by the FULL group extent (not just the live
            # members), so placement, and therefore the fill, does not
            # depend on how much history was already emitted
            w0, size = self._geometry(s0, e1)
            if final or (closed and ready(w0, size)):
                self._restore_piece(live, w0, size, spans)
            else:
                blockers.append((live[0][0], e1))

        if final:
            watermark = self._total
        else:
            watermark = self._total - self.margin
            # a sub-detection-length quiet suffix may still grow into
            # damage: hold it (and margin before it). A DETECTED ongoing
            # span's samples are all owned by pieces (filled ones are
            # final and emit; unfinished ones are blockers below), so a
            # monster dropout streams out tile by tile instead of pinning
            # the watermark at its start.
            if (tail_start < self._total
                    and not any(e1 >= self._total for _, e1 in spans)):
                watermark = min(watermark, tail_start - self.margin)
            if blockers:
                watermark = min(watermark, min(b[0] for b in blockers)
                                - self.margin)
        watermark = max(watermark, self._emit)

        lo = self._emit - self._base
        hi = watermark - self._base
        out = self._out.view()[lo:hi].copy()
        self._emit = watermark

        # retention: keep cap history behind the watermark (a future gap
        # just past it can reach back (cap - span)/2 < cap), and never trim
        # into an unrestored blocker's window
        floor = self._emit - self.cap
        for cs, ce in blockers:
            floor = min(floor, self._geometry(cs, ce)[0])
        floor = max(floor, self._base)
        if floor > self._base:
            drop = floor - self._base
            self._buf.drop(drop)
            self._out.drop(drop)
            self._base = floor
            self._filled = [(fs, fe) for fs, fe in self._filled
                            if fe > floor - self.cap]
            # the first retained span keeps the group it had
            self._origin = next(
                (s0 for s0, _, members in self._partition(
                    [tuple(sp) for sp in self._spans])
                 if members[-1][1] > floor), None)
            self._spans = [sp for sp in self._spans if sp[1] > floor]
        return out

    def _restore_piece(self, members: list[tuple[int, int]], w0: int,
                       size: int, spans: list[tuple[int, int]]) -> None:
        """Restore ONE window and composite the fill into _out over every
        member span (the extraction/masking/composite contract of
        restore_windowed: foreign damage masked, validity mirrored through
        any reflect padding, margin crossfades at each member boundary)."""
        hi = min(w0 + size, self._total)
        bl, bh = w0 - self._base, hi - self._base
        mask = np.ones(hi - w0, bool)
        for s, e in spans:
            ls, le = max(s, w0) - w0, min(e, hi) - w0
            if ls < le:
                mask[ls:le] = False
        sub, mask, local = window_spans(self._buf.view()[bl:bh].copy(), mask,
                                        size)

        restored = self._call_method(sub, local, mask)

        w = composite_weight(size, [(s - w0, e - w0) for s, e in members],
                             self.margin)
        m = hi - w0
        seg = slice(bl, bh)
        ov = self._out.view()      # writes through to the tape's storage
        ov[seg] = (1.0 - w[:m]) * ov[seg] + w[:m] * restored[:m]
        self._filled.extend(members)

    def _call_method(self, sub: np.ndarray, local: list[tuple[int, int]],
                     mask: np.ndarray) -> np.ndarray:
        """The ONE `api.restore` invocation both the live path
        (`_restore_piece`) and `warmup` go through. The persistent-U-Net
        path routes to the carried per-stream net instead (same masks,
        same composite contract)."""
        from .. import api

        if self._unet is not None:
            return self._unet.restore_window(sub, mask)
        return np.asarray(api.restore(
            sub, self.sr, method=self.method, gaps=local, mask=mask,
            threshold=self.threshold, seed=self.seed, device=self.device,
            **self.cfg_kwargs), np.float32)


def restore_stream(chunks, sr: int, method: str = "linear",
                   **kwargs):
    """Generator convenience: yield restored chunks for an iterable of
    input chunks (see StreamRestorer for the contract)."""
    rest = StreamRestorer(sr, method, **kwargs)
    for chunk in chunks:
        out = rest.feed(chunk)
        if len(out):
            yield out
    out = rest.flush()
    if len(out):
        yield out
