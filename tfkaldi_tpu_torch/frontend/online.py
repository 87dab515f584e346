"""Streaming (chunked) acoustic feature extraction.

Port of :class:`tfkaldi_tpu.frontend.online.OnlineFeatureExtractor`,
``OnlineDynamicExtractor`` and ``FusedOnlineFeatureExtractor``
(frontend/online.py:48-658), with
the same ``reset / step / flush / flush_rows / reset_rows`` API. Raw audio
comes in chunks of any size; each frame is emitted once its window is
complete, and the frames are exactly those of the offline
:class:`~tfkaldi_tpu_torch.frontend.features.FeatureExtractor` on the whole
utterance:

- preemphasis ``y[n] = x[n] - a·x[n-1]`` in f64 with two roundings (the
  product, then the difference), as kernel 2 and its plain version compute
  it; the last raw sample of a chunk is carried, so chunk boundaries do not
  show;
- a frame is cut from the buffered preemphasised samples once all
  ``frame_len`` of them exist; under ``snip_edges`` every offline frame is
  interior, so this is the offline frame set;
- the frames go through the extractor's own ``_frames_to_feats`` (DFT, mel,
  log, masking), the offline code after its framing;
- ``flush`` emits what depends on the true length: the zero-padded tail
  frames under ``snip_edges = False`` and the single padded frame of an
  utterance shorter than one window (``FeatureExtractor.frame_geometry``).

Delta dynamics are whole-utterance operators with a reflected boundary at
both ends, so :class:`OnlineDynamicExtractor` (a copy of the JAX class,
frontend/online.py:250-400) streams them: it buffers the f64 static
features of :class:`OnlineFeatureExtractor` in static mode, emits frame
``t`` once frame ``t + A`` exists (``A`` 2 for delta, 4 for ddelta) and runs
the extractor's own dynamics tail over windows that reach the true start,
and at ``flush`` the true end, of the utterance.

:class:`OnlineFeatureExtractor` keeps its sample buffers on the host in
numpy and runs the feature tail on the extractor's device.
:class:`FusedOnlineFeatureExtractor` keeps them on the device: one push is
one call of device ops (preemphasis, append, framing, the feature tail and
an optional f32 CMVN, then the buffer advance) whose result stays on the
device, and the host mirrors the cursors from the pushed lengths, so
nothing is read back mid-stream. ``fused_calls`` counts those calls (at
most one per push), where the JAX class counts its ``dispatch_count``. The
CMVN is :func:`~tfkaldi_tpu_torch.frontend.cmvn.apply_cmvn`, the same f32
ops as the unfused transcriber applies, so here the fused and the unfused
chains agree exactly (XLA's fusion of the JAX fused call rounds within 2
f32 ulps of its unfused chain).
"""

from __future__ import annotations

import numpy as np
import torch

from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn



class OnlineFeatureExtractor:
    """Chunked feature computation over a batch of parallel audio streams,
    sample buffers on the host.

    Usage::

        online = OnlineFeatureExtractor(FeatureExtractor(opts, rate, device))
        online.reset(batch_size)
        for chunk, chunk_lengths in audio_chunks:   # [B, S], [B]
            feats, n_new = online.step(chunk, chunk_lengths)
        feats, n_new = online.flush()               # final padded frame(s)

    Rows may advance at different rates; a row whose stream has ended
    passes length 0 until ``flush``. ``feats`` is numpy f32 ``[B, T, D]``,
    ``T`` padded up to a multiple of ``frame_bucket`` with zero frames.
    ``_emit_static`` (for :class:`OnlineDynamicExtractor`) emits the f64
    static features instead, before the dynamics, the mask and the cast.
    """

    def __init__(self, extractor, frame_bucket: int = 8, _emit_static: bool = False):
        if extractor.opts.dynamic != "nodelta" and not _emit_static:
            raise ValueError("online extraction of delta features goes through OnlineDynamicExtractor (delta "
                             "dynamics are whole-utterance operators; it buffers the lookahead they need)")
        self.extractor = extractor
        self.frame_bucket = int(frame_bucket)
        self._emit_static = bool(_emit_static)
        self._buf = None  # per-row preemphasised, not yet consumed samples

    @property
    def dim(self) -> int:
        return self.extractor.opts.base_dim if self._emit_static else self.extractor.opts.dim

    def reset(self, batch_size: int) -> None:
        self._buf = [np.zeros((0,), np.float64) for _ in range(batch_size)]
        self._prev = np.zeros((batch_size,), np.float64)
        self._total = np.zeros((batch_size,), np.int64)
        self._emitted = np.zeros((batch_size,), np.int64)

    def _emit(self, navail: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Cut ``navail[row]`` frames from the head of each row's buffer,
        advance the buffers and run the feature tail."""
        wl, ws = self.extractor.frame_len, self.extractor.frame_step
        navail = navail.astype(np.int64)
        t_new = int(navail.max(initial=0))
        b = len(self._buf)
        if t_new == 0:
            dtype = np.float64 if self._emit_static else np.float32
            return np.zeros((b, 0, self.dim), dtype), navail.astype(np.int32)
        t_pad = -(-t_new // self.frame_bucket) * self.frame_bucket
        frames = np.zeros((b, t_pad, wl), np.float64)
        for row, n in enumerate(navail):
            if n == 0:
                continue
            span = self._buf[row][: (n - 1) * ws + wl]
            frames[row, :n] = np.lib.stride_tricks.sliding_window_view(span, wl)[::ws]
            self._buf[row] = self._buf[row][n * ws:]
            self._emitted[row] += n
        device = self.extractor.device
        tail = self.extractor._frames_to_static if self._emit_static else self.extractor._frames_to_feats
        with torch.inference_mode():
            feats = tail(torch.from_numpy(frames).to(device), torch.from_numpy(navail).to(device)).cpu().numpy()
        return feats, navail.astype(np.int32)

    def step(self, chunk, lengths) -> tuple[np.ndarray, np.ndarray]:
        """Feed ``[B, S]`` raw samples (``lengths[B]`` valid a row); returns
        ``(feats [B, T, D], new_frames [B])`` for every frame whose window
        is now complete."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before step()")
        x = np.asarray(chunk).astype(np.float64)
        lengths = np.asarray(lengths, np.int64)
        wl, ws = self.extractor.frame_len, self.extractor.frame_step
        a = float(self.extractor.opts.preemph)
        shifted = np.concatenate([self._prev[:, None], x[:, :-1]], axis=1)
        y = x - a * shifted
        navail = np.zeros((len(self._buf),), np.int64)
        for row, n in enumerate(lengths):
            n = int(n)
            if n > 0:
                self._buf[row] = np.concatenate([self._buf[row], y[row, :n]])
                self._prev[row] = x[row, n - 1]
                self._total[row] += n
            have = self._buf[row].shape[0]
            navail[row] = 0 if have < wl else (have - wl) // ws + 1
        return self._emit(navail)

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """End every stream: emit the frames the offline geometry adds for
        the now known lengths; then ``reset`` is required."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before flush()")
        out = self._flush_impl(range(len(self._buf)))
        self._buf = None
        return out

    def _flush_impl(self, rows) -> tuple[np.ndarray, np.ndarray]:
        wl, ws = self.extractor.frame_len, self.extractor.frame_step
        target, _ = self.extractor.frame_geometry(self._total)
        rem = np.zeros((len(self._buf),), np.int64)
        sel = np.asarray(list(rows), np.int64)
        rem[sel] = np.maximum(target.astype(np.int64) - self._emitted, 0)[sel]
        for row, r in enumerate(rem):
            if r == 0:
                continue
            needed = (int(r) - 1) * ws + wl
            have = self._buf[row].shape[0]
            if needed > have:  # literal zeros past the end, as the offline path masks then frames
                self._buf[row] = np.concatenate([self._buf[row], np.zeros((needed - have,), np.float64)])
        return self._emit(rem)

    def flush_rows(self, rows) -> tuple[np.ndarray, np.ndarray]:
        """``flush`` for some rows only (the others emit 0 and keep
        streaming); re-arm the flushed rows with ``reset_rows``."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before flush_rows()")
        return self._flush_impl(rows)

    def reset_rows(self, rows) -> None:
        """Re-arm some rows for new streams; the others are untouched."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before reset_rows()")
        for row in rows:
            self._buf[row] = np.zeros((0,), np.float64)
            self._prev[row] = 0
            self._total[row] = 0
            self._emitted[row] = 0


class OnlineDynamicExtractor:
    """Streaming delta / double-delta features: the static columns
    bit-identical to the offline extractor's, the derivative columns within
    a few f64 ulps (the f64 statics of other batch shapes may round
    otherwise, and a derivative that cancels to about 0 shows it).

    The dynamics (``[2, 1, 0, -1, -2]`` with reflected boundaries) need
    ``lookahead`` future frames an output frame and the true end of the
    utterance. The f64 statics of :class:`OnlineFeatureExtractor` in static
    mode are buffered; frame ``t`` is emitted once frame ``t + A`` exists,
    through the extractor's own ``_apply_dynamics`` over the window
    ``[t - lead, t + n - 1 + A]`` with ``lead = min(A, t)``, so a window's
    edge reflections either do not reach the emitted frames or are the
    utterance's own start reflection. ``flush`` passes the true final frame
    count, so the end reflection is the offline one. Same ``reset / step /
    flush / flush_rows / reset_rows`` API as :class:`OnlineFeatureExtractor`
    (host numpy f32 features)."""

    def __init__(self, extractor, frame_bucket: int = 8):
        if extractor.opts.dynamic == "nodelta":
            raise ValueError("dynamic = 'nodelta' streams through OnlineFeatureExtractor")
        self.extractor = extractor
        self.frame_bucket = int(frame_bucket)
        self.lookahead = {"delta": 2, "ddelta": 4}[extractor.opts.dynamic]
        self._static = OnlineFeatureExtractor(extractor, frame_bucket, _emit_static=True)
        self._buf = None

    @property
    def dim(self) -> int:
        return self.extractor.opts.dim

    def reset(self, batch_size: int) -> None:
        self._static.reset(batch_size)
        self._buf = [None] * batch_size  # each row's static frames from global index _start on
        self._start = np.zeros((batch_size,), np.int64)
        self._total = np.zeros((batch_size,), np.int64)
        self._emitted = np.zeros((batch_size,), np.int64)

    def _ingest(self, feats: np.ndarray, nnew: np.ndarray) -> None:
        for row, n in enumerate(nnew):
            n = int(n)
            if n == 0:
                continue
            new = feats[row, :n]
            self._buf[row] = new.copy() if self._buf[row] is None else np.concatenate([self._buf[row], new])
            self._total[row] += n

    def _emit(self, navail: np.ndarray, flushing: bool):
        a = self.lookahead
        b = len(self._buf)
        if int(navail.max(initial=0)) == 0:
            return np.zeros((b, 0, self.dim), np.float32), navail.astype(np.int32)
        # a window: lead frames of left context, the n emitted, and A of
        # right context unless flushing (the buffer then ends at the true end)
        leads = np.minimum(self._emitted, a).astype(np.int64)
        wlens = np.where(navail > 0, leads + navail + (0 if flushing else a), 0)
        w_pad = -(-int(wlens.max()) // self.frame_bucket) * self.frame_bucket
        windows = np.zeros((b, w_pad, self._static.dim), np.float64)
        for row, n in enumerate(navail):
            if n == 0:
                continue
            first = int(self._emitted[row] - leads[row] - self._start[row])
            windows[row, : int(wlens[row])] = self._buf[row][first: first + int(wlens[row])]
        device = self.extractor.device
        with torch.inference_mode():
            out = self.extractor._apply_dynamics(torch.from_numpy(windows).to(device),
                                                 torch.from_numpy(wlens).to(device)).cpu().numpy()
        t_pad = -(-int(navail.max()) // self.frame_bucket) * self.frame_bucket
        result = np.zeros((b, t_pad, self.dim), np.float32)
        for row, n in enumerate(navail):
            n = int(n)
            if n == 0:
                continue
            lead = int(leads[row])
            result[row, :n] = out[row, lead: lead + n]
            self._emitted[row] += n
            # keep only the frames later windows can still reach
            keep_from = int(max(0, self._emitted[row] - a) - self._start[row])
            if keep_from > 0:
                self._buf[row] = self._buf[row][keep_from:]
                self._start[row] += keep_from
        return result, navail.astype(np.int32)

    def step(self, chunk, lengths) -> tuple[np.ndarray, np.ndarray]:
        """``[B, S]`` raw samples → ``(feats [B, T, D] f32, counts)`` for
        every frame whose lookahead is complete."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before step()")
        self._ingest(*self._static.step(chunk, lengths))
        return self._emit(np.maximum(self._total - self.lookahead - self._emitted, 0), flushing=False)

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Emit the remaining frames with the true end reflection; then
        ``reset`` is required."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before flush()")
        self._ingest(*self._static.flush())
        out = self._emit(self._total - self._emitted, flushing=True)
        self._buf = None
        return out

    def flush_rows(self, rows) -> tuple[np.ndarray, np.ndarray]:
        """``flush`` for some rows (the others emit 0 and keep streaming);
        re-arm the flushed rows with ``reset_rows``."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before flush_rows()")
        self._ingest(*self._static.flush_rows(rows))
        sel = np.asarray(list(rows), np.int64)
        rem = np.zeros((len(self._buf),), np.int64)
        rem[sel] = (self._total - self._emitted)[sel]
        return self._emit(rem, flushing=True)

    def reset_rows(self, rows) -> None:
        """Re-arm some rows for new streams; the others are untouched."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before reset_rows()")
        self._static.reset_rows(rows)
        for row in rows:
            self._buf[row] = None
            self._start[row] = 0
            self._total[row] = 0
            self._emitted[row] = 0


class FusedOnlineFeatureExtractor:
    """The device-resident streaming front-end: one call of device ops a
    push, its features left on the device.

    The device buffer holds the not yet consumed preemphasised samples
    (fewer than ``frame_len`` after a push, so its capacity is ``frame_len``
    plus the padded chunk); pushes are padded to a multiple of
    ``sample_bucket`` samples, and the call computes the most frames that
    padding can complete (its rows past ``new_frames`` are zeros). Same API
    as :class:`OnlineFeatureExtractor`; ``step`` returns a device tensor.
    """

    def __init__(self, extractor, sample_bucket: int = 256, cmvn: np.ndarray | None = None):
        if extractor.opts.dynamic != "nodelta":
            raise ValueError("the fused online front-end streams static features only; delta dynamics go "
                             "through OnlineDynamicExtractor")
        self.extractor = extractor
        self.device = extractor.device
        self.sample_bucket = int(sample_bucket)
        self._cmvn = None if cmvn is None else np.asarray(cmvn, np.float32)
        self._state = None
        self._cap = 0
        #: fused calls since construction (tests hold it to <= 1 a push)
        self.fused_calls = 0

    @property
    def dim(self) -> int:
        return self.extractor.opts.base_dim

    def fuse_cmvn(self, stats: np.ndarray) -> None:
        """Fold CMVN into the fused call (the transcribers hand their stats
        over, so the front-end stays one call a push)."""
        self._cmvn = np.asarray(stats, np.float32)

    def _ensure_cap(self, s_pad: int) -> None:
        need = self.extractor.frame_len + s_pad
        if need <= self._cap:
            return
        if self._state is not None and self._cap:
            buf, nbuf, prev = self._state
            self._state = (torch.nn.functional.pad(buf, (0, need - self._cap)), nbuf, prev)
        self._cap = need

    def reset(self, batch_size: int) -> None:
        self._ensure_cap(self.sample_bucket)
        dev = self.device
        self._state = (torch.zeros(batch_size, self._cap, dtype=torch.float64, device=dev),
                       torch.zeros(batch_size, dtype=torch.long, device=dev),
                       torch.zeros(batch_size, dtype=torch.float64, device=dev))
        self._nbuf = np.zeros((batch_size,), np.int64)
        self._total = np.zeros((batch_size,), np.int64)
        self._emitted = np.zeros((batch_size,), np.int64)

    @torch.inference_mode()
    def _fused(self, chunk, lengths, navail):
        """Preemphasis → append at each row's fill → frames → features
        (→ CMVN) → drop the consumed samples, all on the device."""
        ext = self.extractor
        wl, ws, a = ext.frame_len, ext.frame_step, float(ext.opts.preemph)
        cap = self._cap
        frames_cap = (cap - wl) // ws + 1
        buf, nbuf, prev = self._state
        dev = self.device
        s = chunk.shape[1]
        x = chunk.to(torch.float64)
        shifted = torch.cat([prev[:, None], x[:, :-1]], dim=1)
        y = x - a * shifted  # two roundings, as kernel 2
        last = torch.gather(x, 1, (lengths - 1).clamp(0, s - 1)[:, None])[:, 0]
        prev = torch.where(lengths > 0, last, prev)
        i = torch.arange(cap, device=dev)[None, :]
        src = i - nbuf[:, None]
        take = (src >= 0) & (src < lengths[:, None])
        buf = torch.where(take, torch.gather(y, 1, src.clamp(0, s - 1)), buf)
        nbuf = nbuf + lengths
        fidx = torch.arange(frames_cap, device=dev)[:, None] * ws + torch.arange(wl, device=dev)[None, :]
        tmask = (torch.arange(frames_cap, device=dev)[None, :] < navail[:, None])[:, :, None]
        frames = torch.where(tmask, buf[:, fidx], 0.0)
        feats = ext._frames_to_feats(frames, navail)
        if self._cmvn is not None:
            feats = torch.where(tmask, apply_cmvn(feats, self._cmvn), 0.0)
        consumed = navail * ws
        src2 = i + consumed[:, None]
        buf = torch.where(src2 < nbuf[:, None], torch.gather(buf, 1, src2.clamp(0, cap - 1)), 0.0)
        self._state = (buf, nbuf - consumed, prev)
        return feats

    def _run(self, chunk: np.ndarray, lengths: np.ndarray, navail: np.ndarray):
        """One fused call, or none when nothing is pushed or emitted."""
        b = len(self._nbuf)
        counts = navail.astype(np.int32)
        if int(lengths.max(initial=0)) == 0 and int(navail.max(initial=0)) == 0:
            return torch.zeros(b, 0, self.dim, device=self.device), counts
        s_pad = max(-(-int(chunk.shape[1]) // self.sample_bucket) * self.sample_bucket, self.sample_bucket)
        self._ensure_cap(s_pad)
        padded = np.zeros((b, s_pad), np.float32)
        padded[:, : chunk.shape[1]] = chunk
        dev = self.device
        feats = self._fused(torch.from_numpy(padded).to(dev, non_blocking=True),
                            torch.from_numpy(lengths.astype(np.int64)).to(dev, non_blocking=True),
                            torch.from_numpy(navail.astype(np.int64)).to(dev, non_blocking=True))
        self.fused_calls += 1
        return feats, counts

    def step(self, chunk, lengths):
        """Feed ``[B, S]`` raw samples; returns ``(feats [B, T, D] on the
        device, new_frames [B])``: one fused call, no read-back."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before step()")
        chunk = np.asarray(chunk, np.float32)
        lengths = np.asarray(lengths, np.int64)
        wl, ws = self.extractor.frame_len, self.extractor.frame_step
        have = self._nbuf + lengths
        navail = np.where(have < wl, 0, (have - wl) // ws + 1)
        self._nbuf = have - navail * ws
        self._total += lengths
        self._emitted += navail
        return self._run(chunk, lengths, navail)

    def flush(self):
        """End every stream (the offline geometry's zero-padded tails);
        then ``reset`` is required."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before flush()")
        out = self._flush_impl(range(len(self._nbuf)))
        self._state = None
        return out

    def _flush_impl(self, rows):
        b = len(self._nbuf)
        wl, ws = self.extractor.frame_len, self.extractor.frame_step
        target, _ = self.extractor.frame_geometry(self._total)
        rem = np.zeros((b,), np.int64)
        sel = np.asarray(list(rows), np.int64)
        rem[sel] = np.maximum(target.astype(np.int64) - self._emitted, 0)[sel]
        # tail frames read the zeros kept past each row's fill: the offline
        # mask-then-frame padding
        needed = np.where(rem > 0, (rem - 1) * ws + wl, 0)
        if int(needed.max(initial=0)) > self._cap:
            self._ensure_cap(int(needed.max()) - wl)
        self._emitted += rem
        self._nbuf = np.maximum(self._nbuf - rem * ws, 0)
        return self._run(np.zeros((b, 0), np.float32), np.zeros((b,), np.int64), rem)

    def flush_rows(self, rows):
        """``flush`` for some rows; the others emit 0 and keep streaming."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before flush_rows()")
        return self._flush_impl(rows)

    def reset_rows(self, rows) -> None:
        """Re-arm some rows for new streams (a row-masked zeroing on the
        device); the others are untouched."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before reset_rows()")
        idx = np.asarray(list(rows), np.int64)
        sel = np.zeros((len(self._nbuf),), bool)
        sel[idx] = True
        mask = torch.from_numpy(sel).to(self.device)
        buf, nbuf, prev = self._state
        with torch.inference_mode():
            self._state = (torch.where(mask[:, None], 0.0, buf), torch.where(mask, 0, nbuf),
                           torch.where(mask, 0.0, prev))
        self._nbuf[idx] = 0
        self._total[idx] = 0
        self._emitted[idx] = 0
