"""Streaming voice conversion: incremental cloning with bounded latency.

Counterpart of ``speech_cloner_tpu/pipeline/stream.py`` (`StreamingCloner`):
push audio as it arrives and get cloned audio back with a fixed worst-case
input latency of ``(chunk + lookahead + edge) frames`` (~3 s at the
defaults). ``batch=B`` converts B independent live streams in lockstep, one
forward and one Griffin-Lim per step for all of them, with ``[B, n]`` push
and flush; every carried statistic is per stream.

The design is the JAX module's, step for step:

- each chunk's forward sees ``context_frames`` of real left context and
  ``lookahead_frames`` of real right context (recomputed from h = 0 each
  step); the flush window ends at the last real frame, so the backward GRUs
  start where the offline forward's do;
- the whole-clip feature statistics are carried: the input gain (frozen
  from the first window, then by default refined to the mean |y| of
  everything arrived), the first emitted frame's mel spectrum at unit gain
  (raw c0 is re-derived from it every window at that window's gain and mel
  max), and the running mel max for the ``top_db`` clip;
- steady chunks compute and discard ``edge_frames`` boundary frames a side;
  the flush window is framed center=False over the pre-emphasized stream,
  reflect-padded as the offline front-end pads it;
- Griffin-Lim runs per chunk over ``[chunk - margin, chunk + margin]``
  frames, seeded with the previous chunk's final phase over the leading
  margin; the overlap is crossfaded in the pre-emphasized domain, the
  inverse pre-emphasis IIR carries across chunks, and the output norm is an
  EMA gain with a per-chunk linear ramp.

The host state is numpy, as in the JAX module, including the per-stream
``np.random.default_rng(seed + i)`` phase draws, so both packages draw the
same phases. The device work is two eager methods on tensors, `_forward`
(features, encoder, decoder; the JAX ``_build_fwd``) and `_vocode` (the JAX
``_build_gl``): the predicted spectrogram stays on the device between them,
and one copy per step brings back the waveform before inverse pre-emphasis,
the phase tail, the carried mel spectrum and the mel max. On a CUDA
pipeline every window's GRUs run the hand-written scan kernel
(``ops/cuda_kernels.py``) at T = the window's frames and B = the streams.
The JAX module's compile machinery (``_jitted``, ``_params``,
``_jit_sharded``) has no counterpart.

``mesh=`` (a 1-D ``parallel.make_seq_mesh`` mesh; B a multiple of its size)
shards the streams: the B/n rows of mesh position i run their forward and
Griffin-Lim on device i, with the pipeline's weights replicated there
(`ClonePipeline.replica`), and nothing crosses devices in the steady state.
Every shard's work is launched before the first copy back to the host, so
distinct cards run their shards at once; the host state stays one numpy
state for all B streams.

Each push (flush) opens the recorder's spans (``runtime/profiler.py``
`span`; nothing while the recorder is off): ``stream.push``
(``stream.flush``), and per step ``stream.step`` over the host's
``stream.gains``, ``stream.phases`` and ``stream.emit``, the device's
``stream.forward`` and ``stream.vocode`` (each host-to-device copy inside
them a ``stream.upload``) and the copy back, ``stream.to_host``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.griffin_lim import griffin_lim, magnitudes
from ..ops.preemphasis import preemphasis
from ..ops.stft import stft
from ..runtime.profiler import span
from .clone import ClonePipeline

_TINY = np.float32(np.finfo(np.float32).tiny)
# floor for the mean-|y| input-gain estimates: a silent window must not give
# a gain whose square overflows float32 (the carried unit-gain mel0 is
# rescaled by gain^2 on the device)
_MIN_MEAN = np.float32(1e-12)


class StreamingCloner:
    """Incremental wav -> cloned-wav converter around a `ClonePipeline`.

    Usage::

        s = StreamingCloner(pipeline)
        for block in microphone():          # arbitrary block sizes
            out.append(s.push(block))       # 0+ samples per call
        out.append(s.flush())               # drain the tail

    With ``batch=B``, push/flush take and return ``[B, n]`` arrays and the
    B streams are converted in lockstep (equal lengths; a serving frontend
    pads idle streams with silence).

    Emits float32 waveform at the pipeline's output level convention
    (`pipeline.mean_abs_amp_norm`). Total emitted length is exactly
    ``(n_samples // hop + 1) * hop``: one hop per STFT frame of the pushed
    audio, like the offline frame grid.
    """

    def __init__(
        self,
        pipeline: ClonePipeline,
        *,
        chunk_frames: int = 400,
        context_frames: int = 400,
        lookahead_frames: int = 200,
        margin_frames: int = 16,
        edge_frames: int = 4,
        seed: int = 0,
        batch: int | None = None,
        mesh=None,
        input_gain=None,
        gain_mode: str | None = None,
        first_gain: str = "window",
        out_gain_ema: float = 0.9,
        collect_debug: bool = False,
    ):
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be >= 1")
        if margin_frames < 2:
            raise ValueError("margin_frames must be >= 2 (crossfade needs >= 1 hop)")
        if margin_frames > lookahead_frames + edge_frames:
            raise ValueError("margin_frames must be <= lookahead_frames + edge_frames")
        if margin_frames > context_frames + edge_frames:
            # the vocode region starts margin frames before the emit start;
            # the window reaches only context+edge frames back
            raise ValueError("margin_frames must be <= context_frames + edge_frames")
        if chunk_frames < margin_frames - 1:
            # the crossfade ((margin-1) hops) must fit inside one emitted chunk
            raise ValueError("chunk_frames must be >= margin_frames - 1")
        if batch is not None and batch < 1:
            raise ValueError("batch must be >= 1")
        feat = pipeline.feat_cfg
        # edge_frames must cover the STFT reflect-pad contamination depth
        min_edge = -(-feat.n_fft_ // (2 * feat.hop_length))  # ceil(n_fft/2 / hop)
        if edge_frames < min_edge:
            raise ValueError(f"edge_frames must be >= {min_edge} for this STFT geometry")

        self.p = pipeline
        self.feat = feat
        self.hop = feat.hop_length
        self.C = chunk_frames
        self.Lc = context_frames
        self.Rc = lookahead_frames
        self.M = margin_frames
        self.EB = edge_frames
        # gain_mode: "running" refines the input gain to the mean |y| of
        # everything arrived (exact modulo the amin floor, through the
        # carried-c0 normalization); "frozen" keeps the first window's
        # estimate. None = running when supported, else frozen.
        if gain_mode not in (None, "running", "frozen"):
            raise ValueError("gain_mode must be 'running' or 'frozen'")
        if gain_mode == "running" and not feat.mfcc_normaleze_first_mfcc:
            raise ValueError(
                "gain_mode='running' needs mfcc_normaleze_first_mfcc (the "
                "carried-c0 subtraction is what makes a gain update exact)")
        self._running = (gain_mode != "frozen" and input_gain is None
                         and feat.mfcc_normaleze_first_mfcc)
        # first_gain: scope of a stream's first gain estimate. "window" = that
        # step's model window (output invariant to how the audio was sliced
        # into pushes); "buffered" = everything the occupant has pushed by
        # its first step (closer to the offline clip-wide estimate)
        if first_gain not in ("window", "buffered"):
            raise ValueError("first_gain must be 'window' or 'buffered'")
        self.first_gain = first_gain
        self.out_gain_ema = out_gain_ema
        self.collect_debug = collect_debug
        self.debug_stft: list[np.ndarray] = []
        self._vec = batch is not None
        B = self.B = batch or 1
        # stream rows of each mesh position, with the pipeline on its device
        self.mesh = mesh
        if mesh is None:
            self._shards = [(slice(0, B), pipeline)]
        else:
            if B % mesh.size != 0:
                raise ValueError(f"batch={B} must divide over the {mesh.size}-device mesh")
            if len(mesh.axis_names) != 1:
                raise ValueError("stream mesh must be 1-D (streams axis only)")
            r = B // mesh.size
            self._shards = [(slice(i * r, (i + 1) * r), pipeline.replica(d))
                            for i, d in enumerate(mesh.device_list())]

        # per-stream RNG: stream i draws from seed+i, so a batched run is
        # draw for draw the B single-stream runs with seeds seed..seed+B-1
        self._rng = [np.random.default_rng(seed + i) for i in range(B)]
        self._buf = np.zeros((B, 0), np.float32)
        self._buf_start = 0        # global sample index of _buf[:, 0]
        self._n_samples = 0        # total samples pushed per stream
        self._f0 = 0               # next frame index to emit
        # ``_pending[i]``: stream i's gain and c0 are still to be frozen (at
        # construction unless ``input_gain`` pins the gain, and after
        # ``reset_stream(i)``)
        if input_gain is None:
            self._gain = np.ones(B, np.float32)
        else:
            self._gain = np.broadcast_to(
                np.asarray(input_gain, np.float32), (B,)).copy()
        self._ext_gain = input_gain is not None
        self._pending = np.ones(B, bool)
        # global sample index where each slot's current occupant's audio begins
        self._audio_from = np.zeros(B, np.int64)
        # running-gain accumulators: sum |y| and sample count over the
        # occupant's audio, and the global sample index each slot's sums reach
        self._g_sum = np.zeros(B, np.float64)
        self._g_cnt = np.zeros(B, np.int64)
        self._g_upto = np.zeros(B, np.int64)
        # first emitted frame's mel spectrum at unit gain, and the top_db max
        self._m0 = np.zeros((B, feat.n_mels), np.float32)
        self._mel_max = np.full(B, -np.inf, np.float32)
        self._tail: np.ndarray | None = None        # [B, (M-1)*hop] preemph overlap
        self._phase_tail: np.ndarray | None = None  # [B, M, n_stft]
        self._inv_state = np.zeros(B, np.float32)   # inverse-preemphasis IIR
        self._out_ema = np.zeros(B, np.float32)
        self._out_gain_prev = np.zeros(B, np.float32)
        self._out_pending = np.ones(B, bool)
        self._done = False

    # ------------------------------------------------------------- public ---

    @property
    def min_input_frames(self) -> int:
        """Frames of input needed before the first chunk can emit (the
        algorithmic input latency, excluding compute)."""
        return self.C + self.Rc + self.EB

    @property
    def latency_seconds(self) -> float:
        return self.min_input_frames * self.hop / self.feat.sample_rate

    def reset_stream(self, i: int) -> None:
        """Hand stream slot ``i`` to a new independent stream (serving slot
        reuse): every carried statistic of the slot is cleared, without
        touching the other slots or the shared frame clock. The slot's next
        step re-estimates its gain and re-captures its c0; frames the new
        occupant emits before its audio arrives are converted silence."""
        self._pending[i] = True
        self._m0[i] = 0.0
        self._mel_max[i] = -np.inf
        self._inv_state[i] = 0.0
        self._out_pending[i] = True
        self._g_sum[i] = 0.0
        self._g_cnt[i] = 0
        self._audio_from[i] = self._n_samples
        # the previous occupant's audio must not become the new one's context
        self._buf[i] = 0.0
        if self._tail is not None:
            self._tail[i] = 0.0          # fade the new stream in from zero
        if self._phase_tail is not None:  # not the previous occupant's phase
            self._phase_tail[i] = np.pi * self._rng[i].random(
                self._phase_tail.shape[1:]).astype(np.float32)

    def _in(self, samples) -> np.ndarray:
        samples = np.asarray(samples, np.float32)
        if self._vec:
            if samples.ndim != 2 or samples.shape[0] != self.B:
                raise ValueError(f"batch={self.B} streams expect [B, n] audio")
            return samples
        return samples.reshape(1, -1)

    def _out(self, parts) -> np.ndarray:
        out = (np.concatenate(parts, axis=1) if parts
               else np.zeros((self.B, 0), np.float32))
        return out if self._vec else out[0]

    def push(self, samples) -> np.ndarray:
        """Feed arbitrary-length audio; returns newly available output."""
        if self._done:
            raise RuntimeError("push() after flush()")
        with span("stream.push", self.p.device):
            samples = self._in(samples)
            if samples.shape[1]:
                self._buf = np.concatenate([self._buf, samples], axis=1)
                self._n_samples += samples.shape[1]
            out = []
            while (self._f0 + self.min_input_frames) * self.hop <= self._n_samples:
                with span("stream.step", self.p.device):
                    out.append(self._step())
            return self._out(out)

    def flush(self) -> np.ndarray:
        """Convert the remaining tail exactly and finish the stream."""
        if self._done:
            return self._out([])
        self._done = True
        total = self._n_samples // self.hop + 1 if self._n_samples else 0
        if self._f0 >= total:
            return self._out([])
        with span("stream.flush", self.p.device):
            with span("stream.step", self.p.device):
                emit = self._flush_step(total)
            return self._out([emit])

    def convert_all(self, wav, block: int = 16000) -> np.ndarray:
        """Convenience: stream complete waveform(s) through push/flush."""
        wav = self._in(wav)
        parts = [self.push(self._raw(wav[:, i:i + block]))
                 for i in range(0, wav.shape[1], block)]
        parts.append(self.flush())
        return (np.concatenate([self._in(p) for p in parts], axis=1)
                if self._vec else np.concatenate(parts))

    def _raw(self, x):
        return x if self._vec else x[0]

    # -------------------------------------------------------------- steps ---

    def _update_gains(self, win_lo: int, upto: int) -> None:
        """Per-step input-gain upkeep on the host, before the device work;
        ``win_lo``/``upto`` bound this step's model window in global samples.

        Pending streams freeze their gain from this window: the mean |y| of
        the occupant's samples in [max(win_lo, audio_from), upto), or, with
        ``first_gain="buffered"``, up to everything pushed. In running mode
        the other streams refine their gain to the mean |y| of everything
        the occupant has pushed; a gain change is a uniform dB shift, so the
        running mel max moves by the same dB (c0 is re-derived on the
        device). An external ``input_gain`` pins every gain."""
        if self._ext_gain:
            return
        if self._running:
            for i in range(self.B):
                u = int(self._g_upto[i])
                if upto > u:
                    seg = np.abs(self._buf[i, u - self._buf_start:
                                           upto - self._buf_start])
                    self._g_sum[i] += seg.sum(dtype=np.float64)
                    self._g_cnt[i] += seg.size
                    self._g_upto[i] = upto
        if self._pending.any():
            hi = max(self._n_samples, upto) \
                if self.first_gain == "buffered" else upto
            for i in np.flatnonzero(self._pending):
                lo = max(win_lo, int(self._audio_from[i]), self._buf_start)
                seg = np.abs(self._buf[i, lo - self._buf_start:
                                       hi - self._buf_start])
                m = max(float(seg.mean()) if seg.size else 0.0, _MIN_MEAN)
                self._gain[i] = self.feat.mean_abs_amp_norm / m
                if self._running:
                    # the occupant's accumulation starts where its audio does
                    self._g_sum[i] = float(seg.sum(dtype=np.float64))
                    self._g_cnt[i] = seg.size
                    self._g_upto[i] = hi
        if self._running:
            upd = (~self._pending) & (self._g_cnt > 0)
            if upd.any():
                mean = np.maximum(
                    self._g_sum / np.maximum(self._g_cnt, 1), _MIN_MEAN)
                g_new = (self.feat.mean_abs_amp_norm / mean).astype(np.float32)
                delta = np.where(
                    upd, 20.0 * np.log10(g_new / self._gain), 0.0
                ).astype(np.float32)
                self._mel_max += delta
                self._gain = np.where(upd, g_new, self._gain)

    def _phases(self, n_frames: int) -> np.ndarray:
        """Each stream's initial Griffin-Lim phase draw [B, n_frames, n_stft]."""
        return np.pi * np.stack(
            [g.random((n_frames, self.feat.n_stft)) for g in self._rng]).astype(np.float32)

    @torch.inference_mode()
    def _step(self) -> np.ndarray:
        """One steady chunk: emit frames [f0, f0+C) from a real-context
        window [f0-Lc-EB, f0+C+Rc+EB) (clamped at the global start)."""
        hop, C, M = self.hop, self.C, self.M
        f0 = self._f0
        f1 = f0 + C
        a = max(0, f0 - self.Lc - self.EB)       # window start frame
        e = f1 + self.Rc + self.EB               # window end frame
        v0 = max(0, f0 - M)                      # vocode region start frame
        v1 = f1 + M

        y = self._buf[:, a * hop - self._buf_start : e * hop - self._buf_start]
        with span("stream.gains"):
            self._update_gains(a * hop, e * hop)
        # vocode [v0, v1) with carried-phase init
        with span("stream.phases"):
            phase = self._phases(v1 - v0)
            if self._phase_tail is not None:
                phase[:, :M] = self._phase_tail
        outs = []
        for rows, p in self._shards:
            with span("stream.forward", p.device):
                stft_v, mel_max, mel0 = self._forward(y[rows], v0 - a, v1 - a, f0 - a,
                                                      shard=(rows, p))
            with span("stream.vocode", p.device):
                wav_pre, phase_tail = self._vocode(stft_v, phase[rows], f1 - v0, p=p)
            outs.append((wav_pre, phase_tail, mel0, mel_max, stft_v[:, f0 - v0 : f1 - v0]))
        if self.collect_debug:
            sv = np.concatenate([o[4].cpu().numpy() for o in outs])
            self.debug_stft.append(sv if self._vec else sv[0])
        with span("stream.to_host", self.p.device):
            wav_pre, phase_tail, mel0, mel_max = _to_host_shards([o[:4] for o in outs])
        self._m0, self._mel_max = mel0, mel_max[:, 0]
        self._pending[:] = False
        self._phase_tail = phase_tail.reshape(self.B, M, self.feat.n_stft)

        t_lo = (f1 - v0) * hop
        with span("stream.emit"):
            emit = self._emit(wav_pre, (f0 - v0) * hop, C * hop,
                              wav_pre[:, t_lo : t_lo + (M - 1) * hop].copy())

        # advance; drop audio no future window (the flush window's
        # reflect-padded tail framing included) can reach
        self._f0 = f1
        keep_from = max(0, (self._f0 - (self.Lc + self.C + self.Rc + 2 * self.EB))
                        * hop - self.feat.n_fft_)
        if keep_from > self._buf_start:
            self._buf = self._buf[:, keep_from - self._buf_start:]
            self._buf_start = keep_from
        return emit

    @torch.inference_mode()
    def _flush_step(self, total: int) -> np.ndarray:
        """The exact end window: frames [total - W_end, total), framed
        center=False over offline-identical reflect padding, emitting the
        remaining total - f0 frames."""
        hop, M = self.hop, self.M
        feat = self.feat
        f0 = self._f0
        W_end = min(total, self.Lc + self.C + self.Rc + 2 * self.EB)
        a = total - W_end
        half = feat.n_fft_ // 2
        L = self._n_samples

        # the offline front-end pre-emphasizes the whole clip, then
        # reflect-pads: pre-emphasize the buffer on the host (it keeps an
        # n_fft margin, so every needed x[i] has its y[i-1]), then
        # reflect-index with np.pad mode='reflect' semantics (period-2(L-1)
        # folding also covers pads longer than the clip). The gain commutes
        # with both and applies on the device.
        c = feat.pre_emphasis
        x = self._buf.copy()
        if c != 0.0:
            x[:, 1:] -= c * self._buf[:, :-1]
            # x[:, 0] is exact only at the true clip start; frames [a, total)
            # of a trimmed buffer never reach back to buf_start
            assert self._buf_start == 0 or a * hop - half > self._buf_start, \
                (a, hop, half, self._buf_start)
        idx = np.arange(a * hop - half, (total - 1) * hop - half + feat.n_fft_)
        if L > 1:
            per = 2 * (L - 1)
            m = np.mod(idx, per)
            idx = np.minimum(m, per - m)
        else:
            idx = np.zeros_like(idx)
        y_ext = x[:, idx - self._buf_start]

        with span("stream.gains"):
            self._update_gains(self._buf_start, self._n_samples)
        # fixed-size end vocode region [total - W_v, total)
        W_v = min(self.C + self.Rc + self.EB + M, total)
        v0 = total - W_v
        with span("stream.phases"):
            phase = self._phases(W_v)
            if self._phase_tail is not None and f0 - M >= v0:
                phase[:, f0 - M - v0 : f0 - v0] = self._phase_tail
        outs = []
        for rows, p in self._shards:
            with span("stream.forward", p.device):
                stft_full, mel_max, mel0 = self._forward(y_ext[rows], 0, W_end, f0 - a,
                                                         centered=False, pre_emphasized=True,
                                                         shard=(rows, p))
            with span("stream.vocode", p.device):
                wav_pre, _ = self._vocode(stft_full[:, v0 - a : total - a], phase[rows], M,
                                          tail=False, p=p)
            outs.append((wav_pre, mel0, mel_max, stft_full[:, f0 - a : total - a]))
        if self.collect_debug:
            sv = np.concatenate([o[3].cpu().numpy() for o in outs])
            self.debug_stft.append(sv if self._vec else sv[0])
        with span("stream.to_host", self.p.device):
            wav_pre, mel0, mel_max = _to_host_shards([o[:3] for o in outs])
        self._m0, self._mel_max = mel0, mel_max[:, 0]
        self._pending[:] = False

        with span("stream.emit"):
            emit = self._emit(wav_pre, (f0 - v0) * hop, (total - f0) * hop, None)
        self._f0 = total
        return emit

    def _emit(self, wav_pre, s_lo: int, n_emit: int, tail):
        """Host tail of a step, per stream: crossfade the leading margin with
        the previous chunk, cut the emit region (zero past the last
        synthesizable sample), carry the inverse-pre-emphasis IIR state, and
        apply the EMA output gain with a per-chunk linear ramp."""
        if self._tail is not None:
            ov = self._tail.shape[1]             # (M-1)*hop
            # raised-cosine fade from the previous chunk into this one (a
            # flush shorter than the margin fades over what exists)
            w = 0.5 * (1.0 + np.cos(np.pi * np.arange(ov) / ov)).astype(np.float32)
            n = min(ov, wav_pre.shape[1] - s_lo)
            wav_pre[:, s_lo:s_lo + n] = (
                w[None, :n] * self._tail[:, :n]
                + (1.0 - w[None, :n]) * wav_pre[:, s_lo:s_lo + n])
        self._tail = tail
        emit = np.zeros((self.B, n_emit), np.float32)
        seg = wav_pre[:, s_lo:s_lo + n_emit]
        emit[:, :seg.shape[1]] = seg

        # exact streaming inverse pre-emphasis: the IIR y[n] = x[n] + c*y[n-1]
        # continues across chunks by folding c*y_prev into the first sample
        c = self.feat.pre_emphasis
        if c != 0.0 and n_emit:
            from scipy import signal

            emit[:, 0] += c * self._inv_state
            emit = signal.lfilter([1.0], [1.0, -c], emit, axis=1).astype(np.float32)
            self._inv_state = emit[:, -1].copy()

        # EMA output gain with a per-chunk linear ramp; an out-pending stream
        # (its first chunk, or a reset slot's) seeds its EMA from this chunk
        if n_emit:
            m_abs = np.mean(np.abs(emit), axis=1)
            self._out_ema = np.where(
                self._out_pending, m_abs,
                self.out_gain_ema * self._out_ema
                + (1.0 - self.out_gain_ema) * m_abs)
            g_new = (self.p.mean_abs_amp_norm
                     / np.maximum(self._out_ema, _TINY)).astype(np.float32)
            g_prev = np.where(self._out_pending, g_new, self._out_gain_prev)
            self._out_pending[:] = False
            t = np.linspace(0.0, 1.0, n_emit, dtype=np.float32)
            emit *= g_prev[:, None] + (g_new - g_prev)[:, None] * t[None, :]
            self._out_gain_prev = g_new
        return emit

    # -------------------------------------------------------- device work ---

    def _forward(self, y: np.ndarray, v_lo: int, v_hi: int, c0_pos: int,
                 centered: bool = True, pre_emphasized: bool = False, *, shard=None):
        """Features, encoder and decoder for one window of streams [b, n]
        (``shard`` = (rows, pipeline): the streams ``rows``, on that
        pipeline's device; default all B on the cloner's):
        (stft_pred[:, v_lo:v_hi] on the device, mel max [b], mel0 [b, n_mels]).

        The front-end of ops/features.mfcc_input with its three whole-clip
        statistics replaced by the carried per-stream values: the input
        gain, the first emitted frame's mel spectrum at unit gain (raw c0 is
        re-derived from it at this window's gain and mel max) and the
        running mel max. A pending stream captures its mel0 from this
        window's frame ``c0_pos``. Every reduction is per stream (the JAX
        module vmaps the features over streams); the mel max is taken over
        every frame of the window, the centered STFT's extra last one
        included, before the MFCC is cut to ``n_frames``. The flush passes
        ``centered=False`` with audio already pre-emphasized and padded."""
        feat = self.feat
        rows, p = shard or self._shards[0]
        dev = p.device
        n_frames = (y.shape[1] // feat.hop_length if centered else
                    (y.shape[1] - feat.n_fft_) // feat.hop_length + 1)
        state = np.concatenate(
            [self._gain[rows, None], self._pending[rows, None], self._mel_max[rows, None],
             self._m0[rows]], axis=1).astype(np.float32)
        with span("stream.upload", dev):
            state = torch.from_numpy(state).to(dev)
        gain, pending, mel_max_in, mel0_in = (state[:, 0], state[:, 1] > 0, state[:, 2],
                                              state[:, 3:])
        g2 = (gain * gain)[:, None]
        with span("stream.upload", dev):
            x = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
        x = x * gain[:, None]
        if not pre_emphasized:
            x = preemphasis(x, feat.pre_emphasis)
        Fm = torch.abs(stft(x, n_fft=feat.n_fft_, hop_length=feat.hop_length,
                            win_length=feat.win_length, window=feat.window, center=centered))
        M_spec = (Fm * Fm) @ p._mel_w.T                   # [B, frames, n_mels]
        # amplitude_to_db with the global max carried across chunks:
        # amin=1e-5 on magnitude == 1e-10 on power
        raw = 10.0 * torch.log10(torch.clamp(M_spec * M_spec, min=1e-10))
        mel_max = torch.maximum(mel_max_in, raw.amax(dim=(1, 2)))
        floor = (mel_max - 80.0)[:, None]
        MFCC = torch.maximum(raw, floor[:, :, None]) @ p._dct.T
        mel0 = torch.where(pending[:, None], M_spec[:, c0_pos] / g2, mel0_in)
        raw0 = 10.0 * torch.log10(torch.clamp(torch.square(mel0 * g2), min=1e-10))
        c0 = torch.maximum(raw0, floor) @ p._dct[0]      # [B]
        if feat.mfcc_normaleze_first_mfcc:
            MFCC = torch.cat([MFCC[..., :1] - c0[:, None, None], MFCC[..., 1:]], dim=-1)
        if feat.mfcc_norm_factor != 1.0:
            MFCC = feat.mfcc_norm_factor * MFCC
        if feat.calc_mfcc_derivate:
            zeros = MFCC.new_zeros((MFCC.shape[0], 1, MFCC.shape[2]))
            d = 2.0 * torch.cat([zeros, MFCC[:, 2:] - MFCC[:, :-2], zeros], dim=1)
            MFCC = torch.cat([MFCC, d], dim=-1)
        if feat.clip_output:
            MFCC = torch.clamp(MFCC, -1.0, 1.0)
        _, stft_pred, _ = p.forward_windows(MFCC[:, :n_frames])
        return stft_pred[:, v_lo:v_hi], mel_max, mel0

    def _vocode(self, stft_v: torch.Tensor, phase0: np.ndarray, tail_lo: int,
                tail: bool = True, *, p: ClonePipeline | None = None):
        """Griffin-Lim over one vocode region of b streams [b, W_v, n_stft]
        on pipeline ``p``'s device (default the cloner's)
        from the phase ``phase0``: (pre-emphasized-domain waveforms [B, L],
        each stream's phase over frames [tail_lo - M, tail_lo) for the next
        chunk, or None with ``tail=False``). The denorm of from_power_to_wav
        without the inverse pre-emphasis and amplitude norm, which run on
        the host; the ``realse`` renorm means are per stream and per chunk."""
        feat, p = self.feat, p or self.p
        Fm = magnitudes(stft_v, feat.P_dB_norm_factor, p.realse,
                        lambda x, ndim: x.mean(dim=(1, 2), keepdim=True))
        with span("stream.upload", p.device):
            init_phase = torch.from_numpy(phase0).to(p.device)
        wav, S = griffin_lim(Fm, feat.win_length, feat.hop_length, num_iters=p.n_iter,
                             n_fft=feat.n_fft_, window=feat.window, init_phase=init_phase,
                             momentum=p.gl_momentum, dft=p.gl_dft, return_stft=True)
        return wav, (torch.angle(S[:, tail_lo - self.M : tail_lo]) if tail else None)


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Float32 device tensors with a leading stream axis -> host arrays
    [B, -1] each, in one copy."""
    B = tensors[0].shape[0]
    flat = [t.reshape(B, -1).to(torch.float32) for t in tensors]
    host = torch.cat(flat, dim=1).cpu().numpy()
    cuts = np.cumsum([f.shape[1] for f in flat])[:-1]
    return [part.copy() for part in np.split(host, cuts, axis=1)]


def _to_host_shards(shards: list[tuple]) -> list[np.ndarray]:
    """`_to_host` of each shard's tensors (one copy a shard), joined along
    the stream axis."""
    parts = [_to_host(*tensors) for tensors in shards]
    return [np.concatenate(p) for p in zip(*parts)] if len(parts) > 1 else parts[0]
