"""One step of a streaming conversion of B streams in lockstep, from its
carried state, in the reference's arithmetic.

The stream's design (socom20/speech-cloner's offline path cut into chunks
with bounded latency, as the program's streaming API defines it): chunk
``C`` frames emitted per step from a window with ``Lc`` frames of real left
context, ``Rc`` of lookahead and ``EB`` edge frames a side; the features
use three carried per-stream statistics (the input gain, the first emitted
frame's mel spectrum at unit gain, the running mel maximum); Griffin-Lim
runs over [f0 - M, f1 + M) seeded with the previous step's phase over the
leading M frames, draws the rest from ``default_rng(seed + i)``; the
overlap is crossfaded in the pre-emphasized domain, the inverse
pre-emphasis IIR and an EMA output gain carry across steps.

A state is a dict of numpy arrays (`initial_state`); `push` appends audio
and runs every step that is due; `step` runs one. ``draws`` counts each
stream's phase numbers drawn so far, so a state taken from elsewhere
carries its generator's position.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from scipy import signal

from . import dsp, models
from .precision import Precision

MIN_MEAN = np.float32(1e-12)
TINY = np.float32(np.finfo(np.float32).tiny)


def geometry(traffic: dict) -> dict:
    g = traffic["geometry"]
    return {"C": g["chunk_frames"], "Lc": g["context_frames"], "Rc": g["lookahead_frames"],
            "M": g["margin_frames"], "EB": g["edge_frames"]}


def initial_state(B: int, n_mels: int, seed: int) -> dict:
    return {"buf": np.zeros((B, 0), np.float32), "buf_start": 0, "n_samples": 0, "f0": 0,
            "gain": np.ones(B, np.float32), "pending": np.ones(B, bool),
            "audio_from": np.zeros(B, np.int64), "g_sum": np.zeros(B, np.float64),
            "g_cnt": np.zeros(B, np.int64), "g_upto": np.zeros(B, np.int64),
            "m0": np.zeros((B, n_mels), np.float32), "mel_max": np.full(B, -np.inf, np.float32),
            "tail": None, "phase_tail": None, "inv_state": np.zeros(B, np.float32),
            "out_ema": np.zeros(B, np.float32), "out_gain_prev": np.zeros(B, np.float32),
            "out_pending": np.ones(B, bool), "seed": seed, "draws": 0}


def draws_before(f0: int, geo: dict, n_stft: int) -> int:
    """Phase numbers a stream has drawn before the step that emits from ``f0``."""
    return sum((f + geo["C"] + geo["M"] - max(0, f - geo["M"])) * n_stft
               for f in range(0, f0, geo["C"]))


class Stream:
    """The reference's streaming conversion for one configuration."""

    def __init__(self, trees, config: dict, traffic: dict, prec: Precision, device):
        self.trees, self.prec, self.device = trees, prec, device
        self.f = config["features"]
        self.d = dsp.dims(self.f)
        self.voc = dict(config["vocoder"], **traffic["vocoder"])
        self.geo = geometry(traffic)
        f, d = self.f, self.d
        self.mel_w = dsp.const(dsp.mel_weights(f["sample_rate"], d["n_fft"], f["n_mels"]), device)
        self.dct = dsp.const(dsp.dct_matrix(f["n_mfcc"], f["n_mels"]), device)

    @property
    def min_input_frames(self) -> int:
        g = self.geo
        return g["C"] + g["Rc"] + g["EB"]

    def push(self, st: dict, chunk: np.ndarray) -> tuple[np.ndarray, dict]:
        """Append [B, n] audio; run each step now due. (emitted [B, m], state)."""
        st = copy.deepcopy(st)
        st["buf"] = np.concatenate([st["buf"], np.asarray(chunk, np.float32)], axis=1)
        st["n_samples"] += chunk.shape[1]
        out = []
        while (st["f0"] + self.min_input_frames) * self.d["hop"] <= st["n_samples"]:
            emit, st = self.step(st)
            out.append(emit)
        B = st["buf"].shape[0]
        return (np.concatenate(out, axis=1) if out else np.zeros((B, 0), np.float32)), st

    # ------------------------------------------------------------- a step ---

    def step(self, st: dict) -> tuple[np.ndarray, dict]:
        st = copy.deepcopy(st)
        g, hop = self.geo, self.d["hop"]
        C, M = g["C"], g["M"]
        f0 = st["f0"]
        f1 = f0 + C
        a = max(0, f0 - g["Lc"] - g["EB"])
        e = f1 + g["Rc"] + g["EB"]
        v0, v1 = max(0, f0 - M), f1 + M
        y = st["buf"][:, a * hop - st["buf_start"]:e * hop - st["buf_start"]]
        self._gains(st, a * hop, e * hop)
        phase = self._phases(st, v1 - v0)
        if st["phase_tail"] is not None:
            phase[:, :M] = st["phase_tail"]
        with self.prec.active():
            spec, mel_max, mel0 = self._forward(st, y, v0 - a, v1 - a, f0 - a)
            wav_pre, phase_tail = self._vocode(spec, phase, f1 - v0)
        st["stft"] = spec.cpu().numpy()
        st["m0"], st["mel_max"] = mel0, mel_max
        st["pending"][:] = False
        st["phase_tail"] = phase_tail
        t_lo = (f1 - v0) * hop
        emit = self._emit(st, wav_pre, (f0 - v0) * hop, C * hop,
                          wav_pre[:, t_lo:t_lo + (M - 1) * hop].copy())
        st["f0"] = f1
        keep = max(0, (f1 - (g["Lc"] + C + g["Rc"] + 2 * g["EB"])) * hop - self.d["n_fft"])
        if keep > st["buf_start"]:
            st["buf"] = st["buf"][:, keep - st["buf_start"]:]
            st["buf_start"] = keep
        return emit, st

    def _gains(self, st: dict, win_lo: int, upto: int) -> None:
        """Running input gain: pending streams take the mean |y| of this
        window, the others the mean |y| of everything they have pushed."""
        buf, b0 = st["buf"], st["buf_start"]
        norm = self.f["mean_abs_amp_norm"]
        for i in range(buf.shape[0]):
            u = int(st["g_upto"][i])
            if upto > u:
                seg = np.abs(buf[i, u - b0:upto - b0])
                st["g_sum"][i] += seg.sum(dtype=np.float64)
                st["g_cnt"][i] += seg.size
                st["g_upto"][i] = upto
        for i in np.flatnonzero(st["pending"]):
            lo = max(win_lo, int(st["audio_from"][i]), b0)
            seg = np.abs(buf[i, lo - b0:upto - b0])
            st["gain"][i] = norm / max(float(seg.mean()) if seg.size else 0.0, MIN_MEAN)
            st["g_sum"][i] = float(seg.sum(dtype=np.float64))
            st["g_cnt"][i] = seg.size
            st["g_upto"][i] = upto
        upd = (~st["pending"]) & (st["g_cnt"] > 0)
        if upd.any():
            mean = np.maximum(st["g_sum"] / np.maximum(st["g_cnt"], 1), MIN_MEAN)
            g_new = (norm / mean).astype(np.float32)
            st["mel_max"] = st["mel_max"] + np.where(
                upd, 20.0 * np.log10(g_new / st["gain"]), 0.0).astype(np.float32)
            st["gain"] = np.where(upd, g_new, st["gain"])

    def _phases(self, st: dict, n_frames: int) -> np.ndarray:
        B, n_stft = st["buf"].shape[0], self.d["n_stft"]
        out = []
        for i in range(B):
            gen = np.random.default_rng(st["seed"] + i)
            gen.bit_generator.advance(st["draws"])
            out.append(gen.random((n_frames, n_stft)))
        st["draws"] += n_frames * n_stft
        return np.pi * np.stack(out).astype(np.float32)

    def _forward(self, st, y, v_lo, v_hi, c0_pos):
        f, d, dev = self.f, self.d, self.device
        gain = torch.tensor(st["gain"], device=dev)
        pending = torch.tensor(st["pending"], device=dev)
        mel_max_in = torch.tensor(st["mel_max"], device=dev)
        mel0_in = torch.tensor(st["m0"], device=dev)
        g2 = (gain * gain)[:, None]
        x = dsp.preemphasis(torch.tensor(np.ascontiguousarray(y), device=dev) * gain[:, None],
                            f["pre_emphasis"])
        mag = dsp.stft(x, d["n_fft"], d["hop"], d["win"]).abs()
        mspec = (mag * mag) @ self.mel_w.T
        raw = 10.0 * torch.log10(torch.clamp(mspec * mspec, min=1e-10))
        mel_max = torch.maximum(mel_max_in, raw.amax(dim=(1, 2)))
        floor = (mel_max - 80.0)[:, None]
        m = torch.maximum(raw, floor[:, :, None]) @ self.dct.T
        mel0 = torch.where(pending[:, None], mspec[:, c0_pos] / g2, mel0_in)
        raw0 = 10.0 * torch.log10(torch.clamp(torch.square(mel0 * g2), min=1e-10))
        c0 = torch.maximum(raw0, floor) @ self.dct[0]
        m = dsp.finish_mfcc(m, c0[:, None, None], f)
        n_frames = y.shape[1] // d["hop"]
        _, _, spec = models.forward(self.trees, m[:, :n_frames], self.prec)
        return spec[:, v_lo:v_hi], mel_max.cpu().numpy(), mel0.cpu().numpy()

    def _vocode(self, spec, phase0, tail_lo):
        d, voc = self.d, self.voc
        amp = dsp.magnitudes(spec, voc["realse"], self.f["P_dB_norm_factor"])
        wav, S = dsp.griffin_lim(amp, torch.tensor(phase0, device=self.device), voc["n_iter"],
                                 voc["gl_momentum"], d["n_fft"], d["hop"], d["win"], voc["gl_dft"])
        M = self.geo["M"]
        return wav.cpu().numpy(), torch.angle(S[:, tail_lo - M:tail_lo]).cpu().numpy()

    def _emit(self, st, wav_pre, s_lo, n_emit, tail):
        if st["tail"] is not None:
            ov = st["tail"].shape[1]
            w = 0.5 * (1.0 + np.cos(np.pi * np.arange(ov) / ov)).astype(np.float32)
            n = min(ov, wav_pre.shape[1] - s_lo)
            wav_pre[:, s_lo:s_lo + n] = (w[None, :n] * st["tail"][:, :n]
                                         + (1.0 - w[None, :n]) * wav_pre[:, s_lo:s_lo + n])
        st["tail"] = tail
        emit = np.zeros((wav_pre.shape[0], n_emit), np.float32)
        seg = wav_pre[:, s_lo:s_lo + n_emit]
        emit[:, :seg.shape[1]] = seg
        c = self.f["pre_emphasis"]
        if c:
            emit[:, 0] += c * st["inv_state"]
            emit = signal.lfilter([1.0], [1.0, -c], emit, axis=1).astype(np.float32)
            st["inv_state"] = emit[:, -1].copy()
        m_abs = np.mean(np.abs(emit), axis=1)
        st["out_ema"] = np.where(st["out_pending"], m_abs, self.voc["out_gain_ema"] * st["out_ema"]
                                 + (1.0 - self.voc["out_gain_ema"]) * m_abs)
        g_new = (self.voc["mean_abs_amp_norm"] / np.maximum(st["out_ema"], TINY)).astype(np.float32)
        g_prev = np.where(st["out_pending"], g_new, st["out_gain_prev"])
        st["out_pending"][:] = False
        t = np.linspace(0.0, 1.0, n_emit, dtype=np.float32)
        emit *= g_prev[:, None] + (g_new - g_prev)[:, None] * t[None, :]
        st["out_gain_prev"] = g_new
        return emit
