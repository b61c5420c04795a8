"""Offline conversion through ``ClonePipeline.convert_pcm16``: host waveform
in, int16 PCM out; the clip in 400-frame windows of two half-offset passes,
stitched, then Griffin-Lim (`benchlib.clips` gives the loop and the mix's
parameters).

Compared for each sampled clip: the windows' MFCC, posteriors, mel and
spectrogram, the stitched spectrogram (captured from the pipeline's own
calls) and the PCM.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import program, work
from benchlib.check import block_l2, gap_peak
from benchlib.clips import ClipPath, run_clips
from reference import dsp
from reference.pipeline import convert_windows
from reference.precision import REFERENCE, control_for

BLOCK = 1600    # 0.1 s at 16 kHz: the blocks of the PCM comparison


def instrument(pipe, cap, spans) -> None:
    """Capture the windows' features, posteriors, mel and spectrogram, and the
    stitched spectrogram; span "predict", "vocode" and the banks."""
    fw = pipe.forward_windows

    def forward_windows(x):
        out = fw(x)
        if cap.armed:
            cap.got.update(mfcc=x.clone(), mel=out[0].clone(), stft=out[1].clone(),
                           ppg=out[2].clone())
        return out

    voc = pipe.device_vocode_pcm16

    def device_vocode_pcm16(stft_pred, *args, **kwargs):
        if cap.armed:
            cap.got["stitched"] = stft_pred.clone()
        return voc(stft_pred, *args, **kwargs)

    object.__setattr__(pipe, "forward_windows", forward_windows)
    object.__setattr__(pipe, "device_vocode_pcm16", device_vocode_pcm16)
    spans.wrap(pipe, "device_predict", "predict")
    spans.wrap(pipe, "device_vocode_pcm16", "vocode")
    program.instrument_banks(pipe, spans)


class Control:
    """The reference, one precision below the configuration's."""

    def __init__(self, trees, config: dict, device, cap):
        self.trees, self.config, self.device, self.cap = trees, config, device, cap
        self.prec = control_for(config)

    def convert_pcm16(self, wav: np.ndarray, seed: int = 0) -> np.ndarray:
        out = convert_windows(torch.tensor(wav, device=self.device), self.trees, self.config,
                              seed, self.prec)
        if self.cap.armed:
            self.cap.got.update(out)
        return out["pcm"].to(torch.int16).cpu().numpy()


class Windows(ClipPath):
    median_of = ("pcm_q90_med", "pcm_stage_q90_med")

    def program(self, cell, trees, ctx, cap):
        pipe = program.pipeline(cell.config, trees, ctx.device)
        instrument(pipe, cap, ctx.spans)
        return pipe

    def control(self, cell, trees, ctx, cap):
        return Control(trees, cell.config, ctx.device, cap)

    def call(self, system, wav, seed):
        return system.convert_pcm16(wav, seed=seed)

    def work(self, cell) -> dict:
        cfg = cell.config
        T = cfg["encoder"]["input_shape"][0]
        samples = round(cell.traffic["clip_seconds"] * cfg["features"]["sample_rate"])
        K = max(-(-samples // (T * dsp.dims(cfg["features"])["hop"])), 1)
        rows = 2 * K - 1 if K > 1 else 1
        return {"scan_bound_s": work.scans_bound_s(cfg, T, rows),
                "banks_bound_s": work.banks_bound_s(cfg, rows * T),
                "peak_s": work.step_seconds_at_peak(cfg, rows * T, K * T + 1, K * T,
                                                    cfg["vocoder"]["n_iter"]),
                "banks_per_unit": 3}

    def compare(self, cell, trees, wav, seed, out, got) -> dict:
        cfg = cell.config
        ref = convert_windows(wav, trees, cfg, seed, REFERENCE)
        with REFERENCE.active():       # the vocoder alone, from the program's stitched output
            stage = dsp.pcm16_float(dsp.vocode(got["stitched"], dsp.phase_draw(
                got["stitched"].shape, seed, wav.device), cfg["features"], cfg["vocoder"]))
        return {"mfcc": gap_peak(got["mfcc"], ref["mfcc"]),
                "ppg": gap_peak(got["ppg"], ref["ppg"]),
                "mel": gap_peak(got["mel"], ref["mel"]),
                "stft": max(gap_peak(got["stft"], ref["stft"]),
                            gap_peak(got["stitched"], ref["stitched"])),
                "pcm_q90_med": float(np.quantile(block_l2(out, ref["pcm"], BLOCK), 0.9)),
                "pcm_stage_q90_med": float(np.quantile(block_l2(out, stage, BLOCK), 0.9))}


def run(cell, ctx):
    return run_clips(cell, ctx, Windows())
