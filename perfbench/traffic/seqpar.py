"""Long-form conversion through ``ClonePipeline.convert_seq_parallel``: the
whole clip as one sequence, sharded over ``n_devices`` cards (1: one card,
no halo), no windows and no stitch, float32 waveform out (`benchlib.clips`
gives the loop and the mix's parameters; ``n_devices`` and
``warmup_frames`` are the call's).

Compared for each sampled clip: the MFCC and posteriors (captured at the
encoder's and the first decoder step's inputs), mel, spectrogram and
waveform (returned).
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import program, work
from benchlib.check import block_l2, gap_peak
from benchlib.clips import ClipPath, run_clips
from reference import dsp
from reference.pipeline import convert_sequence
from reference.precision import REFERENCE, control_for

BLOCK = 1600    # 0.1 s at 16 kHz: the blocks of the waveform comparison


def instrument(pipe, cap, spans) -> None:
    def keep(name):
        def pre(mod, args):
            if cap.armed:
                cap.got[name] = args[0].clone()
        return pre
    pipe.encoder.prenet.register_forward_pre_hook(keep("mfcc"))
    pipe.decoder.step1.prenet.register_forward_pre_hook(keep("ppg"))
    program.instrument_banks(pipe, spans)


class Control:
    """The reference, one precision below the configuration's."""

    def __init__(self, trees, config: dict, device, cap):
        self.trees, self.config, self.device, self.cap = trees, config, device, cap
        self.prec = control_for(config)

    def convert_seq_parallel(self, wav: np.ndarray, seed: int = 0, **_):
        out = convert_sequence(torch.tensor(wav, device=self.device), self.trees, self.config,
                               seed, self.prec)
        if self.cap.armed:
            self.cap.got.update(mfcc=out["mfcc"], ppg=out["ppg"])
        return out["wav"].cpu().numpy(), out["mel"][0].cpu().numpy(), out["stft"][0].cpu().numpy()


class Sequence(ClipPath):
    def program(self, cell, trees, ctx, cap):
        pipe = program.pipeline(cell.config, trees, ctx.device)
        instrument(pipe, cap, ctx.spans)
        return pipe

    def control(self, cell, trees, ctx, cap):
        return Control(trees, cell.config, ctx.device, cap)

    def call(self, system, wav, seed):
        tr = self.traffic
        return system.convert_seq_parallel(wav, n_devices=tr["n_devices"],
                                           warmup=tr["warmup_frames"], seed=seed)

    def work(self, cell) -> dict:
        cfg = cell.config
        frames = round(cell.traffic["clip_seconds"] * cfg["features"]["sample_rate"]) \
            // dsp.dims(cfg["features"])["hop"] + 1
        return {"scan_bound_s": work.scans_bound_s(cfg, frames, 1),
                "banks_bound_s": work.banks_bound_s(cfg, frames),
                "peak_s": work.step_seconds_at_peak(cfg, frames, frames, frames,
                                                    cfg["vocoder"]["n_iter"]),
                "banks_per_unit": 3}

    def compare(self, cell, trees, wav, seed, out, got) -> dict:
        ref = convert_sequence(wav, trees, cell.config, seed, REFERENCE)
        y, mel, spec = out
        return {"mfcc": gap_peak(got["mfcc"], ref["mfcc"]),
                "ppg": gap_peak(got["ppg"], ref["ppg"]),
                "mel": gap_peak(mel, ref["mel"][0]),
                "stft": gap_peak(spec, ref["stft"][0]),
                "wav_q90": float(np.quantile(block_l2(y, ref["wav"], BLOCK), 0.9))}


def run(cell, ctx):
    path = Sequence()
    path.traffic = cell.traffic
    res = run_clips(cell, ctx, path)
    res.end_to_end["longform_audio_s_per_s"] = res.end_to_end.pop("audio_s_per_s")
    return res
