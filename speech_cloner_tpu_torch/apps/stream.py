"""Streaming conversion app: clone a recording incrementally, as if live.

Counterpart of ``speech_cloner_tpu/apps/stream.py``, with the same flags,
defaults and summary JSON, plus ``--device``. It feeds audio to
`pipeline/stream.StreamingCloner` in small blocks (optionally paced at
wall-clock realtime like a microphone) and reports the latency profile a
live deployment would see:

  python -m speech_cloner_tpu_torch.apps.stream \\
      --input some.wav --output ./streamed.wav \\
      --enc-ckpt ./enc_ckpt --dec-ckpt ./dec_ckpt \\
      [--chunk-frames 400 --lookahead-frames 200] [--realtime] \\
      [--n-iter 25 --gl-momentum 0.99] [--bf16] [--device cuda|cpu]

A checkpoint is a TF checkpoint prefix or a directory of
``<name>-<step>.npz`` (`make_pipeline`); without ``--dec-ckpt`` the decoder
is `init_trees`' seed-0 one. The vocoder defaults to Fast Griffin-Lim
(momentum 0.99, 25 rounds) because per-chunk latency is the point of
streaming; ``--n-iter 200 --gl-momentum 0`` restores the reference
algorithm. ``--gl-unroll`` is accepted and has no effect (a lax loop knob of
the JAX package).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.audio_io import load_audio, write_riff_wav
from ..models import decoder as dec_m
from ..models import encoder as enc_m
from ..pipeline.clone import make_pipeline
from ..pipeline.stream import StreamingCloner
from ..runtime.config import DEFAULT_DS_CFG, feature_config_from_cfg_d, load_cfg_d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default="./streamed.wav")
    ap.add_argument("--enc-ckpt", required=True)
    ap.add_argument("--dec-ckpt")
    ap.add_argument("--enc-cfg")
    ap.add_argument("--dec-cfg")
    ap.add_argument("--ds-cfg")
    ap.add_argument("--t-s", type=float, default=0.0)
    ap.add_argument("--t-e", type=float, default=60.0)
    ap.add_argument("--chunk-frames", type=int, default=400)
    ap.add_argument("--context-frames", type=int, default=400)
    ap.add_argument("--lookahead-frames", type=int, default=200)
    ap.add_argument("--margin-frames", type=int, default=16)
    ap.add_argument("--n-iter", type=int, default=25)
    ap.add_argument("--gl-momentum", type=float, default=0.99)
    ap.add_argument("--gl-unroll", type=int, default=6,
                    help="accepted for compatibility with the JAX CLI; no effect")
    ap.add_argument("--gl-dft", choices=("fft", "matmul"), default="fft",
                    help="Griffin-Lim transform: 'matmul' multiplies by cos/sin "
                         "bases, 'fft' uses torch.fft")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 model compute (float32 softmax and vocoder)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--gain-mode", choices=("running", "frozen"),
                    default="running",
                    help="input-gain estimate: 'running' converges to the "
                         "offline clip-wide gain as audio arrives; 'frozen' "
                         "keeps the first window's estimate")
    ap.add_argument("--input-gain", type=float,
                    help="pin the input gain (calibrated capture level); "
                         "overrides --gain-mode")
    ap.add_argument("--first-gain", choices=("window", "buffered"),
                    default="window",
                    help="first-gain estimate scope: 'buffered' uses "
                         "everything buffered at first-step time (for a file "
                         "fed faster than realtime, the offline clip-wide "
                         "gain); 'window' keeps output invariant to push "
                         "granularity")
    ap.add_argument("--block-ms", type=float, default=100.0,
                    help="input arrives in blocks of this duration")
    ap.add_argument("--realtime", action="store_true",
                    help="pace input blocks at wall-clock realtime and "
                         "measure end-to-end emission lag")
    ap.add_argument("--stats-json", help="also write the summary JSON here")
    args = ap.parse_args(argv)

    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    enc_cfg = (enc_m.config_from_cfg_d(load_cfg_d(args.enc_cfg))
               if args.enc_cfg else enc_m.EncoderConfig())
    dec_cfg = (dec_m.config_from_cfg_d(load_cfg_d(args.dec_cfg))
               if args.dec_cfg else dec_m.DecoderConfig())
    if not args.dec_ckpt:
        print(" WARNING: no --dec-ckpt; using randomly initialized decoder")
    pipe = make_pipeline(enc_cfg, dec_cfg, feat_cfg, enc_ckpt=args.enc_ckpt,
                         dec_ckpt=args.dec_ckpt, seed=0, device=args.device,
                         n_iter=args.n_iter, gl_momentum=args.gl_momentum,
                         gl_unroll=args.gl_unroll, gl_dft=args.gl_dft,
                         compute_dtype=torch.bfloat16 if args.bf16 else None)
    s = StreamingCloner(pipe, chunk_frames=args.chunk_frames,
                        context_frames=args.context_frames,
                        lookahead_frames=args.lookahead_frames,
                        margin_frames=args.margin_frames,
                        gain_mode=args.gain_mode,
                        first_gain=args.first_gain,
                        input_gain=args.input_gain)

    if not os.path.exists(args.input):
        raise SystemExit(f"error: input file not found: {args.input}")
    sr = feat_cfg.sample_rate
    wav = load_audio(args.input, sr)
    wav = wav[int(args.t_s * sr): int(args.t_e * sr)]
    dur = len(wav) / sr
    block = max(1, int(args.block_ms * sr / 1000.0))
    print(f" streaming {dur:.1f}s in {args.block_ms:.0f} ms blocks; "
          f"algorithmic latency {s.latency_seconds:.2f}s "
          f"({s.min_input_frames} frames)")

    out_parts = []
    chunk_wall_ms = []   # compute wall per emitting push/flush call
    emit_lag_s = []      # realtime mode: block arrival -> audio out
    t_start = time.perf_counter()
    emitted = 0
    for i in range(0, len(wav), block):
        if args.realtime:
            t_due = t_start + i / sr
            now = time.perf_counter()
            if now < t_due:
                time.sleep(t_due - now)
        t_in = time.perf_counter()
        out = s.push(wav[i:i + block])       # ends in the step's copy to the host
        t_out = time.perf_counter()
        if out.size:
            out_parts.append(out)
            emitted += out.size
            chunk_wall_ms.append(1e3 * (t_out - t_in))
            if args.realtime:
                emit_lag_s.append(t_out - t_start - i / sr)
            print(f"  + {out.size / sr:5.2f}s audio @ input {i / sr:6.2f}s "
                  f"(compute {1e3 * (t_out - t_in):7.1f} ms)")
    t_in = time.perf_counter()
    out_parts.append(s.flush())
    flush_ms = 1e3 * (time.perf_counter() - t_in)
    total_wall = time.perf_counter() - t_start

    wav_out = np.concatenate(out_parts)
    write_riff_wav(args.output, wav_out, sr, norm=True)
    print(f" wrote {args.output} ({wav_out.size / sr:.1f}s)")

    # warm = chunks past the first that are not inflated by a first use of
    # a shape (library handles, workspaces): anything over 3x the overall
    # median is left out, so the steady-state numbers describe steady state
    med = float(np.median(chunk_wall_ms)) if chunk_wall_ms else 0.0
    warm = [t for t in chunk_wall_ms[1:] if t <= 3 * med] or chunk_wall_ms[-1:]
    chunk_audio_s = args.chunk_frames * feat_cfg.hop_length / sr
    stats = {
        "audio_s": round(dur, 3),
        "chunks": len(chunk_wall_ms),
        "algorithmic_latency_s": round(s.latency_seconds, 3),
        "first_chunk_ms": round(chunk_wall_ms[0], 1) if chunk_wall_ms else None,
        "compile_chunks": max(0, len(chunk_wall_ms) - 1 - len(warm)),
        "warm_chunk_ms_p50": round(float(np.median(warm)), 1) if warm else None,
        "warm_chunk_ms_max": round(float(np.max(warm)), 1) if warm else None,
        "flush_ms": round(flush_ms, 1),
        # steady-state compute per second of audio (warm chunks only)
        "warm_compute_rtf": round(float(np.median(warm)) / 1e3 / chunk_audio_s, 5)
        if warm else None,
        "realtime": bool(args.realtime),
        "wall_s": round(total_wall, 2),
    }
    if args.realtime and emit_lag_s:
        stats["emit_lag_s_p50"] = round(float(np.median(emit_lag_s)), 3)
        stats["emit_lag_s_max"] = round(float(np.max(emit_lag_s)), 3)
    print(json.dumps(stats))
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return stats


if __name__ == "__main__":
    main()
