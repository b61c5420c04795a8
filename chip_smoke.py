#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (the card's name and power limit also go
out as the raw line ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints):

1. env     card, torch/CUDA versions.
2. build   nvcc-build the GRU scan kernels from speech_cloner_tpu_torch/csrc
           for sm_90a; ptxas registers and spills of every compiled instance
           (the shared-memory float32 forward's; the register forward's
           inference and training (gates) instances in either type; the
           backward's float32 and bf16 ones; the staged bf16 forward's
           (training and inference) and backward's; the float32 register
           and every staged instance must be exactly the plan's tables;
           fails on a spill in an instance that holds its weights in
           registers), build seconds, and the launch
           plan of each kernel shape (cluster size, rows per CTA, clusters,
           threads and shared memory per CTA; for the register forward and
           the backward the weight columns a lane holds in registers, 0 for
           shared memory; whether the staged instance runs, its stage depth
           and its ring's bytes).
2a. banks_kernel  nvcc-build csrc/conv_banks.cu (ptxas registers and spills:
           fails on a spill), then conv_banks (the float32 bank kernel)
           against conv_banks_plain (bank by bank, cuDNN) on the card at the
           main paths' shapes: the encoder (C = 40, K = 6) and both decoder
           steps (C = 128, 256; K = 32), c = 128, at B x T = 59 x 400
           (offline), 16 x 1008 (a stream step), 1 x 12001 (a long-form
           clip, on rows padded as the halo path pads them): max-abs error
           (fails above BANK_TOL), CUDA-event times of the kernel, the
           plain version and the packed width-K conv the port no longer
           runs here (library_ms, the yardstick), the bound (nonzero taps
           at the float32 peak) and its share; each path's sum.
2b. gl_round_kernel  nvcc-build csrc/griffin_lim.cu (ptxas registers and
           spills of each instance, reported: the 640-thread instances hold
           96 registers a thread and spill ~120 bytes), then gl_rounds (one
           Griffin-Lim round a launch) against gl_round_plain and against
           today's rounds through istft / stft on cuBLAS (`rounds`, the
           yardstick) at B x T = 1 x 12001 (a 60 s clip), 1 x 401, 1 x 1400,
           1 x 2401 and 4 x 1400, after 1 and 8 rounds: max-abs of S'
           relative to the magnitudes' peak (fails above GL_TOL), launches
           (one a round, exact), CUDA-event ms a round of the kernel, the
           plain version and the cuBLAS path (library_ms), the bound (4 B T
           400 402 FLOP at the float32 peak) and its share, the plan; then
           each clip of the 4 x 1400 batch against its single conversion
           after 8 rounds, bit for bit (fails otherwise).
3. kernel  gru_scan (CUDA kernel, weights packed ahead as the GRU module
           packs them) against gru_scan_plain on the card, T=400, H in
           {40, 128, 256}, B in {9, 59, 236} (236: a batch of 4 60 s clips),
           float32 and bfloat16 operands: max-abs error (fails above
           KERNEL_TOL), CUDA-event times of both, microseconds per step, the
           SMs the launch ran on, the plan, the roofline bound and its share;
           each bf16 row also the float32 row's time at its shape.
4. path    make_pipeline(EncoderConfig(), DecoderConfig(), seed=0) on cuda,
           n_iter 200, realse 1.2, gl_dft "matmul"; a synthetic 60 s 16 kHz
           clip; warm convert and convert_pcm16 with the launch counter reset
           before and read after each (6 scan launches and 199 Griffin-Lim
           round launches per call, or fail); wall time, RTF, predict/vocode
           split, peak memory.
   profile torch.profiler over one more convert_pcm16: device time by
           kernel name (the top names, and the GRU scan's), device busy time
           and idle share of the wall time.
5. parity  the same pipeline built on the CPU: forward_windows on 3 full-width
           windows (mel, stft, ppg) and from_power_to_wav on a 2-window
           spectrogram (32 Griffin-Lim rounds, same initial phase), GPU
           against CPU, with the tolerances in PARITY_TOL.
6. batch   convert_batch_pcm16 of 4 clips (two of 60 s, two of 10 s padded to
           the 60 s bucket): 6 gru_scan launches per call (one model batch,
           B = 236 rows per scan), each clip's PCM against convert_pcm16's of
           it (same bucket, same initial phase) within BATCH_PCM_TOL; wall
           time, audio seconds per wall second, peak memory.
7. bf16    the main path with compute_dtype=torch.bfloat16: convert_pcm16 of
           the 60 s clip (6 launches, wall, RTF, peak memory), a profile of
           one call, and forward_windows on the 3 parity windows, GPU-bf16
           against CPU-float32, within BF16_GAP_FACTOR times the JAX
           package's own bf16 gap on the same windows (BF16_JAX_GAP).
8. serve   apps.serve.main in process over .npz checkpoints that
           Checkpointer.save writes from the seed-0 weights: 8 stdin requests
           (4 of 60 s, 4 of 10 s, interleaved), --batch-max 4
           --batch-backlog 0 --warm 10,60; every record without error, its
           file written, at least one batch of 2 or more, and each file's
           PCM against the API's conversion of its chunk (convert_pcm16 or
           convert_batch_pcm16 of the same clips in the same order) within
           BATCH_PCM_TOL.
8a. seq_parallel  ClonePipeline.convert_seq_parallel of the 60 s clip over 1
           and 4 shards (4 distinct cards where there are 4, else cuda:0 four
           times), warmup 400: wall of a warm call, RTF, peak memory, scan
           launches (3 x (2n + 2), exact), mel and stft against the card's
           unsharded forward of the padded sequence (median < SP_MEDIAN_TOL);
           a 6 s clip at 32 Griffin-Lim rounds against the CPU port at the
           same shard count within PARITY_TOL.
9. stream  apps.stream.main in process over .npz checkpoints of the seed-0
           weights, the app's defaults (chunk 400, context 400, lookahead
           200, margin 16, 25 Griffin-Lim rounds at momentum 0.99), a 60 s
           clip in 100 ms blocks, then 10 s paced at realtime: the app's
           stats (first, warm and flush ms, warm compute RTF, emission lag),
           6 float32 scan launches a step (or fail), scans at T = 1008
           (the steady window), peak memory, (n // hop + 1) * hop finite
           samples out.
10. stream_parity  StreamingCloner on the card against the CPU pipeline, an
           8 s clip (first window, ramp-up, one steady step, flush) and a
           4.5 s one (first window, a flush over 901 frames): the emitted
           spectrogram and waveform within PARITY_TOL.
11. serve_stream  apps.serve_stream.main over stdin, --slots 4: two 20 s and
           two 8 s sessions opened at once, fed 1 s pcm16 records, closed;
           no error record, each closed with its length, each session's PCM
           against StreamingCloner(batch=4) fed the same audio within
           BATCH_PCM_TOL.
12. stream_capacity  ms per steady stream step at B = 1, 4, 16 streams
           (float32) and B = 4 (bf16), the median of the warm steady steps;
           realtime streams per card (B x 2 s of audio a step over the
           step's seconds), peak memory; a profile of one B = 4 step.
12a. stream_mesh  StreamingCloner(batch=4, mesh=4 shards) against batch=4
           unsharded on the card, a 12 s clip a chunk a push: waveform and
           spectrogram within PARITY_TOL, ms of a steady step, launches
           (6 a shard a step, exact).
13. stream_kernel  gru_scan against gru_scan_plain at the steady window's
           shapes (T = 1008, B = 1, 4, 16, H in {40, 128, 256}), float32
           and bfloat16 operands (KERNEL_TOL), timed, with the bound and
           the plan (register columns, stage depth).
13a. sp_kernel  the same at the sequence-parallel shapes of phase 8a (T =
           12401, 3401 and 400, B = 1), timed, with the bound.
14. train_kernel  the training kernels at a train step's shapes (T=400,
           B=32, H in {40, 128, 256}), float32 and bf16: the training
           forward (ys and gates) of one direction and of both
           (gru_scan_train, gru_scan_fused_train), the backward of each fed
           by it (gru_scan_bwd, gru_scan_fused_bwd), and the inference
           forward of both directions (gru_scan_fused: the decoder step's
           frozen encoder), against their plain versions (TRAIN_TOL of the
           peak; bf16 outputs also one bf16 ulp, the gates float32 either
           way); CUDA-event times of the kernel (its weights packed ahead,
           as the GRU module keeps them) and of the plain version,
           microseconds per step, the bound and its share, the plan with
           the instance's register columns (and, bf16 training, its stage
           depth: the staged instances stage at every width here).
15. train  apps.train_encoder.main, then apps.train_decoder.main on the
           encoder's checkpoint, at full width (EncoderConfig(),
           DecoderConfig()), batch 32, 8 steps, --bn-recal 0 and no cadence
           save (so every launch is a train step's), --loader h5py (the
           per-step .npz reader; phase 19 times the others), on a synthetic
           TIMIT/ARCTIC-layout corpus of 2.5 s utterances (96 TIMIT, 70
           ARCTIC: 64+ training windows each); without and with
           --fused-gru, in float32 and with --bf16. Launch counts per run by
           kernel and operand dtype, checked against the counts of a step
           (encoder: 2 training forwards + 2 backwards, fused 1+1; decoder:
           2 inference forwards of the frozen encoder + 4 + 4, fused
           1+2+2; all bf16 with --bf16); ms per step
           (synchronized, median of steps 2-8), windows per second, peak
           memory; a profile of one float32 and one bf16 decoder step.
16. train_parity  one encoder and one decoder train step at full width
           (B=4, dropout 0) on the card and on the CPU (float32 and float64)
           from the same weights and batch: loss within PARITY_TRAIN_TOL;
           each gradient leaf of the card within PARITY_TRAIN_TOL plus
           PARITY_F32_FACTOR times the CPU float32's own relative L2
           distance of the CPU float64 gradient; TF32 off. The same steps
           on the card in bf16: each leaf's relative L2 distance from the
           CPU float64 gradient within BF16_GAP_FACTOR times the JAX
           package's own bf16 gradient gap of that leaf at the same weights
           and batch (tests/bf16_grad_gap_full_width.json, written by
           tests/bf16_gap_full_width.py --grads), plus the float32
           allowance.
17. speaker  apps.train_speaker_id.main on the synthetic TIMIT corpus at
           the full window geometry (400 x 201), batch 32, SPEAKER_STEPS
           steps, --vocoded-augment 0.5 (the default) and --bn-recal 2, in
           float32 and with --bf16: ms per train step and per vocoded
           augmentation (synchronized, medians of steps 2..), windows per
           second, peak memory; a SpeakerIdConfig() forward and gradient on
           the card against the CPU (float32 and float64; the train_parity
           rule); then apps.convert --verify-ckpt --target-spk on the
           float32 run's checkpoint, whose _verify.json must hold every
           report key.
18. workflow  apps.make_synth_corpus (WORKFLOW_CORPUS), then
           apps.train_full --in-process --demo at full width, batch 32,
           8 / 8 / 6 encoder, decoder and speaker-ID steps, --n-iter 200:
           per stage its wall, peak memory, the loader each trainer chose,
           ms per step (median of steps 2..) and the launches inside its
           train steps against STEP_LAUNCHES x steps (exact), none in the
           speaker-ID stage, CONVERT_LAUNCHES per ClonePipeline.convert in
           the demo (exact); every checkpoint, demo_report.json's three
           tests and verdict (identity_changed), each pred.wav finite and
           of convert's length for its input.
19. loaders  both trainers, batch 32, 8 float32 steps on the workflow's
           corpus with --loader h5py, native and device (launches exact):
           ms per step, windows per second, the device store's bytes; the
           first batch's windows of the three loaders equal on the card, bit
           for bit; then --ds-kind target (the slt wavs in one directory)
           under device and h5py.
20. evaluate  apps.evaluate encoder, decoder and speaker on the workflow's
           checkpoints: each final line printed, its numbers finite; wall
           of each. Then a workflow_wall line (phases 18-20).
20a. parallel_train  apps.train_encoder on the workflow's corpus, batch 32,
           8 steps, single-process and as a data=2 x model=2 gloo world of 4
           processes on the card (--rank-devices): the first logged loss
           within PARITY_TRAIN_TOL, launches exact; in the same world one
           full-width encoder and decoder train step on train_parity's
           batch held by train_parity's rule to phase 16's CPU float32 and
           float64 steps, and three at batch 32 (the first loss against the
           single-process step on the card; ms per step).
20b. lstm  make_pipeline with every CBHG's LSTM branch (use_lstm, full
           width, seed 0): a warm convert_pcm16 of the 60 s clip (wall, RTF
           beside the path phase's, no scan launched, the predict split,
           peak memory, a profile: device launches and idle share); mel,
           stft and ppg on the parity windows against the CPU within
           PARITY_TOL; one float32 encoder and decoder train step at batch
           32 against the CPU's float32 and float64 steps by phase 16's
           rule, forget biases included; ms per step.
20c. extras  nn.attention's AttentionDecoder (B 4, T' 100, memory 400 x
           256, H 256) and Embed, card against CPU (PARITY_TOL; the lookup
           exact), ms; runtime.profiler.trace and a span around one
           convert_pcm16: the trace file names the scan kernel (6 launches)
           and the region; device_memory_stats on cuda:0.
20d. real_demo  a 42 s "narration" of the workflow corpus's 'bdl' voice
           through apps.make_narrator_corpus into a target corpus and the
           TIMIT tree; apps.train_decoder --ds-kind target (8 steps, the
           workflow's encoder) and apps.train_speaker_id (6 steps) on it,
           launches exact; apps.real_demo --spk-ckpt over the 2 held-out
           chunks and 4 TIMIT test utterances: the report's keys and
           verdict, finite losses, 6 scans a convert (exact); stage walls.
21. path_shapes  every (dtype, T, B, H) each kernel (inference forward,
           training forward, backward; one direction or both) was launched
           at by phases 4-20d (cuda_kernels.launch_shapes) that phases 3,
           13, 13a and 14 did not cover, held against its plain version
           (untimed).
22. the script's wall seconds, the {"kernels": [...]} line (each scan
           form by dtype, the bank kernel: its launches by path, its error
           and its, the plain version's, cuDNN's packed conv's and the
           bound's ms from phase 2a; and gl_round: its launches by path, its
           error and ms a round from phase 2b), then the {"ok": true, ...}
           line.

Any failed phase raises and the script exits non-zero. With no CUDA device,
or without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import shutil
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import numpy as np
import torch

T_STEPS = 400
KERNEL_SHAPES = [(H, B) for H in (40, 128, 256) for B in (9, 59, 236)]
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Kernel against plain version, max-abs: float32 sums in another order over
# 400 steps (1e-4); with bf16 operands both carry h in float32 and round ys
# to bf16, so a sum-order difference can move an output by one bf16 ulp
# (2^-8 at |y| < 1) on top.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-8 + 1e-4}
# A batched clip against its single conversion on the same card: other GEMM
# shapes, so float32 sums in other orders, amplified over 200 Griffin-Lim
# rounds; the parity phase's waveform limit (1e-3 of the peak) in PCM steps.
# Also the limit of a served file against the API's conversion of its chunk.
BATCH_PCM_TOL = 33
# max|jax_bf16 - jax_f32| of forward_windows on the bf16 phase's 3 windows,
# at full width with the seed-0 weights: the JAX package's own bf16 gap,
# measured on the CPU by tests/bf16_gap_full_width.py. GPU-bf16 may differ
# from CPU-float32 by at most BF16_GAP_FACTOR times it (the rule the CPU
# tests hold port-bf16 to against JAX-float32).
BF16_JAX_GAP = {"mel": 1.7902115359902382e-04, "stft": 3.2440933864563704e-05,
                "ppg": 6.8303197622299194e-06}
BF16_GAP_FACTOR = 2.0
# GPU against CPU of the same float32 port. Sums run in other orders on the
# two devices (cuBLAS/cuDNN against MKL/oneDNN, the kernel's per-column dot
# against the CPU matmul); over 3 CBHG stacks at full width that leaves
# differences of order 1e-5 relative. The bounds are relative to the CPU
# output's largest magnitude.
PARITY_TOL = {"mel": 1e-4, "stft": 1e-4, "ppg": 1e-4, "wav": 1e-3}
# Training kernels against their plain versions, relative to the output's
# peak: float32 sums in another order over 400 steps (the forward's 1e-4).
# With bf16 operands each bf16 output is rounded once from float32 on both
# sides, so that difference can move it by one bf16 ulp, 2^-7 of its
# magnitude, on top (the gates stay float32: TRAIN_TOL alone).
TRAIN_TOL = 1e-4
BF16_ULP = 2.0**-7
TRAIN_SHAPES = (40, 128, 256)
TRAIN_B = 32
# One train step on the card against the CPU. The loss: within
# PARITY_TRAIN_TOL relative. The gradients: float32 gradients at full width
# are far from exact on their own (train-mode BN sums that cancel, max-pool
# near-ties that float32 rounding decides: the port's CPU float32 decoder
# gradient is up to 1.4% of a leaf's peak, 3.8e-3 in relative L2, from its
# float64 one), so no float32 implementation meets 1e-4 of the peak against
# another. Each leaf of the card's gradient is held to the CPU's float64 one
# in relative L2 within PARITY_TRAIN_TOL plus PARITY_F32_FACTOR times the
# CPU float32 gradient's own distance: as accurate as the CPU's float32.
PARITY_TRAIN_TOL = 1e-4
PARITY_F32_FACTOR = 3.0
TRAIN_STEPS = 8
# bf16 train steps on the card against the CPU float64 gradient: each leaf
# within BF16_GAP_FACTOR times the JAX package's own bf16 gradient gap of
# that leaf (relative L2 of JAX-bf16 against JAX-float32, measured on the
# CPU at the train_parity weights and batch by tests/bf16_gap_full_width.py
# --grads), plus the float32 allowance of the float32 rows
BF16_GRAD_GAP_FILE = Path(__file__).resolve().parent / "tests" / "bf16_grad_gap_full_width.json"
SPEAKER_STEPS = 6
# launches of one train step by kernel (the decoder's frozen encoder runs
# the inference forward)
STEP_LAUNCHES = {
    ("encoder", False): {"gru_scan_train": 2, "gru_scan_bwd": 2},
    ("encoder", True): {"gru_scan_fused_train": 1, "gru_scan_fused_bwd": 1},
    ("decoder", False): {"gru_scan": 2, "gru_scan_train": 4, "gru_scan_bwd": 4},
    ("decoder", True): {"gru_scan_fused": 1, "gru_scan_fused_train": 2, "gru_scan_fused_bwd": 2},
}
# H100 SXM data sheet, dense: float32 outside the tensor cores, and bf16
# products with float32 sums on the tensor cores (the least time of the
# bf16 scans' work, whatever units the kernel uses)
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (data sheet)
DEV = "cuda"
REPEATS = 3  # timed runs of each main-path call; medians reported
# the streaming apps' defaults (apps/stream.py; apps/serve_stream.py adds
# realse 1.2): a steady window is context + chunk + lookahead + 2 edges
STREAM_GEOMETRY = dict(chunk_frames=400, context_frames=400, lookahead_frames=200,
                       margin_frames=16)
STREAM_SETTINGS = dict(n_iter=25, gl_momentum=0.99, gl_dft="fft")
STREAM_STEADY_T = 400 + 400 + 200 + 2 * 4
STREAM_FIRST_T = 400 + 200 + 4           # the first window: frame 0 to C + Rc + EB
STREAM_CHUNK_S = 400 * 80 / 16000
STREAM_B = (1, 4, 16)                    # streams in lockstep (capacity phase)
STREAM_LAUNCHES = 6                      # scans a stream step launches (3 CBHG x 2)
BANK_LAUNCHES = 3                        # bank-kernel launches of a float32 model pass (3 CBHG)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def peak_flops(elem_bytes: int) -> float:
    """The card's peak rate for the scans' products: float32 operands at the
    float32 rate, bf16 ones at the bf16 tensor-core rate."""
    return BF16_FLOPS if elem_bytes == 2 else F32_FLOPS


def gru_bound(T: int, B: int, H: int, elem_bytes: int = 4) -> dict:
    """Least time for one scan: every input/output byte once (gx, cx, ys and
    the weights, ``elem_bytes`` each), 6*T*B*H^2 FLOP at `peak_flops`."""
    flops = 6 * T * B * H * H
    nbytes = elem_bytes * (T * B * 4 * H) + elem_bytes * (3 * H * H)
    ops_ms, bytes_ms = flops / peak_flops(elem_bytes) * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def train_bound(T: int, B: int, H: int, dirs: int, backward: bool, elem_bytes: int = 4,
                gates: bool = True) -> dict:
    """Least time of a training scan launch: 6*T*B*H^2 FLOP per direction at
    `peak_flops` (two products per step either way); bytes per direction:
    forward gx, cx in and ys out (4 T B H operands), with ``gates`` (the
    training forward) r, u, c out (3 T B H float32); backward dys, ys in
    and dgx, dcx out (5 T B H operands), the gates in (3 T B H float32);
    plus the 3 H^2 weights; operands of ``elem_bytes`` bytes."""
    flops = dirs * 6 * T * B * H * H
    operands = (5 if backward else 4) * T * B * H + 3 * H * H
    nbytes = dirs * (elem_bytes * operands + (4 * 3 * T * B * H if backward or gates else 0))
    ops_ms = flops / peak_flops(elem_bytes) * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def errs(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max-abs error, max-abs error over the reference's peak)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def phase_env() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    return smi


def plan_row(plan) -> dict:
    """A launch plan's fields; the weight columns a lane of its instance
    holds in registers (0: shared memory); the staged instances' stage
    depth, ring bytes and whether the staged instance runs."""
    return {"C": plan.cluster, "rows_per_cta": plan.rows, "clusters": plan.clusters,
            "dirs": plan.dirs, "ctas": plan.ctas, "threads": plan.threads,
            "smem_bytes": plan.smem_bytes, "reg_columns": plan.reg_columns,
            "staged": plan.stage_steps > 0, "stage_steps": plan.stage_steps,
            "stage_bytes": plan.stage_bytes}


def ptxas_instances(log: str) -> list[dict]:
    """Every kernel instance in nvcc's -Xptxas -v output: name, template
    arguments (<R, NK, kGates> of the register forward and of the staged
    bf16 forward (gru_scan_reg_staged_kernel), <R, NK> of the backward and
    of the staged bf16 backward (gru_scan_bwd_staged_kernel), NK the
    register columns or 0; the shared-memory float32 forward's <R, kFull>),
    the operand type of the register forward and the backward, registers,
    spill bytes."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # the mangled name also holds the file's anonymous namespace,
            # "..._gru_scan_cu_<hash>": match the kernel's own name
            name = re.search(r"\d(gru_scan(?:_reg|_bwd)?(?:_staged)?_kernel)I(.*?)EEv",
                             m.group(1))
            args = [int(v) for v in re.findall(r"L[ib](\d+)E", name.group(2))] if name else []
            out.append({"kernel": name.group(1) if name else m.group(1), "args": args})
            if name and name.group(1).endswith("_staged_kernel"):
                out[-1]["dtype"] = "bfloat16"
            elif name and name.group(1) != "gru_scan_kernel":
                out[-1]["dtype"] = "bfloat16" if "bfloat16" in name.group(2) else "float32"
            if name and name.group(1) in ("gru_scan_reg_kernel", "gru_scan_reg_staged_kernel"):
                out[-1]["gates"] = len(args) == 3 and args[2] == 1
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    for d in out:
        d["weights_in_registers"] = (d["kernel"] != "gru_scan_kernel"
                                     and len(d["args"]) >= 2 and d["args"][1] > 0)
    return out


def phase_build(ck) -> None:
    t0 = time.perf_counter()
    lib = ck.load_library()
    limits = ck.device_limits(torch.cuda.current_device())
    instances = ptxas_instances(lib.ptxas_log)
    plans = {}
    for dt in KERNEL_DTYPES:
        for H, B in KERNEL_SHAPES + [(H, B) for B in STREAM_B for H in TRAIN_SHAPES]:
            p = ck.gru_scan_plan(H, B, *limits, elem_bytes=dt.itemsize)
            plans[f"{dt},H={H},B={B}"] = plan_row(p)
    for dt in KERNEL_DTYPES:
        for H in TRAIN_SHAPES:
            p = ck.gru_scan_plan(H, TRAIN_B, *limits, elem_bytes=dt.itemsize, dirs=2)
            plans[f"{str(dt).removeprefix('torch.')} inference forward,dirs=2,H={H},"
                  f"B={TRAIN_B}"] = plan_row(p)
    for d in (1, 2):
        for H in TRAIN_SHAPES:
            p = ck.gru_scan_plan(H, TRAIN_B, *limits, dirs=d, backward=True)
            plans[f"backward,dirs={d},H={H},B={TRAIN_B}"] = plan_row(p)
            for dt in KERNEL_DTYPES:
                p = ck.gru_scan_plan(H, TRAIN_B, *limits, elem_bytes=dt.itemsize, dirs=d,
                                     gates=True)
                plans[f"{str(dt).removeprefix('torch.')} training forward,dirs={d},H={H},"
                      f"B={TRAIN_B}"] = plan_row(p)
            p = ck.gru_scan_plan(H, TRAIN_B, *limits, elem_bytes=2, dirs=d, backward=True)
            plans[f"bf16 backward,dirs={d},H={H},B={TRAIN_B}"] = plan_row(p)
    spilled = [d for d in instances if d["weights_in_registers"] and d.get("spill_bytes", 1)]

    def compiled(kernel, dtype, gates=None):   # the (R, NK) instances of one kind
        return sorted(tuple(d["args"][:2]) for d in instances if d["kernel"] == kernel
                      and d.get("dtype") == dtype and d.get("gates", gates) == gates)

    def table(bwd, gates, staged):             # the (R, NK) pairs the plan's table names
        return sorted((R, nk) for nk in ck.REG_COLUMNS for R in ck.ROWS_PER_CTA
                      if ck._reg_instance(bwd, R, nk, gates, staged)[0])
    # the float32 register forward's instances (training, and the inference
    # forward of both directions) and the staged ones (bf16: the training
    # forward, the inference forward of both directions, the backward):
    # exactly the plan's tables, every one compiled
    got = {"float32 training": compiled("gru_scan_reg_kernel", "float32", True),
           "float32 inference": compiled("gru_scan_reg_kernel", "float32", False),
           "staged bfloat16 training": compiled("gru_scan_reg_staged_kernel", "bfloat16", True),
           "staged bfloat16 inference": compiled("gru_scan_reg_staged_kernel", "bfloat16",
                                                 False),
           "staged bfloat16 backward": compiled("gru_scan_bwd_staged_kernel", "bfloat16")}
    want = {"float32 training": table(False, True, False),
            "float32 inference": table(False, False, False),
            "staged bfloat16 training": table(False, True, True),
            "staged bfloat16 inference": table(False, False, True),
            "staged bfloat16 backward": table(True, False, True)}
    emit({"phase": "build", "library": lib.path, "nvcc_seconds": round(lib.build_seconds, 3),
          "load_seconds": round(time.perf_counter() - t0, 3), "instances": instances,
          "n_instances": len(instances), "register_instances": got,
          "n_sms": limits[0], "smem_optin_bytes": limits[1], "plans": plans})
    if not instances or spilled or got != want:
        raise AssertionError(f"build: no ptxas report, a register instance spills ({spilled}), "
                             f"or the compiled instances {got} are not the tables {want}")


# the bank convolutions of the main paths: (B, T) of a model pass, and the
# three CBHG stacks' (C, K); c = 128 channels a bank
BANK_PATHS = {"offline": (59, 400), "stream": (16, 1008), "longform": (1, 12001)}
BANK_STACKS = ((40, 6), (128, 32), (256, 32))
BANK_C = 128
# kernel against plain version, max-abs: float32 sums of up to K*C = 8192
# products (outputs of rms ~1) in another order than cuDNN's
BANK_TOL = 1e-4


def bank_bound(B: int, T: int, C: int, K: int) -> dict:
    """Least time of one bank launch: 2*B*T*C*c FLOP per nonzero tap
    (K(K+1)/2 of them) at the float32 peak; x and the output once and the
    nonzero taps' weights once, float32."""
    taps = K * (K + 1) // 2
    flops = 2 * B * T * C * BANK_C * taps
    nbytes = 4 * (B * T * C + B * T * K * BANK_C + taps * C * BANK_C)
    ops_ms, bytes_ms = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_banks_kernel(ck) -> dict:
    from speech_cloner_tpu_torch.nn.modules import conv1d, pack_bank_kernels
    from speech_cloner_tpu_torch.runtime.config import float32_products

    float32_products(DEV)           # cuDNN's packed conv, the yardstick, without TF32
    t0 = time.perf_counter()
    lib = ck.load_library("conv_banks")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", lib.ptxas_log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", lib.ptxas_log)]
    smem_optin = ck.device_limits(torch.cuda.current_device())[1]
    out = {"phase": "banks_kernel", "library": lib.path,
           "nvcc_seconds": round(lib.build_seconds, 3),
           "load_seconds": round(time.perf_counter() - t0, 3), "registers": regs,
           "spill_bytes": spills, "tolerance": BANK_TOL, "rows": []}
    if not regs or any(spills):
        emit(out)
        raise AssertionError(f"banks_kernel: no ptxas report or a spill: {lib.ptxas_log}")
    gen = torch.Generator(DEV).manual_seed(0)
    for path, (B, T) in BANK_PATHS.items():
        for C, K in BANK_STACKS:
            with torch.inference_mode():
                x = torch.randn((B, T, C), generator=gen, device=DEV)
                kernels = [torch.randn((k, C, BANK_C), generator=gen, device=DEV)
                           / math.sqrt(k * C) for k in range(1, K + 1)]
                packed = pack_bank_kernels(kernels, K).permute(2, 1, 0).contiguous()
                pad = None
                if path == "longform":          # the halo path: rows padded ahead, pad 0
                    x = torch.nn.functional.pad(x, (0, 0, (K - 1) // 2, K // 2))
                    pad = (0, 0)
                got = ck.conv_banks(x, kernels, pad)
                ref = ck.conv_banks_plain(x, kernels, pad)
                err = (got - ref).abs().max().item()
                lib_err = (conv1d(x, packed, pad) - ref).abs().max().item()
                if not math.isfinite(err) or err > BANK_TOL:
                    emit(out)
                    raise AssertionError(f"banks_kernel {path} C={C} K={K}: max-abs {err} > "
                                         f"{BANK_TOL}")
                ms = cuda_ms(lambda: ck.conv_banks(x, kernels, pad), n=10)
                plain_ms = cuda_ms(lambda: ck.conv_banks_plain(x, kernels, pad), n=5)
                library_ms = cuda_ms(lambda: conv1d(x, packed, pad), n=5)
            b = bank_bound(B, T, C, K)
            row = {"path": path, "B": B, "T": T, "C": C, "K": K, "c": BANK_C,
                   "plan": dataclasses.asdict(ck.conv_banks_plan(B, T, C, K, smem_optin)),
                   "max_abs_err": err, "library_max_abs_err": lib_err, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b["bound_ms"],
                   "bound_by": b["bound_by"], "share_of_bound": b["bound_ms"] / ms,
                   "library_share_of_bound": b["bound_ms"] / library_ms,
                   "tflops": b["flops"] / ms / 1e9}
            emit({"phase": "banks_kernel", **row})
            out["rows"].append(row)
    out["paths"] = {path: {key: sum(r[key] for r in out["rows"] if r["path"] == path)
                           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
                    for path in BANK_PATHS}
    for v in out["paths"].values():
        v["share_of_bound"] = v["bound_ms"] / v["ms"]
        v["library_share_of_bound"] = v["bound_ms"] / v["library_ms"]
    emit({k: v for k, v in out.items() if k != "rows"})
    return out


# Griffin-Lim rounds (csrc/griffin_lim.cu): (T, B) of the checked shapes,
# the 60 s clip's first; rounds a comparison runs; a 60 s convert's rounds
GL_SHAPES = ((12001, 1), (401, 1), (1400, 1), (2401, 1), (1400, 4))
GL_ROUNDS = (1, 8)
GL_CONVERT_ROUNDS = 199
# kernel against plain version and cuBLAS rounds, max-abs of S' relative to
# the magnitudes' peak: float32 sums cut into other tiles move most bins by
# ~1e-6 of the peak, but a bin whose projection is nearly 0 has an
# ill-conditioned phase and moves by up to its magnitude; over ~2.4 M bins
# the largest gap read 3.8e-4 after one round and 4.3e-3 after 8 (plain
# against cuBLAS)
GL_TOL = {1: 2e-3, 8: 2e-2}


def gl_bound_ms(B: int, T: int) -> float:
    """Least time of one round: two dense DFT products of B*T x 400 x 402
    multiply-adds at the float32 peak (operations bound it: the bases and S
    are a few MB)."""
    return 4 * B * T * 400 * 402 / F32_FLOPS * 1e3


def phase_gl_round_kernel(ck) -> dict:
    from speech_cloner_tpu_torch.ops.griffin_lim import rounds
    from speech_cloner_tpu_torch.ops.stft import _window, istft, stft, window_sumsquare
    from speech_cloner_tpu_torch.runtime.config import float32_products

    float32_products(DEV)
    t0 = time.perf_counter()
    lib = ck.load_library("griffin_lim")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", lib.ptxas_log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", lib.ptxas_log)]
    out = {"phase": "gl_round_kernel", "library": lib.path,
           "nvcc_seconds": round(lib.build_seconds, 3),
           "load_seconds": round(time.perf_counter() - t0, 3), "registers": regs,
           "spill_bytes": spills, "tolerance": GL_TOL, "rows": []}
    if not regs:
        emit(out)
        raise AssertionError(f"gl_round_kernel: no ptxas report: {lib.ptxas_log}")
    n_sms, optin = ck.device_limits(torch.cuda.current_device())
    win = _window("hann", 400, 400, torch.device(DEV))
    project = lambda x: stft(istft(x, 80, 400, 400, dft="matmul"), 400, 80, 400,  # noqa: E731
                             dft="matmul")
    for T, B in GL_SHAPES:
        g = torch.Generator(DEV).manual_seed(T + B)
        amp = 10 * torch.rand((B, T, 201), generator=g, device=DEV) ** 4
        S0 = torch.polar(amp, math.pi * torch.rand((B, T, 201), generator=g, device=DEV))
        env = window_sumsquare("hann", T, 80, 400, 400, DEV)
        plan = ck.gl_round_plan(B, T, 400, 80, optin, n_sms)
        row = {"T": T, "B": B, "plan": dataclasses.asdict(plan)}
        peak = amp.max().item()
        for n in GL_ROUNDS:
            before = ck.launch_counts["gl_round", torch.float32]
            got = ck.gl_rounds(S0.clone(), amp, n, win, env, plan)
            torch.cuda.synchronize()
            launches = ck.launch_counts["gl_round", torch.float32] - before
            plain = S0
            for _ in range(n):
                plain = ck.gl_round_plain(plain, amp, win, env, plan)
            gemm = rounds(S0, amp, project, n + 1, 0.0)
            errs = {"plain": (got - plain).abs().max().item() / peak,
                    "library": (got - gemm).abs().max().item() / peak,
                    "plain_vs_library": (plain - gemm).abs().max().item() / peak}
            row[f"max_err_rel_peak_{n}"] = errs
            if launches != n or not all(math.isfinite(e) and e <= GL_TOL[n] for e in
                                        (errs["plain"], errs["library"])):
                emit(out)
                raise AssertionError(f"gl_round_kernel T={T} B={B} rounds={n}: launches "
                                     f"{launches}, errors {errs} against {GL_TOL[n]}")
        row["ms"] = cuda_ms(lambda: ck.gl_rounds(S0.clone(), amp, 10, win, env, plan), n=5) / 10
        row["plain_ms"] = cuda_ms(lambda: ck.gl_round_plain(S0, amp, win, env, plan), n=2)
        row["library_ms"] = cuda_ms(lambda: rounds(S0, amp, project, 11, 0.0), n=3) / 10
        row["bound_ms"] = gl_bound_ms(B, T)
        row["bound_by"] = "operations"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["library_share_of_bound"] = row["bound_ms"] / row["library_ms"]
        emit({"phase": "gl_round_kernel", **row})
        out["rows"].append(row)
    # each clip of a batch against its single conversion, bit for bit
    T, B = GL_SHAPES[-1]
    g = torch.Generator(DEV).manual_seed(7)
    amp = 10 * torch.rand((B, T, 201), generator=g, device=DEV) ** 4
    S0 = torch.polar(amp, math.pi * torch.rand((B, T, 201), generator=g, device=DEV))
    env = window_sumsquare("hann", T, 80, 400, 400, DEV)
    batch = ck.gl_rounds(S0.clone(), amp, 8, win, env, ck.gl_round_plan(B, T, 400, 80, optin,
                                                                         n_sms))
    one = ck.gl_round_plan(1, T, 400, 80, optin, n_sms)
    out["batch_bits_equal"] = [bool(torch.equal(batch[b], ck.gl_rounds(
        S0[b:b + 1].clone(), amp[b:b + 1].contiguous(), 8, win, env, one)[0])) for b in range(B)]
    emit({k: v for k, v in out.items() if k != "rows"})
    if not all(out["batch_bits_equal"]):
        raise AssertionError(f"gl_round_kernel: a batched clip differs from its single "
                             f"conversion: {out['batch_bits_equal']}")
    return out


def check_scan(ck, gen, dt: torch.dtype, T: int, B: int, H: int):
    """gru_scan against gru_scan_plain on seeded inputs of one shape; fails
    above KERNEL_TOL. Returns the inputs, the packed weights and the
    element-wise difference."""
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEV)).to(dt)
    gx, cx = rnd(T, B, 2 * H), rnd(T, B, H)
    lim = math.sqrt(6.0 / (3 * H))
    Wg, Wc = rnd(H, 2 * H, scale=lim), rnd(H, H, scale=lim)
    packed = ck.pack_gru_weights(Wg, Wc)
    got = ck.gru_scan(gx, cx, Wg, Wc, packed)
    ref = ck.gru_scan_plain(gx, cx, Wg, Wc)
    torch.cuda.synchronize()
    if got.dtype != dt:
        raise AssertionError(f"gru_scan {dt} returned {got.dtype}")
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    if not math.isfinite(err) or err > KERNEL_TOL[dt]:
        raise AssertionError(f"gru_scan {dt} T={T} H={H} B={B}: max-abs {err} > "
                             f"{KERNEL_TOL[dt]}")
    return (gx, cx, Wg, Wc), packed, diff


def phase_kernel(ck) -> list[dict]:
    gen = torch.Generator(DEV).manual_seed(0)
    limits = ck.device_limits(torch.cuda.current_device())
    rows, f32_ms = [], {}
    for dt in KERNEL_DTYPES:      # float32 first: each bf16 row shows its time
        for H, B in KERNEL_SHAPES:
            (gx, cx, Wg, Wc), packed, diff = check_scan(ck, gen, dt, T_STEPS, B, H)
            err = diff.max().item()
            plan = ck.gru_scan_plan(H, B, *limits, elem_bytes=dt.itemsize)
            sm_ids = torch.full((plan.ctas,), -1, dtype=torch.int32, device=DEV)
            ck.gru_scan_launch(gx, cx, packed, plan, sm_ids=sm_ids)
            ms = cuda_ms(lambda: ck.gru_scan(gx, cx, Wg, Wc, packed), n=20)
            plain_ms = cuda_ms(lambda: ck.gru_scan_plain(gx, cx, Wg, Wc), n=3, warmup=1)
            b = gru_bound(T_STEPS, B, H, dt.itemsize)
            row = {"dtype": str(dt).removeprefix("torch."), "H": H, "B": B, "T": T_STEPS,
                   "max_abs_err": err, "tolerance": KERNEL_TOL[dt],
                   "equal_share": (diff == 0).float().mean().item(), "ms": ms,
                   "us_per_step": ms * 1000 / T_STEPS, "sms": len(set(sm_ids.tolist())),
                   "plan": plan_row(plan), "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                   "bound_by": b["bound_by"], "share_of_bound": b["bound_ms"] / ms,
                   "flops": b["flops"], "bytes": b["bytes"]}
            if dt == torch.float32:
                f32_ms[H, B] = ms
            else:
                row.update(f32_ms=f32_ms[H, B], ratio_to_f32=ms / f32_ms[H, B])
            emit({"phase": "kernel", **row})
            rows.append(row)
    return rows


def phase_path_shapes(ck, rows: list[dict], train_rows: list[dict]) -> list[dict]:
    """Every shape the main paths launched each kernel at (ck.launch_shapes:
    warm-ups, batches, the server's chunks and warm buckets, train steps)
    that the kernel phases did not hold against the plain version: checked
    here, untimed."""
    gen = torch.Generator(DEV).manual_seed(1)
    done = {("gru_scan", r["dtype"], r["T"], r["B"], r["H"]) for r in rows}
    done |= {(r["kernel"], r["dtype"], r["T"], r["B"], r["H"]) for r in train_rows}
    launched = sorted((name, str(dt).removeprefix("torch."), T, B, H, dt)
                      for name, shapes in ck.launch_shapes.items() for dt, T, B, H in shapes)
    extra = []
    for name, dtn, T, B, H, dt in launched:
        if (name, dtn, T, B, H) in done:
            continue
        if name == "gru_scan":
            err = check_scan(ck, gen, dt, T, B, H)[2].max().item()
            tol = KERNEL_TOL[dt]
        else:
            err = check_train_kernel(ck, gen, name, T, B, H, dt)[1]
            tol = train_tol(dt)
        extra.append({"kernel": name, "dtype": dtn, "H": H, "B": B, "T": T,
                      "max_abs_err": err, "tolerance": tol})
    emit({"phase": "path_shapes", "launched": [s[:5] for s in launched],
          "checked_here": extra})
    return extra


def train_operands(gen, D: int, T: int, B: int, H: int, dtype=torch.float32):
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEV)).to(dtype)
    lim = math.sqrt(6.0 / (3 * H))
    return rnd(D, T, B, 2 * H), rnd(D, T, B, H), rnd(D, H, 2 * H, scale=lim), rnd(D, H, H, scale=lim)


def train_tol(dt: torch.dtype) -> float | str:
    return TRAIN_TOL if dt == torch.float32 else f"one bf16 ulp + {TRAIN_TOL} of the peak"


def train_errs(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, bool]:
    """(max-abs error, max-abs error over the reference's peak, every element
    within TRAIN_TOL of the peak, plus one bf16 ulp of the reference where
    the output is rounded to bf16)."""
    ulp = BF16_ULP if got.dtype == torch.bfloat16 else 0.0
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    peak = max(ref.abs().max().item(), 1e-30)
    ok = bool((err <= ulp * ref.abs() + TRAIN_TOL * peak).all())
    return err.max().item(), err.max().item() / peak, ok


def check_train_kernel(ck, gen, name: str, T: int, B: int, H: int, dtype=torch.float32):
    """One training kernel against its plain version on seeded operands of
    ``dtype``: the inference forward of both directions ("gru_scan_fused"),
    the training forward of one direction or both ("gru_scan_train",
    "gru_scan_fused_train"), or the backward fed by that training forward
    ("gru_scan_bwd", "gru_scan_fused_bwd"; the forward's ys and gates are
    checked too). Returns (error relative to the peak, max-abs error, a
    callable launching the kernel, a callable running the plain version);
    fails unless every output is within `train_errs`'s limit."""
    D = 2 if name.startswith("gru_scan_fused") else 1
    gx, cx, Wg, Wc = train_operands(gen, D, T, B, H, dtype)
    # the weights packed ahead, as the GRU module caches them a weight version
    packed = torch.stack([ck.pack_gru_weights(a, b) for a, b in zip(Wg, Wc)])
    packed_bwd = torch.stack([ck.pack_gru_weights_bwd(a, b) for a, b in zip(Wg, Wc)])
    if name == "gru_scan_fused":
        kernel = lambda: ck.gru_scan_fused(gx, cx, Wg, Wc, packed)  # noqa: E731
        plain = lambda: ck.gru_scan_fused_plain(gx, cx, Wg, Wc)  # noqa: E731
        pairs = [(kernel(), plain())]
    else:
        ys, gates = ck.gru_scan_train_forward(gx, cx, Wg, Wc, packed)
        pairs = list(zip((ys, gates), ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)))
        if name.endswith("_bwd"):
            dys = torch.randn(ys.shape, generator=gen, device=DEV).to(dtype)
            kernel = lambda: ck.gru_scan_train_backward(dys, ys, gates, Wg, Wc,  # noqa: E731
                                                        packed_bwd)
            plain = lambda: ck.gru_scan_backward_plain(dys, ys, gates, Wg, Wc)  # noqa: E731
            pairs += list(zip(kernel(), plain()))
        else:
            kernel = lambda: ck.gru_scan_train_forward(gx, cx, Wg, Wc, packed)  # noqa: E731
            plain = lambda: ck.gru_scan_fused_plain(gx, cx, Wg, Wc, with_gates=True)  # noqa: E731
    torch.cuda.synchronize()
    checks = [train_errs(a, b) for a, b in pairs]
    abs_err, err = max(c[0] for c in checks), max(c[1] for c in checks)
    if not (all(c[2] for c in checks) and math.isfinite(err)):
        raise AssertionError(f"{name} {dtype} T={T} B={B} H={H}: (max-abs, of the peak, ok) "
                             f"{checks} against {train_tol(dtype)}")
    return err, abs_err, kernel, plain


# the timed training-kernel rows, float32 and bf16 ("gru_scan_fused" is the
# inference form, as the decoder step's frozen encoder runs it)
TRAIN_KERNELS = ("gru_scan_train", "gru_scan_bwd", "gru_scan_fused", "gru_scan_fused_train",
                 "gru_scan_fused_bwd")


def phase_train_kernel(ck) -> list[dict]:
    """The training kernels at a train step's shapes against their plain
    versions, timed."""
    gen = torch.Generator(DEV).manual_seed(2)
    rows = []
    for dt in KERNEL_DTYPES:
        for name in TRAIN_KERNELS:
            for H in TRAIN_SHAPES:
                rows.append(train_kernel_row(ck, gen, name, dt, H))
    return rows


def train_kernel_row(ck, gen, name: str, dt: torch.dtype, H: int) -> dict:
    err, abs_err, kernel, plain = check_train_kernel(ck, gen, name, T_STEPS, TRAIN_B, H, dt)
    ms = cuda_ms(kernel, n=20)
    plain_ms = cuda_ms(plain, n=1, warmup=1)
    dirs = 2 if name.startswith("gru_scan_fused") else 1
    bwd = name.endswith("_bwd")
    train_fwd = name.endswith("_train")      # the training forward, gates out
    b = train_bound(T_STEPS, TRAIN_B, H, dirs, bwd, dt.itemsize, gates=train_fwd)
    plan = ck.gru_scan_plan(H, TRAIN_B, *ck.device_limits(torch.cuda.current_device()),
                            elem_bytes=dt.itemsize, dirs=dirs, backward=bwd, gates=train_fwd)
    row = {"kernel": name, "dtype": str(dt).removeprefix("torch."), "H": H, "B": TRAIN_B,
           "T": T_STEPS, "dirs": dirs, "training_forward": train_fwd,
           "max_abs_err": abs_err, "max_err_rel_peak": err,
           "tolerance": train_tol(dt),
           "ms": ms, "us_per_step": ms * 1000 / T_STEPS,
           "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "share_of_bound": b["bound_ms"] / ms, "flops": b["flops"],
           "bytes": b["bytes"], "plan": plan_row(plan)}
    emit({"phase": "train_kernel", **row})
    return row


def synthetic_clip(seconds: float, sr: int = 16000, seed: int = 0) -> np.ndarray:
    """Voiced-like test signal from default_rng(seed): harmonics on a
    wandering pitch, amplitude bursts, and noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.3 * t) + 10.0 * rng.standard_normal(n).cumsum() / sr
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 12))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t + rng.uniform(0, 2 * np.pi)) ** 2
    return (0.2 * env * voiced + 0.01 * rng.standard_normal(n)).astype(np.float32)


def phase_path(ck, pipe, wav: np.ndarray) -> dict:
    sync = torch.cuda.synchronize
    spw = pipe.enc_cfg.n_timesteps * pipe.feat_cfg.hop_length
    frames = max(-(-len(wav) // spw), 1) * pipe.enc_cfg.n_timesteps   # whole windows
    want_len = (frames - 1) * pipe.feat_cfg.hop_length
    pipe.convert_pcm16(wav[:16000])      # warm-up: cuBLAS/cuDNN handles, caches
    pipe.convert(wav)
    sync()
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "path", "seconds_of_audio": len(wav) / 16000,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    for name, fn in (("convert", pipe.convert), ("convert_pcm16", pipe.convert_pcm16)):
        walls = []
        for _ in range(REPEATS):
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            res = fn(wav)
            sync()
            walls.append(time.perf_counter() - t0)
            launches = ck.launch_counts["gru_scan", torch.float32]
            banks = ck.launch_counts["conv_banks", torch.float32]
            gl = ck.launch_counts["gl_round", torch.float32]
            y = res[0] if isinstance(res, tuple) else res
            if launches != 6 or banks != BANK_LAUNCHES or gl != GL_CONVERT_ROUNDS:
                raise AssertionError(f"{name}: gru_scan launched {launches} times, want 6; "
                                     f"conv_banks {banks}, want {BANK_LAUNCHES}; gl_round "
                                     f"{gl}, want {GL_CONVERT_ROUNDS}")
            if y.shape != (want_len,) or not np.isfinite(y.astype(np.float32)).all():
                raise AssertionError(f"{name}: output shape {y.shape} (want {want_len},) "
                                     f"or non-finite values")
        wall = float(np.median(walls))
        out[name] = {"wall_s": wall, "walls_s": walls, "rtf": wall / (len(wav) / 16000),
                     "gru_scan_launches": launches, "conv_banks_launches": banks,
                     "gl_round_launches": gl,
                     "out_len": int(y.shape[0]),
                     "dtype": str(y.dtype)}
    splits = []
    with torch.inference_mode():
        wav_d = pipe.pad_wav(wav)
        for _ in range(REPEATS):
            sync()
            t0 = time.perf_counter()
            _, stft_pred, _ = pipe.device_predict(wav_d)
            sync()
            t1 = time.perf_counter()
            pipe.device_vocode(stft_pred, torch.Generator(DEV).manual_seed(0))
            sync()
            splits.append((t1 - t0, time.perf_counter() - t1))
    out["predict_s"] = float(np.median([p for p, _ in splits]))
    out["vocode_s"] = float(np.median([v for _, v in splits]))
    out["predict_vocode_s"] = splits
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


def profile_call(fn, label: str, call: str, top: int = 12) -> tuple[dict, object]:
    """torch.profiler over one call of ``fn``: device time by kernel name,
    summed device busy time against the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side entries only (kernels, memcpy/memset): an aten op's own
        # "self device time" repeats the time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append({"name": e.key[:80], "calls": e.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    out = {"phase": label, "call": call, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
           "n_kernel_names": len(rows), "device_launches": sum(r["calls"] for r in rows),
           "top": rows[:top],
           "gru_scan": [r for r in rows if "gru_scan" in r["name"]]}
    return out, res


def phase_profile(pipe, wav: np.ndarray, top: int = 12, label: str = "profile") -> dict:
    """torch.profiler over one warm convert_pcm16."""
    out = profile_call(lambda: pipe.convert_pcm16(wav), label, "convert_pcm16", top)[0]
    emit(out)
    return out


def max_rel(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    err = (a - b).abs().max().item()
    return err, err / max(b.abs().max().item(), 1e-30)


@torch.inference_mode()
def window_parity(pipe, cpu_pipe, wav: np.ndarray, res: dict):
    """forward_windows on the first 3 windows of ``wav`` on the card and on
    the CPU: each output's max-abs error and its share of the CPU peak into
    ``res``; returns the CPU outputs."""
    from speech_cloner_tpu_torch.ops import mfcc_input

    T = pipe.enc_cfg.n_timesteps
    clip = wav[: 3 * T * pipe.feat_cfg.hop_length]
    mfcc_cpu = mfcc_input(torch.tensor(clip), cpu_pipe.feat_cfg)[0][: 3 * T]
    mfcc_gpu = mfcc_input(torch.tensor(clip, device=DEV), pipe.feat_cfg)[0][: 3 * T]
    res["mfcc_max_abs"] = max_rel(mfcc_gpu, mfcc_cpu)[0]
    x = mfcc_cpu.reshape(3, T, -1)
    got = pipe.forward_windows(x.to(DEV))
    ref = cpu_pipe.forward_windows(x)
    for name, g, r in zip(("mel", "stft", "ppg"), got, ref):
        res[f"{name}_max_abs"], res[f"{name}_rel"] = max_rel(g, r)
    return ref


def phase_parity(pipe, cpu_pipe, wav: np.ndarray) -> dict:
    from speech_cloner_tpu_torch.ops import from_power_to_wav

    T = pipe.enc_cfg.n_timesteps
    res = {"phase": "parity", "tolerance_rel": PARITY_TOL}
    ref = window_parity(pipe, cpu_pipe, wav, res)
    with torch.inference_mode():
        spec = ref[1][:2].reshape(2 * T, -1)     # a 2-window linear spectrogram
        phase0 = torch.tensor(np.pi * np.random.default_rng(1).random(spec.shape,
                                                                      dtype=np.float32))
        kw = dict(P_dB_norm_factor=0.01, pre_emphasis=0.97, hop_length=80, win_length=400,
                  mean_abs_amp_norm=0.045, n_iter=32, realse=1.2, dft="matmul")
        w_gpu = from_power_to_wav(spec.to(DEV), init_phase=phase0.to(DEV), **kw)
        w_cpu = from_power_to_wav(spec, init_phase=phase0, **kw)
        res["wav_max_abs"], res["wav_rel"] = max_rel(w_gpu, w_cpu)
    emit(res)
    for name, tol in PARITY_TOL.items():
        if not res[f"{name}_rel"] <= tol:
            raise AssertionError(f"parity {name}: relative max-abs {res[f'{name}_rel']} > {tol}")
    return res


def timed_calls(ck, fn, dtype: torch.dtype, want_launches: int = 6) -> tuple[list[float], object]:
    """REPEATS warm calls of fn(), each with the launch counters reset before
    and read after (fails unless the forward of ``dtype`` operands ran
    want_launches times); their wall times."""
    walls, res = [], None
    for _ in range(REPEATS):
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if ck.launch_counts["gru_scan", dtype] != want_launches:
            raise AssertionError(f"gru_scan {dtype} launched {ck.launch_counts['gru_scan', dtype]}"
                                 f" times, want {want_launches}")
    return walls, res


def phase_batch(ck, pipe) -> dict:
    """convert_batch_pcm16 of 2 x 60 s + 2 x 10 s clips: one bucket, one model
    batch (B = 4 * 59 rows per scan), each clip equal to its single conversion."""
    sr = pipe.feat_cfg.sample_rate
    wavs = [synthetic_clip(60.0, seed=1), 0.3 * synthetic_clip(10.0, seed=2),
            synthetic_clip(60.0, seed=3), 2.0 * synthetic_clip(10.0, seed=4)]
    seconds = sum(len(w) for w in wavs) / sr
    length = pipe.padded_length(max(len(w) for w in wavs))
    frames = length // pipe.feat_cfg.hop_length
    pipe.convert_batch_pcm16(wavs)                       # warm-up at these shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, pcms = timed_calls(ck, lambda: pipe.convert_batch_pcm16(wavs), torch.float32)
    launches, peak = ck.launch_counts["gru_scan", torch.float32], torch.cuda.max_memory_allocated()
    phase = math.pi * torch.rand((len(wavs), frames, pipe.feat_cfg.n_stft),
                                 generator=torch.Generator(DEV).manual_seed(5), device=DEV)
    batched = pipe.convert_batch_pcm16(wavs, init_phase=phase)
    lsb = []
    with torch.inference_mode():
        for i, w in enumerate(wavs):
            _, stft, _ = pipe.device_predict(pipe.pad_wav(w, length))
            one = pipe.device_vocode_pcm16(stft, init_phase=phase[i]).cpu().numpy()
            if one.shape != batched[i].shape:
                raise AssertionError(f"batch clip {i}: shape {batched[i].shape}, single "
                                     f"{one.shape}")
            lsb.append(int(np.abs(one.astype(np.int32) - batched[i].astype(np.int32)).max()))
    wall = float(np.median(walls))
    out = {"phase": "batch", "clips_s": [len(w) / sr for w in wavs], "padded_s": length / sr,
           "gru_scan_launches": launches, "wall_s": wall, "walls_s": walls,
           "audio_s_per_wall_s": seconds / wall, "max_memory_allocated_bytes": peak,
           "pcm_max_lsb_vs_single": lsb, "pcm_tolerance_lsb": BATCH_PCM_TOL,
           "scan_plans": {H: plan_row(ck.gru_scan_plan(
               H, 236, *ck.device_limits(torch.cuda.current_device()))) for H in (40, 128, 256)}}
    emit(out)
    if max(lsb) > BATCH_PCM_TOL or not all(np.abs(p).max() == 32767 for p in pcms):
        raise AssertionError(f"batch: PCM against single conversions {lsb} LSB > "
                             f"{BATCH_PCM_TOL}, or a clip not peak-normalized")
    return out


def phase_bf16(ck, pipe, cpu_pipe, wav: np.ndarray) -> dict:
    """The main path with bf16 models: timing, launches, a profile, and
    GPU-bf16 forward_windows against CPU-float32."""
    from speech_cloner_tpu_torch.ops import mfcc_input

    bf = dataclasses.replace(pipe, compute_dtype=torch.bfloat16)
    bf.convert_pcm16(wav)                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, pcm = timed_calls(ck, lambda: bf.convert_pcm16(wav), torch.bfloat16)
    launches, peak = ck.launch_counts["gru_scan", torch.bfloat16], torch.cuda.max_memory_allocated()
    if not np.abs(pcm).max() == 32767:
        raise AssertionError("bf16 convert_pcm16: output not peak-normalized")
    wall = float(np.median(walls))
    out = {"phase": "bf16", "seconds_of_audio": len(wav) / 16000, "wall_s": wall,
           "walls_s": walls, "rtf": wall / (len(wav) / 16000),
           "gru_scan_launches": launches, "max_memory_allocated_bytes": peak}
    T = pipe.enc_cfg.n_timesteps
    with torch.inference_mode():
        clip = torch.tensor(wav[: 3 * T * pipe.feat_cfg.hop_length])
        x = mfcc_input(clip, cpu_pipe.feat_cfg)[0][: 3 * T].reshape(3, T, -1)
        ref = cpu_pipe.forward_windows(x)
        got = bf.forward_windows(x.to(DEV))
    for name, g, r in zip(("mel", "stft", "ppg"), got, ref):
        out[f"{name}_max_abs"], out[f"{name}_rel"] = max_rel(g, r)
        out[f"{name}_jax_bf16_gap"] = BF16_JAX_GAP[name]
        out[f"{name}_limit"] = BF16_GAP_FACTOR * BF16_JAX_GAP[name]
        out[f"{name}_ratio_to_jax_gap"] = out[f"{name}_max_abs"] / BF16_JAX_GAP[name]
    emit(out)
    phase_profile(bf, wav, label="bf16_profile")
    for name in ("mel", "stft", "ppg"):
        if not out[f"{name}_max_abs"] <= out[f"{name}_limit"]:
            raise AssertionError(f"bf16 parity {name}: max-abs {out[f'{name}_max_abs']} > "
                                 f"{out[f'{name}_limit']}")
    return out


def phase_serve(ck, pipe) -> dict:
    """apps.serve.main in process: .npz checkpoints of the seed-0 weights, 8
    interleaved stdin requests of 60 s and 10 s, batching on. Every served
    file is held against the API's conversion of its chunk by ``pipe`` (the
    same seed-0 weights and settings)."""
    from speech_cloner_tpu_torch.apps import serve
    from speech_cloner_tpu_torch.data.audio_io import write_riff_wav
    from speech_cloner_tpu_torch.models import DecoderConfig, EncoderConfig
    from speech_cloner_tpu_torch.pipeline.clone import init_trees
    from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer

    work = Path(__file__).resolve().parent / "build" / "serve_smoke"
    shutil.rmtree(work, ignore_errors=True)
    trees = init_trees(EncoderConfig(), DecoderConfig(), 0)
    for name, (params, state) in zip(("encoder", "decoder"), trees):
        Checkpointer(str(work / name), name).save(
            {"params": params, "model_state": state, "step": 0}, step=0)
    paths = []
    for i in range(8):
        seconds = 60.0 if i % 2 == 0 else 10.0
        paths.append(str(work / f"req{i}_{int(seconds)}s.wav"))
        write_riff_wav(paths[-1], synthetic_clip(seconds, seed=10 + i), 16000)
    argv = ["--enc-ckpt", str(work / "encoder"), "--dec-ckpt", str(work / "decoder"),
            "--output-dir", str(work / "out"), "--batch-max", "4", "--batch-backlog", "0",
            "--warm", "10,60", "--n-iter", "200", "--realse", "1.2", "--max-requests", "8",
            "--device", DEV]
    stdout, errors = io.StringIO(), []

    def run():
        try:
            serve.main(argv)
        except BaseException as e:      # noqa: BLE001  (re-raised below)
            errors.append(e)

    stdin, sys.stdin = sys.stdin, io.StringIO("".join(p + "\n" for p in paths))
    try:
        with contextlib.redirect_stdout(stdout):
            ck.reset_launch_counts()
            server = threading.Thread(target=run, daemon=True)
            server.start()
            server.join(600)
    finally:
        sys.stdin = stdin
    if server.is_alive() or errors:
        raise AssertionError(f"serve: did not finish in 600 s or raised {errors}")
    recs = [json.loads(line) for line in stdout.getvalue().splitlines() if line.startswith("{")]
    warm = [r for r in recs if "warmed_s" in r]
    results = [r for r in recs if "input" in r]
    bad = [r for r in results if "error" in r or not Path(r["output"]).exists()]
    audio_s = sum(r.get("duration_s", 0.0) for r in results)
    span_s = max(r["ts"] for r in results) - max(r["ts"] for r in warm)
    out = {"phase": "serve", "argv": argv[4:], "n_results": len(results), "errors": bad,
           "warm": warm, "batch_sizes": [r.get("batch") for r in results],
           "rtf": [r.get("rtf") for r in results], "wall_s": [r.get("wall_s") for r in results],
           "audio_s": audio_s, "served_span_s": span_s,
           "audio_s_per_wall_s": audio_s / max(span_s, 1e-9),
           "gru_scan_launches": ck.launch_counts["gru_scan", torch.float32]}
    if len(results) != 8 or bad or max(out["batch_sizes"]) < 2:
        emit(out)
        raise AssertionError(f"serve: {len(results)} records, {len(bad)} bad, batch sizes "
                             f"{out['batch_sizes']}")
    out["pcm_max_lsb_vs_api"] = served_against_api(pipe, results)
    out["pcm_tolerance_lsb"] = BATCH_PCM_TOL
    emit(out)
    shutil.rmtree(work, ignore_errors=True)
    if max(out["pcm_max_lsb_vs_api"]) > BATCH_PCM_TOL:
        raise AssertionError(f"serve: served PCM against the API's {out['pcm_max_lsb_vs_api']} "
                             f"LSB > {BATCH_PCM_TOL}")
    return out


def served_against_api(pipe, results: list[dict]) -> list[int]:
    """The server writes a chunk's records in a run, in the chunk's order.
    Convert each chunk's input files again through the API (convert_pcm16
    alone, convert_batch_pcm16 for a batch; seed 0) and return, per record,
    the largest PCM difference in LSB from the file the server wrote."""
    from speech_cloner_tpu_torch.data.audio_io import load_audio

    sr = pipe.feat_cfg.sample_rate
    lsb, i = [], 0
    while i < len(results):
        chunk = results[i:i + results[i]["batch"]]
        if {(r["batch"], r["wall_s"]) for r in chunk} != {(len(chunk), chunk[0]["wall_s"])}:
            raise AssertionError(f"serve: records {i}.. do not form a chunk: {chunk}")
        wavs = [load_audio(r["input"], sr) for r in chunk]
        want = pipe.convert_batch_pcm16(wavs) if len(wavs) > 1 else [pipe.convert_pcm16(wavs[0])]
        for r, w in zip(chunk, want):
            with wave.open(r["output"], "rb") as f:
                got = np.frombuffer(f.readframes(f.getnframes()), "<i2")
            if got.shape != w.shape:
                raise AssertionError(f"serve: {r['output']} holds {got.shape}, API {w.shape}")
            lsb.append(int(np.abs(got.astype(np.int32) - w.astype(np.int32)).max()))
        i += len(chunk)
    return lsb


def stream_checkpoints(work: Path) -> list[str]:
    """The seed-0 full-width weights as .npz checkpoints under ``work``; the
    streaming apps' weight flags."""
    from speech_cloner_tpu_torch.models import DecoderConfig, EncoderConfig
    from speech_cloner_tpu_torch.pipeline.clone import init_trees
    from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer

    for name, (params, state) in zip(("encoder", "decoder"),
                                     init_trees(EncoderConfig(), DecoderConfig(), 0)):
        Checkpointer(str(work / name), name).save({"params": params, "model_state": state},
                                                  step=0)
    return ["--enc-ckpt", str(work / "encoder"), "--dec-ckpt", str(work / "decoder")]


def stream_app_run(ck, stream_app, argv: list[str]) -> tuple[dict, dict, int]:
    """apps.stream.main(argv) in process, the launch counters reset just
    before and read just after: (its stats, the launch counts, peak memory)."""
    log = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    with contextlib.redirect_stdout(log):
        stats = stream_app.main(argv)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ck.launch_counts.items() if v}
    return stats, counts, torch.cuda.max_memory_allocated()


def phase_stream(ck, work: Path, flags: list[str]) -> dict:
    """apps.stream.main over ``flags``' checkpoints (`stream_checkpoints`), the
    app's defaults, a 60 s clip in 100 ms blocks: every step launches the
    float32 scan 6 times (or fail), the scan runs at T = STREAM_STEADY_T,
    the output holds (n // hop + 1) * hop finite samples. Then a 10 s run
    paced at realtime for the emission lag."""
    from speech_cloner_tpu_torch.apps import stream as stream_app
    from speech_cloner_tpu_torch.data.audio_io import read_riff_wav, write_riff_wav

    src = work / "stream_in.wav"
    wav = synthetic_clip(60.0, seed=20)
    write_riff_wav(str(src), wav, 16000, norm=False)
    wav = read_riff_wav(str(src))[0]          # what the app reads
    out = {"phase": "stream", "settings": {**STREAM_GEOMETRY, **STREAM_SETTINGS,
                                           "block_ms": 100, "realse": 1.0}}
    for name, extra, seconds in (("offline", [], 60.0), ("realtime", ["--realtime",
                                                                       "--t-e", "10"], 10.0)):
        dst = work / f"streamed_{name}.wav"
        stats, counts, peak = stream_app_run(
            ck, stream_app, flags + ["--input", str(src), "--output", str(dst),
                                     "--device", DEV, *extra])
        n = int(seconds * 16000)
        got = read_riff_wav(str(dst))[0]
        steps = stats["chunks"] + 1                  # the steady steps and the flush
        want = {("gru_scan", torch.float32): STREAM_LAUNCHES * steps,
                ("conv_banks", torch.float32): BANK_LAUNCHES * steps}
        out[name] = {**stats, "steps": steps,
                     "launches": {f"{k}:{str(d).removeprefix('torch.')}": v
                                  for (k, d), v in counts.items()},
                     "scan_launches_per_step": counts.get(("gru_scan", torch.float32), 0) / steps,
                     "max_memory_allocated_bytes": peak, "out_len": int(got.shape[0]),
                     "want_len": (n // 80 + 1) * 80}
        if counts != want or got.shape != ((n // 80 + 1) * 80,) or not np.isfinite(got).all():
            emit(out)
            raise AssertionError(f"stream {name}: launches {counts}, want {want}; output "
                                 f"{got.shape}, want {(n // 80 + 1) * 80} finite samples")
    shapes = ck.launch_shapes["gru_scan"]
    out["scan_shapes_T"] = sorted({T for dt, T, B, H in shapes if B == 1 and T != T_STEPS})
    steady_H = sorted({H for dt, T, B, H in shapes if (dt, T, B) == (torch.float32,
                                                                     STREAM_STEADY_T, 1)})
    out["steady_scan_H"] = steady_H
    emit(out)
    if len(steady_H) != 3:          # the three CBHG stacks' widths
        raise AssertionError(f"stream: scans at T={STREAM_STEADY_T}, B=1 for H={steady_H}")
    return out


def stream_pipes(pipe, realse: float = 1.0):
    """``pipe`` (same models, same device) with the streaming apps' vocoder settings."""
    return dataclasses.replace(pipe, realse=realse, **STREAM_SETTINGS)


def phase_stream_parity(pipe, cpu_pipe) -> dict:
    """StreamingCloner on the card against the same on the CPU: an 8 s clip
    (the first window, a ramp-up window, one steady step, the flush) and a
    4.5 s one (the first window, then a flush over all 901 frames, an odd
    T): the emitted spectrogram within PARITY_TOL["stft"], the waveform
    within PARITY_TOL["wav"], both of the CPU output's peak."""
    from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner

    out = {"phase": "stream_parity", "tolerance_rel": PARITY_TOL, "clips": []}
    for seconds in (8.0, 4.5):
        wav = synthetic_clip(seconds, seed=21)
        res = {}
        for name, p in (("gpu", stream_pipes(pipe)), ("cpu", stream_pipes(cpu_pipe))):
            s = StreamingCloner(p, collect_debug=True, **STREAM_GEOMETRY)
            t0 = time.perf_counter()
            res[name] = (s.convert_all(wav, block=1600), np.concatenate(s.debug_stft),
                         time.perf_counter() - t0)
        (gw, gs, gt), (cw, cs, ct) = res["gpu"], res["cpu"]
        if gw.shape != cw.shape or not np.isfinite(gw).all():
            emit(out)
            raise AssertionError(f"stream_parity {seconds} s: card output {gw.shape}, "
                                 f"CPU {cw.shape}")
        d = np.abs(gw - cw)
        out["clips"].append({
            "seconds": seconds, "frames": int(gs.shape[0]),
            "stft_max_abs": float(np.abs(gs - cs).max()),
            "stft_rel": float(np.abs(gs - cs).max() / np.abs(cs).max()),
            "wav_max_abs": float(d.max()), "wav_rel": float(d.max() / np.abs(cw).max()),
            "wav_argmax_s": int(d.argmax()) / 16000, "out_len": int(gw.shape[0]),
            "gpu_s": gt, "cpu_s": ct})
    emit(out)
    bad = [(c["seconds"], name, c[f"{name}_rel"]) for c in out["clips"] for name in ("stft", "wav")
           if not c[f"{name}_rel"] <= PARITY_TOL[name]]
    if bad:
        raise AssertionError(f"stream_parity (clip s, output, relative max-abs): {bad} over "
                             f"{PARITY_TOL}")
    return out


def phase_serve_stream(ck, pipe, flags: list[str]) -> dict:
    """apps.serve_stream.main over ``flags``' checkpoints and stdin, --slots 4,
    --mesh 1 (the slots over a stream mesh of the one card: the records of
    the unsharded server), the server's defaults: four sessions open at
    clock 0 (two of 20 s, two of 8 s), each fed in 1 s pcm16 records and
    closed after its last; no error record, every session closed with its
    length, and each session's PCM against StreamingCloner(batch=4) fed the
    same audio per slot, within BATCH_PCM_TOL."""
    import base64

    from speech_cloner_tpu_torch.apps import serve_stream
    from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner

    lengths = {"s0": 20, "s1": 8, "s2": 20, "s3": 8}
    audio = {sid: (synthetic_clip(sec, seed=30 + i) * 32767).astype("<i2")
             for i, (sid, sec) in enumerate(lengths.items())}
    lines = [{"open": sid} for sid in lengths]
    for sec in range(max(lengths.values())):
        for sid, n in lengths.items():
            if sec < n:
                lines.append({"sid": sid, "pcm16": base64.b64encode(
                    audio[sid][sec * 16000:(sec + 1) * 16000].tobytes()).decode()})
                if sec == n - 1:
                    lines.append({"close": sid})
    argv = flags + ["--slots", "4", "--mesh", "1", "--device", DEV]
    stdout, errors = io.StringIO(), []

    def run():
        try:
            serve_stream.main(argv)
        except BaseException as e:      # noqa: BLE001  (re-raised below)
            errors.append(e)

    stdin, sys.stdin = sys.stdin, io.StringIO("".join(json.dumps(x) + "\n" for x in lines))
    try:
        with contextlib.redirect_stdout(stdout):
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            server = threading.Thread(target=run, daemon=True)
            server.start()
            server.join(600)
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in ck.launch_counts.items() if v}
    finally:
        sys.stdin = stdin
    if server.is_alive() or errors:
        raise AssertionError(f"serve_stream: did not finish in 600 s or raised {errors}")
    recs = [json.loads(line) for line in stdout.getvalue().splitlines() if line.startswith("{")]
    slots = {r["opened"]: r["slot"] for r in recs if "opened" in r}
    closed = {r["closed"]: r["seconds"] for r in recs if "closed" in r}
    got = {sid: np.concatenate([np.frombuffer(base64.b64decode(r["pcm16"]), "<i2")
                                for r in recs if r.get("sid") == sid and "pcm16" in r])
           for sid in closed}
    bad = [r for r in recs if "error" in r]
    out = {"phase": "serve_stream", "slots": 4, "sessions_s": lengths, "closed": closed,
           "errors": bad, "wall_s": wall, "audio_s": sum(lengths.values()),
           "launches": {f"{k}:{str(d).removeprefix('torch.')}": v for (k, d), v in counts.items()}}
    if bad or closed != {k: float(v) for k, v in lengths.items()} \
            or any(got[sid].size != 16000 * n for sid, n in lengths.items()):
        emit(out)
        raise AssertionError(f"serve_stream: errors {bad}, closed {closed}, want {lengths}")
    # the reference: one cloner of 4 streams, each slot its session's audio
    # then silence, pushed in the server's blocks (chunk_frames * hop)
    s = StreamingCloner(stream_pipes(pipe, realse=1.2), batch=4, **STREAM_GEOMETRY)
    x = np.zeros((4, 16000 * (max(lengths.values()) + 4)), np.float32)
    for sid, slot in slots.items():
        x[slot, : audio[sid].size] = audio[sid].astype(np.float32) / 32768.0
    block = STREAM_GEOMETRY["chunk_frames"] * 80
    ref = np.concatenate([s.push(x[:, i:i + block]) for i in range(0, x.shape[1], block)],
                         axis=1)
    lsb = {}
    for sid, slot in slots.items():
        want = (np.clip(ref[slot, : got[sid].size] * 4.0, -1.0, 1.0) * 32767.0).astype("<i2")
        lsb[sid] = int(np.abs(want.astype(np.int32) - got[sid].astype(np.int32)).max())
    out.update(pcm_max_lsb_vs_api=lsb, pcm_tolerance_lsb=BATCH_PCM_TOL)
    emit(out)
    if max(lsb.values()) > BATCH_PCM_TOL or counts.get(("gru_scan", torch.float32), 0) == 0:
        raise AssertionError(f"serve_stream: PCM against StreamingCloner(batch=4) {lsb} LSB > "
                             f"{BATCH_PCM_TOL}, or no scan launch ({counts})")
    return out


def stream_capacity_run(ck, pipe, B: int, dtype: torch.dtype, profile: bool = False) -> dict:
    """StreamingCloner(batch=B) of ``pipe`` fed one chunk a push (one step a
    push once the first window is full): ms of each steady step (host clock;
    a push ends in its copy to the host), the launch counters reset before
    and read after (STREAM_LAUNCHES a step or fail), peak memory; with
    ``profile``, torch.profiler over one more steady step."""
    from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner

    clip = synthetic_clip(20.0, seed=40)
    x = np.stack([np.roll(clip, 1600 * i) * (0.5 + 0.1 * (i % 5)) for i in range(B)])
    block = STREAM_GEOMETRY["chunk_frames"] * 80
    s = StreamingCloner(pipe, batch=B, **STREAM_GEOMETRY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    steps = []
    for i in range(0, x.shape[1], block):
        f0 = s._f0
        t0 = time.perf_counter()
        y = s.push(x[:, i:i + block])
        dt = time.perf_counter() - t0
        if y.shape[1]:
            steps.append((f0, dt * 1e3))
    counts = {k: v for k, v in ck.launch_counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    # steady: the window no longer clamped at frame 0; the first of them
    # is its shape's first use (cuFFT plans, workspaces)
    steady = [ms for f0, ms in steps if f0 >= STREAM_GEOMETRY["context_frames"] + 4][1:]
    ms = float(np.median(steady))
    row = {"B": B, "dtype": str(dtype).removeprefix("torch."), "steps": len(steps),
           "step_ms": [ms for _, ms in steps], "warm_steady_steps": len(steady),
           "ms_per_step": ms, "realtime_streams": B * STREAM_CHUNK_S / (ms / 1e3),
           "max_memory_allocated_bytes": peak,
           "launches": {f"{k}:{str(d).removeprefix('torch.')}": v for (k, d), v in counts.items()}}
    want = {("gru_scan", dtype): STREAM_LAUNCHES * len(steps)}
    if dtype == torch.float32:
        want["conv_banks", dtype] = BANK_LAUNCHES * len(steps)
    if counts != want or len(steady) < 5:
        raise AssertionError(f"stream_capacity B={B} {dtype}: launches {counts} over "
                             f"{len(steps)} steps, {len(steady)} warm steady steps")
    if profile:
        row["profile"] = profile_call(lambda: s.push(x[:, :block]), "stream_profile",
                                      f"StreamingCloner.push, one steady step, B={B}")[0]
    return row


def phase_stream_capacity(ck, pipe) -> dict:
    """Steady-state ms per stream step at B = 1, 4, 16 (float32; and B = 4
    with bf16 models), realtime streams per card = B x chunk seconds / step
    seconds, peak memory, a profile of one B = 4 step."""
    p = stream_pipes(pipe)
    rows = [stream_capacity_run(ck, p, B, torch.float32, profile=B == 4) for B in STREAM_B]
    rows.append(stream_capacity_run(ck, dataclasses.replace(p, compute_dtype=torch.bfloat16), 4,
                                    torch.bfloat16))
    prof = rows[1].pop("profile")
    out = {"phase": "stream_capacity", "chunk_s": STREAM_CHUNK_S, "runs": rows}
    emit(out)
    emit(prof)
    return out


def phase_stream_kernel(ck) -> list[dict]:
    """The scan at a steady stream window's shapes (T = STREAM_STEADY_T, B
    = 1, 4, 16, H = 40, 128, 256), float32 and bf16 operands, against its
    plain version, timed."""
    gen = torch.Generator(DEV).manual_seed(3)
    limits = ck.device_limits(torch.cuda.current_device())
    T, rows = STREAM_STEADY_T, []
    for dt in KERNEL_DTYPES:
        for B in STREAM_B:
            for H in (40, 128, 256):
                (gx, cx, Wg, Wc), packed, diff = check_scan(ck, gen, dt, T, B, H)
                ms = cuda_ms(lambda: ck.gru_scan(gx, cx, Wg, Wc, packed), n=20)
                plain_ms = cuda_ms(lambda: ck.gru_scan_plain(gx, cx, Wg, Wc), n=1, warmup=1)
                b = gru_bound(T, B, H, dt.itemsize)
                row = {"dtype": str(dt).removeprefix("torch."), "H": H, "B": B, "T": T,
                       "max_abs_err": diff.max().item(), "tolerance": KERNEL_TOL[dt], "ms": ms,
                       "us_per_step": ms * 1000 / T, "plain_ms": plain_ms,
                       "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                       "share_of_bound": b["bound_ms"] / ms,
                       "plan": plan_row(ck.gru_scan_plan(H, B, *limits,
                                                         elem_bytes=dt.itemsize))}
                emit({"phase": "stream_kernel", **row})
                rows.append(row)
    return rows


TIMIT_PHONES = ("h#", "sh", "iy", "hh", "ae", "dcl", "d", "y", "er", "pau")


def write_corpus(root: Path) -> tuple[Path, Path]:
    """A TIMIT-layout tree (64 TRAIN, 32 TEST utterances; RIFF audio, PHN/TXT/WRD
    labels) and an ARCTIC-layout one (70 'slt' utterances with .lab files),
    every utterance 2.5 s of synthetic_clip: one 400-frame window each."""
    from speech_cloner_tpu_torch.data.audio_io import write_riff_wav

    sr, seconds = 16000, 2.5
    n = int(sr * seconds)
    cuts = np.linspace(0, n, len(TIMIT_PHONES) + 1).astype(int)
    timit, arctic = root / "timit", root / "arctic"
    i = 0
    for ds_type, count in (("TRAIN", 64), ("TEST", 32)):
        for k in range(count):
            d = timit / ds_type / f"DR{k % 8 + 1}" / f"{'MF'[k % 2]}SPK{k // 8}"
            d.mkdir(parents=True, exist_ok=True)
            stem = f"SX{k}"
            write_riff_wav(str(d / f"{stem}.WAV"), synthetic_clip(seconds, seed=100 + i), sr,
                           norm=False)
            (d / f"{stem}.PHN").write_text("".join(
                f"{a} {b} {ph}\n" for a, b, ph in zip(cuts[:-1], cuts[1:], TIMIT_PHONES)))
            (d / f"{stem}.TXT").write_text(f"0 {n} she had your dark suit\n")
            (d / f"{stem}.WRD").write_text(f"0 {n} she\n")
            i += 1
    spk = arctic / "cmu_us_slt_arctic"
    (spk / "wav").mkdir(parents=True, exist_ok=True)
    (spk / "lab").mkdir(parents=True, exist_ok=True)
    for k in range(70):
        write_riff_wav(str(spk / "wav" / f"arctic_a{k:04d}.wav"),
                       synthetic_clip(seconds, seed=1000 + k), sr, norm=False)
        (spk / "lab" / f"arctic_a{k:04d}.lab").write_text(
            "#\n" + "".join(f"{b / sr:.4f} 125 {ph}\n" for b, ph in
                            zip(cuts[1:], ("pau", "ae", "b", "k", "d", "iy", "s", "t", "er",
                                           "pau"))))
    return timit, arctic


def run_app(ck, app, name: str, fused: bool, argv: list[str], profile_step: int | None,
            bf16: bool = False, first: list | None = None):
    """Run a training app's main(argv) in process (``bf16``: with --bf16)
    with each train step timed (synchronized before and after) and, at
    ``profile_step``, profiled; the launch counters reset just before and
    read just after, and checked by kernel and by operand dtype. ``first``
    receives copies of the windows the first step was given."""
    step_attr = f"{name}_train_step"
    step_fn = getattr(app, step_attr)
    times, prof = [], {}

    def timed(*a, **k):
        if first is not None and not times:
            first.extend(torch.as_tensor(x).clone() for x in a[1:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(times) == profile_step:
            prof["out"], res = profile_call(lambda: step_fn(*a, **k),
                                            f"train_profile_{name}{'_bf16' if bf16 else ''}",
                                            f"{name}_train_step")
        else:
            res = step_fn(*a, **k)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return res

    setattr(app, step_attr, timed)
    log = io.StringIO()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            app.main(argv + (["--fused-gru"] if fused else []) + (["--bf16"] if bf16 else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ck.launch_counts)
    finally:
        setattr(app, step_attr, step_fn)
    dt = torch.bfloat16 if bf16 else torch.float32
    per_step = STEP_LAUNCHES[(name, fused)]
    want = {(k, d): TRAIN_STEPS * per_step.get(k, 0) if d == dt else 0 for k, d in counts}
    steady = times[1:]
    if profile_step is not None and profile_step < len(steady):
        steady = [t for i, t in enumerate(times) if i not in (0, profile_step)]
    ms = float(np.median(steady)) * 1e3
    run = {"app": name, "fused_gru": fused, "bf16": bf16, "steps": len(times),
           "ms_per_step": ms, "step_ms": [t * 1e3 for t in times],
           "windows_per_s": TRAIN_B / (ms / 1e3), "wall_s": wall,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": {f"{k}:{str(d).removeprefix('torch.')}": v
                        for (k, d), v in counts.items() if v},
           "launches_want": {k: TRAIN_STEPS * v for k, v in per_step.items()}}
    if "out" in prof:
        emit(prof["out"])
    if len(times) != TRAIN_STEPS or counts != want:
        emit({"phase": "train", "run": run, "log": log.getvalue()[-2000:]})
        raise AssertionError(f"train {name} fused={fused} {dt}: {len(times)} steps, launches "
                             f"{run['launches']}, want {run['launches_want']}")
    return run


def phase_train(ck, work: Path) -> dict:
    """Both training apps at full width on a synthetic corpus written under
    ``work``, without and with --fused-gru, in float32 and with --bf16; the
    decoder trains on the unfused float32 encoder's checkpoint."""
    from speech_cloner_tpu_torch.apps import train_decoder, train_encoder

    timit, arctic = write_corpus(work)
    common = ["--batch-size", str(TRAIN_B), "--max-steps", str(TRAIN_STEPS), "--bn-recal", "0",
              "--save-each-n-epochs", "1000", "--seed", "0", "--device", DEV, "--loader", "h5py"]
    runs = []
    for bf16 in (False, True):
        for fused in (False, True):
            tag = ("_fused" if fused else "") + ("_bf16" if bf16 else "")
            runs.append(run_app(ck, train_encoder, "encoder", fused,
                                ["--ds-path", str(timit), "--model-path", str(work / f"enc{tag}"),
                                 "--log-dir", str(work / f"el{tag}"), *common], None, bf16))
            runs.append(run_app(ck, train_decoder, "decoder", fused,
                                ["--ds-path", str(arctic), "--spk-id", "slt", "--enc-ckpt",
                                 str(work / "enc"), "--model-path", str(work / f"dec{tag}"),
                                 "--log-dir", str(work / f"dl{tag}"), *common],
                                None if fused else 4, bf16))
    out = {"phase": "train", "corpus": {"timit_utterances": 96, "arctic_utterances": 70,
                                        "seconds_each": 2.5},
           "batch": TRAIN_B, "steps": TRAIN_STEPS, "runs": runs}
    emit(out)
    return out


def leaf_paths(tree, prefix: str = "") -> dict:
    """{path: leaf} of a nested dict/list tree, paths "a/b/0/c" (one name for
    a leaf in either package's tree of the JAX layout, whatever the order)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaf_paths(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in leaf_paths(sub, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def with_lstm(enc_cfg, dec_cfg):
    """The configs with every CBHG's LSTM branch on (use_lstm)."""
    lstm = lambda c: dataclasses.replace(c, use_lstm=True)  # noqa: E731
    return lstm(enc_cfg), dataclasses.replace(lstm(dec_cfg), step1=lstm(dec_cfg.step1),
                                              step2=lstm(dec_cfg.step2))


def train_parity_setup(use_lstm: bool = False, B: int = 4):
    """The train_parity models and batch: full-width configs with dropout 0
    (the decoder's f_mel mix on; ``use_lstm``: every CBHG's LSTM branch),
    the seed-0 trees, and one batch of B (mfcc, phn, mel, stft) from
    default_rng(3)."""
    from speech_cloner_tpu_torch.models import DecoderConfig, EncoderConfig
    from speech_cloner_tpu_torch.pipeline.clone import init_trees

    enc_cfg = dataclasses.replace(EncoderConfig(), dropout_rate=0.0)
    dec_cfg = dataclasses.replace(DecoderConfig(), dropout_rate=0.0, use_target_mel_step2=True)
    if use_lstm:
        enc_cfg, dec_cfg = with_lstm(enc_cfg, dec_cfg)
    trees = init_trees(enc_cfg, dec_cfg, 0)
    rng = np.random.default_rng(3)
    T = enc_cfg.n_timesteps
    mfcc = rng.uniform(-1, 1, (B, T, enc_cfg.input_dim)).astype(np.float32)
    phn = np.eye(61, dtype=np.float32)[rng.integers(0, 61, (B, T))]
    mel = rng.uniform(0, 1, (B, T, 80)).astype(np.float32)
    stft = rng.uniform(0, 1, (B, T, 201)).astype(np.float32)
    return enc_cfg, dec_cfg, trees, (mfcc, phn, mel, stft)


def port_train_grads(dev, dtype, compute_dtype=None, setup=train_parity_setup) -> dict:
    """One encoder and one decoder step of the port (epoch 300) on ``dev``
    with models in ``dtype`` (``compute_dtype``: the steps' mixed
    precision), the models and batch of ``setup``: {name: (loss, {leaf
    path: gradient})}."""
    from speech_cloner_tpu_torch.runtime.jax_params import (
        decoder_from_jax, encoder_from_jax, module_to_jax)
    from speech_cloner_tpu_torch.train import (
        DecoderLossConfig, OptimizerConfig, decoder_train_step, encoder_train_step,
        make_train_state)

    enc_cfg, dec_cfg, ((ep, es), (dp, ds)), (mfcc, phn, mel, stft) = setup()
    opt_cfg = OptimizerConfig()
    enc = encoder_from_jax(ep, es, enc_cfg, dev).to(dtype)
    _, m = encoder_train_step(make_train_state(enc, opt_cfg, 1), mfcc, phn, model=enc,
                              opt_cfg=opt_cfg, opt=opt_cfg.make(), compute_dtype=compute_dtype)
    frozen = encoder_from_jax(ep, es, enc_cfg, dev).to(dtype).requires_grad_(False)
    dec = decoder_from_jax(dp, ds, dec_cfg, dev).to(dtype)
    ts = {**make_train_state(dec, opt_cfg, 1), "epoch": np.int32(300)}
    _, dm = decoder_train_step(ts, mfcc, mel, stft, encoder=frozen, model=dec,
                               loss_cfg=DecoderLossConfig(), opt_cfg=opt_cfg,
                               opt=opt_cfg.make(), compute_dtype=compute_dtype)
    return {"encoder": (float(m["loss"]), leaf_paths(module_to_jax(enc, grads=True))),
            "decoder": (float(dm["loss"]), leaf_paths(module_to_jax(dec, grads=True)))}


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_train_parity() -> tuple[dict, dict]:
    """One encoder and one decoder train step at full width (B = 4, dropout 0,
    the f_mel mix live at epoch 300) on the card and on the CPU, from the
    seed-0 weights and one batch: loss and every gradient leaf; then the
    same steps on the card with bf16 compute, each leaf against the JAX
    package's own bf16 gap. Returns the phase's line and the CPU float32
    and float64 steps ({"float32": ..., "float64": ...} of
    `port_train_grads`) for parallel_train."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {(dev, dtype): port_train_grads(dev, dtype)
           for dev, dtype in ((DEV, torch.float32), ("cpu", torch.float32),
                              ("cpu", torch.float64))}
    bf16 = port_train_grads(DEV, torch.float32, torch.bfloat16)
    jax_gap = json.loads(BF16_GRAD_GAP_FILE.read_text())
    out = {"phase": "train_parity", "batch": 4, "tolerance_rel_peak": PARITY_TRAIN_TOL,
           "bf16_gap_factor": BF16_GAP_FACTOR,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    bad = []
    for name in ("encoder", "decoder"):
        (gl, gg), (cl, cg) = res[DEV, torch.float32][name], res["cpu", torch.float32][name]
        c64 = res["cpu", torch.float64][name][1]
        bl, bg = bf16[name]
        rows = {}
        for path, c in c64.items():
            a, b = gg[path], cg[path]
            rows[path] = {"gpu_l2": rel_l2(a, c), "cpu_l2": rel_l2(b, c),
                          "gpu_cpu_max_rel_peak": float(np.abs(a - b).max()
                                                        / max(np.abs(b).max(), 1e-30)),
                          "bf16_l2": rel_l2(bg[path], c),
                          "jax_bf16_gap": jax_gap[name]["leaves"][path]}
        out[name] = {"loss_gpu": gl, "loss_cpu": cl, "loss_rel": abs(gl - cl) / abs(cl),
                     "grad_leaves": len(rows),
                     "gpu_vs_f64_max_rel_l2": max(r["gpu_l2"] for r in rows.values()),
                     "cpu_f32_vs_f64_max_rel_l2": max(r["cpu_l2"] for r in rows.values()),
                     "gpu_vs_cpu_max_rel_peak": max(r["gpu_cpu_max_rel_peak"]
                                                    for r in rows.values()),
                     "leaves_gpu_vs_cpu_within_tol_of_peak": sum(
                         r["gpu_cpu_max_rel_peak"] <= PARITY_TRAIN_TOL for r in rows.values()),
                     "bf16_loss_gpu": bl, "bf16_loss_rel": abs(bl - cl) / abs(cl),
                     "bf16_vs_f64_max_rel_l2": max(r["bf16_l2"] for r in rows.values()),
                     "bf16_max_ratio_to_jax_gap": max(r["bf16_l2"] / r["jax_bf16_gap"]
                                                      for r in rows.values()),
                     "jax_bf16_gap_max": max(r["jax_bf16_gap"] for r in rows.values())}
        if not out[name]["loss_rel"] <= PARITY_TRAIN_TOL:
            bad.append((name, "loss", out[name]["loss_rel"]))
        bad += [(name, p, r) for p, r in rows.items()
                if not r["gpu_l2"] <= PARITY_TRAIN_TOL + PARITY_F32_FACTOR * r["cpu_l2"]]
        bad += [(name, "bf16", p, r) for p, r in rows.items()
                if not r["bf16_l2"] <= (BF16_GAP_FACTOR * r["jax_bf16_gap"] + PARITY_TRAIN_TOL
                                        + PARITY_F32_FACTOR * r["cpu_l2"])]
    emit(out)
    if bad:
        raise AssertionError(f"train_parity: {bad}")
    return out, {"float32": res["cpu", torch.float32], "float64": res["cpu", torch.float64]}


def speaker_parity() -> dict:
    """A SpeakerIdConfig() forward (eval) and train-mode gradient on the card
    against the CPU in float32 and float64, from the seed-0 weights and 4
    random windows: the logits within PARITY_TOL of their peak, the loss
    within PARITY_TRAIN_TOL, each gradient leaf by the train_parity rule."""
    from speech_cloner_tpu_torch.models import speaker_id as spk_m
    from speech_cloner_tpu_torch.runtime.jax_params import module_to_jax, speaker_id_from_jax
    from speech_cloner_tpu_torch.train.metrics import softmax_xent

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = spk_m.SpeakerIdConfig()
    params, state = spk_m.init_tree(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (4, cfg.n_timesteps, cfg.n_features)).astype(np.float32)
    y = np.eye(cfg.n_output, dtype=np.float32)[rng.integers(0, cfg.n_output, 4)]
    res = {}
    for dev, dtype in ((DEV, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        model = speaker_id_from_jax(params, state, cfg, dev).to(dtype)
        xt = torch.tensor(x, device=dev, dtype=dtype)
        with torch.no_grad():
            logits = model(xt).cpu().double().numpy()
        loss = softmax_xent(model(xt, train=True), torch.tensor(y, device=dev, dtype=dtype))
        loss.backward()
        res[dev, dtype] = (logits, loss.item(), leaf_paths(module_to_jax(model, grads=True)))
    (ga, gl, gg), (ca, cl, cg) = res[DEV, torch.float32], res["cpu", torch.float32]
    c64 = res["cpu", torch.float64][2]
    rows = {p: (rel_l2(gg[p], c), rel_l2(cg[p], c)) for p, c in c64.items()}
    out = {"logits_rel_peak": float(np.abs(ga - ca).max() / np.abs(ca).max()),
           "loss_rel": abs(gl - cl) / abs(cl), "grad_leaves": len(rows),
           "gpu_vs_f64_max_rel_l2": max(g for g, _ in rows.values()),
           "cpu_f32_vs_f64_max_rel_l2": max(c for _, c in rows.values())}
    bad = [p for p, (g, c) in rows.items() if not g <= PARITY_TRAIN_TOL + PARITY_F32_FACTOR * c]
    if bad or not out["logits_rel_peak"] <= PARITY_TOL["ppg"] \
            or not out["loss_rel"] <= PARITY_TRAIN_TOL:
        raise AssertionError(f"speaker parity: {out}, leaves {bad}")
    return out


def run_speaker_app(app, argv: list[str]) -> dict:
    """apps.train_speaker_id.main(argv) in process, each train step and each
    vocoded augmentation timed (synchronized before and after)."""
    times = {"speaker_train_step": [], "mix_vocoded": []}
    real = {k: getattr(app, k) for k in times}

    def timed(name):
        def fn(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real[name](*a, **k)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return res
        return fn

    log = io.StringIO()
    try:
        for k in times:
            setattr(app, k, timed(k))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            app.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, fn in real.items():
            setattr(app, k, fn)
    steps = times["speaker_train_step"]
    # mix_vocoded also runs for the vocoded validation and the BN
    # recalibration; the training batches' calls come first in each step
    step_ms = float(np.median(steps[1:])) * 1e3
    aug_ms = float(np.median(times["mix_vocoded"][1:])) * 1e3
    if len(steps) != SPEAKER_STEPS:
        raise AssertionError(f"speaker: {len(steps)} steps, want {SPEAKER_STEPS}: "
                             f"{log.getvalue()[-2000:]}")
    return {"bf16": "--bf16" in argv, "steps": len(steps), "ms_per_step": step_ms,
            "step_ms": [t * 1e3 for t in steps], "augment_ms": aug_ms,
            "augment_calls": len(times["mix_vocoded"]),
            "windows_per_s": TRAIN_B / ((step_ms + aug_ms) / 1e3),
            "windows_per_s_without_augment": TRAIN_B / (step_ms / 1e3), "wall_s": wall,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "log_tail": log.getvalue()[-600:]}


def phase_speaker(work: Path) -> dict:
    """The speaker-ID verifier: its trainer in float32 and bf16 on the train
    phase's TIMIT-layout corpus under ``work`` (8 speakers), the model on
    the card against the CPU, then apps.convert --verify-ckpt on the float32
    checkpoint."""
    from speech_cloner_tpu_torch.apps import convert, train_speaker_id
    from speech_cloner_tpu_torch.data.audio_io import write_riff_wav
    from speech_cloner_tpu_torch.models import DecoderConfig, EncoderConfig
    from speech_cloner_tpu_torch.pipeline.clone import init_trees
    from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer

    common = ["--ds-path", str(work / "timit"), "--batch-size", str(TRAIN_B), "--max-steps",
              str(SPEAKER_STEPS), "--bn-recal", "2", "--seed", "0", "--device", DEV]
    runs = [run_speaker_app(train_speaker_id, common + ["--model-path", str(work / tag)] + flags)
            for tag, flags in (("spk", []), ("spk_bf16", ["--bf16"]))]
    parity = speaker_parity()
    for name, (params, state) in zip(("encoder", "decoder"),
                                     init_trees(EncoderConfig(), DecoderConfig(), 0)):
        Checkpointer(str(work / name), name).save({"params": params, "model_state": state},
                                                  step=0)
    src = work / "verify_in.wav"
    write_riff_wav(str(src), synthetic_clip(4.0, seed=7), 16000)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        convert.main(["--input", str(src), "--output-dir", str(work / "verified"),
                      "--enc-ckpt", str(work / "encoder"), "--dec-ckpt", str(work / "decoder"),
                      "--verify-ckpt", str(work / "spk"), "--target-spk", "SPK1",
                      "--device", DEV])
    convert_s = time.perf_counter() - t0
    report = json.loads((work / "verified" / "verify_in_verify.json").read_text())
    want = {"true_top", "pred_top", "identity_changed", "n_windows_true", "n_windows_pred",
            "target_spk_id", "target_p_true", "target_p_pred", "target_hit"}
    out = {"phase": "speaker", "batch": TRAIN_B, "geometry": [400, 201], "runs": runs,
           "parity": parity, "verify_report": report, "convert_verify_s": convert_s}
    emit(out)
    if set(report) != want or not all(math.isfinite(p) for _, p in report["pred_top"]):
        raise AssertionError(f"speaker: verify report keys {sorted(report)}, want {sorted(want)}")
    return out


# the workflow phase's corpus (apps.make_synth_corpus): 8 + 4 TIMIT speakers
# of 8 utterances plus the target (FSLT0) and source (MBDL0) voices, 50
# ARCTIC utterances each of slt and bdl (so the decoder's seed-0 2% split
# holds one validation utterance for apps.evaluate decoder)
WORKFLOW_CORPUS = ["--train-spk", "8", "--test-spk", "4", "--utts", "8", "--arctic-utts", "50",
                   "--seed", "0"]
WORKFLOW_STEPS = {"encoder": 8, "decoder": 8, "speaker": 6}
CONVERT_LAUNCHES = 6          # scans per ClonePipeline.convert (3 CBHG x 2 directions)
LOADERS = ("h5py", "native", "device")


def counts_delta(ck, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in ck.launch_counts.items() if v - before.get(k, 0)}


def launch_names(counts: dict) -> dict:
    return {f"{k}:{str(d).removeprefix('torch.')}": v for (k, d), v in counts.items() if v}


def convert_launches(n: int, gl_rounds: int = 0) -> dict:
    """`launch_names` of n float32 converts: the inference forward's
    CONVERT_LAUNCHES scans and BANK_LAUNCHES bank-kernel launches each, and
    ``gl_rounds`` Griffin-Lim round launches each (the matmul DFT's rounds;
    0 with the FFT DFT, the pipelines' default)."""
    counts = {"gru_scan:float32": CONVERT_LAUNCHES * n, "conv_banks:float32": BANK_LAUNCHES * n,
              "gl_round:float32": gl_rounds * n}
    return {k: v for k, v in counts.items() if v}


def add_counts(total: dict, *counts: dict) -> dict:
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


@contextlib.contextmanager
def patched(obj, name: str, make):
    """obj.name replaced by make(original) inside the block."""
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def phase_workflow(ck, root: Path) -> dict:
    """apps.make_synth_corpus, then apps.train_full --in-process --demo at
    full width on the card: per stage its wall, peak memory, the loader each
    trainer chose, ms per step (median of steps 2..) and the launches inside
    its train steps (STEP_LAUNCHES x steps, exact), all its launches, and in
    the demo CONVERT_LAUNCHES per ClonePipeline.convert (exact); then every
    checkpoint, the demo report's three tests and verdict, and each pred.wav
    (finite, convert's length for its input)."""
    from speech_cloner_tpu_torch.apps import (clone_demo, make_synth_corpus, train_decoder,
                                              train_encoder, train_full, train_speaker_id)
    from speech_cloner_tpu_torch.data.audio_io import read_riff_wav
    from speech_cloner_tpu_torch.pipeline.clone import ClonePipeline
    from speech_cloner_tpu_torch.runtime.checkpoint import Checkpointer

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        make_synth_corpus.main(["--out-dir", str(root / "synth"), *WORKFLOW_CORPUS])
    corpus_s = time.perf_counter() - t0
    stages, steps, converts = {}, {n: [] for n in WORKFLOW_STEPS}, []
    step_counts = {n: {} for n in WORKFLOW_STEPS}

    def stage_main(name, real):
        def run(argv):
            log = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(ck.launch_counts)
            t = time.perf_counter()
            with contextlib.redirect_stdout(log):
                real(argv)
            torch.cuda.synchronize()
            loader = re.findall(r" loader: (\w+)", log.getvalue())
            stages[name] = {"wall_s": time.perf_counter() - t,
                            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                            "loader": loader[0] if loader else None,
                            "launches": launch_names(counts_delta(ck, before)),
                            "log_tail": log.getvalue()[-400:]}
        return run

    def timed_step(name):
        def make(real):
            def step(*a, **k):
                torch.cuda.synchronize()
                before = dict(ck.launch_counts)
                t = time.perf_counter()
                out = real(*a, **k)
                torch.cuda.synchronize()
                steps[name].append(time.perf_counter() - t)
                add_counts(step_counts[name], counts_delta(ck, before))
                return out
            return step
        return make

    def counted_convert(real):
        def convert(self, wav, seed=0):
            before = dict(ck.launch_counts)
            out = real(self, wav, seed)
            converts.append((len(wav), len(out[0]), sum(counts_delta(ck, before).values())))
            return out
        return convert

    run = root / "run"
    argv = ["--timit-path", str(root / "synth" / "timit"), "--target-path",
            str(root / "synth" / "arctic"), "--spk-id", "slt", "--work-dir", str(run),
            "--batch-size", str(TRAIN_B), "--enc-steps", str(WORKFLOW_STEPS["encoder"]),
            "--dec-steps", str(WORKFLOW_STEPS["decoder"]), "--spk-steps",
            str(WORKFLOW_STEPS["speaker"]), "--demo", "--target-timit-spk", "SLT0",
            "--n-iter", "200", "--in-process", "--device", DEV]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for name, app in (("encoder", train_encoder), ("decoder", train_decoder),
                          ("speaker", train_speaker_id), ("demo", clone_demo)):
            stack.enter_context(patched(app, "main", lambda real, n=name: stage_main(n, real)))
        for name, app, attr in (("encoder", train_encoder, "encoder_train_step"),
                                ("decoder", train_decoder, "decoder_train_step"),
                                ("speaker", train_speaker_id, "speaker_train_step")):
            stack.enter_context(patched(app, attr, timed_step(name)))
        stack.enter_context(patched(ClonePipeline, "convert", counted_convert))
        with contextlib.redirect_stdout(io.StringIO()):
            train_full.main(argv)
    wall = time.perf_counter() - t0

    bad = []
    for name, n in WORKFLOW_STEPS.items():
        st = stages[name]
        st["steps"] = len(steps[name])
        st["ms_per_step"] = float(np.median(steps[name][1:])) * 1e3 if steps[name] else None
        st["step_launches"] = launch_names(step_counts[name])
        want = ({} if name == "speaker" else
                {k: n * v for k, v in STEP_LAUNCHES[(name, False)].items()})
        st["step_launches_want"] = {f"{k}:float32": v for k, v in want.items() if v}
        if st["steps"] != n or st["step_launches"] != st["step_launches_want"]:
            bad.append(f"{name}: {st['steps']} steps, launches in steps {st['step_launches']}")
    if stages["speaker"]["launches"]:
        bad.append(f"speaker stage launched scans: {stages['speaker']['launches']}")
    demo = stages["demo"]
    demo["converts"] = len(converts)
    demo["launches_want"] = convert_launches(len(converts))
    if not converts or demo["launches"] != demo["launches_want"] or any(
            c[2] != CONVERT_LAUNCHES + BANK_LAUNCHES for c in converts):
        bad.append(f"demo: launches {demo['launches']} over {len(converts)} converts")
    for d, ckname, stage in (("enc_ckpt", "encoder", "encoder"),
                             ("dec_ckpt", "decoder", "decoder"),
                             ("spk_ckpt", "speaker_id", "speaker")):
        n = WORKFLOW_STEPS[stage]
        if Checkpointer(str(run / d), ckname).latest_step() != n:
            bad.append(f"no {ckname}-{n} checkpoint")
    report = json.loads((run / "demo" / "demo_report.json").read_text())
    tests = report.get("tests", {})
    if set(tests) != {"test1_self_reconstruction", "test2_target_speaker",
                      "test3_other_speaker"} or "identity_changed" not in report.get(
                          "verification", {}):
        bad.append(f"demo report: tests {sorted(tests)}, verification "
                   f"{sorted(report.get('verification', {}))}")
    by_length = {n_in: n_out for n_in, n_out, _ in converts}
    wavs = {}
    for t in tests:
        true = read_riff_wav(str(run / "demo" / t / "true.wav"))[0]
        pred = read_riff_wav(str(run / "demo" / t / "pred.wav"))[0]
        wavs[t] = {"true_samples": len(true), "pred_samples": len(pred)}
        if not np.isfinite(pred).all() or len(pred) != by_length.get(len(true)):
            bad.append(f"{t}: pred.wav {len(pred)} samples for {len(true)} in")
    total = {}
    for st in stages.values():
        add_counts(total, st["launches"])
    out = {"phase": "workflow", "corpus_s": corpus_s, "wall_s": wall, "stages": stages,
           "launches": total,
           "demo_wavs": wavs, "report_tests": tests,
           "verification": report.get("verification")}
    emit(out)
    if bad:
        raise AssertionError(f"workflow: {bad}")
    return out


def phase_loaders(ck, root: Path) -> dict:
    """Both trainers at full width, batch 32, TRAIN_STEPS float32 steps on the
    workflow's corpus with each --loader (launches exact, as in the train
    phase); the first batch's windows of the three loaders equal on the card,
    bit for bit; the device store's bytes. Then --ds-kind target (the slt
    wavs in one flat directory) under device and h5py."""
    from speech_cloner_tpu_torch.apps import train_decoder, train_encoder

    synth = root / "synth"
    book = root / "book"
    book.mkdir()
    for wav in sorted((synth / "arctic" / "cmu_us_slt_arctic" / "wav").glob("*.wav")):
        shutil.copy(wav, book / wav.name)
    common = ["--batch-size", str(TRAIN_B), "--max-steps", str(TRAIN_STEPS), "--bn-recal", "0",
              "--save-each-n-epochs", "1000", "--seed", "0", "--device", DEV]
    runs, firsts, total = [], {}, {}
    t_phase = time.perf_counter()
    cases = [(loader, "encoder", []) for loader in LOADERS]
    cases += [(loader, "decoder", []) for loader in LOADERS]
    cases += [(loader, "decoder", ["--ds-kind", "target"]) for loader in ("device", "h5py")]
    for loader, name, extra in cases:
        app = train_encoder if name == "encoder" else train_decoder
        tag = f"{name}_{loader}{'_target' if extra else ''}"
        ds = synth / "timit" if name == "encoder" else (book if extra else synth / "arctic")
        stores, first = [], []
        argv = ["--ds-path", str(ds), "--model-path", str(root / tag), "--log-dir",
                str(root / f"{tag}_logs"), "--loader", loader, *extra, *common]
        if name == "decoder":
            argv += ["--spk-id", "slt", "--enc-ckpt", str(root / "run" / "enc_ckpt")]

        def keep(real, stores=stores):
            def from_npz(*a, **k):
                stores.append(real(*a, **k))
                return stores[-1]
            return from_npz
        with patched(app, "from_npz", keep):
            run = run_app(ck, app, name, False, argv, None, first=first)
        add_counts(total, run["launches"])
        run.update(loader=loader, ds_kind="target" if extra else "corpus",
                   store_bytes=stores[0].nbytes if stores else None,
                   first_batch_shapes=[list(t.shape) for t in first])
        runs.append(run)
        emit({"phase": "loaders", **{k: v for k, v in run.items() if k != "step_ms"}})
        if not extra:
            firsts[name, loader] = first
    equal = {}
    for name in ("encoder", "decoder"):
        ref = firsts[name, "h5py"]
        for loader in ("native", "device"):
            got = firsts[name, loader]
            equal[f"{name}:{loader}"] = len(got) == len(ref) and all(
                g.device.type == torch.device(DEV).type and torch.equal(g, r.to(g.device))
                for g, r in zip(got, ref))
    out = {"phase": "loaders", "wall_s": time.perf_counter() - t_phase,
           "first_batch_equal_to_h5py": equal,
           "summary": {f"{r['app']}:{r['loader']}:{r['ds_kind']}": {
               "ms_per_step": r["ms_per_step"], "windows_per_s": r["windows_per_s"],
               "store_bytes": r["store_bytes"]} for r in runs},
           "launches": total}
    emit(out)
    if not all(equal.values()):
        raise AssertionError(f"loaders: first batches differ: {equal}")
    return out


def phase_evaluate(ck, root: Path) -> dict:
    """apps.evaluate encoder, decoder and speaker on the workflow's
    checkpoints: each prints its final line with finite numbers over at
    least one frame or window (the decoder: a positive loss)."""
    from speech_cloner_tpu_torch.apps import evaluate

    synth, run = root / "synth", root / "run"
    modes = {"encoder": ["--ds-path", str(synth / "timit"), "--ckpt", str(run / "enc_ckpt")],
             "decoder": ["--ds-path", str(synth / "arctic"), "--ckpt", str(run / "dec_ckpt"),
                         "--enc-ckpt", str(run / "enc_ckpt"), "--batch-size", "1"],
             "speaker": ["--ds-path", str(synth / "timit"), "--ckpt", str(run / "spk_ckpt"),
                         "--batch-size", "8"]}
    rows, total, bad = {}, {}, []
    for mode, args in modes.items():
        log = io.StringIO()
        before = dict(ck.launch_counts)
        t = time.perf_counter()
        with contextlib.redirect_stdout(log):
            evaluate.main([mode, *args, "--device", DEV])
        torch.cuda.synchronize()
        lines = [s for s in log.getvalue().splitlines() if " final" in s or "accuracy over" in s]
        nums = [float(x) for x in re.findall(r"-?\d+\.\d+|nan", lines[-1])] if lines else []
        delta = counts_delta(ck, before)
        add_counts(total, delta)
        rows[mode] = {"wall_s": time.perf_counter() - t, "final_line": lines[-1] if lines else None,
                      "launches": launch_names(delta)}
        scored = [int(n) for n in re.findall(r"over (\d+)", lines[-1])] if lines else []
        if not nums or not all(math.isfinite(v) for v in nums) or (
                scored[0] == 0 if scored else nums[0] <= 0.0):
            bad.append(f"{mode}: {lines[-1:] or log.getvalue()[-400:]}")
    out = {"phase": "evaluate", "modes": rows, "launches": launch_names(total)}
    emit(out)
    if bad:
        raise AssertionError(f"evaluate: {bad}")
    return out


# ------------------------------------------------------------ the parallel layer ---

SP_WARMUP = 400
SP_SHARDS = (1, 4)
# scans of one convert_seq_parallel over n shards: 3 CBHG x (2 directions a
# shard + the first shard's exact head and the last shard's exact tail)
def sp_launches(n: int) -> int:
    return 3 * (2 * n + 2)


# convert_seq_parallel against the card's unsharded forward of the whole
# padded sequence as one window: the median |difference| of mel and stft,
# the bound JAX tests/test_pipeline.py holds its own SP conversion to (the
# GRU states at the seams are warmed up, not exact)
SP_MEDIAN_TOL = 1e-3
SP_PARITY_SECONDS = 6.0
SP_PARITY_ITERS = 32     # Griffin-Lim rounds of the card-against-CPU parity run
STREAM_MESH_SHARDS = 4
# the stream mesh against the streams run one by one on the same card (the
# shards' own computation: same kernels, same shapes), and against the
# unsharded batch (see phase_stream_mesh), relative to the peak
STREAM_MESH_SELF_TOL = 1e-6
STREAM_MESH_WAV_TOL = 1e-2
PARALLEL_WORLD = (2, 2)  # (n_data, n_model) of the parallel_train phase
PARALLEL_B = 32


def sp_devices(n: int) -> tuple[list[str], str]:
    """n distinct cards where there are that many, else cuda:0 n times."""
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)], f"{n} distinct cards"
    return [f"{DEV}:0"] * n, f"cuda:0 {n} times (one card)"


def phase_seq_parallel(ck, pipe, cpu_pipe, wav: np.ndarray) -> dict:
    """convert_seq_parallel of the 60 s clip over 1 and 4 shards (warmup
    SP_WARMUP): wall of a warm call (synchronized), RTF, peak memory, scan
    launches (exact), mel and stft against the card's unsharded forward of
    the padded sequence as one window (median within SP_MEDIAN_TOL); then a
    SP_PARITY_SECONDS clip at SP_PARITY_ITERS rounds on the card against the
    CPU port at the same shard count, within PARITY_TOL."""
    from speech_cloner_tpu_torch.ops import mfcc_input
    from speech_cloner_tpu_torch.parallel.mesh import make_seq_mesh

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    hop = pipe.feat_cfg.hop_length
    frames = len(wav) // hop + 1
    out = {"phase": "seq_parallel", "seconds_of_audio": len(wav) / 16000, "frames": frames,
           "warmup": SP_WARMUP, "runs": [], "parity": []}
    for n in SP_SHARDS:
        devices, placed = sp_devices(n)
        mesh = make_seq_mesh(n, devices=devices)
        pipe.convert_seq_parallel(wav, mesh=mesh, warmup=SP_WARMUP)      # warm
        sync()
        torch.cuda.reset_peak_memory_stats()
        walls, counts = [], {}
        for _ in range(REPEATS):
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            wav_pred, mel, stft = pipe.convert_seq_parallel(wav, mesh=mesh, warmup=SP_WARMUP)
            sync()
            walls.append(time.perf_counter() - t0)
            if counts and counts != {k: v for k, v in ck.launch_counts.items() if v}:
                raise AssertionError(f"seq_parallel: launches differ between calls: {counts}")
            counts = {k: v for k, v in ck.launch_counts.items() if v}
        wall = float(np.median(walls))
        per = -(-frames // n)
        with torch.inference_mode():
            mfcc = mfcc_input(torch.tensor(wav, device=DEV), pipe.feat_cfg)[0]
            mfcc = torch.nn.functional.pad(mfcc, (0, 0, 0, per * n - frames))
            mel_ref, stft_ref, _ = pipe.forward_windows(mfcc[None])
        mel_ref, stft_ref = (t[0, :frames].cpu().numpy() for t in (mel_ref, stft_ref))
        run = {"shards": n, "placed_on": placed, "frames_per_shard": per,
               "scan_T": per + min(SP_WARMUP, per), "edge_scan_T": min(SP_WARMUP, per),
               "wall_s": wall, "walls_s": walls, "rtf": wall / (len(wav) / 16000),
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": launch_names(counts), "launches_want": sp_launches(n),
               "mel_median_abs_vs_unsharded": float(np.median(np.abs(mel - mel_ref))),
               "stft_median_abs_vs_unsharded": float(np.median(np.abs(stft - stft_ref))),
               "mel_max_abs_vs_unsharded": float(np.abs(mel - mel_ref).max()),
               "stft_max_abs_vs_unsharded": float(np.abs(stft - stft_ref).max()),
               "out_len": int(wav_pred.shape[0])}
        out["runs"].append(run)
        ok = (counts == {("gru_scan", torch.float32): sp_launches(n),
                         ("conv_banks", torch.float32): BANK_LAUNCHES * n}
              and wav_pred.shape == (min(frames, per * n - 1) * hop,)
              and np.isfinite(wav_pred).all()
              and mel.shape == (frames, 80) and stft.shape == (frames, 201)
              and run["mel_median_abs_vs_unsharded"] < SP_MEDIAN_TOL
              and run["stft_median_abs_vs_unsharded"] < SP_MEDIAN_TOL)
        if not ok:
            emit(out)
            raise AssertionError(f"seq_parallel {n} shards: {run}")
    short = synthetic_clip(SP_PARITY_SECONDS, seed=5)
    gpu_p = dataclasses.replace(pipe, n_iter=SP_PARITY_ITERS)
    cpu_p = dataclasses.replace(cpu_pipe, n_iter=SP_PARITY_ITERS)
    for n in SP_SHARDS:
        devices, _ = sp_devices(n)
        t_pad = -(-(len(short) // hop + 1) // n) * n
        phase0 = (np.pi * np.random.default_rng(6).random((t_pad, 201))).astype(np.float32)
        got = gpu_p.convert_seq_parallel(short, mesh=make_seq_mesh(n, devices=devices),
                                         warmup=SP_WARMUP, init_phase=phase0)
        ref = cpu_p.convert_seq_parallel(short, n_devices=n, warmup=SP_WARMUP, init_phase=phase0)
        row = {"shards": n, "seconds": SP_PARITY_SECONDS, "n_iter": SP_PARITY_ITERS}
        for name, g, r in zip(("wav", "mel", "stft"), got, ref):
            row[f"{name}_rel"] = float(np.abs(g - r).max() / np.abs(r).max())
        out["parity"].append(row)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    bad = [(r["shards"], k, r[f"{k}_rel"]) for r in out["parity"] for k in ("wav", "mel", "stft")
           if not r[f"{k}_rel"] <= PARITY_TOL[k]]
    if bad:
        raise AssertionError(f"seq_parallel card against CPU: {bad} over {PARITY_TOL}")
    return out


def phase_sp_kernel(ck, sp: dict) -> list[dict]:
    """The float32 scan at the sequence-parallel shapes the seq_parallel phase
    launched (T = a shard's frames + warmup, and the edge scans' T =
    warmup; B = 1; H = 40, 128, 256) against its plain version, timed, with
    the bound."""
    t_phase = time.perf_counter()
    gen = torch.Generator(DEV).manual_seed(4)
    limits = ck.device_limits(torch.cuda.current_device())
    Ts = sorted({r["scan_T"] for r in sp["runs"]} | {r["edge_scan_T"] for r in sp["runs"]})
    rows = []
    for T in Ts:
        for H in (40, 128, 256):
            (gx, cx, Wg, Wc), packed, diff = check_scan(ck, gen, torch.float32, T, 1, H)
            ms = cuda_ms(lambda: ck.gru_scan(gx, cx, Wg, Wc, packed), n=3, warmup=1)
            plain_ms = cuda_ms(lambda: ck.gru_scan_plain(gx, cx, Wg, Wc), n=1, warmup=0)
            b = gru_bound(T, 1, H)
            row = {"dtype": "float32", "H": H, "B": 1, "T": T, "max_abs_err": diff.max().item(),
                   "tolerance": KERNEL_TOL[torch.float32], "ms": ms,
                   "us_per_step": ms * 1000 / T, "plain_ms": plain_ms,
                   "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                   "share_of_bound": b["bound_ms"] / ms,
                   "plan": plan_row(ck.gru_scan_plan(H, 1, *limits))}
            emit({"phase": "sp_kernel", **row})
            rows.append(row)
    emit({"phase": "sp_kernel", "phase_s": time.perf_counter() - t_phase})
    return rows


def phase_stream_mesh(ck, pipe) -> dict:
    """StreamingCloner(batch=4, mesh=4 shards), a 12 s clip a chunk a push,
    against (1) four single-stream cloners (seeds 0-3, the mesh shards'
    own computation: one stream a shard on the same card), the waveform
    within STREAM_MESH_SELF_TOL of the peak; (2) batch=4 unsharded on the
    card: the spectrogram within PARITY_TOL["stft"], the waveform within
    STREAM_MESH_WAV_TOL (a B = 4 GEMM sums in another order than four B = 1
    ones, and 25 momentum-0.99 Griffin-Lim rounds amplify a ~1e-6
    spectrogram gap some thousandfold: 7.0e-7 -> 2.0e-3 in a CPU rehearsal
    of this phase). ms of a steady step of each; the mesh run's launches
    (STREAM_LAUNCHES a shard a step, exact)."""
    from speech_cloner_tpu_torch.parallel.mesh import make_seq_mesh
    from speech_cloner_tpu_torch.pipeline.stream import StreamingCloner

    t_phase = time.perf_counter()
    p = stream_pipes(pipe)
    devices, placed = sp_devices(STREAM_MESH_SHARDS)
    mesh = make_seq_mesh(STREAM_MESH_SHARDS, devices=devices, axis_name="streams")
    clip = synthetic_clip(12.0, seed=41)
    x = np.stack([np.roll(clip, 1600 * i) * (0.5 + 0.1 * i) for i in range(4)])
    block = STREAM_GEOMETRY["chunk_frames"] * 80

    def run(rows, **kw):
        s = StreamingCloner(p, collect_debug=True, **STREAM_GEOMETRY, **kw)
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        outs, steps = [], []
        for i in range(0, x.shape[1], block):
            f0 = s._f0
            t0 = time.perf_counter()
            outs.append(s.push(rows[..., i:i + block]))
            if outs[-1].shape[-1]:
                steps.append((f0, (time.perf_counter() - t0) * 1e3))
        outs.append(s.flush())
        counts = {k: v for k, v in ck.launch_counts.items() if v}
        steady = [ms for f0, ms in steps if f0 >= STREAM_GEOMETRY["context_frames"] + 4][1:]
        return (np.concatenate(outs, axis=-1), np.concatenate(s.debug_stft, axis=-2),
                float(np.median(steady)), counts, len(steps) + 1)

    bw, bs, bms, _, _ = run(x, batch=4)
    mw, ms_, mms, counts, n_steps = run(x, batch=4, mesh=mesh)
    singles = [run(x[i], seed=i) for i in range(4)]
    sw = np.stack([r[0] for r in singles])
    out = {"phase": "stream_mesh", "shards": STREAM_MESH_SHARDS, "placed_on": placed,
           "batch": 4, "seconds": 12.0,
           "wav_rel_vs_single_streams": float(np.abs(mw - sw).max() / np.abs(sw).max()),
           "wav_max_abs_vs_unsharded": float(np.abs(mw - bw).max()),
           "wav_rel_vs_unsharded": float(np.abs(mw - bw).max() / np.abs(bw).max()),
           "stft_rel_vs_unsharded": float(np.abs(ms_ - bs).max() / np.abs(bs).max()),
           "tolerance": {"self": STREAM_MESH_SELF_TOL, "stft": PARITY_TOL["stft"],
                         "wav": STREAM_MESH_WAV_TOL},
           "jax_mesh_gap_guide": 2.04e-6, "ms_per_steady_step": mms,
           "unsharded_ms_per_steady_step": bms,
           "single_stream_ms_per_steady_step": singles[0][2], "launches": launch_names(counts),
           "launches_want": STREAM_LAUNCHES * STREAM_MESH_SHARDS * n_steps,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    if not (out["wav_rel_vs_single_streams"] <= STREAM_MESH_SELF_TOL
            and out["stft_rel_vs_unsharded"] <= PARITY_TOL["stft"]
            and out["wav_rel_vs_unsharded"] <= STREAM_MESH_WAV_TOL) or \
            counts != {("gru_scan", torch.float32): out["launches_want"],
                       ("conv_banks", torch.float32): BANK_LAUNCHES * STREAM_MESH_SHARDS * n_steps}:
        raise AssertionError(f"stream_mesh: {out}")
    return out


def parallel_rank(rank: int, world: int, app_argv: list[str], batch) -> dict:
    """One rank of the parallel_train world (a process of its own): the
    encoder app's DP + TP run over ``app_argv`` with its train steps timed
    (synchronized) and its launches counted; then one encoder and one
    decoder train step at full width on this rank's rows of
    train_parity_setup's batch (the gradients gathered), and three more on
    its rows of ``batch``, the last two timed."""
    from speech_cloner_tpu_torch.apps import train_encoder
    from speech_cloner_tpu_torch.ops import cuda_kernels as ck
    from speech_cloner_tpu_torch.parallel.mesh import make_mesh
    from speech_cloner_tpu_torch.parallel.sharding import gather_tree
    from speech_cloner_tpu_torch.runtime.config import float32_products

    torch.cuda.set_device(0)
    float32_products(DEV)
    times = []
    real = train_encoder.encoder_train_step

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(*a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return res
    train_encoder.encoder_train_step = timed
    ck.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        train_encoder.main(app_argv)
    app_counts = launch_names(ck.launch_counts)
    train_encoder.encoder_train_step = real

    mesh = make_mesh(*PARALLEL_WORLD, device=torch.device(DEV, 0))
    ck.reset_launch_counts()
    out = {"app_step_ms": [t * 1e3 for t in times], "app_launches": app_counts}
    for name in ("encoder", "decoder"):
        loss, model, _ = parallel_step(name, train_parity_setup()[3], mesh)
        grads = gather_tree(grad_tree(model), mesh, "params")
        loss_b, _, ms = parallel_step(name, batch, mesh, timed=2)
        out[name] = {"loss": loss, "grads": leaf_paths(jax_layout_host(grads)) if rank == 0
                     else None, "loss_b": loss_b, "ms_per_step": ms}
    out["step_launches"] = launch_names(ck.launch_counts)
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return out


def grad_tree(model):
    from speech_cloner_tpu_torch.runtime.tree import tree_map

    return tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                    model.params_tree())


def jax_layout_host(tree):
    from speech_cloner_tpu_torch.runtime.tree import tree_map

    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy().copy(), tree)


def parallel_step(name: str, batch, mesh=None, timed: int = 0, setup=train_parity_setup):
    """A ``name`` train step at full width (``setup``'s weights and configs,
    dropout 0, epoch 300) on the card, on ``batch`` (mfcc, phn, mel, stft):
    under ``mesh`` on this rank's rows, the model sharded; then ``timed``
    more steps. Returns (the first step's loss, the model with its
    gradients, ms per timed step (median) or None)."""
    from speech_cloner_tpu_torch.parallel.sharding import shard_module
    from speech_cloner_tpu_torch.runtime.jax_params import decoder_from_jax, encoder_from_jax
    from speech_cloner_tpu_torch.train import (
        DecoderLossConfig, OptimizerConfig, decoder_train_step, encoder_train_step,
        make_train_state)

    enc_cfg, dec_cfg, ((ep, es), (dp, ds)), _ = setup()
    mfcc, phn, mel, stft = batch
    if mesh is not None:
        b = mfcc.shape[0] // mesh.n_data
        rows = slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
        mfcc, phn, mel, stft = (a[rows] for a in (mfcc, phn, mel, stft))
    opt_cfg = OptimizerConfig()
    if name == "encoder":
        model = encoder_from_jax(ep, es, enc_cfg, DEV)
        ts = {}

        def run(t):
            return encoder_train_step(t, mfcc, phn, model=model, opt_cfg=opt_cfg,
                                      opt=opt_cfg.make())
    else:
        frozen = encoder_from_jax(ep, es, enc_cfg, DEV).requires_grad_(False)
        model = decoder_from_jax(dp, ds, dec_cfg, DEV)
        ts = {"epoch": np.int32(300)}

        def run(t):
            return decoder_train_step(t, mfcc, mel, stft, encoder=frozen, model=model,
                                      loss_cfg=DecoderLossConfig(), opt_cfg=opt_cfg,
                                      opt=opt_cfg.make())
    if mesh is not None:
        shard_module(model, mesh)
    ts, m = run({**make_train_state(model, opt_cfg, 1), **ts})
    loss = float(m["loss"])
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = run(ts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return loss, model, float(np.median(times)) * 1e3 if times else None


def phase_parallel_train(ck, root: Path, cpu_steps: dict) -> dict:
    """apps.train_encoder at full width on the workflow's corpus, batch 32,
    TRAIN_STEPS steps, single-process and as a 2 x 2 world (--n-data 2
    --n-model 2 --dist-backend gloo, every rank on the card(s) of
    sp_devices): the world's first logged loss within PARITY_TRAIN_TOL of
    the single run's, its launches (each rank's STEP_LAUNCHES x steps).
    Then, in the same world, one encoder and one decoder train step at full
    width on train_parity's batch (B = 4: one row pair a data rank) held by
    train_parity's rule to the CPU steps ``cpu_steps`` (the loss within
    PARITY_TRAIN_TOL of the CPU float32 one, each gradient leaf within
    PARITY_TRAIN_TOL plus PARITY_F32_FACTOR times the CPU float32 gradient's
    own distance, relative L2, from the CPU float64 one), and three steps
    at batch PARALLEL_B (the decoder's the multichip dry-run analogue): the
    first loss within PARITY_TRAIN_TOL of the single-process step on the
    card, ms a step. The world runs in processes of its own (its gloo
    all-reduces pass through the host on one card, so its step times say
    nothing of a multi-card run)."""
    from speech_cloner_tpu_torch.apps import train_encoder
    from speech_cloner_tpu_torch.parallel.distributed import spawn_world

    t_phase = time.perf_counter()
    n_data, n_model = PARALLEL_WORLD
    world = n_data * n_model
    devices, placed = sp_devices(world)
    common = ["--ds-path", str(root / "synth" / "timit"), "--batch-size", str(TRAIN_B),
              "--max-steps", str(TRAIN_STEPS), "--bn-recal", "0", "--save-each-n-epochs", "1000",
              "--steps-per-call", "1", "--seed", "0", "--device", DEV]
    single = run_app(ck, train_encoder, "encoder", False,
                     common + ["--model-path", str(root / "par1"), "--log-dir",
                               str(root / "par1_logs")], None)
    mesh_argv = common + ["--model-path", str(root / "par4"), "--log-dir",
                          str(root / "par4_logs"), "--n-data", str(n_data), "--n-model",
                          str(n_model), "--rank-devices", ",".join(devices),
                          "--dist-backend", "gloo"]
    enc_cfg, _, _, _ = train_parity_setup()
    rng = np.random.default_rng(8)
    T = enc_cfg.n_timesteps
    batch = (rng.uniform(-1, 1, (PARALLEL_B, T, enc_cfg.input_dim)).astype(np.float32),
             np.eye(61, dtype=np.float32)[rng.integers(0, 61, (PARALLEL_B, T))],
             rng.uniform(0, 1, (PARALLEL_B, T, 80)).astype(np.float32),
             rng.uniform(0, 1, (PARALLEL_B, T, 201)).astype(np.float32))
    t0 = time.perf_counter()
    ranks = spawn_world(parallel_rank, world, mesh_argv, batch, backend="gloo")
    world_s = time.perf_counter() - t0

    def first_loss(logs: Path) -> float:
        return json.loads((logs / "trn.jsonl").read_text().splitlines()[0])["loss"]
    loss1, loss4 = first_loss(root / "par1_logs"), first_loss(root / "par4_logs")
    app_launches = add_counts({}, *[r["app_launches"] for r in ranks])
    step_launches = add_counts({}, *[r["step_launches"] for r in ranks])
    want_app = {f"{k}:float32": world * TRAIN_STEPS * v
                for k, v in STEP_LAUNCHES[("encoder", False)].items()}
    out = {"phase": "parallel_train", "world": {"data": n_data, "model": n_model},
           "backend": "gloo", "placed_on": placed, "world_wall_s": world_s,
           "note": "one card: every gloo all-reduce is staged through the host; these step "
                   "times say nothing of a multi-card run",
           "app": {"first_loss_single": loss1, "first_loss_world": loss4,
                   "loss_rel": abs(loss4 - loss1) / abs(loss1),
                   "single_ms_per_step": single["ms_per_step"],
                   "world_ms_per_step_rank0": float(np.median(ranks[0]["app_step_ms"][1:])),
                   "launches": app_launches, "launches_want": want_app},
           "launches": add_counts(dict(app_launches), step_launches), "steps": {}}
    bad = []
    if not out["app"]["loss_rel"] <= PARITY_TRAIN_TOL or app_launches != want_app:
        bad.append(("app", out["app"]))
    for name in ("encoder", "decoder"):
        c32_loss, c32 = cpu_steps["float32"][name]
        c64 = cpu_steps["float64"][name][1]
        got = ranks[0][name]["grads"]
        rows = {p: (rel_l2(got[p], c), rel_l2(c32[p], c)) for p, c in c64.items()}
        worst = max(rows, key=lambda p: rows[p][0] - PARITY_F32_FACTOR * rows[p][1])
        loss_b = parallel_step(name, batch)[0]
        out["steps"][name] = {
            "loss_cpu": c32_loss, "loss_world": [r[name]["loss"] for r in ranks],
            "loss_rel": max(abs(r[name]["loss"] - c32_loss) / abs(c32_loss) for r in ranks),
            "grad_leaves": len(rows), "world_vs_f64_max_rel_l2": max(g for g, _ in rows.values()),
            "cpu_f32_vs_f64_max_rel_l2": max(c for _, c in rows.values()),
            "worst_leaf": [worst, *rows[worst]],
            f"loss_b{PARALLEL_B}_single": loss_b,
            f"loss_b{PARALLEL_B}_world": [r[name]["loss_b"] for r in ranks],
            f"loss_b{PARALLEL_B}_rel": max(abs(r[name]["loss_b"] - loss_b) / abs(loss_b)
                                           for r in ranks),
            f"world_ms_per_step_b{PARALLEL_B}": [r[name]["ms_per_step"] for r in ranks]}
        st = out["steps"][name]
        if not (st["loss_rel"] <= PARITY_TRAIN_TOL
                and st[f"loss_b{PARALLEL_B}_rel"] <= PARITY_TRAIN_TOL):
            bad.append((name, "loss", st["loss_rel"], st[f"loss_b{PARALLEL_B}_rel"]))
        bad += [(name, p, g, c) for p, (g, c) in rows.items()
                if not g <= PARITY_TRAIN_TOL + PARITY_F32_FACTOR * c]
    out["max_memory_allocated_bytes_rank0"] = ranks[0]["max_memory_allocated_bytes"]
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"parallel_train: {bad}")
    return out


# ------------------------------------------------------------------- the rest ---

LSTM_TRAIN_B = 32
ATTENTION_SHAPE = dict(B=4, T_out=100, T_mem=400, in_dim=80, M=256, H=256)
REAL_DEMO_NARRATION_S = 42.0   # >= 40 s: 7 chunks of ~6 s, 5 to train, 2 held out
REAL_DEMO_VERIFY_UTTS = 4


def phase_lstm(ck, path: dict, wav: np.ndarray) -> dict:
    """make_pipeline with every CBHG's LSTM branch on (EncoderConfig and
    DecoderConfig at full width, use_lstm), seed-0 weights: a warm
    convert_pcm16 of the 60 s clip REPEATS times (wall, RTF against the GRU
    path's, no scan launched), the predict split, peak memory, a profile
    (the LSTM loop's kernel launches, device idle share); mel, stft and ppg
    on the 3 parity windows against the CPU within PARITY_TOL; one float32
    encoder and one decoder train step at batch LSTM_TRAIN_B against the
    CPU's float32 and float64 steps by train_parity's rule (forget biases
    included), and ms per step."""
    from speech_cloner_tpu_torch.models import DecoderConfig, EncoderConfig
    from speech_cloner_tpu_torch.pipeline import make_pipeline

    enc_cfg, dec_cfg = with_lstm(EncoderConfig(), DecoderConfig())
    settings = dict(seed=0, n_iter=200, realse=1.2, gl_dft="matmul")
    pipe = make_pipeline(enc_cfg, dec_cfg, device=DEV, **settings)
    cpu_pipe = make_pipeline(enc_cfg, dec_cfg, device="cpu", **settings)
    seconds = len(wav) / 16000
    pipe.convert_pcm16(wav[:16000])
    pipe.convert_pcm16(wav)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = timed_calls(ck, lambda: pipe.convert_pcm16(wav), torch.float32, want_launches=0)[0]
    launches = launch_names(ck.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    predict = []
    with torch.inference_mode():
        wav_d = pipe.pad_wav(wav)
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.device_predict(wav_d)
            torch.cuda.synchronize()
            predict.append(time.perf_counter() - t0)
    prof = profile_call(lambda: pipe.convert_pcm16(wav), "lstm_profile", "convert_pcm16")[0]
    emit(prof)
    wall = float(np.median(walls))
    out = {"phase": "lstm", "seconds_of_audio": seconds, "convert_pcm16_wall_s": wall,
           "walls_s": walls, "rtf": wall / seconds, "gru_path_wall_s":
           path["convert_pcm16"]["wall_s"], "gru_path_rtf": path["convert_pcm16"]["rtf"],
           "predict_s": float(np.median(predict)), "max_memory_allocated_bytes": peak,
           "launches": launches, "device_launches_per_convert": prof["device_launches"],
           "device_idle_share": prof["idle_share"], "tolerance_rel": PARITY_TOL}
    window_parity(pipe, cpu_pipe, wav, out)
    del pipe, cpu_pipe

    setup = lambda: train_parity_setup(use_lstm=True, B=LSTM_TRAIN_B)  # noqa: E731
    batch = setup()[3]
    ck.reset_launch_counts()
    card = {}
    for name in ("encoder", "decoder"):
        loss, model, _ = parallel_step(name, batch, setup=setup)
        grads = leaf_paths(jax_layout_host(grad_tree(model)))
        ms = parallel_step(name, batch, timed=2, setup=setup)[2]
        card[name] = (loss, grads, ms)
    train_launches = launch_names(ck.launch_counts)
    cpu = {dt: port_train_grads("cpu", dt, setup=setup) for dt in (torch.float32, torch.float64)}
    bad = [(k, out[f"{k}_rel"]) for k in ("mel", "stft", "ppg")
           if not out[f"{k}_rel"] <= PARITY_TOL[k]]
    scans = [k for k in (*launches, *train_launches) if k.startswith("gru_scan")]
    if scans or launches != {"conv_banks:float32": BANK_LAUNCHES,
                             "gl_round:float32": GL_CONVERT_ROUNDS}:
        bad.append(("launches", launches, train_launches))
    out["train"] = {"batch": LSTM_TRAIN_B}
    for name, (loss, grads, ms) in card.items():
        c32_loss, c32 = cpu[torch.float32][name]
        c64 = cpu[torch.float64][name][1]
        rows = {p: (rel_l2(grads[p], c), rel_l2(c32[p], c)) for p, c in c64.items()}
        worst = max(rows, key=lambda p: rows[p][0] - PARITY_F32_FACTOR * rows[p][1])
        fb = {p: rows[p] for p in rows if p.endswith("forget_bias")}
        out["train"][name] = {
            "ms_per_step": ms, "loss_gpu": loss, "loss_cpu": c32_loss,
            "loss_rel": abs(loss - c32_loss) / abs(c32_loss), "grad_leaves": len(rows),
            "gpu_vs_f64_max_rel_l2": max(g for g, _ in rows.values()),
            "cpu_f32_vs_f64_max_rel_l2": max(c for _, c in rows.values()),
            "worst_leaf": [worst, *rows[worst]], "forget_bias_leaves": fb}
        if not out["train"][name]["loss_rel"] <= PARITY_TRAIN_TOL or len(fb) != (
                2 if name == "encoder" else 4):
            bad.append((name, "loss or forget biases", out["train"][name]))
        bad += [(name, p, g, c) for p, (g, c) in rows.items()
                if not g <= PARITY_TRAIN_TOL + PARITY_F32_FACTOR * c]
    out["train"]["launches"] = train_launches
    emit(out)
    if bad:
        raise AssertionError(f"lstm: {bad}")
    return out


def phase_extras(ck, pipe, wav: np.ndarray, work: Path) -> dict:
    """The attention module at ATTENTION_SHAPE, card against CPU (outputs
    and alignments within PARITY_TOL's mel limit of their peak; the
    embedding's lookup exact), CUDA-event ms; runtime.profiler.trace around
    one convert_pcm16 of the GRU pipeline: the trace file under ``work``
    names the scan kernel and the spanned region, 6 scan launches;
    device_memory_stats reads bytes in use on cuda:0."""
    from speech_cloner_tpu_torch.nn.attention import (AttentionDecoder, Embed,
                                                      attention_decoder_init, embed_init)
    from speech_cloner_tpu_torch.runtime import profiler

    a = ATTENTION_SHAPE
    g = torch.Generator().manual_seed(0)
    dec = AttentionDecoder(attention_decoder_init(g, a["in_dim"], a["M"], a["H"]))
    x = torch.randn(a["B"], a["T_out"], a["in_dim"], generator=g)
    memory = torch.randn(a["B"], a["T_mem"], a["M"], generator=g)
    emb = Embed(embed_init(g, 61, a["H"]))
    ids = torch.randint(0, 61, (a["B"], a["T_out"]), generator=g)
    res = {"phase": "extras", "attention_shape": a, "tolerance_rel": PARITY_TOL["mel"]}
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = dec(x, memory)
        res["attention_cpu_ms"] = (time.perf_counter() - t0) * 1e3
        emb_ref = emb(ids)
        dec_d, x_d, mem_d, emb_d = dec.to(DEV), x.to(DEV), memory.to(DEV), emb.to(DEV)
        got = dec_d(x_d, mem_d)
        res["attention_ms"] = cuda_ms(lambda: dec_d(x_d, mem_d), 3)
        for name, gv, rv in zip(("outputs", "alignments"), got, ref):
            res[f"{name}_max_abs"], res[f"{name}_rel"] = max_rel(gv, rv)
        res["embed_exact"] = bool(torch.equal(emb_d(ids.to(DEV)).cpu(), emb_ref))

    trace_dir = work / "trace"
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with profiler.trace(str(trace_dir), device=DEV):
        with profiler.span("extras_convert"):
            pipe.convert_pcm16(wav)
            torch.cuda.synchronize()
    res["traced_convert_wall_s"] = time.perf_counter() - t0
    res["launches"] = launch_names(ck.launch_counts)
    files = sorted(trace_dir.glob("*.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
    res["trace_file_bytes"] = files[0].stat().st_size if files else 0
    res["trace_scan_kernels"] = sum(1 for e in events if e.get("cat") == "kernel"
                                    and "gru_scan" in e.get("name", ""))
    res["trace_has_region"] = any(e.get("name") == "extras_convert" for e in events)
    stats = profiler.device_memory_stats()
    res["device_memory_stats"] = stats
    emit(res)
    bad = [k for k in ("outputs", "alignments") if not res[f"{k}_rel"] <= PARITY_TOL["mel"]]
    if not (res["embed_exact"] and res["trace_has_region"]
            and res["trace_scan_kernels"] == CONVERT_LAUNCHES
            and res["launches"] == convert_launches(1, GL_CONVERT_ROUNDS)
            and stats["cuda:0"]["bytes_in_use"] > 0) or bad:
        raise AssertionError(f"extras: {bad} {res}")
    return res


def phase_real_demo(ck, root: Path) -> dict:
    """The real-voice demo on the workflow's corpus under ``root``: a
    REAL_DEMO_NARRATION_S "narration" of the synthetic ARCTIC 'bdl' voice
    (its utterances end to end) through apps.make_narrator_corpus into a
    target corpus and the TIMIT tree (speaker FNARR0, class NARR0); apps.train_decoder
    --ds-kind target on it from the workflow's encoder and
    apps.train_speaker_id on the grown tree (TRAIN_STEPS / SPEAKER_STEPS
    steps, batch 32, launches exact); then apps.real_demo with --spk-ckpt
    over the two held-out chunks and REAL_DEMO_VERIFY_UTTS TIMIT test
    utterances: the report's keys, finite losses, CONVERT_LAUNCHES scans a
    convert (exact); each stage's wall."""
    from speech_cloner_tpu_torch.apps import (make_narrator_corpus, real_demo, train_decoder,
                                              train_speaker_id)
    from speech_cloner_tpu_torch.data.audio_io import load_audio, write_riff_wav
    from speech_cloner_tpu_torch.pipeline.clone import ClonePipeline

    synth, real = root / "synth", root / "real"
    src = real / "source"
    src.mkdir(parents=True)
    walls, total = {}, {}
    parts, n = [], 0
    for f in sorted((synth / "arctic" / "cmu_us_bdl_arctic" / "wav").glob("*.wav")):
        if n >= REAL_DEMO_NARRATION_S * 16000:
            break
        parts.append(load_audio(str(f)))
        n += len(parts[-1])
    write_riff_wav(str(real / "narration.wav"), np.concatenate(parts), 16000, norm=False)
    for f in sorted((synth / "timit" / "TEST").rglob("*.WAV"))[:REAL_DEMO_VERIFY_UTTS]:
        shutil.copy(f, src / f"{f.parent.name}_{f.stem}.wav")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        make_narrator_corpus.main(["--clip", str(real / "narration.wav"), "--out-dir", str(real),
                                   "--timit-dir", str(synth / "timit")])
    walls["narrator_corpus_s"] = time.perf_counter() - t0
    common = ["--batch-size", str(TRAIN_B), "--bn-recal", "0", "--seed", "0", "--device", DEV]
    t0 = time.perf_counter()
    dec_run = run_app(ck, train_decoder, "decoder", False,
                      ["--ds-path", str(real / "target"), "--ds-kind", "target", "--enc-ckpt",
                       str(root / "run" / "enc_ckpt"), "--model-path", str(real / "dec_ckpt"),
                       "--log-dir", str(real / "dl"), "--max-steps", str(TRAIN_STEPS),
                       "--save-each-n-epochs", "1000", "--loader", "h5py", *common], None)
    walls["train_decoder_s"] = time.perf_counter() - t0
    add_counts(total, dec_run["launches"])
    t0 = time.perf_counter()
    ck.reset_launch_counts()
    spk_run = run_speaker_app(train_speaker_id, ["--ds-path", str(synth / "timit"),
                                                 "--model-path", str(real / "spk_ckpt"),
                                                 "--max-steps", str(SPEAKER_STEPS), *common])
    spk_launches = launch_names(ck.launch_counts)
    walls["train_speaker_s"] = time.perf_counter() - t0
    converts = []

    def counted(real_convert):
        def convert(self, wav, seed=0):
            before = dict(ck.launch_counts)
            out = real_convert(self, wav, seed)
            converts.append(sum(counts_delta(ck, before).values()))
            return out
        return convert
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with patched(ClonePipeline, "convert", counted), \
            contextlib.redirect_stdout(io.StringIO()) as log:
        report = real_demo.main(["--heldout-dir", str(real / "heldout"), "--source-dir", str(src),
                                 "--enc-ckpt", str(root / "run" / "enc_ckpt"), "--dec-ckpt",
                                 str(real / "dec_ckpt"), "--spk-ckpt", str(real / "spk_ckpt"),
                                 "--target-timit-spk", "NARR0", "--out-dir",
                                 str(real / "demo"), "--verify-utts",
                                 str(REAL_DEMO_VERIFY_UTTS), "--device", DEV])
    torch.cuda.synchronize()
    walls["real_demo_s"] = time.perf_counter() - t0
    demo_launches = launch_names(ck.launch_counts)
    add_counts(total, demo_launches)
    tests = report.get("tests", {})
    v = report.get("verification", {})
    out = {"phase": "real_demo", "narration_s": n / 16000, "walls": walls,
           "target_files": len(list((real / "target").glob("*.wav"))),
           "heldout_files": len(list((real / "heldout").glob("*.wav"))),
           "decoder": {k: dec_run[k] for k in ("ms_per_step", "steps", "launches", "wall_s")},
           "speaker": {k: spk_run[k] for k in ("ms_per_step", "steps", "wall_s")},
           "speaker_launches": spk_launches, "converts": len(converts),
           "demo_launches": demo_launches, "report_tests": tests, "verification": v,
           "launches": total, "spec_png_skipped": "spec.png skipped" in log.getvalue()}
    emit(out)
    bad = []
    if set(report) != {"enc_ckpt", "dec_ckpt", "n_iter", "tests", "verification"} or set(
            tests) != {"test1_heldout_reconstruction", "test2_heldout_reconstruction",
                       "test3_source_conversion"}:
        bad.append(("report keys", sorted(report), sorted(tests)))
    if not all(math.isfinite(t[k]) for t in tests.values()
               for k in ("mel_loss", "stft_loss", "loss", "mcd_db")):
        bad.append(("losses", tests))
    if v.get("target_spk_id") != "NARR0" or "target_p_pred" not in v or "control_top" not in v:
        bad.append(("verification", v))
    if spk_launches or len(converts) != 2 + REAL_DEMO_VERIFY_UTTS or any(
            c != CONVERT_LAUNCHES + BANK_LAUNCHES for c in converts) or demo_launches != \
            convert_launches(len(converts)):
        bad.append(("launches", spk_launches, converts, demo_launches))
    if bad:
        raise AssertionError(f"real_demo: {bad}")
    return out


# the kernels line's name of each kernel form by operand dtype
KERNEL_NAMES = {**{(k, "float32"): k for k in ("gru_scan", *TRAIN_KERNELS)},
                ("gru_scan", "bfloat16"): "gru_scan_bf16",
                ("gru_scan_train", "bfloat16"): "gru_scan_bf16_train",
                ("gru_scan_bwd", "bfloat16"): "gru_scan_bwd_bf16",
                ("gru_scan_fused", "bfloat16"): "gru_scan_fused_bf16",
                ("gru_scan_fused_train", "bfloat16"): "gru_scan_fused_bf16_train",
                ("gru_scan_fused_bwd", "bfloat16"): "gru_scan_fused_bwd_bf16"}
# the training kernels' work: one encoder and one decoder train step
# (B = 32, T = 400), launches at each H per kernel form (the inference
# forward of both directions: the decoder step's frozen encoder)
STEP_WORK = {"gru_scan_train": {40: 2, 128: 2, 256: 2}, "gru_scan_bwd": {40: 2, 128: 2, 256: 2},
             "gru_scan_fused": {40: 1}, "gru_scan_fused_train": {40: 1, 128: 1, 256: 1},
             "gru_scan_fused_bwd": {40: 1, 128: 1, 256: 1}}


def kernels_line(rows: list[dict], path_rows: list[dict], convert_launches: int,
                 bf16_launches: int, train_rows: list[dict], train: dict,
                 stream_rows: list[dict], stream_launches: dict,
                 workflow_launches: dict, sp_rows: list[dict], sp: dict, banks: dict,
                 bank_convert_launches: int, gl: dict, gl_convert_launches: int) -> dict:
    """The {"kernels": [...]} object: each kernel form and operand dtype with
    its launches on its main paths (one convert, the train runs of that
    dtype, the streaming runs: the stream app's two, the stream server's,
    the capacity runs, by dtype and then by kernel in ``stream_launches``;
    and the workflow, loaders, evaluate, seq_parallel, stream_mesh,
    parallel_train, lstm, extras and real_demo phases, by phase in
    ``workflow_launches``: {phase: {"kernel:dtype": n}}), its error against
    the plain version, and its, the plain version's and the bound's ms for
    the work named in the entry (``sp_rows``: the scan at the
    sequence-parallel shapes of ``sp``'s runs; ``banks``: the banks_kernel
    phase, and ``bank_convert_launches`` its kernel's launches in one
    convert; ``gl``: the gl_round_kernel phase, and ``gl_convert_launches``
    its kernel's launches in one convert)."""

    def workflow(name: str, dtype: str) -> dict:
        return {ph: c.get(f"{name}:{dtype}", 0) for ph, c in workflow_launches.items()}
    per_step = {f"{app}{'_fused' if fused else ''}": launches
                for (app, fused), launches in STEP_LAUNCHES.items()}

    def train_launches(name: str, dtype: str) -> int:
        return sum(r["launches"].get(f"{name}:{dtype}", 0) for r in train["runs"])

    def head(name: str, dtype: str) -> dict:
        return {"name": KERNEL_NAMES[name, dtype], "route": "cuda",
                "source": "speech_cloner_tpu_torch/csrc/gru_scan.cu",
                "replaces": "speech_cloner_tpu/ops/pallas_kernels.py:46", "dtype": dtype}

    def kernel_entry(dtype: str, convert: int) -> dict:
        """The one-direction inference forward; ms for one convert's scans:
        fw and bw at H = 40, 128, 256, B = 2K-1 = 59."""
        main_rows = [r for r in rows if r["B"] == 59 and r["dtype"] == dtype]
        elem = 2 if dtype == "bfloat16" else 4
        ops_ms = sum(2 * gru_bound(T_STEPS, 59, r["H"], elem)["ops_ms"] for r in main_rows)
        bytes_ms = sum(2 * gru_bound(T_STEPS, 59, r["H"], elem)["bytes_ms"] for r in main_rows)
        in_train = train_launches("gru_scan", dtype)
        streaming = stream_launches[dtype]["gru_scan"]
        flow = workflow("gru_scan", dtype)
        return {
            **head("gru_scan", dtype),
            "launches": convert + in_train + sum(streaming.values()) + sum(flow.values()),
            "launches_by_path": {"convert": convert, "train": in_train, **streaming, **flow},
            "launches_note": f"one {dtype} convert, the {dtype} train runs' decoder steps' "
                             "frozen encoder (2 a step without --fused-gru), the "
                             f"{dtype} streaming runs ({STREAM_LAUNCHES} a stream step), "
                             "the workflow (frozen encoder, BN recalibration, validation, "
                             f"{CONVERT_LAUNCHES} a demo convert), loaders and evaluate "
                             "phases, the parallel phases (a sequence-parallel convert "
                             "over n shards: 3 x (2n + 2); the stream mesh: "
                             f"{STREAM_LAUNCHES} a shard a step; the 2 x 2 world's frozen "
                             "encoder), none in the lstm phase, the extras phase's traced "
                             "convert, and the real_demo phase (its decoder steps' frozen "
                             f"encoder, {CONVERT_LAUNCHES} a demo convert)",
            "max_abs_err": max(r["max_abs_err"] for r in rows + path_rows + stream_rows + sp_rows
                               if r["dtype"] == dtype and r.get("kernel", "gru_scan") == "gru_scan"),
            "ms": sum(2 * r["ms"] for r in main_rows),
            "f32_ms": (sum(2 * r["f32_ms"] for r in main_rows) if dtype == "bfloat16"
                       else None),
            "plain_ms": sum(2 * r["plain_ms"] for r in main_rows),
            "bound_ms": sum(2 * r["bound_ms"] for r in main_rows),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "library_note": "none: nn.GRU computes r*(W h), not (r*h) W",
            "work": f"the 6 scans of one 60 s convert, {dtype} operands: fw+bw at "
                    "H=40,128,256, B=59, T=400",
            "launches_per_train_step": {k: v.get("gru_scan", 0) for k, v in per_step.items()},
            "per_shape": [r for r in rows if r["dtype"] == dtype],
            "path_shapes_checked": [r for r in path_rows
                                    if r["dtype"] == dtype and r["kernel"] == "gru_scan"],
            "stream_step": {
                B: {key: sum(2 * r[key] for r in stream_rows if r["B"] == B and r["dtype"] == dtype)
                    for key in ("ms", "plain_ms", "bound_ms")}
                for B in STREAM_B},
            "stream_step_note": f"the {STREAM_LAUNCHES} scans of one steady stream step: fw+bw "
                                f"at H=40,128,256, T={STREAM_STEADY_T}, B streams",
            "stream_per_shape": [r for r in stream_rows if r["dtype"] == dtype],
            "seq_parallel_call": {
                run["shards"]: {key: sum(
                    (2 * run["shards"] if r["T"] == run["scan_T"] else 2) * r[key]
                    for r in sp_rows if r["T"] in (run["scan_T"], run["edge_scan_T"]))
                    for key in ("ms", "plain_ms", "bound_ms")}
                for run in sp["runs"]} if dtype == "float32" else None,
            "seq_parallel_note": "the scans of one 60 s convert_seq_parallel over n shards: "
                                 "per H = 40, 128, 256, 2n at T = a shard's frames + warmup "
                                 "and 2 edge scans at T = warmup, B = 1",
            "seq_parallel_per_shape": sp_rows if dtype == "float32" else None,
        }

    def train_entry(name: str, dtype: str) -> dict:
        krows = {r["H"]: r for r in train_rows if r["kernel"] == name and r["dtype"] == dtype}
        work = STEP_WORK[name]
        elem = 2 if dtype == "bfloat16" else 4
        total = lambda key: sum(n * krows[H][key] for H, n in work.items())  # noqa: E731
        b = [(n, train_bound(T_STEPS, TRAIN_B, H, krows[H]["dirs"], name.endswith("_bwd"), elem,
                             gates=name.endswith("_train"))) for H, n in work.items()]
        flow = workflow(name, dtype)
        return {
            **head(name, dtype),
            "launches": train_launches(name, dtype) + sum(flow.values()),
            "launches_by_path": {"train": train_launches(name, dtype), **flow},
            "launches_note": f"the {dtype} train runs' launches of this kernel, and the "
                             "workflow, loaders, parallel_train and real_demo phases' train "
                             "steps (none in the lstm phase)",
            "max_abs_err": max(r["max_abs_err"] for r in list(krows.values()) + path_rows
                               if r.get("kernel") == name and r["dtype"] == dtype),
            "max_err_rel_peak": max(r["max_err_rel_peak"] for r in krows.values()),
            "ms": total("ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("operations" if sum(n * x["ops_ms"] for n, x in b)
                         >= sum(n * x["bytes_ms"] for n, x in b) else "bytes"),
            "library_ms": None,
            "library_note": "none: no PyTorch call computes the TF GRU cell's scan or its "
                            "gradient",
            "work": "one encoder and one decoder train step's launches (B=32, T=400): "
                    + ", ".join(f"{n} at H={H}" for H, n in work.items()),
            "launches_per_train_step": {k: v.get(name, 0) for k, v in per_step.items()},
            "staged_widths": [H for H, r in krows.items() if r["plan"]["staged"]],
            "per_shape": list(krows.values()),
        }

    def banks_entry() -> dict:
        """The float32 bank kernel; ms for one convert's banks (B = 59, T =
        400 at the encoder's and both decoder steps' C and K), cuDNN's packed
        width-K conv as the library."""
        in_train = train_launches("conv_banks", "float32")
        streaming = stream_launches["float32"]["conv_banks"]
        flow = workflow("conv_banks", "float32")
        paths = banks["paths"]
        return {
            "name": "conv_banks", "route": "cuda",
            "source": "speech_cloner_tpu_torch/csrc/conv_banks.cu", "replaces": None,
            "replaces_note": "no Pallas kernel: the JAX package runs the banks as one packed "
                             "width-K lax.conv (speech_cloner_tpu/nn/modules.py)",
            "dtype": "float32",
            "launches": (bank_convert_launches + in_train + sum(streaming.values())
                         + sum(flow.values())),
            "launches_by_path": {"convert": bank_convert_launches, "train": in_train,
                                 **streaming, **flow},
            "launches_note": f"{BANK_LAUNCHES} a float32 model pass under inference_mode "
                             "(3 CBHG): one convert, the float32 streaming runs (3 a stream "
                             "step), the workflow and real_demo phases' demo converts, the "
                             "parallel phases (3 a sequence-parallel shard; 3 a stream-mesh "
                             "shard a step), the lstm phase's converts and the extras "
                             "phase's traced convert; none in bf16 or in training (the "
                             "train runs, the frozen encoder under no_grad, BN "
                             "recalibration, validation, evaluate)",
            "max_abs_err": max(r["max_abs_err"] for r in banks["rows"]),
            "ms": paths["offline"]["ms"],
            "plain_ms": paths["offline"]["plain_ms"],
            "bound_ms": paths["offline"]["bound_ms"],
            "bound_by": "operations",
            "library_ms": paths["offline"]["library_ms"],
            "library_note": "cuDNN's packed width-K conv (F.conv1d over all K taps), the "
                            "yardstick: the port runs it only for bf16 and training",
            "work": "the 3 bank launches of one 60 s convert: B=59, T=400 at (C, K) = "
                    + ", ".join(f"({C}, {K})" for C, K in BANK_STACKS),
            "stream_step": paths["stream"],
            "longform_clip": paths["longform"],
            "per_shape": banks["rows"],
        }

    def gl_entry() -> dict:
        """The Griffin-Lim round kernel; ms for one 60 s convert's rounds
        (T = 12001, B = 1), today's cuBLAS rounds as the library."""
        flow = workflow("gl_round", "float32")
        clip = next(r for r in gl["rows"] if (r["T"], r["B"]) == GL_SHAPES[0])
        return {
            "name": "gl_round", "route": "cuda",
            "source": "speech_cloner_tpu_torch/csrc/griffin_lim.cu", "replaces": None,
            "replaces_note": "no Pallas kernel: the JAX package's Griffin-Lim is jnp matmuls "
                             "(speech_cloner_tpu/ops/griffin_lim.py)",
            "dtype": "float32",
            "launches": gl_convert_launches + sum(flow.values()),
            "launches_by_path": {"convert": gl_convert_launches, **flow},
            "launches_note": f"{GL_CONVERT_ROUNDS} a convert with the matmul DFT and no "
                             "momentum (the path, batch, serve, bf16, lstm and extras "
                             "phases' pipelines); none with the FFT DFT (the streams, the "
                             "pipelines' default in the workflow and demos, the "
                             "sequence-parallel loop) or Fast Griffin-Lim momentum (training's "
                             "vocoded augmentation)",
            "max_err_rel_peak": max(max(r[f"max_err_rel_peak_{n}"]["plain"],
                                        r[f"max_err_rel_peak_{n}"]["library"])
                                    for r in gl["rows"] for n in GL_ROUNDS),
            "ms": GL_CONVERT_ROUNDS * clip["ms"],
            "plain_ms": GL_CONVERT_ROUNDS * clip["plain_ms"],
            "bound_ms": GL_CONVERT_ROUNDS * clip["bound_ms"],
            "bound_by": "operations",
            "library_ms": GL_CONVERT_ROUNDS * clip["library_ms"],
            "library_note": "today's rounds through istft / stft with the matmul DFT "
                            "(cuBLAS float32 GEMMs and element-wise launches), the yardstick",
            "work": f"the {GL_CONVERT_ROUNDS} rounds of one 60 s convert: B=1, T=12001",
            "batch_bits_equal": gl["batch_bits_equal"],
            "per_shape": gl["rows"],
        }

    return {"kernels": [*(entry for dtype, convert in (("float32", convert_launches),
                                                       ("bfloat16", bf16_launches))
                          for entry in (kernel_entry(dtype, convert),
                                        *(train_entry(n, dtype) for n in TRAIN_KERNELS))),
                        banks_entry(), gl_entry()]}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from speech_cloner_tpu_torch.models import DecoderConfig, EncoderConfig
        from speech_cloner_tpu_torch.ops import cuda_kernels as ck
        from speech_cloner_tpu_torch.pipeline import make_pipeline
    except ImportError as e:
        print(f"chip_smoke: the speech_cloner_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 1

    phase_env()
    phase_build(ck)
    banks = phase_banks_kernel(ck)
    gl = phase_gl_round_kernel(ck)
    rows = phase_kernel(ck)

    settings = dict(seed=0, n_iter=200, realse=1.2, gl_dft="matmul")
    pipe = make_pipeline(EncoderConfig(), DecoderConfig(), device=DEV, **settings)
    wav = synthetic_clip(60.0)
    path = phase_path(ck, pipe, wav)
    phase_profile(pipe, wav)
    cpu_pipe = make_pipeline(EncoderConfig(), DecoderConfig(), device="cpu", **settings)
    phase_parity(pipe, cpu_pipe, wav)
    phase_batch(ck, pipe)
    bf16 = phase_bf16(ck, pipe, cpu_pipe, wav)
    phase_serve(ck, pipe)
    sp = phase_seq_parallel(ck, pipe, cpu_pipe, wav)
    stream_work = Path(__file__).resolve().parent / "build" / "stream_smoke"
    shutil.rmtree(stream_work, ignore_errors=True)
    stream_work.mkdir(parents=True)
    stream_flags = stream_checkpoints(stream_work)
    stream = phase_stream(ck, stream_work, stream_flags)
    phase_stream_parity(pipe, cpu_pipe)
    serve_stream = phase_serve_stream(ck, pipe, stream_flags)
    capacity = phase_stream_capacity(ck, pipe)
    stream_mesh = phase_stream_mesh(ck, pipe)
    shutil.rmtree(stream_work, ignore_errors=True)
    stream_rows = phase_stream_kernel(ck)
    sp_rows = phase_sp_kernel(ck, sp)
    train_rows = phase_train_kernel(ck)
    work = Path(__file__).resolve().parent / "build" / "train_smoke"
    shutil.rmtree(work, ignore_errors=True)
    train = phase_train(ck, work)
    _, cpu_steps = phase_train_parity()
    phase_speaker(work)
    shutil.rmtree(work, ignore_errors=True)
    flow_root = Path(__file__).resolve().parent / "build" / "workflow_smoke"
    shutil.rmtree(flow_root, ignore_errors=True)
    flow_root.mkdir(parents=True)
    t_flow = time.perf_counter()
    flow = phase_workflow(ck, flow_root)
    loaders = phase_loaders(ck, flow_root)
    evaluated = phase_evaluate(ck, flow_root)
    emit({"phase": "workflow_wall", "seconds": time.perf_counter() - t_flow})
    parallel = phase_parallel_train(ck, flow_root, cpu_steps)
    lstm = phase_lstm(ck, path, wav)
    extras = phase_extras(ck, pipe, wav, flow_root)
    demo = phase_real_demo(ck, flow_root)
    shutil.rmtree(flow_root, ignore_errors=True)
    path_rows = phase_path_shapes(ck, rows + stream_rows + sp_rows, train_rows)

    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    stream_launches = {
        dtype: {kernel: {"stream": sum(stream[run]["launches"].get(f"{kernel}:{dtype}", 0)
                                       for run in ("offline", "realtime")),
                         "serve_stream": serve_stream["launches"].get(f"{kernel}:{dtype}", 0),
                         "stream_capacity": sum(r["launches"].get(f"{kernel}:{dtype}", 0)
                                                for r in capacity["runs"])}
                for kernel in ("gru_scan", "conv_banks")}
        for dtype in ("float32", "bfloat16")}
    emit(kernels_line(rows, path_rows, path["convert"]["gru_scan_launches"],
                      bf16["gru_scan_launches"], train_rows, train, stream_rows,
                      stream_launches, {"workflow": flow["launches"],
                                        "loaders": loaders["launches"],
                                        "evaluate": evaluated["launches"],
                                        "seq_parallel": add_counts(
                                            {}, *[r["launches"] for r in sp["runs"]]),
                                        "stream_mesh": stream_mesh["launches"],
                                        "parallel_train": parallel["launches"],
                                        "lstm": add_counts({}, lstm["launches"],
                                                           lstm["train"]["launches"]),
                                        "extras": extras["launches"],
                                        "real_demo": demo["launches"]},
                      sp_rows, sp, banks, path["convert"]["conv_banks_launches"], gl,
                      path["convert"]["gl_round_launches"]))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
