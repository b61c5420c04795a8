#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (the card's name and power limit also go
out as the raw line ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints):

1. env     card, torch/CUDA versions.
2. build   nvcc-build the GRU scan kernel from speech_cloner_tpu_torch/csrc
           for sm_90a; ptxas registers/shared memory/spills, build seconds,
           and the launch plan of each kernel shape (cluster size, rows per
           CTA, clusters, threads and shared memory per CTA).
3. kernel  gru_scan (CUDA kernel, weights packed ahead as the GRU module
           packs them) against gru_scan_plain on the card, T=400, H in
           {40, 128, 256}, B in {9, 59}: max-abs error (fails above 1e-4),
           CUDA-event times of both, microseconds per step, the SMs the
           launch ran on, the roofline bound and its share.
4. path    make_pipeline(EncoderConfig(), DecoderConfig(), seed=0) on cuda,
           n_iter 200, realse 1.2, gl_dft "matmul"; a synthetic 60 s 16 kHz
           clip; warm convert and convert_pcm16 with the launch counter reset
           before and read after each (6 launches per call, or fail); wall
           time, RTF, predict/vocode split, peak memory.
   profile torch.profiler over one more convert_pcm16: device time by
           kernel name (the top names, and the GRU scan's), device busy time
           and idle share of the wall time.
5. parity  the same pipeline built on the CPU: forward_windows on 3 full-width
           windows (mel, stft, ppg) and from_power_to_wav on a 2-window
           spectrogram (32 Griffin-Lim rounds, same initial phase), GPU
           against CPU, with the tolerances in PARITY_TOL.
6. the {"kernels": [...]} line, then the {"ok": true, ...} line.

Any failed phase raises and the script exits non-zero. With no CUDA device,
or without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

T_STEPS = 400
KERNEL_SHAPES = [(H, B) for H in (40, 128, 256) for B in (9, 59)]
KERNEL_TOL = 1e-4
# GPU against CPU of the same float32 port. Sums run in other orders on the
# two devices (cuBLAS/cuDNN against MKL/oneDNN, the kernel's per-column dot
# against the CPU matmul); over 3 CBHG stacks at full width that leaves
# differences of order 1e-5 relative. The bounds are relative to the CPU
# output's largest magnitude.
PARITY_TOL = {"mel": 1e-4, "stft": 1e-4, "ppg": 1e-4, "wav": 1e-3}
F32_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores (data sheet)
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (data sheet)
DEV = "cuda"
REPEATS = 3  # timed runs of each main-path call; medians reported


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


def gru_bound(T: int, B: int, H: int) -> dict:
    """Least time for one scan: every input/output byte once, 6*T*B*H^2 FLOP."""
    flops = 6 * T * B * H * H
    nbytes = 4 * (T * B * 4 * H) + 4 * (3 * H * H)
    ops_ms, bytes_ms = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


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
    return {"C": plan.cluster, "rows_per_cta": plan.rows, "clusters": plan.clusters,
            "ctas": plan.ctas, "threads": plan.threads, "smem_bytes": plan.smem_bytes}


def phase_build(ck) -> None:
    t0 = time.perf_counter()
    lib = ck.load_library()
    limits = ck.device_limits(torch.cuda.current_device())
    emit({"phase": "build", "library": lib.path, "nvcc_seconds": round(lib.build_seconds, 3),
          "load_seconds": round(time.perf_counter() - t0, 3), "ptxas": lib.ptxas_log.strip(),
          "n_sms": limits[0], "smem_optin_bytes": limits[1],
          "plans": {f"H={H},B={B}": plan_row(ck.gru_scan_plan(H, B, *limits))
                    for H, B in KERNEL_SHAPES}})


def phase_kernel(ck) -> list[dict]:
    gen = torch.Generator(DEV).manual_seed(0)
    limits = ck.device_limits(torch.cuda.current_device())
    rows = []
    for H, B in KERNEL_SHAPES:
        def rnd(*shape, scale=1.0):
            return scale * torch.randn(shape, generator=gen, device=DEV)
        gx, cx = rnd(T_STEPS, B, 2 * H), rnd(T_STEPS, B, H)
        lim = math.sqrt(6.0 / (3 * H))
        Wg, Wc = rnd(H, 2 * H, scale=lim), rnd(H, H, scale=lim)
        packed = ck.pack_gru_weights(Wg, Wc)
        got = ck.gru_scan(gx, cx, Wg, Wc, packed)
        ref = ck.gru_scan_plain(gx, cx, Wg, Wc)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not math.isfinite(err) or err > KERNEL_TOL:
            raise AssertionError(f"gru_scan H={H} B={B}: max-abs {err} > {KERNEL_TOL}")
        plan = ck.gru_scan_plan(H, B, *limits)
        sm_ids = torch.full((plan.ctas,), -1, dtype=torch.int32, device=DEV)
        ck.gru_scan_launch(gx, cx, packed, plan, sm_ids=sm_ids)
        ms = cuda_ms(lambda: ck.gru_scan(gx, cx, Wg, Wc, packed), n=20)
        plain_ms = cuda_ms(lambda: ck.gru_scan_plain(gx, cx, Wg, Wc), n=3, warmup=1)
        b = gru_bound(T_STEPS, B, H)
        row = {"H": H, "B": B, "T": T_STEPS, "max_abs_err": err, "ms": ms,
               "us_per_step": ms * 1000 / T_STEPS, "sms": len(set(sm_ids.tolist())),
               "plan": plan_row(plan), "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
               "bound_by": b["bound_by"], "share_of_bound": b["bound_ms"] / ms,
               "flops": b["flops"], "bytes": b["bytes"]}
        emit({"phase": "kernel", **row})
        rows.append(row)
    return rows


def synthetic_clip(seconds: float, sr: int = 16000) -> np.ndarray:
    """Voiced-like test signal from default_rng(0): harmonics on a wandering
    pitch, amplitude bursts, and noise."""
    rng = np.random.default_rng(0)
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
            launches = ck.launch_counts["gru_scan"]
            y = res[0] if isinstance(res, tuple) else res
            if launches != 6:
                raise AssertionError(f"{name}: gru_scan launched {launches} times, want 6")
            if y.shape != (want_len,) or not np.isfinite(y.astype(np.float32)).all():
                raise AssertionError(f"{name}: output shape {y.shape} (want {want_len},) "
                                     f"or non-finite values")
        wall = float(np.median(walls))
        out[name] = {"wall_s": wall, "walls_s": walls, "rtf": wall / (len(wav) / 16000),
                     "gru_scan_launches": launches, "out_len": int(y.shape[0]),
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


def phase_profile(pipe, wav: np.ndarray, top: int = 12) -> dict:
    """torch.profiler over one warm convert_pcm16: device time by kernel name,
    summed device busy time against the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.convert_pcm16(wav)
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
    out = {"phase": "profile", "call": "convert_pcm16", "wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
           "n_kernel_names": len(rows), "top": rows[:top],
           "gru_scan": [r for r in rows if "gru_scan_kernel" in r["name"]]}
    emit(out)
    return out


def max_rel(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    err = (a - b).abs().max().item()
    return err, err / max(b.abs().max().item(), 1e-30)


def phase_parity(pipe, cpu_pipe, wav: np.ndarray) -> dict:
    from speech_cloner_tpu_torch.ops import from_power_to_wav, mfcc_input

    T = pipe.enc_cfg.n_timesteps
    res = {"phase": "parity", "tolerance_rel": PARITY_TOL}
    with torch.inference_mode():
        clip = wav[: 3 * T * pipe.feat_cfg.hop_length]
        mfcc_cpu = mfcc_input(torch.tensor(clip), cpu_pipe.feat_cfg)[0][: 3 * T]
        mfcc_gpu = mfcc_input(torch.tensor(clip, device=DEV), pipe.feat_cfg)[0][: 3 * T]
        res["mfcc_max_abs"] = max_rel(mfcc_gpu, mfcc_cpu)[0]
        x = mfcc_cpu.reshape(3, T, -1)
        got = pipe.forward_windows(x.to(DEV))
        ref = cpu_pipe.forward_windows(x)
        for name, g, r in zip(("mel", "stft", "ppg"), got, ref):
            res[f"{name}_max_abs"], res[f"{name}_rel"] = max_rel(g, r)
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


def main() -> int:
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
    rows = phase_kernel(ck)

    settings = dict(seed=0, n_iter=200, realse=1.2, gl_dft="matmul")
    pipe = make_pipeline(EncoderConfig(), DecoderConfig(), device=DEV, **settings)
    wav = synthetic_clip(60.0)
    path = phase_path(ck, pipe, wav)
    phase_profile(pipe, wav)
    cpu_pipe = make_pipeline(EncoderConfig(), DecoderConfig(), device="cpu", **settings)
    phase_parity(pipe, cpu_pipe, wav)

    # one convert's launches: fw and bw at H = 40, 128, 256, B = 2K-1 = 59
    main_rows = [r for r in rows if r["B"] == 59]
    ops_ms = sum(2 * gru_bound(T_STEPS, 59, r["H"])["ops_ms"] for r in main_rows)
    bytes_ms = sum(2 * gru_bound(T_STEPS, 59, r["H"])["bytes_ms"] for r in main_rows)
    emit({"kernels": [{
        "name": "gru_scan",
        "route": "cuda",
        "source": "speech_cloner_tpu_torch/csrc/gru_scan.cu",
        "replaces": "speech_cloner_tpu/ops/pallas_kernels.py:46",
        "launches": path["convert"]["gru_scan_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(2 * r["ms"] for r in main_rows),
        "plain_ms": sum(2 * r["plain_ms"] for r in main_rows),
        "bound_ms": sum(2 * r["bound_ms"] for r in main_rows),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "library_note": "none: nn.GRU computes r*(W h), not (r*h) W",
        "work": "the 6 scans of one 60 s convert: fw+bw at H=40,128,256, B=59, T=400",
        "per_shape": rows,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
