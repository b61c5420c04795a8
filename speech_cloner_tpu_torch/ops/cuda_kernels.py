"""Hand-written CUDA kernels of the port, their builds and their plain versions.

Counterpart of ``speech_cloner_tpu/ops/pallas_kernels.py``. The one TPU
kernel there, the GRU time scan (`gru_scan_pallas`), is the CUDA C++ kernel
``csrc/gru_scan.cu`` for sm_90a here, built with nvcc into a shared library
with a plain C interface and bound with ctypes.

Dispatch goes by the tensor's device: a CPU tensor takes the plain PyTorch
version (`gru_scan_plain`), a CUDA tensor launches the kernel or raises.
Nothing falls back. The JAX package's global switch `use_pallas_gru` has no
counterpart.

The library is built at first use into ``build/torch_kernels/`` at the root
of the checkout, named by a hash of the source and the flags, so a fresh
checkout builds it and an unchanged one reuses it. ``launch_counts`` counts
the kernel's launches; nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_H = 512  # csrc/gru_scan.cu kMaxH

launch_counts: dict[str, int] = {"gru_scan": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float   # 0.0 when an existing build was loaded
    ptxas_log: str         # nvcc -Xptxas -v output: registers, shared memory, spills


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return found


@functools.lru_cache(maxsize=None)
def load_library(name: str = "gru_scan") -> KernelLibrary:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f"lib{name}_{digest}.so"
    log = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.scl_gru_scan_f32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.scl_gru_scan_f32.restype = ci
    lib.scl_gru_scan_smem_bytes.argtypes = [ci]
    lib.scl_gru_scan_smem_bytes.restype = ctypes.c_longlong
    return KernelLibrary(lib, str(so), seconds, log.read_text() if log.exists() else "")


# ----------------------------------------------------------------- GRU scan ---

def _check_gru_shapes(gx, cx, Wg_h, Wc_h) -> tuple[int, int, int]:
    if gx.dim() != 3 or gx.shape[2] % 2:
        raise ValueError(f"gx must be [T, B, 2H], got {tuple(gx.shape)}")
    T, B, H2 = gx.shape
    H = H2 // 2
    for name, t, want in (("cx", cx, (T, B, H)), ("Wg_h", Wg_h, (H, H2)),
                          ("Wc_h", Wc_h, (H, H))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    devices = {t.device for t in (gx, cx, Wg_h, Wc_h)}
    if len(devices) != 1:
        raise ValueError(f"gru_scan operands on several devices: {sorted(map(str, devices))}")
    return T, B, H


def gru_scan_plain(gx: torch.Tensor, cx: torch.Tensor, Wg_h: torch.Tensor,
                   Wc_h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch GRU scan, a loop over T: same function and signature as
    `gru_scan_pallas`: gx [T,B,2H], cx [T,B,H], Wg_h [H,2H], Wc_h [H,H] -> ys [T,B,H]."""
    T, B, H = _check_gru_shapes(gx, cx, Wg_h, Wc_h)
    h = gx.new_zeros((B, H))
    ys = []
    for t in range(T):
        ru = torch.sigmoid(gx[t] + h @ Wg_h)
        r, u = ru[:, :H], ru[:, H:]
        c = torch.tanh(cx[t] + (r * h) @ Wc_h)
        h = u * h + (1.0 - u) * c
        ys.append(h)
    return torch.stack(ys) if ys else gx.new_zeros((0, B, H))


def gru_scan(gx: torch.Tensor, cx: torch.Tensor, Wg_h: torch.Tensor,
             Wc_h: torch.Tensor) -> torch.Tensor:
    """GRU scan: the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    T, B, H = _check_gru_shapes(gx, cx, Wg_h, Wc_h)
    if gx.device.type == "cpu":
        return gru_scan_plain(gx, cx, Wg_h, Wc_h)
    if gx.device.type != "cuda":
        raise ValueError(f"gru_scan: unsupported device {gx.device}")
    for name, t in (("gx", gx), ("cx", cx), ("Wg_h", Wg_h), ("Wc_h", Wc_h)):
        if t.dtype != torch.float32:
            raise TypeError(f"gru_scan: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gru_scan: {name} must be contiguous")
    if H > MAX_H:
        raise ValueError(f"gru_scan: H={H} exceeds the kernel's limit of {MAX_H}")
    lib = load_library().lib
    ys = torch.empty((T, B, H), dtype=torch.float32, device=gx.device)
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        rc = lib.scl_gru_scan_f32(gx.data_ptr(), cx.data_ptr(), Wg_h.data_ptr(),
                                  Wc_h.data_ptr(), ys.data_ptr(), T, B, H, stream)
    if rc != 0:
        raise RuntimeError(f"gru_scan kernel launch failed: CUDA error {rc} "
                           f"(T={T}, B={B}, H={H})")
    launch_counts["gru_scan"] += 1
    return ys


def gru_dir_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """One GRU direction [B, T, C] -> [B, T, H] (`gru_dir_apply_pallas`): the
    input projections as two matmuls over all steps, then the scan."""
    C = x.shape[2]
    gk, ck = params["gates_kernel"], params["candidate_kernel"]
    xt = x.transpose(0, 1)                                   # [T, B, C]
    gx = torch.matmul(xt, gk[:C]) + params["gates_bias"]     # [T, B, 2H]
    cx = torch.matmul(xt, ck[:C]) + params["candidate_bias"]  # [T, B, H]
    ys = gru_scan(gx.contiguous(), cx.contiguous(), gk[C:].contiguous(),
                  ck[C:].contiguous())
    return ys.transpose(0, 1)
