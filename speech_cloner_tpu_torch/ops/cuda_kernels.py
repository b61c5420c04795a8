"""Hand-written CUDA kernels of the port, their builds and their plain versions.

Counterpart of ``speech_cloner_tpu/ops/pallas_kernels.py``. The one TPU
kernel there, the GRU time scan (`gru_scan_pallas`), is the CUDA C++ kernel
``csrc/gru_scan.cu`` for sm_90a here, built with nvcc into a shared library
with a plain C interface and bound with ctypes.

Dispatch goes by the tensor's device: a CPU tensor takes the plain PyTorch
version (`gru_scan_plain`), a CUDA tensor launches the kernel or raises.
Nothing falls back. The kernel takes float32 or bfloat16 operands (the
models' ``compute_dtype``); with bfloat16 it keeps the state and the sums in
float32, as the Pallas kernel does, and rounds only its output. The JAX
package's global switch `use_pallas_gru` has no counterpart.

The kernel splits the recurrent weights over the CTAs of a thread-block
cluster and gives each cluster a group of batch rows. Its launch is planned
here, in plain Python the CPU tests reach: `gru_scan_plan` picks the cluster
size, the rows per CTA, the number of clusters, the threads and the shared
memory per CTA; `pack_gru_weights` lays the weights out by CTA (the GRU
module packs once, at construction).

The library is built at first use into ``build/torch_kernels/`` at the root
of the checkout, named by a hash of the source and the flags, so a fresh
checkout builds it and an unchanged one reuses it. ``launch_counts`` counts
the kernel's launches; nothing else adds to it. ``launch_shapes`` keeps the
shapes they ran at.
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
import torch.nn.functional as F

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# csrc/gru_scan.cu limits: kMaxH, kMaxCluster, the R instantiations,
# kMaxThreads, kL
MAX_H = 512
MAX_CLUSTER = 16        # above 8 CTAs a cluster is non-portable; Hopper allows 16 on request
ROWS_PER_CTA = (1, 2, 4, 8)
MAX_THREADS = 512
TEAM_LANES = 8          # threads per hidden unit
# Cluster sizing (gru_cluster_size), from a sweep of plans on an H100
# (gru_scan_sweep.py): one CTA while the weights are small, else slices of at
# most 32 units, so a CTA runs 256 threads.
SINGLE_CTA_WEIGHT_BYTES = 48 * 1024
UNITS_PER_CTA = 32
CTA_RESERVED_SMEM = 1024     # shared memory the card keeps per resident CTA

# the kernel's entry point by operand type (csrc/gru_scan.cu)
SCAN_ENTRY = {torch.float32: "scl_gru_scan_f32", torch.bfloat16: "scl_gru_scan_bf16"}

launch_counts: dict[str, int] = {"gru_scan": 0}
# every (dtype, T, B, H) the scan kernel was launched at in this process;
# reset_launch_counts leaves it be
launch_shapes: set[tuple[torch.dtype, int, int, int]] = set()


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
    for fn in (lib.scl_gru_scan_f32, lib.scl_gru_scan_bf16):
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ctypes.c_longlong, vp]
        fn.restype = ci
    lib.scl_gru_scan_device_limits.argtypes = [ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
    lib.scl_gru_scan_device_limits.restype = ci
    return KernelLibrary(lib, str(so), seconds, log.read_text() if log.exists() else "")


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory bytes per block) of CUDA device ``index``."""
    n_sms, optin = ctypes.c_int(), ctypes.c_int()
    rc = load_library().lib.scl_gru_scan_device_limits(index, ctypes.byref(n_sms),
                                                       ctypes.byref(optin))
    if rc != 0:
        raise RuntimeError(f"reading the limits of CUDA device {index} failed: CUDA error {rc}")
    return n_sms.value, optin.value


# ----------------------------------------------------------------- GRU scan ---

@dataclasses.dataclass(frozen=True)
class GruScanPlan:
    """One launch of csrc/gru_scan.cu: ``clusters`` clusters of ``cluster``
    CTAs; each cluster owns ``rows`` batch rows, each of its CTAs ``units``
    hidden units of them (the last CTA fewer where C does not divide H), one
    team of TEAM_LANES threads per unit."""
    H: int
    B: int
    cluster: int       # C, CTAs per cluster
    units: int         # Hc = ceil(H / C), hidden units per CTA
    rows: int          # R, batch rows per cluster (every CTA of it works on all of them)
    clusters: int
    threads: int       # per CTA: Hc * TEAM_LANES rounded up to a warp
    smem_bytes: int    # dynamic shared memory per CTA

    @property
    def ctas(self) -> int:
        return self.cluster * self.clusters


def gru_cluster_size(H: int) -> int:
    """CTAs per cluster for width H: one while all 3*H*H weights take at most
    SINGLE_CTA_WEIGHT_BYTES (H <= 64), else the fewest, a power of two, with
    at most UNITS_PER_CTA units each (H = 128: 4, 256: 8, 512: 16)."""
    if 12 * H * H <= SINGLE_CTA_WEIGHT_BYTES:
        return 1
    C = 2
    while -(-H // C) > UNITS_PER_CTA:
        C *= 2
    return C


def gru_weight_stride(H: int) -> int:
    """Row stride of a CTA's weights in shared memory: the least >= H that is
    TEAM_LANES mod 32 words, so the four teams of a warp read distinct banks."""
    return H + (TEAM_LANES - H % 32) % 32


def gru_scan_smem_bytes(H: int, C: int, R: int, elem_bytes: int = 4) -> int:
    """Shared memory per CTA (csrc/gru_scan.cu Layout): 4 mbarriers of 8
    bytes, two buffers each of h and r*h [H][R] in float32, the weights
    [3*Hc][stride] of ``elem_bytes`` bytes each (4 float32, 2 bfloat16);
    each region rounded up to 16 bytes."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    w_words = -(-3 * -(-H // C) * gru_weight_stride(H) * elem_bytes // 4)
    return 4 * (8 + 4 * r4(H * R) + r4(w_words))


def gru_scan_plan(H: int, B: int, n_sms: int, smem_optin: int,
                  cluster: int | None = None, elem_bytes: int = 4) -> GruScanPlan:
    """Launch plan of the scan for width H and B batch rows on a card with
    ``n_sms`` SMs and ``smem_optin`` bytes of shared memory per block, for
    operands of ``elem_bytes`` bytes (4 float32, 2 bfloat16).

    The cluster size is `gru_cluster_size(H)` unless given. The rows per
    cluster are the fewest in ROWS_PER_CTA whose shared memory fits and
    whose CTAs take one SM each; from two rows on, also two CTAs to an SM
    where two fit in its shared memory. With no row count that small, the
    largest that fits, and the clusters run in waves. Raises if none fits.
    B = 59: 1 row at H = 40 (59 CTAs), 2 at H = 128 (120) and 256 (240).

    From gru_scan_sweep.py on an H100 (T = 400): a row tile of 2 beat 1 row
    at two CTAs per SM (H = 128, B = 59: 0.631 ms against 0.691), and two
    CTAs per SM beat a tile of 4 at one per SM (H = 256, B = 59: 1.152 ms
    against 1.366): their steps' latencies interleave."""
    if not 0 < H <= MAX_H:
        raise ValueError(f"gru_scan_plan: H={H} outside 1..{MAX_H}")
    if B < 1:
        raise ValueError(f"gru_scan_plan: B={B} must be positive")
    C = gru_cluster_size(H) if cluster is None else cluster
    if C not in (1, 2, 4, 8, MAX_CLUSTER):
        raise ValueError(f"gru_scan_plan: cluster size {C} not in 1, 2, 4, 8, {MAX_CLUSTER}")
    Hc = -(-H // C)
    threads = -(-Hc * TEAM_LANES // 32) * 32
    fits = [(R, gru_scan_smem_bytes(H, C, R, elem_bytes)) for R in ROWS_PER_CTA]
    fits = [(R, smem) for R, smem in fits if smem <= smem_optin]
    if threads > MAX_THREADS or not fits:
        raise RuntimeError(f"gru_scan_plan: no plan fits H={H} in a {C}-CTA cluster "
                           f"({Hc} units per CTA, {smem_optin} bytes of shared memory)")

    def takes(R, smem):         # the card runs all CTAs of this row tile at once
        per_sm = 2 if R >= 2 and 2 * smem + CTA_RESERVED_SMEM <= smem_optin else 1
        return -(-B // R) * C <= per_sm * n_sms

    R, smem = next(((R, smem) for R, smem in fits if takes(R, smem)), fits[-1])
    return GruScanPlan(H, B, C, Hc, R, -(-B // R), threads, smem)


def pack_gru_weights(Wg_h: torch.Tensor, Wc_h: torch.Tensor,
                     cluster: int | None = None) -> torch.Tensor:
    """The recurrent weights laid out by CTA: [C, 3*Hc, H], where row g*Hc + i
    of CTA c is the column of gate g (Wg_h's r and u halves, then Wc_h) for
    unit c*Hc + i, zero past H, in the weights' dtype. C is
    `gru_cluster_size(H)` unless given. Packing only moves values, so casting
    a packed tensor equals packing the cast weights."""
    H = Wc_h.shape[0]
    C = gru_cluster_size(H) if cluster is None else cluster
    Hc = -(-H // C)

    def by_cta(w):                                   # [H, H] -> [H, C, Hc]
        return F.pad(w, (0, C * Hc - H)).reshape(H, C, Hc)

    parts = torch.stack([by_cta(Wg_h[:, :H]), by_cta(Wg_h[:, H:]), by_cta(Wc_h)])
    return parts.permute(2, 0, 3, 1).reshape(C, 3 * Hc, H).contiguous()


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
    `gru_scan_pallas`: gx [T,B,2H], cx [T,B,H], Wg_h [H,2H], Wc_h [H,H] -> ys [T,B,H].

    Operands narrower than float32 (bfloat16) are widened: h and every sum
    are float32, as in the Pallas kernel, and ys is rounded to the operands'
    dtype."""
    T, B, H = _check_gru_shapes(gx, cx, Wg_h, Wc_h)
    dtype = gx.dtype
    acc = torch.promote_types(dtype, torch.float32)
    gx, cx, Wg_h, Wc_h = (t.to(acc) for t in (gx, cx, Wg_h, Wc_h))
    h = gx.new_zeros((B, H))
    ys = []
    for t in range(T):
        ru = torch.sigmoid(gx[t] + h @ Wg_h)
        r, u = ru[:, :H], ru[:, H:]
        c = torch.tanh(cx[t] + (r * h) @ Wc_h)
        h = u * h + (1.0 - u) * c
        ys.append(h)
    return (torch.stack(ys) if ys else gx.new_zeros((0, B, H))).to(dtype)


def gru_scan(gx: torch.Tensor, cx: torch.Tensor, Wg_h: torch.Tensor,
             Wc_h: torch.Tensor, packed: torch.Tensor | None = None) -> torch.Tensor:
    """GRU scan: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

    ``packed`` is `pack_gru_weights(Wg_h, Wc_h)` made ahead of the call (the
    GRU module keeps one per direction); when None, the wrapper packs. Its
    first dimension is the cluster size the launch uses."""
    T, B, H = _check_gru_shapes(gx, cx, Wg_h, Wc_h)
    if gx.device.type == "cpu":
        return gru_scan_plain(gx, cx, Wg_h, Wc_h)
    if gx.device.type != "cuda":
        raise ValueError(f"gru_scan: unsupported device {gx.device}")
    for name, t in (("gx", gx), ("cx", cx), ("Wg_h", Wg_h), ("Wc_h", Wc_h)):
        if t.dtype not in SCAN_ENTRY:
            raise TypeError(f"gru_scan: {name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != gx.dtype:
            raise TypeError(f"gru_scan: {name} is {t.dtype}, gx {gx.dtype}: one dtype for all")
        if not t.is_contiguous():
            raise ValueError(f"gru_scan: {name} must be contiguous")
    if H > MAX_H:
        raise ValueError(f"gru_scan: H={H} exceeds the kernel's limit of {MAX_H}")
    if T == 0 or B == 0:
        return gx.new_zeros((T, B, H))
    if packed is None:
        packed = pack_gru_weights(Wg_h, Wc_h)
    index = gx.device.index if gx.device.index is not None else torch.cuda.current_device()
    plan = gru_scan_plan(H, B, *device_limits(index), cluster=packed.shape[0],
                         elem_bytes=gx.element_size())
    return gru_scan_launch(gx, cx, packed, plan)


def gru_scan_launch(gx: torch.Tensor, cx: torch.Tensor, packed: torch.Tensor,
                    plan: GruScanPlan, sm_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel with an explicit plan; `gru_scan` is the entry point.
    ``sm_ids`` (int32 [plan.ctas] on the card), when given, receives the SM
    each CTA ran on."""
    T, B, H2 = gx.shape
    H = H2 // 2
    if (plan.H, plan.B) != (H, B):
        raise ValueError(f"gru_scan: plan for H={plan.H}, B={plan.B} given H={H}, B={B}")
    want = (plan.cluster, 3 * plan.units, H)
    if tuple(packed.shape) != want:
        raise ValueError(f"gru_scan: packed weights must be {want}, got {tuple(packed.shape)}")
    if gx.dtype not in SCAN_ENTRY or cx.dtype != gx.dtype:
        raise TypeError(f"gru_scan: gx and cx must be one of {list(SCAN_ENTRY)}, got "
                        f"{gx.dtype} and {cx.dtype}")
    if (packed.device != gx.device or packed.dtype != gx.dtype
            or not packed.is_contiguous()):
        raise ValueError(f"gru_scan: packed weights must be contiguous {gx.dtype} on the "
                         "operands' device")
    sm_ptr = None
    if sm_ids is not None:
        if (sm_ids.device != gx.device or sm_ids.dtype != torch.int32
                or sm_ids.numel() < plan.ctas):
            raise ValueError(f"gru_scan: sm_ids must be int32 with {plan.ctas} elements "
                             "on the operands' device")
        sm_ptr = sm_ids.data_ptr()
    entry = getattr(load_library().lib, SCAN_ENTRY[gx.dtype])
    ys = torch.empty((T, B, H), dtype=gx.dtype, device=gx.device)
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        rc = entry(gx.data_ptr(), cx.data_ptr(), packed.data_ptr(), ys.data_ptr(), sm_ptr,
                   T, B, H, plan.cluster, plan.rows, plan.clusters, plan.threads,
                   plan.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"gru_scan kernel launch failed: CUDA error {rc} "
                           f"(T={T}, B={B}, H={H}, {gx.dtype}, plan {plan})")
    launch_counts["gru_scan"] += 1
    launch_shapes.add((gx.dtype, T, B, H))
    return ys


def gru_dir_apply(params: dict, x: torch.Tensor,
                  packed: torch.Tensor | None = None) -> torch.Tensor:
    """One GRU direction [B, T, C] -> [B, T, H] (`gru_dir_apply_pallas`): the
    input projections as two matmuls over all steps, then the scan
    (``packed``: the direction's `pack_gru_weights`, or None)."""
    C = x.shape[2]
    gk, ck = params["gates_kernel"], params["candidate_kernel"]
    xt = x.transpose(0, 1)                                   # [T, B, C]
    gx = torch.matmul(xt, gk[:C]) + params["gates_bias"]     # [T, B, 2H]
    cx = torch.matmul(xt, ck[:C]) + params["candidate_bias"]  # [T, B, H]
    ys = gru_scan(gx.contiguous(), cx.contiguous(), gk[C:].contiguous(),
                  ck[C:].contiguous(), packed)
    return ys.transpose(0, 1)
