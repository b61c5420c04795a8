"""Hand-written CUDA kernels of the port, their builds and their plain versions.

Counterpart of ``speech_cloner_tpu/ops/pallas_kernels.py``. The one TPU
kernel there, the GRU time scan (`gru_scan_pallas`), is the CUDA C++ kernel
``csrc/gru_scan.cu`` for sm_90a here, built with nvcc into a shared library
with a plain C interface and bound with ctypes. A second kernel,
``csrc/conv_banks.cu`` (`conv_banks`), stands beside no TPU kernel: the
JAX package runs the CBHG bank convolutions as one packed width-K
``lax.conv`` (`nn.modules.pack_bank_kernels`). It runs the float32 bank
convolutions of inference over their nonzero taps only (bank k does k taps
of the packed conv's K), bound by the SMs' float32 FFMA rate (no tensor
cores without TF32): pairs of banks k and K + 1 - k give every block K + 1
taps, the input tile sits once in shared memory for every tap of both, and
each thread keeps an 8 x 8 tile of float32 sums (`conv_banks_plan`). A
third, ``csrc/griffin_lim.cu`` (`gl_rounds`), also stands beside no TPU
kernel: the JAX package's Griffin-Lim is jnp matmuls. It runs one whole
round of the float32 matmul-DFT vocoder in one launch, a CTA a tile of one
clip's frames: the inverse DFT over the tile and its halo, overlap-add,
envelope, reflect padding, forward DFT and projection, the intermediates in
shared memory (`gl_round_plan`; plain version `gl_round_plain`).

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
memory per CTA; `pack_gru_weights` lays the weights out by CTA.

Both directions in one launch: `gru_scan_fused` stacks the two directions'
operands on a leading axis and the kernel runs direction 1 backwards in
time (the JAX package's `gru_apply_fused`); `gru_scan_fused_plain` is its
plain version, one loop over T for both.

Training: when autograd records (grad mode on and an operand requires
grad), both entry points go through `GruScan`, whose forward also keeps the
gates r, u, c (float32 for either operand type) and whose backward is the
kernel ``scl_gru_scan_bwd_f32`` or ``scl_gru_scan_bwd_bf16`` (on the CPU
`gru_scan_backward_plain`); the weight gradients are matmuls over all T*B
rows. Gradients come back in the operands' dtype: with bfloat16 operands
the backward widens its inputs, keeps float32 inside and rounds dgx and dcx
once. Every form holds its weights in registers, for either operand
type, where a column class serves it (H <= 256); past that the float32
forward keeps them in shared memory (the shared-memory kernel) and the
bf16 forward and the backward keep theirs in shared memory within the
register kernels. Every bf16 form, the inference forward (one direction or
both), the training forward and the backward, stages its operands through
shared memory by the TMA (`GruScanPlan.stage_steps`, `gru_stage_steps`),
so no step of its scan touches device memory; the float32 forms do not.

The library is built at first use into ``build/torch_kernels/`` at the root
of the checkout, named by a hash of the source and the flags, so a fresh
checkout builds it and an unchanged one reuses it. ``launch_counts`` counts
the launches by (kernel, operand dtype): the inference forward
(``gru_scan``, ``gru_scan_fused`` for both directions), the training
forward that also writes the gates (``gru_scan_train``,
``gru_scan_fused_train``) and the backward (``gru_scan_bwd``,
``gru_scan_fused_bwd``), the bank convolutions (``conv_banks``,
float32 only) and the Griffin-Lim rounds (``gl_round``, float32 only);
nothing else adds to them. ``launch_shapes`` keeps the
(dtype, T, B, H) each scan kernel ran at.
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

import numpy as np
import torch
import torch.nn.functional as F

from .stft import _dft_mats_np

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
REGS_PER_SM = 65536
# The register forward (every forward form, float32 or bf16) and the
# backward hold their weights in registers: a lane holds NK columns of each
# of its unit's three rows, NK the least column class >= ceil(H /
# TEAM_LANES) (csrc/gru_scan.cu reg_columns); wider, the weights stay in
# shared memory.
REG_COLUMNS = (5, 8, 16, 32)
MAX_CTA_THREADS_PER_SM = 2048
# Their rows per cluster, among the register instances: the R of least
# waves x ROW_COST[R], a wave's time relative to R = 1 (gru_scan_sweep.py on
# an H100 at H = 256, C = 8: B = 32 for the backward, B = 9 for the bf16
# forward, which every float32 forward form shares); ties take the
# smaller R. A wave holds, by shared memory, registers and threads, per_sm
# CTAs on each SM, and of clusters of 8 or more one fewer than the SMs
# divide into (the GPCs' SMs do not all divide by 8: 16 clusters of 8 at
# one CTA per SM ran as two waves, 15 as one).
ROW_COST_BWD = {1: 1.0, 2: 1.5, 4: 3.6, 8: 11.8}
ROW_COST_BF16 = {1: 1.0, 2: 1.26, 4: 2.1, 8: 5.2}
# The staged instances (bf16 operands with a column class: every form;
# csrc/gru_scan.cu "staging by the TMA"): a ring of STAGE_RING slots in
# shared memory, each S steps of every input and output box [S][R][Hc]
# (bytes per element below, each box on STAGE_ALIGN bytes); S is the
# largest of STAGE_STEPS that keeps the instance's CTAs per SM. The float32
# forms are not staged: gru_scan_sweep.py timed the staged float32
# inference forward of both directions within 1% of the unstaged one at
# B = 32 on an H100.
STAGE_RING = 2
STAGE_ALIGN = 128
STAGE_STEPS = (32, 16, 8)
STAGE_BOXES = {"forward": (2, 2, 2, 2),             # gx r, gx u, cx in; ys out
               "training": (2, 2, 2, 2, 4, 4, 4),   # the same, and r, u, c out
               "backward": (2, 2, 4, 4, 4, 2, 2, 2)}  # dy, h[t-1], r, u, c in; dcx, dgr, dgu out

# the kernel's entry point by operand type (csrc/gru_scan.cu)
SCAN_ENTRY = {torch.float32: "scl_gru_scan_f32", torch.bfloat16: "scl_gru_scan_bf16"}
BWD_ENTRY = {torch.float32: "scl_gru_scan_bwd_f32", torch.bfloat16: "scl_gru_scan_bwd_bf16"}

# the kernels by form: the forward of one direction (inference, and
# training with the gates out), its backward, and the both-directions forms
KERNELS = ("gru_scan", "gru_scan_train", "gru_scan_bwd",
           "gru_scan_fused", "gru_scan_fused_train", "gru_scan_fused_bwd")
# launches by (kernel, operand dtype)
launch_counts: dict[tuple[str, torch.dtype], int] = {
    **{(k, dt): 0 for k in KERNELS for dt in SCAN_ENTRY}, ("conv_banks", torch.float32): 0,
    ("gl_round", torch.float32): 0}
# every (dtype, T, B, H) each kernel was launched at in this process;
# reset_launch_counts leaves them be
launch_shapes: dict[str, set[tuple[torch.dtype, int, int, int]]] = {k: set() for k in KERNELS}


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


def build_shared_library(src: Path, compiler, flags: tuple[str, ...]) -> tuple[Path, float, str]:
    """Build ``src`` into ``build/torch_kernels/lib<stem>_<hash>.so`` unless
    that build exists, the hash covering the source and the flags;
    ``compiler()`` names the compiler, asked only when a build runs. Returns
    (the library's path, the build's seconds or 0.0, the compiler's output).
    A failed build raises with the compiler's output."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f"lib{src.stem}_{digest}.so"
    log = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = compiler()
        t0 = time.perf_counter()
        proc = subprocess.run([cmd, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd).name} failed to build {src} (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return so, seconds, log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library(name: str = "gru_scan", defines: tuple[str, ...] = ()) -> KernelLibrary:
    """Build (once per source hash) and load ``csrc/<name>.cu``; ``defines``
    (``NAME=VALUE``, passed as ``-D``) make a separate build, as
    gru_scan_sweep.py's probe builds do."""
    so, seconds, log = build_shared_library(_CSRC / f"{name}.cu", _nvcc,
                                            NVCC_FLAGS + tuple(f"-D{d}" for d in defines))
    lib = ctypes.CDLL(str(so))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "conv_banks":
        lib.scl_conv_banks_f32.argtypes = [vp, ctypes.POINTER(vp), vp] + [ci] * 12 + [cll, vp]
        lib.scl_conv_banks_f32.restype = ci
        lib.scl_conv_banks_smem_bytes.argtypes = [ci, ci]
        lib.scl_conv_banks_smem_bytes.restype = cll
        return KernelLibrary(lib, str(so), seconds, log)
    if name == "griffin_lim":
        lib.scl_gl_round_f32.argtypes = [vp] * 9 + [ci] * 6 + [cll, vp]
        lib.scl_gl_round_f32.restype = ci
        lib.scl_gl_round_smem_bytes.argtypes = [ci]
        lib.scl_gl_round_smem_bytes.restype = cll
        return KernelLibrary(lib, str(so), seconds, log)
    for fn in (lib.scl_gru_scan_f32, lib.scl_gru_scan_bf16, lib.scl_gru_scan_bwd_f32,
               lib.scl_gru_scan_bwd_bf16):
        fn.argtypes = [vp] * 6 + [ci] * 9 + [cll, vp]
        fn.restype = ci
    lib.scl_gru_scan_device_limits.argtypes = [ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
    lib.scl_gru_scan_device_limits.restype = ci
    return KernelLibrary(lib, str(so), seconds, log)


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
    clusters: int      # per direction
    threads: int       # per CTA: Hc * TEAM_LANES rounded up to a warp
    smem_bytes: int    # dynamic shared memory per CTA
    dirs: int = 1      # directions in the launch (2: both of a bidirectional GRU)
    backward: bool = False
    gates: bool = False   # the training forward (writes the gates r, u, c)
    stage_steps: int = 0  # S of the staged instance (`gru_stage_steps`); 0: not staged

    @property
    def ctas(self) -> int:
        return self.dirs * self.cluster * self.clusters

    @property
    def stage_bytes(self) -> int:
        """Shared memory of the ring of stages (0 unstaged)."""
        return STAGE_RING * gru_stage_slot_bytes(
            self.stage_steps, self.rows, self.units, self.backward,
            self.gates) if self.stage_steps else 0

    @property
    def reg_columns(self) -> int:
        """The register columns of the plan's register-forward or backward
        instance (`gru_reg_columns`; 0: weights in shared memory)."""
        return gru_reg_columns(self.H, self.rows, self.threads, self.backward, self.gates,
                               self.stage_steps > 0)


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


def _reg_max_threads(nk: int) -> int:
    return 256 if nk >= 16 else MAX_THREADS


def _reg_instance(backward: bool, R: int, nk: int, gates: bool = False,
                  staged: bool = False) -> tuple[bool, int, bool]:
    """(weights in registers, CTAs per SM compiled for, candidate rows in
    shared memory) of the register forward's (with ``gates``, its training
    form's, float32 or bf16 operands) or the backward's instance for R rows
    and column class nk (csrc/gru_scan.cu reg_instance, reg_min_ctas,
    cand_in_smem): the pairs where ptxas reports no spill on sm_90a. The
    ``staged`` instances (bf16) also hold the training forward's (4, 32)
    and the backward's (2, 32); the inference forward's, staged (bf16) or
    not, hold every pair, the unstaged (4|8, 32) with their candidate rows
    in shared memory (as (4, 16) in every form)."""
    return (nk > 0 and not (backward and nk == 32 and R >= (4 if staged else 2))
            and not (gates and nk == 32 and R >= (8 if staged else 4)),
            2 if nk == 16 and R <= (1 if backward else 4) else 1,
            not backward and (nk == 16 and R == 4
                              or nk == 32 and R >= 4 and not gates and not staged))


def gru_reg_columns(H: int, R: int, threads: int, backward: bool = False,
                    gates: bool = False, staged: bool = False) -> int:
    """Columns of each weight row a lane of the register forward (the
    inference form of either operand type, one direction or both; with
    ``gates`` the training form; with ``backward`` the backward) holds in
    registers with R rows and CTAs of ``threads`` threads (csrc/gru_scan.cu
    reg_columns): the least of REG_COLUMNS >= ceil(H / TEAM_LANES) when
    that instance is a register one and the CTA within its launch bounds
    (256 threads from 16 columns on); 0: the weights stay in shared memory
    (always past H = 256). ``staged``: the staged instance's table
    (`_reg_instance`)."""
    n = -(-H // TEAM_LANES)
    nk = next((c for c in REG_COLUMNS if n <= c), 0)
    in_registers = _reg_instance(backward, R, nk, gates, staged)[0]
    return nk if in_registers and threads <= _reg_max_threads(nk) else 0


def _registers_per_thread(nk: int, backward: bool, R: int) -> int:
    """The most registers a thread of that instance may use (its launch bounds)."""
    if nk == 0:
        return REGS_PER_SM // MAX_THREADS
    return min(255, REGS_PER_SM // (_reg_max_threads(nk) * _reg_instance(backward, R, nk)[1]))


def _ctas_by_registers(threads: int, nk: int, backward: bool, R: int) -> int:
    """CTAs of ``threads`` threads of that instance an SM holds by its
    threads and the registers its launch bounds allow."""
    return min(MAX_CTA_THREADS_PER_SM // threads,
               REGS_PER_SM // (threads * _registers_per_thread(nk, backward, R)))


def gru_stageable(H: int, C: int) -> bool:
    """Whether width H over C CTAs can be staged: tensor-map rows and boxes
    of whole 16 bytes (bf16 rows of H, boxes of H / C units), so H a
    multiple of 8 C (csrc/gru_scan.cu stageable). Every production width
    (40, 128, 256 at C = 1, 4, 8) is."""
    return H % (TEAM_LANES * C) == 0


def gru_stage_slot_bytes(S: int, R: int, Hc: int, backward: bool, gates: bool = True) -> int:
    """Bytes of one slot of the ring: S steps of every box [S][R][Hc] of
    the form (STAGE_BOXES: the backward, the training forward (``gates``)
    or the inference forward), each rounded up to STAGE_ALIGN
    (csrc/gru_scan.cu StageLayout)."""
    a = STAGE_ALIGN
    form = "backward" if backward else "training" if gates else "forward"
    return sum(-(-S * R * Hc * es // a) * a for es in STAGE_BOXES[form])


def gru_stage_steps(H: int, C: int, R: int, smem_optin: int, elem_bytes: int = 2,
                    backward: bool = False, gates: bool = False) -> int:
    """The stage depth S of the staged instance for R rows (0: the unstaged
    one): bf16 operands (every form: the inference forward of one
    direction or both, the training forward, the backward), a stageable
    shape (`gru_stageable`) with a register column class; the largest S of
    STAGE_STEPS whose shared memory keeps the CTAs per SM that the
    instance's registers and threads allow (two at 16 columns and small R),
    so the plan's waves stay those of the unstaged instance. B = 1 and B =
    32: 32 at H = 40, 128 and 256, in every form."""
    if elem_bytes != 2 or not gru_stageable(H, C):
        return 0
    threads = -(-(H // C) * TEAM_LANES // 32) * 32
    nk = gru_reg_columns(H, R, threads, backward, gates, staged=True)
    if not nk:
        return 0
    per_sm = _ctas_by_registers(threads, nk, backward, R)
    for S in STAGE_STEPS:
        smem = gru_scan_smem_bytes(H, C, R, elem_bytes, backward, gates, S)
        if per_sm * (smem + CTA_RESERVED_SMEM) <= smem_optin + CTA_RESERVED_SMEM:
            return S
    return 0


def gru_scan_smem_bytes(H: int, C: int, R: int, elem_bytes: int = 4,
                        backward: bool = False, gates: bool = False,
                        stage_steps: int = 0) -> int:
    """Shared memory per CTA; each region rounded up to 16 bytes.

    The float32 forward in shared memory (csrc/gru_scan.cu Layout; every
    float32 forward form without a column class): 4 mbarriers of 8 bytes,
    two buffers each of h and r*h [H][R] in float32, the weights
    [3*Hc][stride] in float32. The register forward (LayoutReg: either
    operand type, ``elem_bytes``, any form) and the backward (LayoutBwd,
    float32 vectors and weights for either operand type) hold their weights
    in registers (`gru_reg_columns`), so their vectors have Hp = 8 * NK
    rows (zero past H) and they keep no weights: the forward two buffers of h and r*h
    [Hp][R], the backward two of [dcx, dgu] [Hp][2R] and two of dgr [Hp][R]
    (the forward's (R, NK) = (4, 16), and the unstaged inference
    forward's (4|8, 32), keep their candidate rows [Hc][stride(H)] in
    float32). Without a column class (H > 256) Hp is H
    rounded up to even and the weights follow: bf16 pairs
    [3*Hc][stride(ceil(H/2))] words or float32 rows [3*Hc][stride(H)] (the
    bf16 backward's widened once per launch). With ``stage_steps`` S (the
    staged instances) the mbarriers take 16 floats (the ring's two more)
    and the ring of STAGE_RING slots (`gru_stage_slot_bytes`) follows from
    the next STAGE_ALIGN bytes."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    Hc = -(-H // C)
    nk = gru_reg_columns(H, R, -(-Hc * TEAM_LANES // 32) * 32, backward, gates,
                         stage_steps > 0)
    if not backward and elem_bytes == 4 and not nk:
        return 4 * (8 + 4 * r4(H * R) + r4(3 * Hc * gru_weight_stride(H)))
    hp = TEAM_LANES * nk if nk else H + H % 2
    if backward:
        vectors = 2 * r4(hp * 2 * R) + 2 * r4(hp * R)
        weights = r4(3 * Hc * gru_weight_stride(H))
    else:
        vectors = 4 * r4(hp * R)
        weights = r4(3 * Hc * gru_weight_stride(-(-H // 2)))
    if nk:      # with the candidate rows in shared memory (f32) or none
        in_smem = _reg_instance(backward, R, nk, gates, stage_steps > 0)[2]
        weights = r4(Hc * gru_weight_stride(H)) if in_smem else 0
    if not stage_steps:
        return 4 * (8 + vectors + weights)
    ring = -(-4 * (16 + vectors + weights) // STAGE_ALIGN) * STAGE_ALIGN
    return ring + STAGE_RING * gru_stage_slot_bytes(stage_steps, R, Hc, backward, gates)


@functools.lru_cache(maxsize=None)
def gru_scan_plan(H: int, B: int, n_sms: int, smem_optin: int,
                  cluster: int | None = None, elem_bytes: int = 4, dirs: int = 1,
                  backward: bool = False, gates: bool = False,
                  stage_steps: int | None = None) -> GruScanPlan:
    """Launch plan of the scan for width H and B batch rows on a card with
    ``n_sms`` SMs and ``smem_optin`` bytes of shared memory per block, for
    operands of ``elem_bytes`` bytes (4 float32, 2 bfloat16), ``dirs``
    directions in one launch (each takes its own clusters), of the forward
    or (``backward``) of its gradient. The backward's plan is the same for
    both operand types (it widens bf16 weights to float32 where it keeps
    them). ``gates``: the training forward, whose register instances differ
    from the inference forward's (`_reg_instance`).

    The cluster size is `gru_cluster_size(H)` unless given. The rows per
    cluster are the fewest in ROWS_PER_CTA whose shared memory fits and
    whose CTAs take one SM each; from two rows on, also two CTAs to an SM
    where two fit in its shared memory. With no row count that small, the
    largest that fits, and the clusters run in waves. Raises if none fits.
    This is the plan of every form without a column class (H > 256, or a
    cluster size whose CTAs pass the register instances' launch bounds),
    the float32 forward's then the shared-memory kernel. From
    gru_scan_sweep.py on an H100 (T = 400), that kernel at a row tile of 2
    beat 1 row at two CTAs per SM (H = 128, B = 59: 0.631 ms against
    0.691), and at two CTAs per SM beat a tile of 4 at one per SM (H = 256,
    B = 59: 1.152 ms against 1.366): their steps' latencies interleave.

    Every forward (either operand type, any form) and the backward with
    their weights in registers (`gru_reg_columns`) take instead the
    register instance's R of least waves x ROW_COST[R] (their steps' cost
    grows with R faster than the shared-memory forward's, and their CTAs are
    fewer to an SM): B = 32 backward 1 row at every width; B = 59 inference
    forward 1 row at H = 40 and 128, 4 at H = 256; B = 32 training forward
    1 row at H = 40 and 128, 2 at H = 256; B = 1 one row everywhere.

    Plans are pure functions of the arguments and kept once made, since
    every scan of a train step asks again (the staged plan searches row
    counts and stage depths); the host time this saves a step has not been
    measured.

    Every bf16 form takes its staged instance where
    `gru_stage_steps` gives a depth (``stage_steps``, given,
    forces one for every row count: 0 the unstaged instance; a depth the
    shape cannot take raises); its ring's shared memory counts in the CTAs
    per SM, which the depth keeps, so the rows are those of the unstaged
    instance."""
    if not 0 < H <= MAX_H:
        raise ValueError(f"gru_scan_plan: H={H} outside 1..{MAX_H}")
    if elem_bytes not in (2, 4):
        raise ValueError(f"gru_scan_plan: elem_bytes={elem_bytes} not 2 or 4")
    if B < 1:
        raise ValueError(f"gru_scan_plan: B={B} must be positive")
    C = gru_cluster_size(H) if cluster is None else cluster
    if C not in (1, 2, 4, 8, MAX_CLUSTER):
        raise ValueError(f"gru_scan_plan: cluster size {C} not in 1, 2, 4, 8, {MAX_CLUSTER}")
    if dirs not in (1, 2):
        raise ValueError(f"gru_scan_plan: dirs={dirs} not 1 or 2")
    Hc = -(-H // C)
    threads = -(-Hc * TEAM_LANES // 32) * 32

    def depth(R):           # the stage depth of R rows' instance
        if stage_steps is None:
            return gru_stage_steps(H, C, R, smem_optin, elem_bytes, backward, gates)
        if stage_steps and not (elem_bytes == 2 and gru_stageable(H, C)
                                and 0 < stage_steps <= 256
                                and stage_steps & (stage_steps - 1) == 0):
            raise ValueError(f"gru_scan_plan: stage_steps={stage_steps} for H={H}, C={C}, "
                             f"elem_bytes={elem_bytes}, dirs={dirs}, backward={backward}, "
                             f"gates={gates}")
        return stage_steps if gru_reg_columns(H, R, threads, backward, gates, True) else 0

    fits = [(R, depth(R)) for R in ROWS_PER_CTA]
    fits = [(R, S, gru_scan_smem_bytes(H, C, R, elem_bytes, backward, gates, S))
            for R, S in fits]
    fits = [(R, S, smem) for R, S, smem in fits if smem <= smem_optin]
    if threads > MAX_THREADS or not fits:
        raise RuntimeError(f"gru_scan_plan: no plan fits H={H} in a {C}-CTA cluster "
                           f"({Hc} units per CTA, {smem_optin} bytes of shared memory)")

    if gru_reg_columns(H, 1, threads, backward, gates) == 0:
        def takes(R, S, smem):  # the card runs all CTAs of this row tile at once
            per_sm = 2 if R >= 2 and 2 * smem + CTA_RESERVED_SMEM <= smem_optin else 1
            return dirs * -(-B // R) * C <= per_sm * n_sms

        R, S, smem = next((f for f in fits if takes(*f)), fits[-1])
    else:
        cost = ROW_COST_BWD if backward else ROW_COST_BF16

        def time(R, S, smem):   # waves of clusters times a wave's relative time
            nk = gru_reg_columns(H, R, threads, backward, gates, S > 0)
            per_sm = min(_ctas_by_registers(threads, nk, backward, R),
                         (smem_optin + CTA_RESERVED_SMEM) // (smem + CTA_RESERVED_SMEM))
            slots = max(per_sm, 1) * n_sms // C - (1 if C >= 8 else 0)
            return -(-dirs * -(-B // R) // max(slots, 1)) * cost[R]

        R, S, smem = min((f for f in fits
                          if gru_reg_columns(H, f[0], threads, backward, gates, f[1] > 0)),
                         key=lambda f: time(*f))
    return GruScanPlan(H, B, C, Hc, R, -(-B // R), threads, smem, dirs, backward, gates, S)


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


def pack_gru_weights_bwd(Wg_h: torch.Tensor, Wc_h: torch.Tensor,
                         cluster: int | None = None) -> torch.Tensor:
    """The backward kernel's layout [C, 3*Hc, H]: row g*Hc + i of CTA c is ROW
    c*Hc + i of Wg_h's r half, of its u half, then of Wc_h (the forward's
    packing of the transposed blocks), zero past H."""
    H = Wc_h.shape[0]
    return pack_gru_weights(torch.cat([Wg_h[:, :H].t(), Wg_h[:, H:].t()], dim=1),
                            Wc_h.t(), cluster)


def _check_gru_shapes(gx, cx, Wg_h, Wc_h, stacked: bool = False) -> tuple[int, int, int]:
    """(T, B, H) of one direction's operands, or of ``stacked`` ones with a
    leading direction axis (gx [D, T, B, 2H], Wg_h [D, H, 2H], ...)."""
    lead = tuple(gx.shape[:1]) if stacked else ()
    if gx.dim() != 3 + len(lead) or gx.shape[-1] % 2:
        raise ValueError(f"gx must be [{'D, ' if stacked else ''}T, B, 2H], "
                         f"got {tuple(gx.shape)}")
    T, B, H2 = gx.shape[-3:]
    H = H2 // 2
    for name, t, want in (("cx", cx, lead + (T, B, H)), ("Wg_h", Wg_h, lead + (H, H2)),
                          ("Wc_h", Wc_h, lead + (H, H))):
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


def _step_order(x: torch.Tensor) -> torch.Tensor:
    """Stacked [D, T, ...] in each direction's step order: direction 1 runs
    time backwards (its own inverse)."""
    return torch.stack([x[0], x[1].flip(0)]) if x.shape[0] == 2 else x


def gru_scan_fused_plain(gx: torch.Tensor, cx: torch.Tensor, Wg_h: torch.Tensor,
                         Wc_h: torch.Tensor, with_gates: bool = False):
    """Plain version of the stacked scan, one loop over T for every direction
    (`gru_apply_fused`'s scan): gx [D,T,B,2H], cx [D,T,B,H], Wg_h [D,H,2H],
    Wc_h [D,H,H] -> ys [D,T,B,H]; direction 1 (D = 2) runs time backwards.
    ``with_gates`` also returns r, u, c as [D,T,B,3H] (what the training
    forward keeps). float32 sums; ys in the operands' dtype."""
    T, B, H = _check_gru_shapes(gx, cx, Wg_h, Wc_h, stacked=True)
    D, dtype = gx.shape[0], gx.dtype
    acc = torch.promote_types(dtype, torch.float32)
    gx, cx, Wg_h, Wc_h = (t.to(acc) for t in (gx, cx, Wg_h, Wc_h))
    gx, cx = _step_order(gx), _step_order(cx)
    h = gx.new_zeros((D, B, H))
    ys, gates = [], []
    for s in range(T):
        ru = torch.sigmoid(gx[:, s] + torch.bmm(h, Wg_h))
        r, u = ru[..., :H], ru[..., H:]
        c = torch.tanh(cx[:, s] + torch.bmm(r * h, Wc_h))
        h = u * h + (1.0 - u) * c
        ys.append(h)
        if with_gates:
            gates.append(torch.cat([r, u, c], dim=-1))
    stack = lambda v, n: _step_order(torch.stack(v, 1) if v else gx.new_zeros((D, 0, B, n)))  # noqa: E731
    ys = stack(ys, H).to(dtype)
    return (ys, stack(gates, 3 * H)) if with_gates else ys


def _h_prev(ys: torch.Tensor) -> torch.Tensor:
    """h of each step's previous step, stacked [D, T, B, H] by time: ys of
    time t-1 for direction 0, of t+1 for direction 1, zero at each start."""
    hp = torch.zeros_like(ys)
    hp[0, 1:] = ys[0, :-1]
    if ys.shape[0] == 2:
        hp[1, :-1] = ys[1, 1:]
    return hp


def gru_scan_backward_plain(dys: torch.Tensor, ys: torch.Tensor, gates: torch.Tensor,
                            Wg_h: torch.Tensor, Wc_h: torch.Tensor):
    """Plain version of the backward kernel, a written-out reverse loop over
    the stacked scan's steps: dys, ys [D,T,B,H], gates [D,T,B,3H] (r, u, c of
    the forward), Wg_h [D,H,2H], Wc_h [D,H,H] -> (dgx [D,T,B,2H], dcx [D,T,B,H]).

    Operands narrower than float32 (bfloat16) are widened, h[t-1] read from
    the widened ys (what the forward returned, as the kernel reads it); the
    carry and every sum are float32, and dgx and dcx are rounded to dys's
    dtype once."""
    D, T, B, H = ys.shape
    dtype = dys.dtype
    acc = torch.promote_types(dtype, torch.float32)
    dys, ys, gates, Wg_h, Wc_h = (t.to(acc) for t in (dys, ys, gates, Wg_h, Wc_h))
    dy, hp, g = _step_order(dys), _step_order(_h_prev(ys)), _step_order(gates)
    WgT, WcT = Wg_h.transpose(1, 2), Wc_h.transpose(1, 2)
    carry = ys.new_zeros((D, B, H))
    dgx, dcx = [None] * T, [None] * T
    for s in reversed(range(T)):
        r, u, c = g[:, s, :, :H], g[:, s, :, H:2 * H], g[:, s, :, 2 * H:]
        dh = dy[:, s] + carry
        du = dh * (hp[:, s] - c)
        dcx[s] = dh * (1.0 - u) * (1.0 - c * c)
        drh = torch.bmm(dcx[s], WcT)
        dgx[s] = torch.cat([drh * hp[:, s] * r * (1.0 - r), du * u * (1.0 - u)], dim=-1)
        carry = dh * u + drh * r + torch.bmm(dgx[s], WgT)
    if T == 0:
        return ys.new_zeros((D, 0, B, 2 * H), dtype=dtype), ys.new_zeros((D, 0, B, H), dtype=dtype)
    return (_step_order(torch.stack(dgx, 1)).to(dtype),
            _step_order(torch.stack(dcx, 1)).to(dtype))


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _check_cuda_operands(what: str, dtypes, **tensors) -> None:
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} must be float32 or bfloat16, got {t.dtype}"
                            if len(dtypes) > 1 else
                            f"{what}: {name} must be float32, got {t.dtype}")
        if t.dtype != first.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, {next(iter(tensors))} "
                            f"{first.dtype}: one dtype for all")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _scan(gx, cx, Wg_h, Wc_h, packed, packed_bwd, stacked: bool):
    """The scan of one direction, or of ``stacked`` directions: through
    `GruScan` when autograd records, else the plain version (CPU) or the
    kernel (CUDA)."""
    T, B, H = _check_gru_shapes(gx, cx, Wg_h, Wc_h, stacked)
    if gx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_scan: unsupported device {gx.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gx, cx, Wg_h, Wc_h)):
        if stacked:
            return GruScan.apply(gx, cx, Wg_h, Wc_h, packed, packed_bwd)
        lead = lambda t: None if t is None else t[None]  # noqa: E731
        return GruScan.apply(gx[None], cx[None], Wg_h[None], Wc_h[None], lead(packed),
                             lead(packed_bwd))[0]
    if gx.device.type == "cpu":
        return (gru_scan_fused_plain(gx, cx, Wg_h, Wc_h) if stacked
                else gru_scan_plain(gx, cx, Wg_h, Wc_h))
    _check_cuda_operands("gru_scan", SCAN_ENTRY, gx=gx, cx=cx, Wg_h=Wg_h, Wc_h=Wc_h)
    if H > MAX_H:
        raise ValueError(f"gru_scan: H={H} exceeds the kernel's limit of {MAX_H}")
    if T == 0 or B == 0:
        return gx.new_zeros(gx.shape[:-1] + (H,))
    if packed is None:
        packed = (torch.stack([pack_gru_weights(a, b) for a, b in zip(Wg_h, Wc_h)])
                  if stacked else pack_gru_weights(Wg_h, Wc_h))
    plan = gru_scan_plan(H, B, *device_limits(_device_index(gx)), cluster=packed.shape[-3],
                         elem_bytes=gx.element_size(), dirs=gx.shape[0] if stacked else 1)
    return gru_scan_launch(gx, cx, packed, plan)


def gru_scan(gx: torch.Tensor, cx: torch.Tensor, Wg_h: torch.Tensor,
             Wc_h: torch.Tensor, packed: torch.Tensor | None = None,
             packed_bwd: torch.Tensor | None = None) -> torch.Tensor:
    """GRU scan: the CUDA kernel for CUDA tensors, the plain version for CPU
    ones; through `GruScan` (forward and backward kernels) when autograd
    records.

    ``packed`` is `pack_gru_weights(Wg_h, Wc_h)` made ahead of the call (the
    GRU module keeps one per direction), ``packed_bwd`` the backward's
    `pack_gru_weights_bwd` (read only when autograd records); when None,
    the wrappers pack. The first dimension of each is the cluster size the
    launch uses."""
    return _scan(gx, cx, Wg_h, Wc_h, packed, packed_bwd, stacked=False)


def gru_scan_fused(gx: torch.Tensor, cx: torch.Tensor, Wg_h: torch.Tensor,
                   Wc_h: torch.Tensor, packed: torch.Tensor | None = None,
                   packed_bwd: torch.Tensor | None = None) -> torch.Tensor:
    """Both directions of a bidirectional GRU in one scan: gx [2,T,B,2H],
    cx [2,T,B,H], Wg_h [2,H,2H], Wc_h [2,H,H] -> ys [2,T,B,H], direction 1
    running time backwards over its inputs (in their time order; no flip).
    One kernel launch on CUDA tensors (``packed``: [2, C, 3*Hc, H], each
    direction's `pack_gru_weights`; ``packed_bwd`` the same of
    `pack_gru_weights_bwd`), `gru_scan_fused_plain` on CPU ones."""
    return _scan(gx, cx, Wg_h, Wc_h, packed, packed_bwd, stacked=True)


def _count(name: str, dtype, T: int, B: int, H: int) -> None:
    launch_counts[name, dtype] += 1
    launch_shapes[name].add((dtype, T, B, H))


def gru_scan_launch(gx: torch.Tensor, cx: torch.Tensor, packed: torch.Tensor,
                    plan: GruScanPlan, sm_ids: torch.Tensor | None = None,
                    gates: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the forward kernel with an explicit plan; `gru_scan` and
    `gru_scan_fused` are the entry points. gx [T,B,2H] (one direction) or
    [D,T,B,2H] (stacked, ``plan.dirs`` = D), packed [C,3*Hc,H] or
    [D,C,3*Hc,H]. ``sm_ids`` (int32 [plan.ctas] on the card), when given,
    receives the SM each CTA ran on; ``gates`` (float32 [D,T,B,3H] for
    either operand type: the training forward), r, u, c of every step."""
    stacked = gx.dim() == 4
    D = gx.shape[0] if stacked else 1
    T, B, H2 = gx.shape[-3:]
    H = H2 // 2
    if (plan.H, plan.B, plan.dirs, plan.backward, plan.gates) != (H, B, D, False,
                                                                  gates is not None):
        raise ValueError(f"gru_scan: forward plan for H={plan.H}, B={plan.B}, dirs={plan.dirs}, "
                         f"gates={plan.gates} given H={H}, B={B}, dirs={D}, "
                         f"gates={gates is not None}")
    want = ((D,) if stacked else ()) + (plan.cluster, 3 * plan.units, H)
    if tuple(packed.shape) != want:
        raise ValueError(f"gru_scan: packed weights must be {want}, got {tuple(packed.shape)}")
    if gx.dtype not in SCAN_ENTRY or cx.dtype != gx.dtype:
        raise TypeError(f"gru_scan: gx and cx must be one of {list(SCAN_ENTRY)}, got "
                        f"{gx.dtype} and {cx.dtype}")
    if (packed.device != gx.device or packed.dtype != gx.dtype
            or not packed.is_contiguous()):
        raise ValueError(f"gru_scan: packed weights must be contiguous {gx.dtype} on the "
                         "operands' device")
    sm_ptr = gates_ptr = None
    if sm_ids is not None:
        if (sm_ids.device != gx.device or sm_ids.dtype != torch.int32
                or sm_ids.numel() < plan.ctas):
            raise ValueError(f"gru_scan: sm_ids must be int32 with {plan.ctas} elements "
                             "on the operands' device")
        sm_ptr = sm_ids.data_ptr()
    if gates is not None:
        if (tuple(gates.shape) != (D, T, B, 3 * H) or gates.dtype != torch.float32
                or gates.device != gx.device or not gates.is_contiguous()):
            raise ValueError(f"gru_scan: gates must be contiguous float32 {(D, T, B, 3 * H)} "
                             "on the operands' device")
        gates_ptr = gates.data_ptr()
    entry = getattr(load_library().lib, SCAN_ENTRY[gx.dtype])
    ys = torch.empty(gx.shape[:-1] + (H,), dtype=gx.dtype, device=gx.device)
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        rc = entry(gx.data_ptr(), cx.data_ptr(), packed.data_ptr(), ys.data_ptr(), gates_ptr,
                   sm_ptr, T, B, H, plan.cluster, plan.rows, plan.clusters, D, plan.threads,
                   plan.stage_steps, plan.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"gru_scan kernel launch failed: CUDA error {rc} "
                           f"(T={T}, B={B}, H={H}, {gx.dtype}, plan {plan})")
    _count(("gru_scan_fused" if stacked else "gru_scan") + ("_train" if gates is not None else ""),
           gx.dtype, T, B, H)
    return ys


def gru_scan_bwd_launch(dys: torch.Tensor, ys: torch.Tensor, gates: torch.Tensor,
                        packed_bwd: torch.Tensor, plan: GruScanPlan,
                        stacked: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: dys, ys [D,T,B,H], gates [D,T,B,3H]
    (float32) from the training forward, packed_bwd [D,C,3*Hc,H]
    (`pack_gru_weights_bwd` of each direction) -> (dgx [D,T,B,2H], dcx
    [D,T,B,H]); dys, ys, packed_bwd, dgx and dcx are all float32 or all
    bfloat16 (``scl_gru_scan_bwd_f32`` / ``scl_gru_scan_bwd_bf16``). Counts
    ``gru_scan_fused_bwd`` when ``stacked`` (the both-directions form), else
    ``gru_scan_bwd`` (D = 1)."""
    D, T, B, H = ys.shape
    if (plan.H, plan.B, plan.dirs, plan.backward) != (H, B, D, True):
        raise ValueError(f"gru_scan_bwd: backward plan for H={plan.H}, B={plan.B}, "
                         f"dirs={plan.dirs} given H={H}, B={B}, dirs={D}")
    want = (D, plan.cluster, 3 * plan.units, H)
    if tuple(packed_bwd.shape) != want:
        raise ValueError(f"gru_scan_bwd: packed weights must be {want}, got "
                         f"{tuple(packed_bwd.shape)}")
    if tuple(dys.shape) != tuple(ys.shape) or tuple(gates.shape) != (D, T, B, 3 * H):
        raise ValueError(f"gru_scan_bwd: dys {tuple(dys.shape)} / gates {tuple(gates.shape)} "
                         f"do not match ys {tuple(ys.shape)}")
    _check_cuda_operands("gru_scan_bwd", BWD_ENTRY, dys=dys, ys=ys, packed=packed_bwd)
    _check_cuda_operands("gru_scan_bwd", (torch.float32,), gates=gates)
    if len({t.device for t in (dys, ys, gates, packed_bwd)}) != 1:
        raise ValueError("gru_scan_bwd: operands on several devices")
    dgx = torch.empty((D, T, B, 2 * H), dtype=ys.dtype, device=ys.device)
    dcx = torch.empty((D, T, B, H), dtype=ys.dtype, device=ys.device)
    with torch.cuda.device(ys.device):
        stream = torch.cuda.current_stream(ys.device).cuda_stream
        rc = getattr(load_library().lib, BWD_ENTRY[ys.dtype])(
            dys.data_ptr(), ys.data_ptr(), gates.data_ptr(), packed_bwd.data_ptr(),
            dgx.data_ptr(), dcx.data_ptr(), T, B, H, plan.cluster, plan.rows, plan.clusters,
            D, plan.threads, plan.stage_steps, plan.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"gru_scan_bwd kernel launch failed: CUDA error {rc} "
                           f"(T={T}, B={B}, H={H}, {ys.dtype}, plan {plan})")
    _count("gru_scan_fused_bwd" if stacked else "gru_scan_bwd", ys.dtype, T, B, H)
    return dgx, dcx


def gru_scan_train_forward(gx, cx, Wg_h, Wc_h, packed=None):
    """The training forward of the stacked scan [D, ...]: (ys, gates) with ys
    in the operands' dtype (float32 or bfloat16) and gates r, u, c
    [D,T,B,3H] float32; the kernel (D = 1: the one-direction entry) on CUDA
    tensors, `gru_scan_fused_plain` on CPU ones."""
    T, B, H = _check_gru_shapes(gx, cx, Wg_h, Wc_h, stacked=True)
    if gx.device.type == "cpu":
        return gru_scan_fused_plain(gx, cx, Wg_h, Wc_h, with_gates=True)
    _check_cuda_operands("gru_scan", SCAN_ENTRY, gx=gx, cx=cx, Wg_h=Wg_h, Wc_h=Wc_h)
    D = gx.shape[0]
    if packed is None:
        packed = torch.stack([pack_gru_weights(a, b) for a, b in zip(Wg_h, Wc_h)])
    plan = gru_scan_plan(H, B, *device_limits(_device_index(gx)), cluster=packed.shape[-3],
                         elem_bytes=gx.element_size(), dirs=D, gates=True)
    gates = torch.empty((D, T, B, 3 * H), dtype=torch.float32, device=gx.device)
    if D == 1:
        return gru_scan_launch(gx[0], cx[0], packed[0], plan, gates=gates)[None], gates
    return gru_scan_launch(gx, cx, packed, plan, gates=gates), gates


def gru_scan_train_backward(dys, ys, gates, Wg_h, Wc_h, packed=None):
    """(dgx, dcx) of the stacked scan: the backward kernel on CUDA tensors
    (``packed``: [D, C, 3*Hc, H], each direction's `pack_gru_weights_bwd`,
    or None to pack here), `gru_scan_backward_plain` on CPU ones."""
    if ys.device.type == "cpu":
        return gru_scan_backward_plain(dys, ys, gates, Wg_h, Wc_h)
    D, T, B, H = ys.shape
    if packed is None:
        packed = torch.stack([pack_gru_weights_bwd(a, b) for a, b in zip(Wg_h, Wc_h)])
    plan = gru_scan_plan(H, B, *device_limits(_device_index(ys)), cluster=packed.shape[1],
                         elem_bytes=ys.element_size(), dirs=D, backward=True)
    return gru_scan_bwd_launch(dys, ys, gates, packed, plan, stacked=D == 2)


class GruScan(torch.autograd.Function):
    """The stacked scan [D, ...] with its gradient. Forward: the training
    forward (ys, and the gates r, u, c kept for the backward; storing them
    costs 3H floats a row and step, where recomputing them would run the
    forward's exchanges again). Backward: (dgx, dcx) from the backward kernel
    (plain loop on the CPU), then `gru_weight_grads`. Every gradient comes
    back in its operand's dtype. ``packed`` and
    ``packed_bwd`` (the forward's and the backward's packings, or None) are
    not differentiated."""

    @staticmethod
    def forward(ctx, gx, cx, Wg_h, Wc_h, packed, packed_bwd):
        with torch.no_grad():
            ys, gates = gru_scan_train_forward(gx, cx, Wg_h, Wc_h, packed)
        ctx.save_for_backward(ys, gates, Wg_h, Wc_h, packed_bwd)
        return ys

    @staticmethod
    def backward(ctx, dys):
        ys, gates, Wg_h, Wc_h, packed_bwd = ctx.saved_tensors
        dgx, dcx = gru_scan_train_backward(dys.contiguous(), ys, gates, Wg_h.contiguous(),
                                           Wc_h.contiguous(), packed_bwd)
        return (dgx, dcx, *gru_weight_grads(ys, gates, dgx, dcx), None, None)


def gru_weight_grads(ys: torch.Tensor, gates: torch.Tensor, dgx: torch.Tensor,
                     dcx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrent weights' gradients of the stacked scan [D, T, B, ...]
    from its outputs and its inputs' gradients: dWg_h = sum over steps of
    h[t-1]^T dgx[t] and dWc_h = sum of (r h[t-1])^T dcx[t], as two matmuls
    over all T*B rows in the operands' dtype (bf16 products accumulate in
    float32 on the card)."""
    D, T, B, H = ys.shape
    hp = _h_prev(ys).reshape(D, T * B, H)
    rh = (gates[..., :H].reshape(D, T * B, H) * hp).to(ys.dtype)
    return (torch.bmm(hp.transpose(1, 2), dgx.reshape(D, T * B, 2 * H)),
            torch.bmm(rh.transpose(1, 2), dcx.reshape(D, T * B, H)))


def gru_dir_apply(params: dict, x: torch.Tensor, packed: torch.Tensor | None = None,
                  packed_bwd: torch.Tensor | None = None) -> torch.Tensor:
    """One GRU direction [B, T, C] -> [B, T, H] (`gru_dir_apply_pallas`): the
    input projections as two matmuls over all steps, then the scan
    (``packed``, ``packed_bwd``: the direction's `pack_gru_weights` and
    `pack_gru_weights_bwd`, or None)."""
    C = x.shape[2]
    gk, ck = params["gates_kernel"], params["candidate_kernel"]
    xt = x.transpose(0, 1)                                   # [T, B, C]
    gx = torch.matmul(xt, gk[:C]) + params["gates_bias"]     # [T, B, 2H]
    cx = torch.matmul(xt, ck[:C]) + params["candidate_bias"]  # [T, B, H]
    ys = gru_scan(gx.contiguous(), cx.contiguous(), gk[C:].contiguous(),
                  ck[C:].contiguous(), packed, packed_bwd)
    return ys.transpose(0, 1)


# ------------------------------------------------------- bank convolutions ---

# csrc/conv_banks.cu: kRows, kMaxBanks, the ring of two stages of 32
# channels x 128 columns; a launch's channels are rounded up to 4
BANK_TILE_ROWS = 128
BANK_RING_BYTES = 4 * 2 * 32 * 128
MAX_BANKS = 128


@dataclasses.dataclass(frozen=True)
class ConvBanksPlan:
    """Launches of csrc/conv_banks.cu for one call: each reduces ``chunk``
    input channels (the last the rest) with an input tile of ``x_rows``
    rows in shared memory, ``smem_bytes`` a launch at most."""
    C: int
    x_rows: int
    chunk: int
    smem_bytes: int

    @property
    def chunks(self) -> list[tuple[int, int]]:
        """(first channel, channels) of each launch."""
        return [(c0, min(self.chunk, self.C - c0)) for c0 in range(0, self.C, self.chunk)]


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _bank_row_stride(channels: int) -> int:
    """The input tile's row stride in words (csrc/conv_banks.cu x_stride):
    the channels rounded up to 4, plus 4, or 8 where that would be a
    multiple of 16."""
    r = _round4(channels)
    return r + (8 if (r + 4) % 16 == 0 else 4)


def conv_banks_smem_bytes(x_rows: int, channels: int) -> int:
    """Shared memory of a launch over ``channels`` input channels: the ring
    of weight stages and the input tile [x_rows][row stride], float32
    (csrc/conv_banks.cu scl_conv_banks_smem_bytes)."""
    return BANK_RING_BYTES + 4 * x_rows * _bank_row_stride(channels)


def conv_banks_plan(B: int, T_out: int, C: int, K: int, smem_optin: int) -> ConvBanksPlan:
    """The launches for B rows of T_out output frames, C input channels and
    K banks on a card with ``smem_optin`` bytes of shared memory a block.

    A tile of BANK_TILE_ROWS frames, numbered densely over the batch, reads
    its frames, K - 1 halo rows, and K - 1 more for each batch row it
    crosses (at most ceil((rows - 1) / T_out), and B - 1): ``x_rows``. All C
    channels in one launch where that tile fits (every shape of the models:
    225 KB with the ring at C = 256, K = 32, B > 1); else the fewest equal
    chunks, each a multiple of 4, that fit. Raises where not even 4
    channels fit."""
    if min(B, T_out, C, K) < 1 or K > MAX_BANKS:
        raise ValueError(f"conv_banks_plan: B={B}, T_out={T_out}, C={C}, K={K} (K <= {MAX_BANKS})")
    return _conv_banks_plan(min(B - 1, -(-(BANK_TILE_ROWS - 1) // T_out)), C, K, smem_optin)


@functools.lru_cache(maxsize=None)
def _conv_banks_plan(crossed: int, C: int, K: int, smem_optin: int) -> ConvBanksPlan:
    """`conv_banks_plan` for a tile that crosses ``crossed`` batch rows (at
    most BANK_TILE_ROWS - 1, so the cache stays small whatever the clip
    lengths)."""
    x_rows = BANK_TILE_ROWS + (K - 1) * (1 + crossed)
    if conv_banks_smem_bytes(x_rows, 4) > smem_optin:
        raise ValueError(f"conv_banks_plan: an input tile of {x_rows} rows (K={K}, "
                         f"{crossed} batch rows crossed) does not fit {smem_optin} bytes of "
                         "shared memory")
    n = 1
    while conv_banks_smem_bytes(x_rows, _round4(-(-C // n))) > smem_optin:
        n += 1
    chunk = _round4(-(-C // n))
    return ConvBanksPlan(C, x_rows, chunk, conv_banks_smem_bytes(x_rows, min(chunk, C)))


def _bank_padding(K: int, pad) -> tuple[int, int]:
    """(left, right) zero rows: TF 'same' for K taps unless given."""
    return ((K - 1) // 2, K // 2) if pad is None else tuple(pad)


def conv_banks_plain(x: torch.Tensor, kernels, pad=None) -> torch.Tensor:
    """Plain version of the bank kernel, bank by bank: x [B, T, C] and the
    K bank kernels [k, C, c] (k = 1..K) -> [B, T + left + right - K + 1,
    K*c], bank k in channels [(k-1)c, kc); ``pad`` (left, right) zero rows
    around each row, TF 'same' ((K-1)//2, K//2) by default. Bank k reads the
    padded input from (K-1)//2 - (k-1)//2 on, where the packed width-K
    conv (`nn.modules.pack_bank_kernels`) places its taps, so both give the
    same function."""
    K = len(kernels)
    left, right = _bank_padding(K, pad)
    xp = F.pad(x.transpose(1, 2), (left, right))                  # [B, C, T_pad]
    T_out = xp.shape[-1] - K + 1
    outs = []
    for kern in kernels:
        k = kern.shape[0]
        off = (K - 1) // 2 - (k - 1) // 2
        outs.append(F.conv1d(xp[..., off:off + T_out + k - 1], kern.permute(2, 1, 0)))
    return torch.cat(outs, dim=1).transpose(1, 2)


def conv_banks(x: torch.Tensor, kernels, pad=None) -> torch.Tensor:
    """The K bank convolutions of x [B, T, C] with the bank kernels [k, C, c]
    (k = 1..K, in order), as `conv_banks_plain`: the CUDA kernel
    (csrc/conv_banks.cu) for a CUDA tensor, the plain version for a CPU one.
    The kernel takes float32, contiguous x and kernels on one device, any
    K <= MAX_BANKS, C and c, and raises on anything else. It has no
    gradient: a caller whose autograd records takes the packed conv."""
    if x.device.type == "cpu":
        return conv_banks_plain(x, kernels, pad)
    if x.device.type != "cuda":
        raise ValueError(f"conv_banks: unsupported device {x.device}")
    K = len(kernels)
    if not 0 < K <= MAX_BANKS:
        raise ValueError(f"conv_banks: {K} banks, the kernel takes 1..{MAX_BANKS}")
    if x.dim() != 3:
        raise ValueError(f"conv_banks: x must be [B, T, C], got {tuple(x.shape)}")
    B, T, C = x.shape
    c = kernels[0].shape[-1]
    for k, kern in enumerate(kernels, start=1):
        if tuple(kern.shape) != (k, C, c):
            raise ValueError(f"conv_banks: bank {k} must be {(k, C, c)}, got {tuple(kern.shape)}")
        if kern.device != x.device:
            raise ValueError(f"conv_banks: bank {k} on {kern.device}, x on {x.device}")
    _check_cuda_operands("conv_banks", (torch.float32,), x=x,
                         **{f"bank {k}": kern for k, kern in enumerate(kernels, start=1)})
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *kernels)):
        raise ValueError("conv_banks: the kernel has no gradient; autograd records here")
    left, right = _bank_padding(K, pad)
    if min(left, right) < 0:
        raise ValueError(f"conv_banks: padding {(left, right)}")
    T_out = T + left + right - K + 1
    out = torch.empty((B, max(T_out, 0), K * c), dtype=x.dtype, device=x.device)
    if T_out < 1 or B == 0 or T == 0 or c == 0:
        return out.zero_()
    plan = conv_banks_plan(B, T_out, C, K, device_limits(_device_index(x))[1])
    lib = load_library("conv_banks").lib
    ptrs = (ctypes.c_void_p * K)(*(kern.data_ptr() for kern in kernels))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i, (c0, n) in enumerate(plan.chunks):
            rc = lib.scl_conv_banks_f32(x.data_ptr(), ptrs, out.data_ptr(), B, T, C, K, c,
                                        left, right, c0, n, _round4(n), plan.x_rows, int(i > 0),
                                        conv_banks_smem_bytes(plan.x_rows, n), stream)
            if rc != 0:
                raise RuntimeError(f"conv_banks kernel launch failed: CUDA error {rc} "
                                   f"(B={B}, T={T}, C={C}, K={K}, c={c}, pad={(left, right)}, "
                                   f"plan {plan})")
            launch_counts["conv_banks", torch.float32] += 1
    return out


# ------------------------------------------------------- Griffin-Lim rounds ---

# csrc/griffin_lim.cu: the STFT it takes (kNfft, kHop); its instances
# (warp rows, rows a lane, columns a lane: 4 or 8 row lanes a warp for 10 or
# 20 columns, so 4 * WR * RL or 8 * WR * RL chunk rows and 160 WR threads a
# CTA, one CTA an SM), each with the microseconds a wave of it took on an
# H100 (the sweep of PERF.md section 6: T = 1400 / 2401 / 2401 / 12001;
# only their ratios choose);
# its shared memory: two ring slots of the S rows' 40 columns (stride 44)
# and 40 basis rows, the segment's chunks (stride 84), the window
GL_N_FFT = 400
GL_HOP = 80
GL_INSTANCES = ((2, 2, 10, 66), (2, 4, 10, 112), (4, 4, 10, 187), (4, 3, 20, 330))
_GL_TAPS = GL_N_FFT // GL_HOP
_GL_DEPTH = 40


@dataclasses.dataclass(frozen=True)
class GlRoundPlan:
    """The launch of csrc/griffin_lim.cu for a round of B clips of T
    frames: each clip's frames in ``tiles`` tiles of balanced size, a CTA a
    tile, of the instance with ``rows`` chunk rows (a tile at most rows - 4
    frames), ``warp_rows`` warp rows and ``lanes`` columns a lane."""
    B: int
    T: int
    rows: int
    tiles: int
    warp_rows: int
    lanes: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.B * self.tiles

    @property
    def threads(self) -> int:
        return 160 * self.warp_rows

    def tile(self, i: int) -> tuple[int, int]:
        """Frames [t0, t1) of tile i of each clip."""
        return i * self.T // self.tiles, (i + 1) * self.T // self.tiles


def gl_instance_rows(warp_rows: int, rows_a_lane: int, lanes: int) -> int:
    """Chunk rows a CTA of the instance computes."""
    return (4 if lanes == 10 else 8) * warp_rows * rows_a_lane


def gl_round_smem_bytes(rows: int) -> int:
    """Shared memory of the instance with ``rows`` chunk rows
    (csrc/griffin_lim.cu scl_gl_round_smem_bytes)."""
    halo_rows = rows + _GL_TAPS - 1
    return 4 * (2 * (halo_rows * (_GL_DEPTH + 4) + _GL_DEPTH * GL_N_FFT)
                + halo_rows * (GL_HOP + 4) + GL_N_FFT)


def gl_round_plan(B: int, T: int, n_fft: int, hop: int, smem_optin: int,
                  n_sms: int) -> GlRoundPlan | None:
    """The launch of a Griffin-Lim round over B clips of T frames, or None
    where the kernel does not take the shape (another STFT than n_fft 400,
    hop 80; T < 4, where the centered STFT's reflect padding is undefined;
    no instance within ``smem_optin`` bytes of shared memory).

    Tiles of rows - 4 frames at most; the instance of least estimated time,
    waves of one CTA an SM times the instance's time a wave
    (`GL_INSTANCES`), ties to the fewer rows. A 60 s clip (T = 12,001)
    fills the card in one wave of 96-row tiles (131 CTAs), a 7 s one
    (T = 1,400) in one of 16-row tiles (117 CTAs)."""
    if (n_fft, hop) != (GL_N_FFT, GL_HOP) or B < 1 or T < _GL_TAPS - 1:
        return None
    best = None
    for wr, rl, lanes, wave_us in GL_INSTANCES:
        rows = gl_instance_rows(wr, rl, lanes)
        smem = gl_round_smem_bytes(rows)
        tiles = -(-T // (rows - _GL_TAPS + 1))
        if smem > smem_optin or T < 2 * tiles or B * tiles >= 2**31:
            continue
        cost = -(-B * tiles // n_sms) * wave_us
        if best is None or cost < best[0]:
            best = (cost, GlRoundPlan(B, T, rows, tiles, wr, lanes, smem))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=8)
def gl_bases(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's bases on ``device``, `ops.stft._dft_mats`' float32 values
    laid out for it: the inverse [402, 400] (inv_re's 201 rows, then
    inv_im's), the forward [400, 400] (column 2f fwd_re[f], 2f + 1
    fwd_im[f], f < 200) and the Nyquist bin's [400, 2]."""
    fwd_re, fwd_im, inv_re, inv_im = _dft_mats_np(GL_N_FFT)
    inv = np.concatenate([inv_re, inv_im])
    fwd = np.stack([fwd_re[:-1].T, fwd_im[:-1].T], axis=2).reshape(GL_N_FFT, -1)
    nyq = np.stack([fwd_re[-1], fwd_im[-1]], axis=1)
    return tuple(torch.tensor(np.ascontiguousarray(m), device=device) for m in (inv, fwd, nyq))


def gl_round_plain(S: torch.Tensor, amp: torch.Tensor, window: torch.Tensor,
                   envelope: torch.Tensor, plan: GlRoundPlan) -> torch.Tensor:
    """Plain version of one kernel round, tile by tile as the kernel cuts
    them: S [B, T, 201] complex64, amp [B, T, 201], the window [400] and the
    squared-window envelope [(T - 1) * 80 + 400] (`ops.stft.window_sumsquare`)
    -> S' [B, T, 201]. A tile of frames [t0, t1) takes the S rows [t0 - 4,
    t0 + rows) (zeros outside the clip), overlap-adds their windowed inverse
    frames (re parts' product plus im parts') into chunks [t0, t0 + rows)
    tap by tap, divides by the envelope
    where it exceeds float32 tiny, reflect-pads the clip's first and last 200
    samples in place, frames the segment at stride 80, windows, transforms
    and projects onto ``amp``."""
    B, T, F_ = S.shape
    rows, hop, n_fft, taps = plan.rows, GL_HOP, GL_N_FFT, _GL_TAPS
    inv, fwd, nyq = gl_bases(S.device)
    spec = torch.view_as_real(S).reshape(B, T, 2 * F_)
    out = torch.empty_like(S)
    L = (T - 1) * hop
    tiny = torch.finfo(torch.float32).tiny
    for i in range(plan.tiles):
        t0, t1 = plan.tile(i)
        lo, hi = max(t0 - taps + 1, 0), min(t0 + rows, T)
        halo = spec.new_zeros((B, rows + taps - 1, 2 * F_))
        halo[:, lo - t0 + taps - 1:hi - t0 + taps - 1] = spec[:, lo:hi]
        frames = (halo[..., 0::2] @ inv[:F_] + halo[..., 1::2] @ inv[F_:]) * window  # frame t0-4+a
        y = frames[:, taps - 1:taps - 1 + rows, :hop]
        for j in range(1, taps):
            y = y + frames[:, taps - 1 - j:taps - 1 - j + rows, j * hop:(j + 1) * hop]
        y = y.reshape(B, rows * hop)
        p = t0 * hop + torch.arange(rows * hop, device=S.device)
        env = envelope[p.clamp(max=envelope.numel() - 1)]
        div = (p < envelope.numel()) & (env > tiny)
        y = torch.where(div, y / torch.where(div, env, 1.0), y)
        y = F.pad(y, (0, (taps - 1) * hop))
        base, end = t0 * hop, (t1 - 1) * hop + n_fft
        left = torch.arange(base, max(base, min(end, n_fft // 2)), device=S.device)
        right = torch.arange(min(max(L + n_fft // 2, base), end), end, device=S.device)
        y[:, left - base] = y[:, n_fft - left - base]
        y[:, right - base] = y[:, 2 * L + n_fft - 2 - right - base]
        x = y.unfold(-1, n_fft, hop)[:, :t1 - t0] * window
        X = torch.cat([x @ fwd, x @ nyq], dim=-1).reshape(B, t1 - t0, F_, 2)
        re, im = X[..., 0], X[..., 1]
        sc = 1.0 / torch.clamp(torch.hypot(re, im), min=tiny)
        a = amp[:, t0:t1]
        out[:, t0:t1] = torch.complex(a * (re * sc), a * (im * sc))
    return out


def gl_rounds(S: torch.Tensor, amp: torch.Tensor, n_rounds: int, window: torch.Tensor,
              envelope: torch.Tensor, plan: GlRoundPlan) -> torch.Tensor:
    """``n_rounds`` Griffin-Lim rounds from S [B, T, 201] complex64 onto the
    magnitudes amp [B, T, 201] float32: one launch of csrc/griffin_lim.cu a
    round on a CUDA tensor (two buffers, S itself and one more, in turn: S
    is overwritten; and scratch for the inverse's re parts' sums), `gl_round_plain` round by round on a CPU one. ``plan``:
    `gl_round_plan` of (B, T); ``window`` [400] and ``envelope`` as
    `gl_round_plain` takes them. Raises on anything the kernel does not
    take."""
    B, T, F_ = S.shape
    if (plan.B, plan.T) != (B, T) or F_ != GL_N_FFT // 2 + 1:
        raise ValueError(f"gl_rounds: S {tuple(S.shape)} against plan {plan}")
    if S.dtype != torch.complex64 or amp.dtype != torch.float32 or amp.shape != S.shape:
        raise TypeError(f"gl_rounds: S must be complex64 and amp float32 {tuple(S.shape)}, got "
                        f"{S.dtype} and {amp.dtype} {tuple(amp.shape)}")
    if window.shape != (GL_N_FFT,) or envelope.shape != ((T - 1) * GL_HOP + GL_N_FFT,):
        raise ValueError(f"gl_rounds: window {tuple(window.shape)}, envelope "
                         f"{tuple(envelope.shape)} for T={T}")
    if S.device.type == "cpu":
        for _ in range(n_rounds):
            S = gl_round_plain(S, amp, window, envelope, plan)
        return S
    if S.device.type != "cuda":
        raise ValueError(f"gl_rounds: unsupported device {S.device}")
    for name, t in (("amp", amp), ("window", window), ("envelope", envelope)):
        if t.device != S.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"gl_rounds: {name} must be float32, contiguous, on {S.device}")
    if torch.is_grad_enabled() and (S.requires_grad or amp.requires_grad):
        raise ValueError("gl_rounds: the kernel has no gradient; autograd records here")
    bufs = (S.contiguous(), torch.empty_like(S))
    stash = torch.empty(plan.ctas * plan.rows * GL_N_FFT, dtype=torch.float32, device=S.device)
    lib = load_library("griffin_lim").lib
    bases = gl_bases(S.device)
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        rest = [t.data_ptr() for t in (amp, envelope, *bases, window, stash)]
        for r in range(n_rounds):
            src, dst = bufs[r % 2], bufs[1 - r % 2]
            rc = lib.scl_gl_round_f32(src.data_ptr(), dst.data_ptr(), *rest, B, T, plan.rows,
                                      plan.warp_rows, plan.lanes, plan.tiles, plan.smem_bytes,
                                      stream)
            if rc != 0:
                raise RuntimeError(f"gl_round kernel launch failed: CUDA error {rc} (plan {plan})")
            launch_counts["gl_round", torch.float32] += 1
    return bufs[n_rounds % 2]
