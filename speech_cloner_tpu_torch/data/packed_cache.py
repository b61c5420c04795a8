"""Packed feature cache (.sclpack) and the host library that serves it.

Counterpart of ``speech_cloner_tpu/data/packed_cache.py``: a flat,
memory-mappable copy of the ``.npz`` feature cache, read by the port's own
host C++ library ``csrc/scl_data.cc`` (mmap, a threaded window gather, PCM
decoding), bound with ctypes. The library is built with the host C++
compiler at first use into ``build/torch_kernels/`` at the root of the
checkout, named by a hash of the source and the flags, as
``ops/cuda_kernels.py`` builds the scan kernels; a failed build raises with
the compiler's output. `PackedReader(use_native=False)` is the numpy
reader of the same file, which the caller asks for by name: a native
reader never gives way to it.

Layout (little-endian):
  'SCLPACK1' | u32 n_utts | u32 n_streams
  u32 dims[n_streams]          # columns per stream
  u32 n_frames[n_utts]         # rows per utterance (shared across streams)
  u64 offsets[n_utts]          # byte offset of each utterance's data block
  data: per utt, streams concatenated, float32 row-major
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import struct
from pathlib import Path

import numpy as np

from ..ops.cuda_kernels import build_shared_library
from .dataset import FeatureCache, window_index_batches

MAGIC = b"SCLPACK1"
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "scl_data.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def _cxx() -> str:
    found = shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError("no C++ compiler (c++ or g++) on the PATH: building "
                           f"{_SRC.name} needs one")
    return found


@functools.lru_cache(maxsize=None)
def load_native() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/scl_data.cc``; raises
    with the compiler's output when the build fails."""
    so = build_shared_library(_SRC, _cxx, CXX_FLAGS)[0]
    lib = ctypes.CDLL(str(so))
    vp, ci, i32p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)
    lib.scl_open.restype = vp
    lib.scl_open.argtypes = [ctypes.c_char_p]
    lib.scl_close.restype = None
    lib.scl_close.argtypes = [vp]
    for f in (lib.scl_n_utts, lib.scl_n_streams):
        f.restype = ci
        f.argtypes = [vp]
    for f in (lib.scl_stream_dim, lib.scl_n_frames):
        f.restype = ci
        f.argtypes = [vp, ci]
    lib.scl_gather_batch.restype = ci
    lib.scl_gather_batch.argtypes = [vp, i32p, i32p, ci, ci, ci,
                                     ctypes.POINTER(ctypes.c_float), ci]
    lib.scl_decode_pcm.restype = ctypes.c_int64
    lib.scl_decode_pcm.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64, i32p]
    return lib


def native_decode_pcm(path: str):
    """16-bit PCM RIFF WAV or NIST SPHERE -> (float32 mono, rate) through the
    host library; None for a file it does not decode (other sample widths,
    shorten-compressed SPHERE)."""
    lib = load_native()
    sr = ctypes.c_int32(0)
    n = lib.scl_decode_pcm(os.fsencode(path), None, 0, ctypes.byref(sr))
    if n < 0:
        return None
    out = np.empty(n, np.float32)
    got = lib.scl_decode_pcm(os.fsencode(path),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
                             ctypes.byref(sr))
    if got != n:
        return None
    return out, int(sr.value)


def write_pack(path: str, utts: list[dict[str, np.ndarray]], streams: list[str]):
    """Per-utterance feature dicts (the same rows in every stream) -> .sclpack."""
    n_utts = len(utts)
    dims = [int(utts[0][s].shape[1]) for s in streams]
    n_frames = [int(u[streams[0]].shape[0]) for u in utts]
    for u in utts:
        for s in streams:
            if u[s].shape[0] != u[streams[0]].shape[0]:
                raise ValueError("streams must share frame count")

    header = MAGIC + struct.pack("<II", n_utts, len(streams))
    header += struct.pack(f"<{len(streams)}I", *dims)
    header += struct.pack(f"<{n_utts}I", *n_frames)
    offsets, cur = [], len(header) + 8 * n_utts
    for i in range(n_utts):
        offsets.append(cur)
        cur += n_frames[i] * sum(dims) * 4
    header += struct.pack(f"<{n_utts}Q", *offsets)

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        for u in utts:
            for s in streams:
                f.write(np.ascontiguousarray(u[s], dtype=np.float32).tobytes())
    os.replace(tmp, path)
    return path


def pack_from_npz(npz_path: str, out_path: str, streams=("mfcc", "mel_dB", "power_dB")):
    """An ``.npz`` feature cache (data/dataset.py) -> .sclpack, the streams
    it holds in the given order."""
    with FeatureCache(npz_path) as cache:
        streams = [s for s in streams if s in cache]
        n = cache.n_utts
        utts = [{s: cache[s, i] for s in streams} for i in range(n)]
    return write_pack(out_path, utts, streams)


class PackedReader:
    """Window crops out of a .sclpack: the host library's threaded gather
    (``use_native``; raises when the library cannot be built or the file
    opened), or numpy over a memory map."""

    def __init__(self, path: str, n_threads: int = 4, use_native: bool = True):
        self.path = path
        self.n_threads = n_threads
        self._lib = self._h = None
        if not use_native:
            self._open_python()
            return
        self._lib = load_native()
        self._h = self._lib.scl_open(os.fsencode(path))
        if not self._h:
            raise RuntimeError(f"scl_open could not open {path} as a .sclpack")
        self.n_utts = self._lib.scl_n_utts(self._h)
        self.n_streams = self._lib.scl_n_streams(self._h)
        self.dims = [self._lib.scl_stream_dim(self._h, s) for s in range(self.n_streams)]
        self.n_frames = np.asarray([self._lib.scl_n_frames(self._h, i)
                                    for i in range(self.n_utts)])

    def _open_python(self):
        with open(self.path, "rb") as f:
            head = f.read(16)
            if head[:8] != MAGIC:
                raise ValueError(f"{self.path}: bad sclpack magic")
            self.n_utts, self.n_streams = struct.unpack("<II", head[8:])
            self.dims = list(struct.unpack(f"<{self.n_streams}I", f.read(4 * self.n_streams)))
            self.n_frames = np.asarray(struct.unpack(f"<{self.n_utts}I", f.read(4 * self.n_utts)))
            self.offsets = np.asarray(struct.unpack(f"<{self.n_utts}Q", f.read(8 * self.n_utts)))
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")

    @property
    def native(self) -> bool:
        return self._lib is not None

    def gather(self, utts: np.ndarray, starts: np.ndarray, T: int, stream: int) -> np.ndarray:
        """[B] utterance ids + [B] start frames -> [B, T, dim] float32 windows,
        zero past the utterance's end."""
        B = len(utts)
        out = np.empty((B, T, self.dims[stream]), np.float32)
        if self._lib is not None:
            u = np.ascontiguousarray(utts, np.int32)
            s = np.ascontiguousarray(starts, np.int32)
            i32p = ctypes.POINTER(ctypes.c_int32)
            rc = self._lib.scl_gather_batch(
                self._h, u.ctypes.data_as(i32p), s.ctypes.data_as(i32p), B, T, stream,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self.n_threads)
            if rc != 0:
                raise RuntimeError(f"scl_gather_batch failed rc={rc}")
            return out
        for b in range(B):
            i, s0 = int(utts[b]), int(starts[b])
            off = int(self.offsets[i]) + sum(int(self.n_frames[i]) * self.dims[st] * 4
                                             for st in range(stream))
            arr = np.frombuffer(self._mm, np.float32, count=int(self.n_frames[i]) * self.dims[stream],
                                offset=off).reshape(-1, self.dims[stream])
            n_copy = max(0, min(T, arr.shape[0] - s0))
            out[b, :n_copy] = arr[s0:s0 + n_copy]
            out[b, n_copy:] = 0.0
        return out

    def close(self):
        if self._lib is not None and self._h:
            self._lib.scl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def packed_window_sampler(reader: PackedReader, *, batch_size=32, n_timesteps=400,
                          streams=(0, 1, 2), samples=None, n_epochs=1, rng=None,
                          randomize=True):
    """One random crop per utterance per pass over ``samples`` (default: all),
    the JAX sampler's draws (`dataset.window_index_batches`), batches
    assembled by ``reader.gather``."""
    samples = np.arange(reader.n_utts) if samples is None else samples
    for utts, starts in window_index_batches(reader.n_frames, samples, batch_size, n_timesteps,
                                             n_epochs, rng, randomize):
        yield tuple(reader.gather(utts, starts, n_timesteps, s) for s in streams)
