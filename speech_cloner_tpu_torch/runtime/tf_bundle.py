"""Pure-Python reader for TensorFlow checkpoint bundles (v2 format).

The port's own copy of ``speech_cloner_tpu/runtime/tf_bundle.py`` (the port
imports nothing of the JAX package). A bundle is a ``<prefix>.index`` (a
LevelDB-style SSTable whose values are BundleEntryProto messages) plus
``<prefix>.data-00000-of-00001`` shards of raw little-endian tensor bytes.

Implements exactly the subset the reference's checkpoints use: uncompressed
table blocks with prefix-compressed keys, varint/length-delimited protobuf
fields, one shard, no tensor slices. numpy only; no TensorFlow.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (the subset that appears in checkpoints)
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: np.bytes_, 9: np.int64, 10: np.bool_, 14: np.uint16,
    17: np.uint32, 18: np.uint64, 19: np.float16,
}


def _varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _block_entries(block: bytes):
    """Iterate (key, value) of a table block (prefix-compressed keys)."""
    if len(block) < 4:
        return
    n_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos : pos + unshared]
        pos += unshared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    block = data[offset : offset + size]
    compression = data[offset + size]
    if compression != 0:
        raise ValueError(f"compressed table block (type {compression}) unsupported")
    return block


def _parse_shape(msg: bytes) -> list[int]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1}."""
    dims = []
    pos = 0
    while pos < len(msg):
        tag, pos = _varint(msg, pos)
        field, wire = tag >> 3, tag & 7
        if field == 2 and wire == 2:  # Dim submessage
            ln, pos = _varint(msg, pos)
            sub = msg[pos : pos + ln]
            pos += ln
            spos = 0
            size = 1
            while spos < len(sub):
                stag, spos = _varint(sub, spos)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 0:
                    size, spos = _varint(sub, spos)
                elif swire == 2:
                    sln, spos = _varint(sub, spos)
                    spos += sln
                else:
                    _, spos = _varint(sub, spos)
            dims.append(size)
        elif wire == 0:
            _, pos = _varint(msg, pos)
        elif wire == 2:
            ln, pos = _varint(msg, pos)
            pos += ln
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
    return dims


def _parse_entry(msg: bytes) -> dict:
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5, crc=6."""
    out = {"dtype": 1, "shape": [], "shard_id": 0, "offset": 0, "size": 0}
    pos = 0
    while pos < len(msg):
        tag, pos = _varint(msg, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(msg, pos)
            if field == 1:
                out["dtype"] = val
            elif field == 3:
                out["shard_id"] = val
            elif field == 4:
                out["offset"] = val
            elif field == 5:
                out["size"] = val
        elif wire == 2:
            ln, pos = _varint(msg, pos)
            if field == 2:
                out["shape"] = _parse_shape(msg[pos : pos + ln])
            pos += ln
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
    return out


class BundleReader:
    """tf.train.load_checkpoint equivalent for simple (single-shard,
    unsliced) checkpoints — everything the reference ships."""

    def __init__(self, ckpt_prefix: str):
        self.prefix = ckpt_prefix
        with open(ckpt_prefix + ".index", "rb") as f:
            idx = f.read()
        if len(idx) < 48:
            raise ValueError(f"{ckpt_prefix}.index: {len(idx)} bytes, shorter than a "
                             "table footer")

        magic = struct.unpack("<Q", idx[-8:])[0]
        if magic != _TABLE_MAGIC:
            raise ValueError(f"{ckpt_prefix}.index: bad table magic {magic:#x}")
        footer = idx[-48:-8]
        _, p = _varint(footer, 0)           # metaindex offset
        _, p = _varint(footer, p)           # metaindex size
        index_off, p = _varint(footer, p)   # index block handle
        index_size, p = _varint(footer, p)

        self.entries: dict[str, dict] = {}
        for _, handle in _block_entries(_read_block(idx, index_off, index_size)):
            off, hp = _varint(handle, 0)
            size, _ = _varint(handle, hp)
            for key, value in _block_entries(_read_block(idx, off, size)):
                if key == b"":
                    continue  # BundleHeaderProto
                self.entries[key.decode()] = _parse_entry(value)

        self._shards: dict[int, np.memmap] = {}

    # --- tf.train.CheckpointReader-compatible surface ---

    def get_variable_to_shape_map(self) -> dict[str, list[int]]:
        return {k: list(v["shape"]) for k, v in self.entries.items()}

    def has_tensor(self, name: str) -> bool:
        return name in self.entries

    def _shard(self, shard_id: int) -> np.memmap:
        if shard_id not in self._shards:
            path = None
            for total in range(1, 64):
                cand = f"{self.prefix}.data-{shard_id:05d}-of-{total:05d}"
                if os.path.exists(cand):
                    path = cand
                    break
            if path is None:
                raise FileNotFoundError(f"data shard {shard_id} for {self.prefix}")
            self._shards[shard_id] = np.memmap(path, dtype=np.uint8, mode="r")
        return self._shards[shard_id]

    def get_tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        dtype = _DTYPES[e["dtype"]]
        shard = self._shard(e["shard_id"])
        raw = bytes(shard[e["offset"] : e["offset"] + e["size"]])
        arr = np.frombuffer(raw, dtype=dtype)
        return arr.reshape(e["shape"]) if e["shape"] else arr.reshape(())
