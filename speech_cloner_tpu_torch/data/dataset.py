"""Dataset base: filters, deterministic splits, feature cache, window samplers.

Counterpart of ``speech_cloner_tpu/data/dataset.py`` (`SoundDataset`) with
the same observable semantics: `get_ds_filter` with per-key split_d
trn/val/tst splits, the seed-0 utterance-level validation split, one random
crop per utterance per pass. The samplers draw from ``self.rng``
(``np.random.default_rng(seed)``) exactly as the JAX package's do (one
permutation per pass, one ``integers`` per cropped utterance), so both
packages cut the same windows from the same seed.

The feature cache is an ``.npz`` (the JAX package's is h5py, which the
card's machine does not have) under the same md5 key of the feature config,
``<stem>_<md5>.npz``, with one array per stream and utterance
(``"mfcc/<i>"``, ``"mel_dB/<i>"``, ``"power_dB/<i>"``, ``"phn/<i>"``),
built with the port's ``ops.mfcc_input`` on the CPU. `build_packed_cache`
mirrors it as a ``.sclpack`` for the host library's loader
(``data/packed_cache.py``), and `packed_spec_window_sampler` cuts the same
windows from it; the device-resident loader is ``data/device_dataset.py``.
`play` / `stop` are ``data/viz.py``'s at the corpus's sample rate.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Iterator

import numpy as np
import torch

from ..ops.features import FeatureConfig, feature_matrices, mfcc_input, one_hot, phn_frame_targets

CACHE_KEY_FIELDS = (
    "sample_rate", "pre_emphasis", "hop_length", "win_length", "n_mels",
    "n_mfcc", "n_fft", "window", "mfcc_normaleze_first_mfcc",
    "mfcc_norm_factor", "calc_mfcc_derivate", "M_dB_norm_factor",
    "P_dB_norm_factor", "mean_abs_amp_norm", "clip_output",
)
SPEC_STREAMS = ("mfcc", "mel_dB", "power_dB")


def feature_cache_key(cfg: FeatureConfig, extra: tuple = ()) -> str:
    """md5 over the feature-relevant fields (the JAX package's key)."""
    vals = [str(getattr(cfg, f, None)) for f in CACHE_KEY_FIELDS]
    return hashlib.md5("_".join(list(map(str, extra)) + vals).encode()).hexdigest()


class FeatureCache:
    """Read access to an ``.npz`` feature cache: ``cache[stream, i]`` loads
    one utterance's array; ``frames(i)`` its length in frames."""

    def __init__(self, path: str):
        self._z = np.load(path, allow_pickle=False)
        self._frames: dict[int, int] = {}

    def __getitem__(self, key: tuple[str, int]) -> np.ndarray:
        stream, i = key
        return self._z[f"{stream}/{int(i)}"]

    def __contains__(self, stream: str) -> bool:
        return f"{stream}/0" in self._z.files

    @property
    def n_utts(self) -> int:
        return sum(1 for k in self._z.files if k.startswith("mfcc/"))

    def frames(self, i: int) -> int:
        if i not in self._frames:
            self._frames[i] = int(self[("mfcc", i)].shape[0])
        return self._frames[i]

    def close(self):
        self._z.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SoundDataset:
    """Base for the TIMIT / ARCTIC readers. Subclasses fill ``self.ds`` (a
    dict of same-length numpy arrays, one row per utterance; 'wav' an object
    array of float32 waves) in ``read_dataset_from_disk``, then call
    ``finalize()``."""

    def __init__(self, ds_path: str, feat_cfg: FeatureConfig, *,
                 cache_dir: str | None = None, ds_norm=(0.0, 1.0),
                 n_timesteps: int = 400, seed: int | None = None, verbose: bool = False):
        self.ds_path = ds_path
        self.feat_cfg = feat_cfg
        self.cache_dir = cache_dir or ds_path
        self.ds_norm = tuple(ds_norm)
        self.n_timesteps = n_timesteps
        self.verbose = verbose
        self.rng = np.random.default_rng(seed)
        self.ds: dict[str, np.ndarray] = {}
        self.phn2idx: dict[str, int] = {}
        self.idx2phn: dict[int, str] = {}
        self.n_phn = 0

    # ------------------------------------------------------------ loading ---

    def read_dataset_from_disk(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    _OBJECT_COLS = ("wav", "phn_v", "txt_v", "wrd_v")

    def finalize(self):
        for k in self.ds:
            if k in self._OBJECT_COLS:
                col = np.empty(len(self.ds[k]), dtype=object)
                for i, v in enumerate(self.ds[k]):
                    col[i] = v
                self.ds[k] = col
            else:
                self.ds[k] = np.asarray(self.ds[k])
        self._normalize()

    def _normalize(self):
        """wav <- mult * (wav + add)."""
        add, mult = self.ds_norm
        if (add, mult) != (0.0, 1.0):
            for i in range(len(self.ds["wav"])):
                self.ds["wav"][i] = mult * (self.ds["wav"][i] + add)

    def load_or_build(self, wav_cache_name: str):
        """The decoded corpus, pickled under ``cache_dir`` after the first
        read. As in the JAX package, the pickle holds the corpus after
        ``finalize`` (normalized once) and the scaling is applied again after
        loading or building, so both packages see the same waves from either
        package's pickle."""
        path = os.path.join(self.cache_dir, wav_cache_name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.ds = pickle.load(f)
        else:
            self.read_dataset_from_disk()
            os.makedirs(self.cache_dir, exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(self.ds, f)
        self._normalize()

    # ----------------------------------------------------------- playback ---

    def play(self, wave, blocking: bool = False):
        """Audio playback at the corpus's sample rate (``viz.play``)."""
        from .viz import play

        play(wave, self.feat_cfg.sample_rate, blocking=blocking)

    def stop(self):
        from .viz import stop

        stop()

    # ---------------------------------------------------------- filtering ---

    def get_ds_filter(self, ds_filter_d: dict[str, Any] | None = None) -> np.ndarray:
        """Boolean utterance mask. Values may be scalars or lists (OR within a
        key, AND across keys); 'split_d' adds a deterministic per-key
        trn/val/tst split."""
        n = len(self.ds["wav"])
        f = np.ones(n, dtype=bool)
        if not ds_filter_d:
            return f
        ds_filter_d = dict(ds_filter_d)
        split_d = ds_filter_d.pop("split_d", None)
        for key, val in ds_filter_d.items():
            if key not in self.ds:
                raise KeyError(f"ds filter field {key!r} not in dataset")
            if val is None:
                continue
            pf = np.zeros(n, dtype=bool)
            for v in (val if isinstance(val, (list, tuple)) else [val]):
                pf |= self.ds[key] == v
            f &= pf
        if split_d is not None:
            split_key, split_type = split_d["split_key"], split_d["split_type"]
            p0, p1 = split_d["split_props_v"]
            if split_type not in ("trn", "val", "tst"):
                raise ValueError(f"bad split_type {split_type!r}")
            for k in np.unique(self.ds[split_key][f]):
                idx = np.flatnonzero(f & (self.ds[split_key] == k))
                n_trn, n_val = int(len(idx) * p0), int(len(idx) * p1)
                if split_type != "trn":
                    f[idx[:n_trn]] = False
                if split_type != "val":
                    f[idx[n_trn:n_val]] = False
                if split_type != "tst":
                    f[idx[n_val:]] = False
        return f

    def get_n_windows(self, prop_val: float = 0.3, ds_filter_d=None) -> tuple[int, int]:
        f = self.get_ds_filter(ds_filter_d)
        hop, T = self.feat_cfg.hop_length, self.n_timesteps
        n_windows = sum(w.shape[0] // (hop * T) for w in self.ds["wav"][f])
        n_trn = int((1 - prop_val) * n_windows)
        return n_trn, n_windows - n_trn

    # ------------------------------------------------------ feature cache ---

    @property
    def has_phones(self) -> bool:
        return "phn_v" in self.ds

    def spec_cache_path(self, base_name: str = "spec_cache.npz") -> str:
        stem, _ = os.path.splitext(base_name)
        return os.path.join(self.cache_dir, f"{stem}_{feature_cache_key(self.feat_cfg)}.npz")

    def build_spec_cache(self, base_name: str = "spec_cache.npz", force: bool = False) -> str:
        """Per-utterance {mfcc, mel_dB, power_dB[, phn one-hot]} -> ``.npz``,
        md5-keyed by the feature config; features from ``ops.mfcc_input`` on
        the CPU in float32."""
        path = self.spec_cache_path(base_name)
        if os.path.exists(path) and not force:
            return path
        os.makedirs(self.cache_dir, exist_ok=True)
        mel_w, dct = (torch.tensor(m) for m in feature_matrices(self.feat_cfg))
        arrays = {}
        for i in range(len(self.ds["wav"])):
            if self.verbose and i % 200 == 0:
                print(f" - cached {i}/{len(self.ds['wav'])}")
            y = np.asarray(self.ds["wav"][i], np.float32)
            feats = mfcc_input(torch.from_numpy(y), self.feat_cfg, mel_w=mel_w, dct=dct)
            for name, a in zip(SPEC_STREAMS, feats):
                arrays[f"{name}/{i}"] = a.numpy()
            if self.has_phones:
                idx = phn_frame_targets(y.shape[0], self.ds["phn_v"][i], self.phn2idx,
                                        self.feat_cfg.hop_length, self.feat_cfg.win_length)
                assert arrays[f"mfcc/{i}"].shape[0] == idx.shape[0], (i, idx.shape)
                arrays[f"phn/{i}"] = one_hot(idx, self.n_phn)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        return path

    def build_packed_cache(self, base_name: str = "spec_cache.npz") -> str:
        """Build (if needed) the ``.sclpack`` mirror of the ``.npz`` cache,
        beside it; returns its path."""
        from .packed_cache import pack_from_npz

        npz_path = self.build_spec_cache(base_name)
        pack_path = npz_path.rsplit(".", 1)[0] + ".sclpack"
        if not os.path.exists(pack_path):
            streams = (*SPEC_STREAMS, "phn") if self.has_phones else SPEC_STREAMS
            pack_from_npz(npz_path, pack_path, streams=streams)
        return pack_path

    def packed_spec_window_sampler(self, batch_size: int = 32, n_epochs: int = 1,
                                   randomize_samples: bool = True, sample_trn: bool = True,
                                   prop_val: float = 0.3, ds_filter_d=None, n_threads: int = 4,
                                   base_name: str = "spec_cache.npz"):
        """`spec_window_sampler` on the host library's loader: the same filter
        and split, one ``integers`` draw per utterance (short ones too, as
        the JAX sampler draws), batches gathered by its threads."""
        from .packed_cache import PackedReader, packed_window_sampler

        samples = self._val_split(np.flatnonzero(self.get_ds_filter(ds_filter_d)),
                                  prop_val, sample_trn)
        with PackedReader(self.build_packed_cache(base_name), n_threads=n_threads) as reader:
            yield from packed_window_sampler(reader, batch_size=batch_size,
                                             n_timesteps=self.n_timesteps, samples=samples,
                                             n_epochs=n_epochs, rng=self.rng,
                                             randomize=randomize_samples)

    def get_spec(self, i_sample: int, base_name: str = "spec_cache.npz") -> dict:
        """One utterance's cached features."""
        with FeatureCache(self.spec_cache_path(base_name)) as cache:
            return {n: cache[n, i_sample] for n in (*SPEC_STREAMS, "phn") if n in cache}

    # ------------------------------------------------------------ splits ---

    @staticmethod
    def _val_split(samples: np.ndarray, prop_val: float, sample_trn: bool) -> np.ndarray:
        """Fixed seed-0 utterance split: the last ``prop_val`` of a
        default_rng(0) permutation is validation; when that rounds to no
        utterance, train keeps everything and validation is empty."""
        if prop_val <= 0.0:
            return samples
        idx = np.random.default_rng(0).permutation(len(samples))
        n_val = int(prop_val * len(samples))
        if n_val == 0:
            return samples if sample_trn else samples[:0]
        return samples[idx[:-n_val] if sample_trn else idx[-n_val:]]

    # ----------------------------------------------------------- sampling ---

    def spec_window_sampler(self, batch_size: int = 32, n_epochs: int = 1,
                            randomize_samples: bool = True, sample_trn: bool = True,
                            prop_val: float = 0.3, ds_filter_d=None, yield_idxs: bool = False,
                            base_name: str = "spec_cache.npz") -> Iterator:
        """(mfcc, mel_dB, power_dB[, idxs]) float32 batches of [B, n_timesteps, .]
        windows: one random crop per utterance per pass, short utterances
        zero-padded."""
        samples = self._val_split(np.flatnonzero(self.get_ds_filter(ds_filter_d)),
                                  prop_val, sample_trn)
        T = self.n_timesteps
        with FeatureCache(self.spec_cache_path(base_name)) as cache:
            batch: list[tuple] = []
            for _ in range(n_epochs):
                order = self.rng.permutation(samples) if randomize_samples else samples
                for i in order:
                    spec_len = cache.frames(int(i))
                    if spec_len <= T:
                        i_s = 0
                        rows = [_pad_rows(cache[n, i], T) for n in SPEC_STREAMS]
                    else:
                        i_s = int(self.rng.integers(0, spec_len - T))
                        rows = [cache[n, i][i_s:i_s + T] for n in SPEC_STREAMS]
                    batch.append((*rows, (i_s, i_s + T, int(i))))
                    if len(batch) == batch_size:
                        yield _stack_batch(batch, yield_idxs)
                        batch = []

    def window_sampler(self, batch_size: int = 32, n_epochs: int = 1,
                       randomize_samples: bool = True, ds_filter_d=None,
                       yield_idxs: bool = False, skip_short: bool = True,
                       pad_phn: str | None = None,
                       base_name: str = "spec_cache.npz") -> Iterator:
        """(mfcc, phn_onehot[, idxs]) training batches; with ``pad_phn``, short
        utterances are padded and labelled pad_phn, else skipped."""
        samples = np.flatnonzero(self.get_ds_filter(ds_filter_d))
        T = self.n_timesteps
        with FeatureCache(self.spec_cache_path(base_name)) as cache:
            batch: list[tuple] = []
            for _ in range(n_epochs):
                order = self.rng.permutation(samples) if randomize_samples else samples
                for i in order:
                    spec_len = cache.frames(int(i))
                    if spec_len <= T:
                        if skip_short and pad_phn is None:
                            continue
                        mfcc = _pad_rows(cache["mfcc", i], T)
                        phn = _pad_rows(cache["phn", i], T)
                        if pad_phn is not None:
                            phn[spec_len:, self.phn2idx[pad_phn]] = 1.0
                        i_s = 0
                    else:
                        i_s = int(self.rng.integers(0, spec_len - T))
                        mfcc = cache["mfcc", i][i_s:i_s + T]
                        phn = cache["phn", i][i_s:i_s + T]
                    batch.append((mfcc, phn, (i_s, i_s + T, int(i))))
                    if len(batch) == batch_size:
                        yield _stack_batch(batch, yield_idxs)
                        batch = []


def window_index_batches(n_frames: np.ndarray, samples: np.ndarray, batch_size: int, T: int,
                         n_epochs: int = 1, rng=None, randomize: bool = True):
    """(utts [B], starts [B]) int32 batches: one random crop start per
    utterance of ``samples`` per pass, drawn as the JAX package's packed and
    device samplers draw (one permutation per pass, then one
    ``integers(0, max(frames - T, 1))`` per utterance); a last partial batch
    is dropped. The packed and the device-resident loaders gather from these."""
    rng = rng or np.random.default_rng(0)
    samples = np.asarray(samples)
    for _ in range(n_epochs):
        order = rng.permutation(samples) if randomize else samples
        for i0 in range(0, len(order) - batch_size + 1, batch_size):
            utts = order[i0:i0 + batch_size].astype(np.int32)
            yield utts, np.asarray([rng.integers(0, max(n - T, 1)) for n in n_frames[utts]],
                                   np.int32)


def _pad_rows(a: np.ndarray, T: int) -> np.ndarray:
    pad = T - a.shape[0]
    if pad <= 0:
        return a[:T]
    return np.concatenate([a, np.zeros((pad, a.shape[1]), a.dtype)], axis=0)


def _stack_batch(batch: list[tuple], yield_idxs: bool):
    cols = list(zip(*batch))
    arrays = [np.stack(c).astype(np.float32) for c in cols[:-1]]
    if yield_idxs:
        arrays.append(np.asarray(cols[-1], dtype=np.int64))
    return tuple(arrays)
