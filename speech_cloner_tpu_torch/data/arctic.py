"""CMU ARCTIC reader: the decoder's target-speaker dataset.

Counterpart of ``speech_cloner_tpu/data/arctic.py``: walks
cmu_arctic/cmu_us_<spk>_arctic/{wav,lab}, parses festival .lab end-time
files into (start, end, phone) sample segments, the 43-phone inventory, and
a window sampler that pads short utterances with 'pau' frames.
"""

from __future__ import annotations

import os

import numpy as np

from .audio_io import load_audio
from .dataset import FeatureCache, SoundDataset, _pad_rows, _stack_batch

PHONEMES_43 = np.array([
    "b", "d", "g", "p", "t", "k",
    "jh", "ch",
    "s", "sh", "z", "zh", "f", "th", "v", "dh",
    "m", "n", "ng",
    "l", "r", "w", "y", "hh",
    "aa", "ae", "ah", "ao", "aw", "ax", "ay", "eh", "er", "ey",
    "ih", "iy", "ow", "oy", "uh", "uw",
    "H#", "pau", "ssil",
])


class ARCTIC(SoundDataset):
    def __init__(self, ds_path: str, feat_cfg, *, ds_norm=(0.0, 1.0),
                 wav_cache_name: str = "arctic_cache.pickle", **kw):
        super().__init__(ds_path, feat_cfg, ds_norm=ds_norm, **kw)
        self.phn2idx = {p: i for i, p in enumerate(PHONEMES_43)}
        self.idx2phn = {i: p for i, p in enumerate(PHONEMES_43)}
        self.n_phn = len(PHONEMES_43)
        self.load_or_build(wav_cache_name)

    def read_dataset_from_disk(self):
        self.ds = {k: [] for k in ("wav", "spk_id", "phn_v", "sts_id")}
        for spk_dir in sorted(os.listdir(self.ds_path)):
            abs_spk = os.path.join(self.ds_path, spk_dir)
            wav_dir, lab_dir = os.path.join(abs_spk, "wav"), os.path.join(abs_spk, "lab")
            if not os.path.isdir(abs_spk) or not os.path.isdir(wav_dir):
                continue
            parts = spk_dir.split("_")
            spk_id = parts[-2] if len(parts) >= 2 else spk_dir
            for wav_name in sorted(os.listdir(wav_dir)):
                if not wav_name.endswith(".wav"):
                    continue
                self.ds["wav"].append(load_audio(os.path.join(wav_dir, wav_name),
                                                 self.feat_cfg.sample_rate))
                self.ds["phn_v"].append(
                    self._read_lab(os.path.join(lab_dir, wav_name.replace(".wav", ".lab"))))
                self.ds["spk_id"].append(spk_id)
                self.ds["sts_id"].append(wav_name.split("_")[-1].split(".")[0])
        if self.verbose:
            print(f" - ARCTIC: read {len(self.ds['wav'])} utterances")
        self.finalize()

    def _read_lab(self, path: str):
        """festival .lab: 'end_time_s <num> phone' lines -> cumulative
        (start, end, phone) in samples."""
        out, last = [], 0
        with open(path) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) == 3:
                    end = int(self.feat_cfg.sample_rate * float(parts[0]))
                    out.append((last, end, parts[2]))
                    last = end
        return out

    def window_sampler(self, batch_size=32, n_epochs=1, randomize_samples=True,
                       sample_trn=True, prop_val=0.3,
                       ds_filter_d={"spk_id": ["bdl", "rms", "slt", "clb"]},
                       yield_idxs=False, base_name="spec_cache.npz"):
        """(mfcc, phn_onehot[, idxs]) batches: the seed-0 validation split,
        short utterances padded with 'pau' frames."""
        samples = self._val_split(np.flatnonzero(self.get_ds_filter(ds_filter_d)),
                                  prop_val, sample_trn)
        T = self.n_timesteps
        with FeatureCache(self.spec_cache_path(base_name)) as cache:
            batch = []
            for _ in range(n_epochs):
                order = self.rng.permutation(samples) if randomize_samples else samples
                for i in order:
                    spec_len = cache.frames(int(i))
                    if spec_len <= T:
                        mfcc = _pad_rows(cache["mfcc", i], T)
                        phn = _pad_rows(cache["phn", i], T)
                        phn[spec_len:, self.phn2idx["pau"]] = 1.0
                        i_s = 0
                    else:
                        i_s = int(self.rng.integers(0, spec_len - T))
                        mfcc = cache["mfcc", i][i_s:i_s + T]
                        phn = cache["phn", i][i_s:i_s + T]
                    batch.append((mfcc, phn, (i_s, i_s + T, int(i))))
                    if len(batch) == batch_size:
                        yield _stack_batch(batch, yield_idxs)
                        batch = []
