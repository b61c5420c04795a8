"""Any target speaker's corpus: a directory of mp3/wav/ogg/flac files
(audiobook-style), no phone labels.

Counterpart of ``speech_cloner_tpu/data/target_spk.py``: the files of the
directory in sorted order but those whose name holds an excluded part,
decoded by the port's `load_audio` at the target rate, a duration report,
the ``.npz`` feature cache without phones, and the sampler's sequential
(unseeded) head/tail split whose batches are ``batch_size`` random crops of
ONE file.
"""

from __future__ import annotations

import os

import numpy as np

from .audio_io import load_audio
from .dataset import SPEC_STREAMS, FeatureCache, SoundDataset, _stack_batch


class TargetSpeaker(SoundDataset):
    def __init__(self, ds_path: str, feat_cfg, *, ds_norm=(0.0, 1.0), exclude_files_with=(),
                 extensions=(".mp3", ".wav", ".ogg", ".flac"),
                 wav_cache_name: str = "target_cache.pickle", **kw):
        super().__init__(ds_path, feat_cfg, ds_norm=ds_norm, **kw)
        self.exclude_files_with = tuple(exclude_files_with)
        self.extensions = tuple(extensions)
        self.load_or_build(wav_cache_name)

    def read_dataset_from_disk(self):
        self.ds = {"wav": [], "name": [], "len": []}
        for name in sorted(os.listdir(self.ds_path)):
            if not name.lower().endswith(self.extensions):
                continue
            if any(excl in name for excl in self.exclude_files_with):
                if self.verbose:
                    print(f" excluded: {name}")
                continue
            y = load_audio(os.path.join(self.ds_path, name), self.feat_cfg.sample_rate)
            self.ds["wav"].append(y)
            self.ds["name"].append(name)
            self.ds["len"].append(y.shape[0] / self.feat_cfg.sample_rate)
        if self.verbose:
            total = int(sum(self.ds["len"]))
            print(f" - TargetSpeaker: {len(self.ds['wav'])} files, "
                  f"{total // 3600:02d}:{total % 3600 // 60:02d}:{total % 60:02d} total")
        self.finalize()

    def spec_window_sampler(self, batch_size=32, n_epochs=1, randomize_samples=True,
                            sample_trn=True, prop_val=0.3, ds_filter_d=None,
                            yield_idxs=False, base_name="spec_cache.npz"):
        """Head (train) / tail (validation) split by file order, then
        ``batch_size`` random crops of ONE file per batch; files no longer
        than a window are skipped."""
        n = len(self.ds["wav"])
        cut = int((1 - prop_val) * n)
        samples = np.arange(0, cut) if sample_trn else np.arange(cut, n)
        T = self.n_timesteps
        with FeatureCache(self.spec_cache_path(base_name)) as cache:
            for _ in range(n_epochs):
                order = self.rng.permutation(samples) if randomize_samples else samples
                for i in order:
                    spec_len = cache.frames(int(i))
                    if spec_len <= T:
                        continue
                    feats = [cache[nm, i] for nm in SPEC_STREAMS]
                    batch = []
                    for _ in range(batch_size):
                        i_s = int(self.rng.integers(0, spec_len - T))
                        batch.append((*(a[i_s:i_s + T] for a in feats), (i_s, i_s + T, int(i))))
                    yield _stack_batch(batch, yield_idxs)
