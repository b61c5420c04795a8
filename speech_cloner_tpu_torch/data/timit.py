"""TIMIT reader: phoneme-labelled utterances for encoder training.

Counterpart of ``speech_cloner_tpu/data/timit.py``: the walk of
TRAIN|TEST/DR1-8/<spk>/<utt>.{WAV,PHN,TXT,WRD}, the 61-phoneme inventory,
the 61 -> 39 reduction, on the `SoundDataset` base (filters, cache, window
samplers), the speaker classes and windows the speaker-ID verifier trains
on (`prepare_speaker_dicts`, `speaker_spec_sampler`), and the per-frame and
per-phone samplers (`frame_sampler`, `phoneme_sampler`).
"""

from __future__ import annotations

import os

import numpy as np

from .audio_io import load_audio
from .dataset import FeatureCache, SoundDataset

PHONEMES_61 = np.array([
    "b", "d", "g", "p", "t", "k", "dx", "q",                # stops
    "bcl", "dcl", "gcl", "pcl", "tcl", "kcl",                # closures
    "jh", "ch",                                              # affricates
    "s", "sh", "z", "zh", "f", "th", "v", "dh",              # fricatives
    "m", "n", "ng", "em", "en", "eng", "nx",                 # nasals
    "l", "r", "w", "y", "hh", "hv", "el",                    # semivowels/glides
    "iy", "ih", "eh", "ey", "ae", "aa", "aw", "ay", "ah",
    "ao", "oy", "ow", "uh", "uw", "ux", "er", "ax", "ix",
    "axr", "ax-h",                                           # vowels
    "pau", "epi", "h#",                                      # others
])

# TIMIT 61 -> CMU/MIT 39 reduction; 'q' drops.
PHN_61_TO_39 = {
    "p": "p", "t": "t", "k": "k", "pcl": "sil", "tcl": "sil", "kcl": "sil",
    "dx": "dx", "m": "m", "n": "n", "ng": "ng", "nx": "n", "s": "s",
    "ch": "ch", "th": "th", "f": "f", "l": "l", "r": "r", "y": "y",
    "hh": "hh", "eh": "eh", "ao": "aa", "aa": "aa", "uw": "uw", "er": "er",
    "ay": "ay", "ey": "ey", "aw": "aw", "ax": "ah", "ix": "ih", "b": "b",
    "d": "d", "g": "g", "bcl": "sil", "dcl": "sil", "gcl": "sil", "z": "z",
    "em": "m", "en": "n", "eng": "ng", "sh": "sh", "zh": "sh", "jh": "jh",
    "dh": "dh", "v": "v", "el": "l", "w": "w", "h#": "sil", "epi": "sil",
    "hv": "hh", "ih": "ih", "ae": "ae", "ah": "ah", "uh": "uh", "ux": "uw",
    "oy": "oy", "iy": "iy", "ow": "ow", "axr": "er", "ax-h": "ah",
    "pau": "sil", "q": "",
}

PHONEMES_39 = np.unique([v for v in PHN_61_TO_39.values() if v])


def conv_matrix_61_to_39() -> np.ndarray:
    """[61, 39] 0/1 conversion matrix."""
    M = np.zeros((61, 39), dtype=np.int32)
    idx39 = {p: i for i, p in enumerate(PHONEMES_39)}
    for i, p61 in enumerate(PHONEMES_61):
        if PHN_61_TO_39[p61]:
            M[i, idx39[PHN_61_TO_39[p61]]] = 1
    return M


class TIMIT(SoundDataset):
    def __init__(self, ds_path: str, feat_cfg, *, ds_norm=(0.0, 10.0),
                 wav_cache_name: str = "timit_cache.pickle", **kw):
        super().__init__(ds_path, feat_cfg, ds_norm=ds_norm, **kw)
        if feat_cfg.sample_rate != 16000:
            raise ValueError("TIMIT requires sample_rate == 16000")
        self.make_phoneme_conversion_dicts()
        self.load_or_build(wav_cache_name)

    def make_phoneme_conversion_dicts(self):
        self.phn2idx = {p: i for i, p in enumerate(PHONEMES_61)}
        self.idx2phn = {i: p for i, p in enumerate(PHONEMES_61)}
        self.n_phn = len(PHONEMES_61)

    def conv_61phn_to_39phn(self, phn61_onehot: np.ndarray) -> np.ndarray:
        """One-hot 61 -> normalized 39, 'q' frames taking the nearest
        non-silent neighbour's (the earlier one first)."""
        ret = phn61_onehot @ conv_matrix_61_to_39()
        sums = ret.sum(axis=1)
        for i_q in np.flatnonzero(sums == 0):
            before = [i for i in range(i_q - 1, -1, -1) if sums[i] != 0]
            after = [i for i in range(i_q, len(sums)) if sums[i] != 0]
            if not before and not after:
                raise ValueError("no replacement frame for phoneme 'q'")
            ret[i_q] = ret[(before or after)[0]]
        return ret / ret.sum(axis=-1, keepdims=True)

    def read_dataset_from_disk(self):
        self.ds = {k: [] for k in ("wav", "ds_type", "spk_d", "spk_g", "spk_id", "sts_id",
                                   "phn_v", "txt_v", "wrd_v")}
        for ds_type in ("TRAIN", "TEST"):
            for dr in sorted(os.listdir(os.path.join(self.ds_path, ds_type))):
                dr_path = os.path.join(self.ds_path, ds_type, dr)
                if not os.path.isdir(dr_path):
                    continue
                for spk in sorted(os.listdir(dr_path)):
                    spk_path = os.path.join(dr_path, spk)
                    for stem in sorted({f.split(".")[0] for f in os.listdir(spk_path)}):
                        base = os.path.join(spk_path, stem)
                        self.ds["wav"].append(load_audio(base + ".WAV", self.feat_cfg.sample_rate))
                        self.ds["phn_v"].append(self._read_segments(base + ".PHN"))
                        self.ds["txt_v"].append(self._read_segments(base + ".TXT")[0])
                        self.ds["wrd_v"].append(self._read_segments(base + ".WRD"))
                        self.ds["ds_type"].append(ds_type)
                        self.ds["spk_d"].append(dr)
                        self.ds["spk_g"].append(spk[0])
                        self.ds["spk_id"].append(spk[1:])
                        self.ds["sts_id"].append(stem)
        if self.verbose:
            print(f" - TIMIT: read {len(self.ds['wav'])} utterances")
        self.finalize()

    # ----------------------------------------------------------- samplers ---

    def frame_sampler(self, batch_size=32, n_epochs=1, randomize_samples=True,
                      ds_filter_d={"ds_type": "TRAIN"}, base_name="spec_cache.npz"):
        """Per-frame (mfcc rows, phone one-hot rows) batches over whole
        utterances in (permuted) order; a trailing partial batch is dropped."""
        samples = np.flatnonzero(self.get_ds_filter(ds_filter_d))
        with FeatureCache(self.spec_cache_path(base_name)) as cache:
            x_v, y_v = [], []
            for _ in range(n_epochs):
                order = self.rng.permutation(samples) if randomize_samples else samples
                for i in order:
                    mfcc, phn = cache["mfcc", i], cache["phn", i]
                    for t in range(mfcc.shape[0]):
                        x_v.append(mfcc[t])
                        y_v.append(phn[t])
                        if len(x_v) == batch_size:
                            yield np.stack(x_v), np.stack(y_v)
                            x_v, y_v = [], []

    def phoneme_sampler(self, batch_size=32, n_epochs=1, n_padd=3000, ds_filter_d=None,
                        randomize=True):
        """Raw waveform snippets of one random phone per utterance, the last
        ``n_padd`` samples up to its end, left-zero-padded to ``n_padd``,
        with the phone's label."""
        samples = np.flatnonzero(self.get_ds_filter(ds_filter_d))
        for _ in range(n_epochs):
            order = self.rng.permutation(samples) if randomize else samples
            x_v, y_v = [], []
            for i in order:
                phn_v = self.ds["phn_v"][i]
                a, b, trg = phn_v[int(self.rng.integers(0, len(phn_v)))]
                snippet = self.ds["wav"][i][max(a, b - n_padd):b]
                x_v.append(np.concatenate([np.zeros(n_padd - len(snippet)), snippet]))
                y_v.append(trg)
                if len(x_v) == batch_size:
                    yield np.stack(x_v), np.asarray(y_v)
                    x_v, y_v = [], []

    # ---------------------------------------------------------- speakers ---

    def prepare_speaker_dicts(self, ds_filter_d=None) -> int:
        """The speaker classes of the filtered utterances, in sorted speaker-id
        order (``all_spk_id_v``, ``spk_id2class``, ``spk_class2id``); returns
        their number."""
        f = self.get_ds_filter(ds_filter_d)
        self.all_spk_id_v = list(np.unique(self.ds["spk_id"][f]))
        self.spk_id2class = {s: i for i, s in enumerate(self.all_spk_id_v)}
        self.spk_class2id = {i: s for i, s in enumerate(self.all_spk_id_v)}
        return len(self.all_spk_id_v)

    def speaker_spec_sampler(self, batch_size=32, n_epochs=1, ds_filter_d=None,
                             randomize_samples=True, base_name="spec_cache.npz"):
        """(mfcc, mel_dB, power_dB, speaker one-hot) batches: the window
        sampler's crops of the filtered utterances (no validation split),
        each labelled with its speaker's class."""
        n_spk = self.prepare_speaker_dicts(ds_filter_d)
        eye = np.eye(n_spk, dtype=np.float32)
        for mfcc, mel, power, idxs in self.spec_window_sampler(
                batch_size=batch_size, n_epochs=n_epochs,
                randomize_samples=randomize_samples, sample_trn=True, prop_val=0.0,
                ds_filter_d=ds_filter_d, yield_idxs=True, base_name=base_name):
            cls = np.stack([eye[self.spk_id2class[s]]
                            for s in self.ds["spk_id"][idxs[:, -1]]])
            yield mfcc, mel, power, cls

    @staticmethod
    def _read_segments(path: str):
        """'start end label' lines -> [(start, end, label)]."""
        out = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    out.append((int(parts[0]), int(parts[1]), " ".join(parts[2:])))
        return out
