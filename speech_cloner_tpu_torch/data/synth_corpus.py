"""Synthetic speech corpus generator (a formant source-filter synthesizer).

Counterpart of ``speech_cloner_tpu/data/synth_corpus.py``: numpy and scipy
only, and from the same seed it writes the same files, byte for byte. No
speech corpus ships with the repository; this one writes phoneme-labelled,
speech-like corpora in the on-disk layouts the readers take, so training
and conversion run end to end:

- TIMIT layout  (TRAIN|TEST/DRn/<SPK>/<utt>.{WAV,PHN,TXT,WRD})
- ARCTIC layout (cmu_us_<spk>_arctic/{wav,lab})

A glottal impulse train (voiced) and white noise (unvoiced) excite cascaded
two-pole formant resonators per phone. Speakers differ by f0, vocal-tract
(formant) scale, spectral tilt and breathiness: phone identity is carried
by the formant pattern (learnable by the encoder whoever speaks), speaker
identity by pitch, scale and tilt (learnable by the decoder and the
speaker-ID CNN). Phone boundaries are known exactly, so the labels are
aligned by construction.

The fixed ``TARGET_PROFILE`` voice is both the ARCTIC target speaker
('slt') and the TIMIT speaker 'FSLT0', so a speaker-ID classifier trained
on the TIMIT tree can name the conversion target's class.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np
from scipy import signal

from .audio_io import write_riff_wav

SR = 16000

# ---------------------------------------------------------------- recipes ---

# (F1, F2, F3) formant targets in Hz (Peterson-Barney-style male averages;
# scaled per speaker), kinds drive source mix and duration.
VOWELS = {
    "iy": (270, 2290, 3010), "ih": (390, 1990, 2550), "eh": (530, 1840, 2480),
    "ae": (660, 1720, 2410), "aa": (730, 1090, 2440), "ah": (520, 1190, 2390),
    "ao": (570, 840, 2410), "uw": (300, 870, 2240), "uh": (440, 1020, 2240),
    "er": (490, 1350, 1690), "ey": (480, 2050, 2600), "ow": (450, 1030, 2380),
}
GLIDES = {
    "l": (360, 1300, 2700), "r": (310, 1060, 1380),
    "w": (290, 610, 2150), "y": (270, 2100, 3000),
}
NASALS = {
    "m": (250, 1200, 2100), "n": (250, 1700, 2600), "ng": (250, 2000, 2800),
}
# fricatives: noise band (lo, hi) Hz + voiced flag
FRICATIVES = {
    "s": ((4200, 7600), False), "sh": ((2200, 5600), False),
    "f": ((1200, 7200), False), "th": ((1400, 6800), False),
    "z": ((4200, 7600), True), "v": ((900, 5200), True),
    "dh": ((1100, 5600), True), "hh": ((400, 3200), False),
}
# stops: burst band (lo, hi) + voiced flag (voiced -> shorter closure + voice bar)
STOPS = {
    "p": ((500, 1800), False), "t": ((2800, 6400), False), "k": ((1400, 3600), False),
    "b": ((500, 1800), True), "d": ((2800, 6400), True), "g": ((1400, 3600), True),
}

ALL_PHONES = (list(VOWELS) + list(GLIDES) + list(NASALS)
              + list(FRICATIVES) + list(STOPS))

_DUR_MS = {"vowel": (100, 200), "glide": (70, 140), "nasal": (70, 140),
           "fric": (80, 160), "stop": (60, 110), "sil": (90, 220)}


def _kind(phone: str) -> str:
    if phone in VOWELS:
        return "vowel"
    if phone in GLIDES:
        return "glide"
    if phone in NASALS:
        return "nasal"
    if phone in FRICATIVES:
        return "fric"
    if phone in STOPS:
        return "stop"
    return "sil"


# ---------------------------------------------------------------- speakers ---

@dataclasses.dataclass(frozen=True)
class SpeakerProfile:
    """Everything that makes a synthetic voice identifiable."""

    f0: float              # base pitch Hz
    formant_scale: float   # vocal tract length factor (1.0 = canonical)
    tilt: float            # one-pole lowpass coefficient on the glottal source
    breath: float          # noise floor mixed into voiced segments
    gender: str            # 'M' | 'F' (TIMIT speaker-dir prefix)


# The conversion target voice ('slt' in ARCTIC == 'FSLT0' in TIMIT).
TARGET_PROFILE = SpeakerProfile(f0=205.0, formant_scale=1.10, tilt=0.30,
                                breath=0.02, gender="F")
# A male source voice for conversion demos ('bdl' in ARCTIC).
SOURCE_PROFILE = SpeakerProfile(f0=112.0, formant_scale=0.94, tilt=0.45,
                                breath=0.03, gender="M")


def random_profile(rng: np.random.Generator) -> SpeakerProfile:
    if rng.random() < 0.5:
        f0 = float(rng.uniform(95, 140))
        scale = float(rng.uniform(0.90, 1.02))
        gender = "M"
    else:
        f0 = float(rng.uniform(175, 245))
        scale = float(rng.uniform(1.02, 1.16))
        gender = "F"
    return SpeakerProfile(f0=f0, formant_scale=scale,
                          tilt=float(rng.uniform(0.2, 0.6)),
                          breath=float(rng.uniform(0.01, 0.05)), gender=gender)


# -------------------------------------------------------------- synthesis ---

def _impulse_train(f0_contour: np.ndarray, sr: int) -> np.ndarray:
    """Glottal pulses at a time-varying pitch (one impulse per period)."""
    phase = np.cumsum(f0_contour / sr)
    marks = np.floor(phase)
    imp = np.zeros(len(f0_contour), np.float32)
    imp[1:][np.diff(marks) > 0] = 1.0
    return imp


def _resonate(x: np.ndarray, formants, sr: int, bw=(90.0, 120.0, 160.0)) -> np.ndarray:
    """Cascade of two-pole formant resonators (Klatt-style)."""
    y = x
    for f, b in zip(formants, bw):
        f = min(f, 0.45 * sr)
        r = np.exp(-np.pi * b / sr)
        theta = 2.0 * np.pi * f / sr
        y = signal.lfilter([1.0], [1.0, -2.0 * r * np.cos(theta), r * r], y)
    return y.astype(np.float32)


def _bandnoise(n: int, band, sr: int, rng) -> np.ndarray:
    lo, hi = band
    hi = min(hi, 0.48 * sr)
    b, a = signal.butter(2, [lo, hi], btype="band", fs=sr)
    return signal.lfilter(b, a, rng.standard_normal(n)).astype(np.float32)


def _rms_norm(x: np.ndarray, level: float) -> np.ndarray:
    rms = float(np.sqrt(np.mean(x**2)) + 1e-12)
    return x * (level / rms)


def _phone_sequence(rng: np.random.Generator, n_phones: int, sil: str):
    """Silence-padded pseudo-sentence alternating consonant/vowel clusters."""
    seq = [sil]
    consonants = list(GLIDES) + list(NASALS) + list(FRICATIVES) + list(STOPS)
    vowel_list = list(VOWELS)
    want_vowel = bool(rng.integers(0, 2))
    while len(seq) < n_phones + 1:
        pool = vowel_list if want_vowel else consonants
        p = pool[int(rng.integers(0, len(pool)))]
        if p != seq[-1]:
            seq.append(p)
            # occasional within-word pause
            if rng.random() < 0.04:
                seq.append(sil)
        want_vowel = not want_vowel
    seq.append(sil)
    return seq


def synth_utterance(rng: np.random.Generator, profile: SpeakerProfile,
                    n_phones: int = 24, sr: int = SR, sil: str = "h#"):
    """One labeled utterance.

    Returns (wav float32 [n], segments [(start_sample, end_sample, phone)]).
    """
    seq = _phone_sequence(rng, n_phones, sil)
    durs = [int(sr * rng.uniform(*_DUR_MS[_kind(p)]) / 1000.0) for p in seq]
    n = int(sum(durs))

    # prosody: declination + slow random walk + vibrato
    t = np.arange(n) / sr
    walk = np.cumsum(rng.standard_normal(n)) * (0.02 / np.sqrt(sr))
    walk -= np.linspace(walk[0], walk[-1], n)  # pin endpoints
    f0 = profile.f0 * (1.0 - 0.12 * t / t[-1]) * (1.0 + 0.03 * np.sin(2 * np.pi * 5.5 * t)
                                                  + walk)
    voiced_src = _impulse_train(f0, sr)
    # spectral tilt: one-pole lowpass on the glottal source
    voiced_src = signal.lfilter([1.0 - profile.tilt], [1.0, -profile.tilt], voiced_src)
    voiced_src = voiced_src.astype(np.float32)

    out = np.zeros(n, np.float32)
    segments = []
    xfade = int(0.008 * sr)
    pos = 0
    for phone, dur in zip(seq, durs):
        a, b = pos, pos + dur
        kind = _kind(phone)
        scale = profile.formant_scale
        if kind in ("vowel", "glide", "nasal"):
            formants = (VOWELS | GLIDES | NASALS)[phone]
            seg = _resonate(voiced_src[a:b], [f * scale for f in formants], sr)
            if kind == "nasal":
                seg *= 0.6  # murmur is weaker
            seg += profile.breath * _bandnoise(dur, (300, 6000), sr, rng)
            seg = _rms_norm(seg, 0.18 if kind == "vowel" else 0.12)
        elif kind == "fric":
            band, voiced = FRICATIVES[phone]
            seg = _bandnoise(dur, (band[0] * scale, band[1] * scale), sr, rng)
            seg = _rms_norm(seg, 0.07)
            if voiced:
                buzz = _resonate(voiced_src[a:b], [250 * scale, 1200 * scale, 2400 * scale], sr)
                seg = 0.75 * seg + _rms_norm(buzz, 0.08)
        elif kind == "stop":
            band, voiced = STOPS[phone]
            seg = np.zeros(dur, np.float32)
            n_burst = min(int(0.018 * sr), dur)
            burst = _bandnoise(n_burst, (band[0] * scale, band[1] * scale), sr, rng)
            seg[-n_burst:] = _rms_norm(burst, 0.12) * np.linspace(1.0, 0.2, n_burst)
            if voiced:  # voice bar during closure
                bar = _resonate(voiced_src[a:b], [200 * scale, 900 * scale, 2000 * scale], sr)
                seg += _rms_norm(bar, 0.03)
        else:  # silence
            seg = 0.0005 * rng.standard_normal(dur).astype(np.float32)

        # raised-cosine crossfade into the running signal
        ramp = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, min(xfade, dur)))
        seg[:len(ramp)] *= ramp
        seg[len(seg) - len(ramp):] *= ramp[::-1]
        out[a:b] += seg
        segments.append((a, b, phone))
        pos = b

    peak = float(np.max(np.abs(out)) + 1e-9)
    return (0.35 / peak) * out, segments


# ------------------------------------------------------------ tree writers ---

def _fake_words(segments, sil: str):
    """Group non-silence phones into pseudo 'words' for .WRD/.TXT files."""
    words, cur, start = [], [], None
    for a, b, p in segments:
        if p == sil:
            if cur:
                words.append((start, a, "".join(cur)))
                cur, start = [], None
            continue
        if start is None:
            start = a
        cur.append(p)
    if cur:
        words.append((start, segments[-1][1], "".join(cur)))
    return words


def _spk_name(i: int, gender: str) -> str:
    letters = ""
    k = i
    for _ in range(3):
        letters += chr(ord("A") + k % 26)
        k //= 26
    return f"{gender}{letters}0"


def make_timit_tree(root: str, n_train_spk: int = 24, n_test_spk: int = 8,
                    n_utts: int = 16, n_phones: int = 24, seed: int = 0,
                    include_target: bool = True, verbose: bool = False):
    """Write a TIMIT-layout corpus; returns {speaker_dir: SpeakerProfile}.

    When include_target, speaker FSLT0 (== TARGET_PROFILE, the ARCTIC 'slt'
    voice) is added to TRAIN so a speaker-ID model trained here can name the
    conversion target.
    """
    rng = np.random.default_rng(seed)
    speakers = {}
    rosters = []  # (ds_type, dr, name, profile)
    for i in range(n_train_spk):
        prof = random_profile(rng)
        rosters.append(("TRAIN", f"DR{i % 8 + 1}", _spk_name(i, prof.gender), prof))
    for i in range(n_test_spk):
        prof = random_profile(rng)
        rosters.append(("TEST", f"DR{i % 8 + 1}", _spk_name(n_train_spk + i, prof.gender), prof))
    if include_target:
        rosters.append(("TRAIN", "DR1", "FSLT0", TARGET_PROFILE))
        # the demo conversion source voice, held out in TEST
        rosters.append(("TEST", "DR1", "MBDL0", SOURCE_PROFILE))

    for ds_type, dr, name, prof in rosters:
        speakers[name] = prof
        d = os.path.join(root, ds_type, dr, name)
        os.makedirs(d, exist_ok=True)
        for u in range(n_utts):
            urng = np.random.default_rng((seed, zlib.crc32(name.encode()), u))
            wav, segs = synth_utterance(urng, prof, n_phones=n_phones, sil="h#")
            stem = os.path.join(d, f"SX{u + 1}")
            write_riff_wav(stem + ".WAV", wav, SR, norm=False)
            with open(stem + ".PHN", "w") as f:
                for a, b, p in segs:
                    f.write(f"{a} {b} {p}\n")
            words = _fake_words(segs, "h#")
            with open(stem + ".WRD", "w") as f:
                for a, b, w in words:
                    f.write(f"{a} {b} {w}\n")
            with open(stem + ".TXT", "w") as f:
                f.write(f"0 {segs[-1][1]} {' '.join(w for _, _, w in words)}\n")
        if verbose:
            print(f" - synth TIMIT {ds_type}/{dr}/{name} ({n_utts} utts)")
    return speakers


def make_arctic_tree(root: str, speakers: dict[str, SpeakerProfile] | None = None,
                     n_utts: int = 120, n_phones: int = 24, seed: int = 1,
                     verbose: bool = False):
    """Write an ARCTIC-layout corpus (default: target 'slt' + source 'bdl')."""
    if speakers is None:
        speakers = {"slt": TARGET_PROFILE, "bdl": SOURCE_PROFILE}
    for spk, prof in speakers.items():
        wav_dir = os.path.join(root, f"cmu_us_{spk}_arctic", "wav")
        lab_dir = os.path.join(root, f"cmu_us_{spk}_arctic", "lab")
        os.makedirs(wav_dir, exist_ok=True)
        os.makedirs(lab_dir, exist_ok=True)
        for u in range(n_utts):
            urng = np.random.default_rng((seed, zlib.crc32(spk.encode()), u))
            wav, segs = synth_utterance(urng, prof, n_phones=n_phones, sil="pau")
            name = f"arctic_a{u + 1:04d}"
            write_riff_wav(os.path.join(wav_dir, name + ".wav"), wav, SR, norm=False)
            with open(os.path.join(lab_dir, name + ".lab"), "w") as f:
                f.write("#\n")
                for _, b, p in segs:
                    f.write(f"{b / SR:.5f} 125 {p}\n")
        if verbose:
            print(f" - synth ARCTIC cmu_us_{spk}_arctic ({n_utts} utts)")
    return speakers
