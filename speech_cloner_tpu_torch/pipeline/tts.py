"""Batched text-to-speech: character ids -> int16 PCM, a sentence a row.

`SynthesisPipeline` runs Tacotron (``models/tacotron.py``) on a ragged batch
of sentences: the encoder over each row's characters, the free-running
decoder for the longest row's steps (each row's frames past its own count
dropped), the post-net over each row's frames, and the shared float32
vocoder (``pipeline/vocoder.py``) with each row at its own frame count.
Every stage sees per-row lengths, so a row of a batch gives what it gives
alone.

Each call opens the recorder's spans (``runtime/profiler.py``; nothing while
the recorder is off): ``tts`` (the unit), with ``tts.encode``,
``tts.decode``, ``tts.postnet``, ``vocode`` and the copy back under
``tts.to_host``, and counts ``tts.decode_steps`` (decoder steps run) and
``tts.frames`` (frames kept); on the card the decoder adds
``tts.decode_graph_steps`` and ``tts.decode_graph_captures``
(`models.tacotron.TacotronDecoder.replay`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import tacotron as taco
from ..ops.features import FeatureConfig
from ..runtime import profiler
from ..runtime.config import float32_products
from ..runtime.profiler import span
from . import vocoder


@dataclasses.dataclass(frozen=True, eq=False)
class SynthesisPipeline:
    """The model, the audio geometry and the vocoder settings of the
    text-to-speech path (`runtime.config.tacotron_config_from_cfg_d` reads
    all three from a configuration; `make_synthesis_pipeline` fills in the
    paper's). Call `.synthesize_batch_pcm16(ids, id_lengths, n_frames)`."""

    cfg: taco.TacotronConfig
    model: taco.Tacotron
    feat_cfg: FeatureConfig           # sample rate, hop, window, n_fft, pre-emphasis, dB norm
    device: torch.device
    n_iter: int                       # Griffin-Lim rounds
    realse: float
    gl_momentum: float
    gl_dft: str
    mean_abs_amp_norm: float

    def __post_init__(self):
        float32_products(self.device)

    def device_synthesize(self, ids: torch.Tensor, id_lengths: torch.Tensor,
                          frames: list[int]):
        """(mel [B, r * steps, n_mels], linear [B, max frames, n_stft]) on the
        device, ``frames`` the frames each row keeps."""
        steps = max(taco.steps_for(n, self.cfg.reduction) for n in frames)
        with span("tts.encode", self.device):
            memory = self.model.encode(ids, id_lengths)
        with span("tts.decode", self.device):
            mel = self.model.decoder(memory, id_lengths, steps)
        profiler.count("tts.decode_steps", steps)
        profiler.count("tts.frames", sum(frames))
        with span("tts.postnet", self.device):
            frame_lengths = torch.tensor(frames, device=self.device)
            linear = self.model.postnet(mel[:, :max(frames)], frame_lengths)
        return mel, linear

    def device_vocode_pcm16(self, linear: torch.Tensor, frames: list[int],
                            generator: torch.Generator | None = None,
                            init_phase: torch.Tensor | None = None) -> torch.Tensor:
        """Ragged linear spectrograms -> int16 PCM [B, (T-1)*hop], row b's
        first (frames[b]-1)*hop samples its own."""
        return vocoder.device_vocode_pcm16(
            linear, self.feat_cfg, n_iter=self.n_iter, realse=self.realse,
            momentum=self.gl_momentum, dft=self.gl_dft, mean_abs_amp_norm=self.mean_abs_amp_norm,
            generator=generator, init_phase=init_phase, frames=frames)

    @torch.inference_mode()
    def synthesize_batch_pcm16(self, ids, id_lengths, n_frames, seed: int = 0) -> list[np.ndarray]:
        """Character ids [B, N] (0 after each row's ``id_lengths[b]``) and the
        frames ``n_frames[b]`` each row speaks for -> one int16 PCM array a
        row, (n_frames[b] - 1) * hop samples. Row b's initial Griffin-Lim
        phase is the b-th draw of a generator seeded with ``seed``."""
        frames = [int(n) for n in n_frames]
        least = min_frames(self.feat_cfg)
        if min(frames) < least:
            raise ValueError(f"synthesize_batch_pcm16: frame counts {frames}; the vocoder's "
                             f"reflect padding takes at least {least}")
        with span("tts", self.device):
            ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
            lengths = torch.as_tensor(np.asarray(id_lengths, np.int64), device=self.device)
            _, linear = self.device_synthesize(ids_t, lengths, frames)
            pcm = self.device_vocode_pcm16(linear, frames,
                                           torch.Generator(self.device).manual_seed(seed))
            with span("tts.to_host", self.device):
                out = pcm.cpu().numpy()
        hop = self.feat_cfg.hop_length
        return [out[b, :(n - 1) * hop] for b, n in enumerate(frames)]


def min_frames(feat: FeatureConfig) -> int:
    """Fewest frames a row can have: its (frames - 1) * hop samples must
    exceed n_fft / 2, the STFT's reflect padding."""
    return feat.n_fft_ // 2 // feat.hop_length + 2


def text_ids(text: str, vocab_size: int = 256) -> np.ndarray:
    """A sentence's byte ids (UTF-8), 0 kept for the padding: each byte b
    is 1 + (b - 1) mod (vocab_size - 1)."""
    raw = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int64)
    return 1 + (raw - 1) % (vocab_size - 1)


def pad_ids(rows) -> tuple[np.ndarray, np.ndarray]:
    """Id arrays of any lengths -> (ids [B, N] with 0 after each row, lengths [B])."""
    lengths = np.array([len(r) for r in rows], np.int64)
    ids = np.zeros((len(rows), int(lengths.max())), np.int64)
    for b, r in enumerate(rows):
        ids[b, :len(r)] = r
    return ids, lengths


def make_synthesis_pipeline(cfg: taco.TacotronConfig | None = None,
                            feat_cfg: FeatureConfig | None = None, seed: int = 0, device=None,
                            params=None, **kw) -> SynthesisPipeline:
    """A pipeline on ``device`` (default "cuda"; a missing card raises) with
    the (params, state) trees ``params``, or weights drawn from ``seed`` on
    the CPU (`models.tacotron.init_tree`). ``feat_cfg`` defaults to the
    paper's audio and ``kw``, the pipeline's vocoder fields, each to the
    paper's setting (`runtime.config.TACOTRON_AUDIO`, `TACOTRON_VOCODER`)."""
    from ..runtime.config import tacotron_config_from_cfg_d

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_synthesis_pipeline: no CUDA device; pass device='cpu'")
    _, paper_audio, paper_vocoder = tacotron_config_from_cfg_d({})
    cfg = cfg or taco.TacotronConfig()
    trees = params or taco.init_tree(torch.Generator().manual_seed(seed), cfg)
    model = taco.Tacotron(*trees, cfg).to(device).eval()
    return SynthesisPipeline(cfg=cfg, model=model, feat_cfg=feat_cfg or paper_audio,
                             device=device, **{**paper_vocoder, **kw})
