"""End-to-end voice conversion: source wav -> cloned wav.

Counterpart of ``speech_cloner_tpu/pipeline/clone.py`` (`ClonePipeline`,
`make_pipeline`): features -> encoder PPG -> decoder mel/linear -> two-pass
window stitch -> Griffin-Lim, with every window of both passes in one batch
through the models.

PyTorch runs eagerly, so the JAX package's compile machinery
(``device_params``, ``_jitted``, ``_jit_cache``) has no counterpart here.
Everything runs in float32. On a CUDA device the pipeline turns TF32 off
for both cuDNN convolutions and matmuls
(``torch.backends.cudnn.allow_tf32 = False``,
``torch.backends.cuda.matmul.allow_tf32 = False``), process-wide, to match
the JAX package's float32 ("highest") products. Waiting for later work:
``compute_dtype`` (bf16), ``convert_batch*`` and ``convert_seq_parallel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import decoder as dec_m
from ..models import encoder as enc_m
from ..ops import from_power_to_wav, mfcc_input
from ..ops.features import FeatureConfig, feature_matrices
from ..runtime.checkpoint import restore_params
from ..runtime.jax_params import decoder_from_jax, encoder_from_jax
from .stitch import compound, shifted_window_stack, stitch_single, window_stack


@dataclasses.dataclass(frozen=True, eq=False)
class ClonePipeline:
    """Configs, the two models and the vocoder settings of the clone path.

    Build with `make_pipeline`; call `.convert(wav)` or `.convert_pcm16(wav)`.
    """

    enc_cfg: enc_m.EncoderConfig
    dec_cfg: dec_m.DecoderConfig
    feat_cfg: FeatureConfig
    encoder: enc_m.Encoder
    decoder: dec_m.Decoder
    device: torch.device
    n_iter: int = 200
    realse: float = 1.0
    gl_momentum: float = 0.0          # Fast Griffin-Lim (0 = reference algorithm)
    gl_unroll: int = 1                # lax loop knob of the JAX package; no effect
    gl_dft: str = "fft"               # "matmul": DFT as matmuls against cos/sin bases
    mean_abs_amp_norm: float = 0.045  # 15 * 0.003 (reference test.py:153,165)

    def __post_init__(self):
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        mel_w, dct = feature_matrices(self.feat_cfg)
        object.__setattr__(self, "_mel_w", torch.tensor(mel_w, device=self.device))
        object.__setattr__(self, "_dct", torch.tensor(dct, device=self.device))

    # ------------------------------------------------------------ device ---

    def forward_windows(self, mfcc_windows: torch.Tensor):
        """[K, T, E] MFCC windows -> (y_mel [K,T,80], y_stft [K,T,201], ppg)."""
        ppg = enc_m.posteriors(self.encoder(mfcc_windows))
        y_mel, y_stft = self.decoder(ppg)
        return y_mel, y_stft, ppg

    def device_predict(self, wav: torch.Tensor):
        """Padded wav [L] -> (mel_pred, stft_pred, ppg): features, encoder,
        decoder and the two-pass stitch."""
        T = self.enc_cfg.n_timesteps
        mfcc, _, _ = mfcc_input(wav, self.feat_cfg, mel_w=self._mel_w, dct=self._dct)
        K = mfcc.shape[0] // T
        mfcc = mfcc[: K * T]
        y0 = window_stack(mfcc, T)
        if K > 1:
            both = torch.cat([y0, shifted_window_stack(mfcc, T)], dim=0)
            mel_b, stft_b, ppg_b = self.forward_windows(both)
            return (compound(mel_b[:K], mel_b[K:]), compound(stft_b[:K], stft_b[K:]),
                    compound(ppg_b[:K], ppg_b[K:]))
        mel_w, stft_w, ppg_w = self.forward_windows(y0)
        return stitch_single(mel_w), stitch_single(stft_w), ppg_w.reshape(K * T, -1)

    def device_vocode(self, stft_pred: torch.Tensor, generator: torch.Generator | None = None,
                      init_phase: torch.Tensor | None = None) -> torch.Tensor:
        """Predicted linear power_dB [T, n_stft] -> waveform (Griffin-Lim)."""
        f = self.feat_cfg
        return from_power_to_wav(
            stft_pred, P_dB_norm_factor=f.P_dB_norm_factor, pre_emphasis=f.pre_emphasis,
            hop_length=f.hop_length, win_length=f.win_length,
            mean_abs_amp_norm=self.mean_abs_amp_norm, n_iter=self.n_iter, n_fft=f.n_fft_,
            realse=self.realse, generator=generator, init_phase=init_phase,
            momentum=self.gl_momentum, unroll=self.gl_unroll, dft=self.gl_dft)

    def device_vocode_pcm16(self, stft_pred: torch.Tensor,
                            generator: torch.Generator | None = None,
                            init_phase: torch.Tensor | None = None) -> torch.Tensor:
        """Vocode and peak-normalize to int16 PCM (write_riff_wav's norm=True)."""
        wav = self.device_vocode(stft_pred, generator, init_phase)
        peak = torch.clamp(wav.abs().max(), min=1e-9)
        return torch.clamp(wav / peak * 32767.0, -32768.0, 32767.0).to(torch.int16)

    # -------------------------------------------------------------- host ---

    def pad_wav(self, wav: np.ndarray) -> torch.Tensor:
        """Zero-pad to a whole number of windows, at least one, on the device."""
        spw = self.enc_cfg.n_timesteps * self.feat_cfg.hop_length
        L = int(np.shape(wav)[0])
        pad = max((-L) % spw, spw - L)
        return torch.tensor(np.pad(np.asarray(wav, np.float32), (0, pad)), device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    @torch.inference_mode()
    def convert(self, wav: np.ndarray, seed: int = 0):
        """Host waveform -> (wav_pred, mel_pred, stft_pred, ppg) as numpy."""
        mel_pred, stft_pred, ppg = self.device_predict(self.pad_wav(wav))
        wav_pred = self.device_vocode(stft_pred, self._generator(seed))
        return tuple(t.cpu().numpy() for t in (wav_pred, mel_pred, stft_pred, ppg))

    @torch.inference_mode()
    def convert_pcm16(self, wav: np.ndarray, seed: int = 0) -> np.ndarray:
        """Host waveform -> peak-normalized int16 PCM; only the PCM leaves the device."""
        _, stft_pred, _ = self.device_predict(self.pad_wav(wav))
        return self.device_vocode_pcm16(stft_pred, self._generator(seed)).cpu().numpy()


def make_pipeline(enc_cfg=None, dec_cfg=None, feat_cfg=None, enc_ckpt: str | None = None,
                  dec_ckpt: str | None = None, seed: int = 0, device=None,
                  **kw) -> ClonePipeline:
    """Build a pipeline on ``device`` (default "cuda"; a missing card raises).

    Weights come from ``.npz`` checkpoint directories when paths are given
    (``encoder-<step>.npz`` / ``decoder-<step>.npz``), otherwise from a fresh
    init drawn from ``seed`` on the CPU, so one seed gives the same weights
    on every device.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_pipeline: no CUDA device; pass device='cpu' to run on the CPU")
    enc_cfg = enc_cfg or enc_m.EncoderConfig()
    dec_cfg = dec_cfg or dec_m.DecoderConfig()
    feat_cfg = feat_cfg or FeatureConfig(calc_mfcc_derivate=True)

    seeds = torch.randint(2**62, (2,), generator=torch.Generator().manual_seed(seed)).tolist()
    if enc_ckpt:
        encoder = encoder_from_jax(*restore_params(enc_ckpt, "encoder"), enc_cfg, device)
    else:
        encoder = enc_m.init(torch.Generator().manual_seed(seeds[0]), enc_cfg, device)
    if dec_ckpt:
        decoder = decoder_from_jax(*restore_params(dec_ckpt, "decoder"), dec_cfg, device)
    else:
        decoder = dec_m.init(torch.Generator().manual_seed(seeds[1]), dec_cfg, device)
    return ClonePipeline(enc_cfg=enc_cfg, dec_cfg=dec_cfg, feat_cfg=feat_cfg,
                         encoder=encoder.eval(), decoder=decoder.eval(), device=device, **kw)
