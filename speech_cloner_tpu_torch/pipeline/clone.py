"""End-to-end voice conversion: source wav -> cloned wav.

Counterpart of ``speech_cloner_tpu/pipeline/clone.py`` (`ClonePipeline`,
`make_pipeline`): features -> encoder PPG -> decoder mel/linear -> two-pass
window stitch -> Griffin-Lim, with every window of both passes in one batch
through the models.

Batched conversion (`convert_batch`, `convert_batch_pcm16`, the serving
path): features run per clip, the windows of every clip and both passes go
through the models as one batch, and Griffin-Lim runs on [B, T, F] at once
with every reduction per clip, as the JAX package's ``vmap`` gives.

``compute_dtype=torch.bfloat16`` runs the models in bf16 (the JAX package's
opt-in): the MFCC windows are cast before the encoder, the posteriors are
computed in float32 from float32 logits, the PPG is cast for the decoder, and
mel and linear spectrogram come back in float32 for the vocoder. The bf16
copies of the models are made once, beside the float32 ones.

PyTorch runs eagerly, so the JAX package's compile machinery
(``device_params``, ``_jitted``, ``_jit_cache``) has no counterpart here. On a
CUDA device the pipeline turns TF32 off for cuDNN convolutions and matmuls,
and bf16 GEMMs' reduced-precision split-K reductions, process-wide, to match
the JAX package's float32 ("highest") products and float32 accumulation.

Long-form conversion (`convert_seq_parallel`): one pass over the whole
recording with its time axis sharded over a 1-D mesh of devices
(``parallel/halo.py``: exact conv halos, GRU states warmed up over the
neighbors' frames) and a sharded Griffin-Lim (``parallel/gl_sp.py``), in
float32 (the JAX method runs the float32 weights too).

Each conversion opens the recorder's spans (``runtime/profiler.py``
`span`; nothing while the recorder is off): ``convert`` (features, models
and stitch under ``predict``, Griffin-Lim and PCM under ``vocode``, the copy
back under ``convert.to_host``) and ``longform`` (``longform.features``,
``.forward``, ``.vocode``, ``.to_host``).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..models import decoder as dec_m
from ..models import encoder as enc_m
from ..ops import mfcc_input
from ..ops.features import FeatureConfig, feature_matrices
from ..parallel.mesh import canonical
from ..runtime.checkpoint import load_decoder_weights, load_encoder_weights
from ..runtime.config import float32_products
from ..runtime.jax_params import decoder_from_jax, encoder_from_jax
from ..runtime.profiler import span
from . import vocoder
from .stitch import compound, shifted_window_stack, stitch_single, window_stack


@dataclasses.dataclass(frozen=True, eq=False)
class ClonePipeline:
    """Configs, the two models and the vocoder settings of the clone path.

    Build with `make_pipeline`; call `.convert(wav)` or `.convert_pcm16(wav)`,
    or `.convert_batch(wavs)` / `.convert_batch_pcm16(wavs)` for several clips.
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
    gl_unroll: int = 1                # JAX's lax loop knob: kept for callers, unread
    gl_dft: str = "fft"               # "matmul": DFT as matmuls against cos/sin bases
    mean_abs_amp_norm: float = 0.045  # 15 * 0.003 (reference test.py:153,165)
    compute_dtype: torch.dtype | None = None   # torch.bfloat16: bf16 models (None = float32)

    def __post_init__(self):
        float32_products(self.device)
        mel_w, dct = feature_matrices(self.feat_cfg)
        object.__setattr__(self, "_mel_w", torch.tensor(mel_w, device=self.device))
        object.__setattr__(self, "_dct", torch.tensor(dct, device=self.device))
        object.__setattr__(self, "_models", (enc_m.cast(self.encoder, self.compute_dtype),
                                             dec_m.cast(self.decoder, self.compute_dtype)))
        object.__setattr__(self, "_replicas", {canonical(self.device): self})

    def replica(self, device) -> "ClonePipeline":
        """This pipeline with its weights on ``device`` (itself on its own
        device; one copy per other device, made at first use and kept)."""
        device = canonical(device)
        if device not in self._replicas:
            self._replicas[device] = dataclasses.replace(
                self, encoder=copy.deepcopy(self.encoder).to(device),
                decoder=copy.deepcopy(self.decoder).to(device), device=device)
        return self._replicas[device]

    # ------------------------------------------------------------ device ---

    def forward_windows(self, mfcc_windows: torch.Tensor):
        """[K, T, E] MFCC windows -> (y_mel [K,T,80], y_stft [K,T,201], ppg),
        float32 whatever ``compute_dtype``; the posteriors are always computed
        in float32 from float32 logits."""
        encoder, decoder = self._models
        cd = self.compute_dtype
        ppg = enc_m.posteriors(encoder(mfcc_windows if cd is None else mfcc_windows.to(cd)))
        y_mel, y_stft = decoder(ppg if cd is None else ppg.to(cd))
        return y_mel.to(torch.float32), y_stft.to(torch.float32), ppg

    def device_predict(self, wav: torch.Tensor):
        """Padded wav [L] -> (mel_pred, stft_pred, ppg): features, encoder,
        decoder and the two-pass stitch."""
        return tuple(x[0] for x in self.device_predict_batch(wav[None]))

    def device_predict_batch(self, wavs: torch.Tensor):
        """Padded clips [B, L] -> (mel_pred, stft_pred, ppg), each [B, T', .]:
        features per clip (their norms, dB floors and c0 are per clip), then
        the windows of all clips and both passes as one batch through the
        models, then the stitch per clip."""
        T = self.enc_cfg.n_timesteps
        with span("predict", self.device):
            with span("predict.features", self.device):
                stacks = []
                for wav in wavs:
                    mfcc, _, _ = mfcc_input(wav, self.feat_cfg, mel_w=self._mel_w, dct=self._dct)
                    K = mfcc.shape[0] // T
                    mfcc = mfcc[: K * T]
                    y0 = window_stack(mfcc, T)
                    stacks.append(torch.cat([y0, shifted_window_stack(mfcc, T)]) if K > 1 else y0)
                n = stacks[0].shape[0]      # 2K-1 windows (or 1) per clip: one length, one K
                windows = torch.cat(stacks)
            with span("predict.models", self.device):
                outs = self.forward_windows(windows)
            with span("predict.stitch", self.device):
                preds = []
                for i in range(len(stacks)):
                    mel_b, stft_b, ppg_b = (o[i * n:(i + 1) * n] for o in outs)
                    if K > 1:
                        preds.append((compound(mel_b[:K], mel_b[K:]),
                                      compound(stft_b[:K], stft_b[K:]),
                                      compound(ppg_b[:K], ppg_b[K:])))
                    else:
                        preds.append((stitch_single(mel_b), stitch_single(stft_b),
                                      ppg_b.reshape(K * T, -1)))
                return tuple(torch.stack(x) for x in zip(*preds))

    def _vocoder(self) -> dict:
        return dict(realse=self.realse, dft=self.gl_dft, mean_abs_amp_norm=self.mean_abs_amp_norm)

    def device_vocode(self, stft_pred: torch.Tensor, generator: torch.Generator | None = None,
                      init_phase: torch.Tensor | None = None) -> torch.Tensor:
        """Predicted linear power_dB [..., T, n_stft] -> waveform [..., L]
        (Griffin-Lim; leading axes are clips, each vocoded on its own):
        `pipeline.vocoder.device_vocode` with the pipeline's settings."""
        return vocoder.device_vocode(stft_pred, self.feat_cfg, n_iter=self.n_iter,
                                     momentum=self.gl_momentum,
                                     generator=generator, init_phase=init_phase,
                                     **self._vocoder())

    def device_vocode_pcm16(self, stft_pred: torch.Tensor,
                            generator: torch.Generator | None = None,
                            init_phase: torch.Tensor | None = None) -> torch.Tensor:
        """Vocode and peak-normalize to int16 PCM (write_riff_wav's norm=True),
        each clip by its own peak."""
        return vocoder.pcm16(self.device_vocode(stft_pred, generator, init_phase))

    def device_convert_batch(self, wavs: torch.Tensor, generator: torch.Generator | None = None,
                             init_phase: torch.Tensor | None = None):
        """Padded clips [B, L] -> (wav_pred [B, L'], mel [B, T', 80], stft [B, T', 201]):
        one model batch for all clips, one Griffin-Lim over [B, T', F]. The
        initial phase is one [B, T', F] draw from ``generator``, or ``init_phase``."""
        mel, stft, _ = self.device_predict_batch(wavs)
        return self.device_vocode(stft, generator, init_phase), mel, stft

    def device_convert_batch_pcm16(self, wavs: torch.Tensor,
                                   generator: torch.Generator | None = None,
                                   init_phase: torch.Tensor | None = None) -> torch.Tensor:
        """Padded clips [B, L] -> int16 PCM [B, L'], each clip peak-normalized."""
        _, stft, _ = self.device_predict_batch(wavs)
        return self.device_vocode_pcm16(stft, generator, init_phase)

    # -------------------------------------------------------------- host ---

    def padded_length(self, n: int) -> int:
        """Samples of the window bucket of an n-sample clip: whole windows, at least one."""
        spw = self.enc_cfg.n_timesteps * self.feat_cfg.hop_length
        return max(-(-n // spw), 1) * spw

    def pad_wav(self, wav: np.ndarray, length: int | None = None) -> torch.Tensor:
        """Zero-pad to ``length`` samples (default: the clip's own window
        bucket), on the device."""
        n = int(np.shape(wav)[0])
        length = self.padded_length(n) if length is None else length
        return torch.tensor(np.pad(np.asarray(wav, np.float32), (0, length - n)),
                            device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    @torch.inference_mode()
    def convert(self, wav: np.ndarray, seed: int = 0):
        """Host waveform -> (wav_pred, mel_pred, stft_pred, ppg) as numpy."""
        with span("convert", self.device):
            mel_pred, stft_pred, ppg = self.device_predict(self.pad_wav(wav))
            wav_pred = self.device_vocode(stft_pred, self._generator(seed))
            with span("convert.to_host", self.device):
                return tuple(t.cpu().numpy() for t in (wav_pred, mel_pred, stft_pred, ppg))

    @torch.inference_mode()
    def convert_pcm16(self, wav: np.ndarray, seed: int = 0) -> np.ndarray:
        """Host waveform -> peak-normalized int16 PCM; only the PCM leaves the device."""
        with span("convert", self.device):
            _, stft_pred, _ = self.device_predict(self.pad_wav(wav))
            pcm = self.device_vocode_pcm16(stft_pred, self._generator(seed))
            with span("convert.to_host", self.device):
                return pcm.cpu().numpy()

    @torch.inference_mode()
    def convert_batch(self, wavs, seed: int = 0, init_phase: torch.Tensor | None = None):
        """Equal-length host waveforms -> (wav_pred [B, L'], mel, stft) as numpy.
        The clips pad to their window bucket, as `convert` pads one."""
        lengths = {int(np.shape(w)[0]) for w in wavs}
        if len(lengths) != 1:
            raise ValueError(f"convert_batch: clips of several lengths {sorted(lengths)}; "
                             "use convert_batch_pcm16, which pads to the longest")
        with span("convert", self.device):
            batch = torch.stack([self.pad_wav(w) for w in wavs])
            out = self.device_convert_batch(batch, self._generator(seed), init_phase)
            with span("convert.to_host", self.device):
                return tuple(t.cpu().numpy() for t in out)

    @torch.inference_mode()
    def convert_batch_pcm16(self, wavs, seed: int = 0,
                            init_phase: torch.Tensor | None = None) -> list[np.ndarray]:
        """Host waveforms of any lengths -> one int16 PCM array per clip. Every
        clip pads to the longest clip's window bucket (`convert_pcm16`'s rule
        for that bucket), so all share one model batch and one Griffin-Lim."""
        length = self.padded_length(max(int(np.shape(w)[0]) for w in wavs))
        with span("convert", self.device):
            batch = torch.stack([self.pad_wav(w, length) for w in wavs])
            pcm = self.device_convert_batch_pcm16(batch, self._generator(seed), init_phase)
            with span("convert.to_host", self.device):
                return list(pcm.cpu().numpy())


    # ------------------------------------------------- sequence parallel ---

    @torch.inference_mode()
    def convert_seq_parallel(self, wav: np.ndarray, n_devices: int | None = None,
                             warmup: int = 400, seed: int = 0, sp_vocoder: bool = True,
                             mesh=None, init_phase=None):
        """Long-form conversion with the time axis sharded over a 1-D mesh:
        the model forward by halo exchange (``parallel/halo.py``) and the
        Griffin-Lim loop with boundary-tail exchanges (``parallel/gl_sp.py``);
        no window stitching, and no gather onto one device until the final
        waveform. ``mesh``: a `parallel.make_seq_mesh` mesh; without it, a
        mesh of ``n_devices`` shards (default: every card) over the CUDA
        devices for a CUDA pipeline (more than there are raises), or over
        the CPU for a CPU one (default 1). The frame count pads with zero
        frames up to a multiple of the shard count and the outputs are
        trimmed back; ``warmup`` is capped at a shard's frames; the sharded
        vocoder runs when a shard holds more than n_fft samples, else the
        pipeline's own. ``init_phase`` [T_padded, n_stft] overrides the
        initial phase drawn from ``seed``.

        Returns (wav_pred, mel_pred, stft_pred) numpy arrays."""
        from ..parallel.gl_sp import from_power_to_wav_seq_parallel
        from ..parallel.halo import clone_forward_seq_parallel, gather
        from ..parallel.mesh import make_seq_mesh

        if mesh is None:
            if self.device.type == "cuda":
                mesh = make_seq_mesh(n_devices)
            else:
                mesh = make_seq_mesh(n_devices or 1, devices=[self.device] * (n_devices or 1))
        elif n_devices not in (None, mesh.size):
            raise ValueError(f"n_devices={n_devices} against a mesh of {mesh.size}")
        n = mesh.size
        f = self.feat_cfg
        dev = self.device
        with span("longform", dev):
            with span("longform.features", dev):
                mfcc, _, _ = mfcc_input(torch.tensor(np.asarray(wav, np.float32), device=dev),
                                        f, mel_w=self._mel_w, dct=self._dct)
                # pad the frame count up to a multiple of n with zero frames and
                # trim after (the reference pads, never drops)
                frames = mfcc.shape[0]
                mfcc = F.pad(mfcc, (0, 0, 0, (-frames) % n))
            per = mfcc.shape[0] // n
            warmup = min(warmup, per)

            pipes = [self.replica(d) for d in mesh.device_list()]
            with span("longform.forward", dev):
                fwd = clone_forward_seq_parallel(self.encoder, self.decoder, mesh, warmup=warmup,
                                                 replicas=([p.encoder for p in pipes],
                                                           [p.decoder for p in pipes]))
                mel, stft, _ = fwd(mfcc[None])
            first = mesh.device_list()[0]
            gen = torch.Generator(first).manual_seed(seed)
            with span("longform.vocode", dev):
                if sp_vocoder and per * f.hop_length > f.n_fft_:
                    wav_pred = from_power_to_wav_seq_parallel(
                        [s[0] for s in stft], mesh, P_dB_norm_factor=f.P_dB_norm_factor,
                        pre_emphasis=f.pre_emphasis, hop_length=f.hop_length,
                        win_length=f.win_length, mean_abs_amp_norm=self.mean_abs_amp_norm,
                        n_iter=self.n_iter, n_fft=f.n_fft_, realse=self.realse, generator=gen,
                        init_phase=init_phase, momentum=self.gl_momentum)
                else:
                    wav_pred = pipes[0].device_vocode(
                        gather(stft, device=first)[0], gen,
                        None if init_phase is None else torch.as_tensor(init_phase, device=first))
            # outputs cover exactly the input's frames (wav: frames * hop samples)
            with span("longform.to_host", dev):
                return (wav_pred[:frames * f.hop_length].cpu().numpy(),
                        gather(mel, device="cpu")[0, :frames].numpy(),
                        gather(stft, device="cpu")[0, :frames].numpy())


def init_trees(enc_cfg: enc_m.EncoderConfig, dec_cfg: dec_m.DecoderConfig, seed: int = 0):
    """The ((params, state), (params, state)) trees of encoder and decoder
    that `make_pipeline` draws from ``seed`` on the CPU when given no
    checkpoint, so one seed gives the same weights on every device."""
    seeds = torch.randint(2**62, (2,), generator=torch.Generator().manual_seed(seed)).tolist()
    return (enc_m.init_tree(torch.Generator().manual_seed(seeds[0]), enc_cfg),
            dec_m.init_tree(torch.Generator().manual_seed(seeds[1]), dec_cfg))


def make_pipeline(enc_cfg=None, dec_cfg=None, feat_cfg=None, enc_ckpt: str | None = None,
                  dec_ckpt: str | None = None, seed: int = 0, device=None,
                  **kw) -> ClonePipeline:
    """Build a pipeline on ``device`` (default "cuda"; a missing card raises).

    ``enc_ckpt`` / ``dec_ckpt``, when given, are each a TF checkpoint prefix
    (``<prefix>.index`` beside it, as the JAX package's `make_pipeline`
    reads) or a directory of ``encoder-<step>.npz`` / ``decoder-<step>.npz``
    (the JAX trainers' and `Checkpointer.save`'s format). A model without a
    checkpoint gets `init_trees`' weights from ``seed``. ``kw`` are the
    pipeline's fields (``n_iter``, ``realse``, ``compute_dtype``, ...).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_pipeline: no CUDA device; pass device='cpu' to run on the CPU")
    enc_cfg = enc_cfg or enc_m.EncoderConfig()
    dec_cfg = dec_cfg or dec_m.DecoderConfig()
    feat_cfg = feat_cfg or FeatureConfig(calc_mfcc_derivate=True)

    fresh = None if enc_ckpt and dec_ckpt else init_trees(enc_cfg, dec_cfg, seed)
    enc_tree = load_encoder_weights(enc_ckpt, enc_cfg) if enc_ckpt else fresh[0]
    dec_tree = load_decoder_weights(dec_ckpt, dec_cfg) if dec_ckpt else fresh[1]
    return ClonePipeline(enc_cfg=enc_cfg, dec_cfg=dec_cfg, feat_cfg=feat_cfg,
                         encoder=encoder_from_jax(*enc_tree, enc_cfg, device).eval(),
                         decoder=decoder_from_jax(*dec_tree, dec_cfg, device).eval(),
                         device=device, **kw)
