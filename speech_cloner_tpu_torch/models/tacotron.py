"""Tacotron text-to-speech: character ids -> mel frames -> linear spectrogram.

Wang et al., "Tacotron: Towards End-to-End Speech Synthesis" (Interspeech
2017, arXiv:1703.10135), Table 1 and sections 3-4, at its published widths
by default; the JAX package has no counterpart (its ``nn/attention.py``
holds the pieces, never called by a model there):

  encoder:  embedding(256) -> pre-net FC-256-ReLU, FC-128-ReLU -> CBHG (16
            banks of 128, max-pool 2, projections 128-ReLU and 128, residual,
            4 highways of 128, bidirectional GRU of 128) = memory [B, N, 256]
  decoder:  per step, the last mel frame of the step before (zeros at step
            0) -> pre-net -> attention GRU of 256 on [pre-net out, context]
            -> additive attention over the memory -> dense [GRU out,
            context] 512 -> 256 -> 2 residual GRUs of 256 (x <- x + GRU(x))
            -> dense 256 -> r x 80, r = 2 frames a step
  post-net: CBHG on the mel frames (8 banks of 128, projections 256-ReLU and
            80, residual, a dense 80 -> 128, 4 highways of 128,
            bidirectional GRU of 128) -> dense 256 -> 1025 bins

The forms the paper leaves open are keithito/tacotron's: the attention
GRU's input [pre-net out (128), previous context (256)]; attention depth
256, score v . tanh(W_m m_j + W_q q) with the attention GRU's output as q,
padded characters masked out ahead of the softmax; the dense 512 -> 256
ahead of the residual GRUs; the output read as r frames of 80. Dropout is
off at inference (Tacotron 1 keeps it in training only) and this module
runs inference alone: no dropout, batch norm on its running statistics.

Batches are ragged: characters pad with id 0 after each row's
``id_lengths[b]``, and the CBHGs and the attention take per-row lengths, so
a row gives what it gives alone. The decoder has no stop rule here (random
weights have none to learn): it runs ``steps`` steps for the whole batch,
and each row's frames past its own count are the caller's to drop, as the
post-net's ``frame_lengths`` do. The decoder is the port's one
autoregressive loop: a step's input is the step before's output, so a step
is ~54 small launches, bound by the host's launch cost. On a CUDA memory
with autograd off (`torch.is_grad_enabled` false, as under
`torch.inference_mode`) one step is captured once as a CUDA graph and
replayed a launch a step (`TacotronDecoder.replay`); on the CPU and under
autograd it runs as a plain loop (`TacotronDecoder.loop`). Both drive the
one step body, `TacotronDecoder.step`.

Trees use the layout of the other models: nested dicts, lists for the bank
kernels, the highways and the decoder GRUs; (params, state), the state the
CBHGs' batch-norm statistics.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import CBHG, CBHGConfig, Dense, Prenet
from ..nn.attention import AdditiveAttention, Embed, GRUCell, attention_init, mask_bias
from ..nn.modules import cbhg_init, dense_init, gru_dir_init, prenet_init
from ..runtime import profiler


@dataclasses.dataclass(frozen=True)
class TacotronConfig:
    """The graph's widths; the defaults are the paper's."""

    vocab_size: int = 256               # byte ids, 0 the padding
    embed_size: int = 256               # character embedding
    prenet_size: int = 256              # FC-256 then FC-128 (half), both pre-nets
    encoder_banks: int = 16
    encoder_highway: int = 4
    encoder_units: int = 128            # highway width and GRU units a direction
    attention_rnn_units: int = 256
    attention_depth: int = 256
    decoder_units: int = 256
    decoder_layers: int = 2
    n_mels: int = 80
    reduction: int = 2                  # r: frames a decoder step
    postnet_banks: int = 8
    postnet_projections: tuple[int, int] = (256, 80)
    postnet_highway: int = 4
    postnet_units: int = 128
    n_stft: int = 1025

    def __post_init__(self):
        if self.postnet_projections[1] != self.n_mels:
            raise ValueError(f"postnet_projections {self.postnet_projections}: the second "
                             f"(the residual's) must be n_mels = {self.n_mels}")

    @property
    def memory_size(self) -> int:
        return 2 * self.encoder_units

    @property
    def encoder_cbhg(self) -> CBHGConfig:
        inner = self.prenet_size // 2
        return CBHGConfig(2 * self.encoder_units, self.encoder_banks, self.encoder_highway,
                          projections=None if inner == self.encoder_units
                          else (self.encoder_units, inner))

    @property
    def postnet_cbhg(self) -> CBHGConfig:
        return CBHGConfig(2 * self.postnet_units, self.postnet_banks, self.postnet_highway,
                          projections=tuple(self.postnet_projections))


def steps_for(frames: int, reduction: int) -> int:
    """Decoder steps that emit ``frames`` frames, ``reduction`` a step."""
    return -(-int(frames) // reduction)


GRAPH_BUCKET = 32       # characters: a captured step's memory positions are a multiple of this
GRAPH_CACHE = 8         # captured steps a decoder keeps, the oldest dropped first


def graph_positions(n: int) -> int:
    """Memory positions of the captured step that serves ``n`` characters:
    ``n`` rounded up to a multiple of GRAPH_BUCKET, so that batches whose
    longest sentences differ by a few characters share one capture. The
    padding is zeros, and `mask_bias` gives it zero attention weight."""
    return -(-int(n) // GRAPH_BUCKET) * GRAPH_BUCKET


@dataclasses.dataclass
class DecoderState:
    """What a decoder step reads (the memory, its attention keys, the mask)
    and what it replaces (the three GRU states, the context, and the frame
    fed to the next step)."""

    memory: torch.Tensor        # [B, N, M]
    keys: torch.Tensor          # [B, N, depth]
    bias: torch.Tensor          # [B, N]: 0, or -inf past a row's characters
    h_att: torch.Tensor         # [B, attention_rnn_units]
    context: torch.Tensor       # [B, M]
    hs: list[torch.Tensor]      # [B, decoder_units] a residual GRU
    frame: torch.Tensor         # [B, n_mels]: the last frame of the step before

    def tensors(self) -> list[torch.Tensor]:
        return [self.memory, self.keys, self.bias, self.h_att, self.context, *self.hs,
                self.frame]

    def copy(self) -> "DecoderState":
        return dataclasses.replace(self, hs=list(self.hs))


@dataclasses.dataclass
class CapturedStep:
    graph: "torch.cuda.CUDAGraph"
    state: DecoderState         # the static buffers the graph reads and writes
    y: torch.Tensor             # the step's frames [B, r * n_mels], rewritten by each replay


class TacotronDecoder(nn.Module):
    """The free-running attention decoder: `forward` runs ``steps`` steps
    from the all-zero GO frame, each fed the last frame of the step before."""

    def __init__(self, p, cfg: TacotronConfig):
        super().__init__()
        self.cfg = cfg
        self.prenet = Prenet(p["prenet"])
        self.attention_rnn = GRUCell(p["attention_rnn"])
        self.attention = AdditiveAttention(p["attention"])
        self.project = Dense(p["project"])
        self.rnn = nn.ModuleList(GRUCell(q) for q in p["rnn"])
        self.frames = Dense(p["frames"])
        self.captured: dict[tuple, CapturedStep] = {}    # by (B, positions, dtype, device)

    def _apply(self, *args, **kwargs):
        self.captured.clear()       # a captured step reads the parameters where they were
        return super()._apply(*args, **kwargs)

    def forward(self, memory: torch.Tensor, lengths: torch.Tensor, steps: int) -> torch.Tensor:
        """memory [B, N, M], ``lengths`` [B] characters -> mel frames
        [B, r * steps, n_mels]: `replay` on a CUDA memory with autograd off,
        `loop` elsewhere."""
        if memory.is_cuda and not torch.is_grad_enabled():
            return self.replay(memory, lengths, steps)
        return self.loop(memory, lengths, steps)

    def start(self, memory: torch.Tensor, lengths: torch.Tensor) -> DecoderState:
        """The state ahead of step 0: the memory's keys and mask, zero
        states, and the all-zero GO frame laid out as every later frame is
        (the last n_mels columns of a step's output)."""
        cfg = self.cfg
        B, N, M = memory.shape
        return DecoderState(
            memory=memory, keys=self.attention.keys(memory), bias=mask_bias(lengths, N),
            h_att=memory.new_zeros(B, cfg.attention_rnn_units), context=memory.new_zeros(B, M),
            hs=[memory.new_zeros(B, cfg.decoder_units) for _ in self.rnn],
            frame=memory.new_zeros(B, cfg.reduction * cfg.n_mels)[:, -cfg.n_mels:])

    def step(self, s: DecoderState) -> torch.Tensor:
        """One decoder step: reads ``s``, sets its states and its frame to
        this step's (new tensors, so autograd sees no in-place write), and
        returns the step's r frames [B, r * n_mels]."""
        x = self.prenet(s.frame)
        s.h_att = self.attention_rnn(torch.cat([x, s.context], dim=1), s.h_att)
        s.context, _ = self.attention(s.h_att, s.keys, s.memory, s.bias)
        d = self.project(torch.cat([s.h_att, s.context], dim=1))
        for i, cell in enumerate(self.rnn):
            s.hs[i] = cell(d, s.hs[i])
            d = d + s.hs[i]
        y = self.frames(d)
        s.frame = y[:, -self.cfg.n_mels:]
        return y

    def loop(self, memory: torch.Tensor, lengths: torch.Tensor, steps: int) -> torch.Tensor:
        """`forward`'s frames from a plain loop of `step` (the CPU, autograd)."""
        cfg = self.cfg
        s = self.start(memory, lengths)
        ys = [self.step(s) for _ in range(steps)]
        return torch.stack(ys, dim=1).reshape(memory.shape[0], steps * cfg.reduction, cfg.n_mels)

    def replay(self, memory: torch.Tensor, lengths: torch.Tensor, steps: int) -> torch.Tensor:
        """`forward`'s frames from one captured step (`capture`) replayed
        ``steps`` times on a CUDA memory: the memory padded with zeros to
        `graph_positions`, its start state copied into the step's static
        buffers, then two launches a step, the replay and the copy of its
        frames out. Nothing waits for the card."""
        cfg = self.cfg
        B, n, _ = memory.shape
        out = memory.new_empty(B, steps, cfg.reduction * cfg.n_mels)
        with torch.inference_mode():
            memory = F.pad(memory, (0, 0, 0, graph_positions(n) - n))
            key = (B, memory.shape[1], memory.dtype, memory.device)
            cap = self.captured.get(key)
            if cap is None:
                if len(self.captured) == GRAPH_CACHE:
                    torch.cuda.synchronize(memory.device)     # no replay of the dropped one in flight
                    del self.captured[next(iter(self.captured))]
                cap = self.captured[key] = self.capture(memory)
            for dst, src in zip(cap.state.tensors(), self.start(memory, lengths).tensors()):
                dst.copy_(src)
            for out_step in out.unbind(1):
                cap.graph.replay()
                out_step.copy_(cap.y)
        profiler.count("tts.decode_graph_steps", steps)
        return out.reshape(B, steps * cfg.reduction, cfg.n_mels)

    def capture(self, memory: torch.Tensor) -> CapturedStep:
        """One `step` captured as a CUDA graph over static buffers of
        ``memory``'s shape, type and device, with the copy of its new states
        and frame back into them, so each replay is the next step."""
        B, N, _ = memory.shape
        state = self.start(torch.zeros_like(memory), torch.full((B,), N, device=memory.device))
        here = torch.cuda.current_stream(memory.device)
        side = torch.cuda.Stream(memory.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            self.step(state.copy())     # lazy set-up (cuBLAS workspaces) outside the capture
        here.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(memory.device), torch.cuda.graph(graph, stream=side):
            s = state.copy()
            y = self.step(s)
            for dst, src in zip(state.tensors(), s.tensors()):
                if src is not dst:
                    dst.copy_(src)
        profiler.count("tts.decode_graph_captures")
        return CapturedStep(graph, state, y)

    def params_tree(self):
        return {"prenet": self.prenet.params_tree(),
                "attention_rnn": self.attention_rnn.params_tree(),
                "attention": self.attention.params_tree(), "project": self.project.params_tree(),
                "rnn": [c.params_tree() for c in self.rnn], "frames": self.frames.params_tree()}


class Tacotron(nn.Module):
    """Built from (params, state) trees; `encode`, `decoder` and `postnet`
    are the three stages the synthesis pipeline times apart."""

    def __init__(self, params, state, cfg: TacotronConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = Embed(params["embedding"])
        self.encoder_prenet = Prenet(params["encoder"]["prenet"])
        self.encoder_cbhg = CBHG(params["encoder"]["CBHG"], state["encoder"]["CBHG"],
                                 cfg.encoder_cbhg)
        self.decoder = TacotronDecoder(params["decoder"], cfg)
        self.postnet_cbhg = CBHG(params["postnet"]["CBHG"], state["postnet"]["CBHG"],
                                 cfg.postnet_cbhg)
        self.linear = Dense(params["postnet"]["linear"])

    def encode(self, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """ids [B, N] (0 past each row's ``lengths[b]``) -> memory [B, N, 2U]."""
        return self.encoder_cbhg(self.encoder_prenet(self.embedding(ids)), lengths=lengths)

    def postnet(self, mel: torch.Tensor, frame_lengths: torch.Tensor) -> torch.Tensor:
        """mel [B, T, n_mels], each row's first ``frame_lengths[b]`` frames
        its own -> linear spectrogram [B, T, n_stft] (normalized power dB)."""
        return self.linear(self.postnet_cbhg(mel, lengths=frame_lengths))

    def forward(self, ids, id_lengths, frame_lengths, steps: int):
        """(mel [B, r * steps, n_mels], linear [B, T, n_stft]) for T the
        longest row's frames; ``steps`` at least that row's."""
        mel = self.decoder(self.encode(ids, id_lengths), id_lengths, steps)
        T = int(frame_lengths.max())
        return mel, self.postnet(mel[:, :T], frame_lengths)

    def params_tree(self):
        return {"embedding": self.embedding.params_tree(),
                "encoder": {"prenet": self.encoder_prenet.params_tree(),
                            "CBHG": self.encoder_cbhg.params_tree()},
                "decoder": self.decoder.params_tree(),
                "postnet": {"CBHG": self.postnet_cbhg.params_tree(),
                            "linear": self.linear.params_tree()}}

    def state_tree(self):
        return {"encoder": {"CBHG": self.encoder_cbhg.state_tree()},
                "postnet": {"CBHG": self.postnet_cbhg.state_tree()}}


def init_tree(generator: torch.Generator, cfg: TacotronConfig):
    """Fresh (params, state) trees drawn from ``generator``: the embedding
    truncated-normal with deviation 0.5 (keithito/tacotron's), the rest as
    the other models draw theirs."""
    table = torch.empty(cfg.vocab_size, cfg.embed_size)
    torch.nn.init.trunc_normal_(table, 0.0, 0.5, -1.0, 1.0, generator=generator)
    inner, M = cfg.prenet_size // 2, cfg.memory_size
    enc_cbhg, enc_state = cbhg_init(generator, cfg.encoder_cbhg)
    post_cbhg, post_state = cbhg_init(generator, cfg.postnet_cbhg)
    params = {
        "embedding": {"lookup_table": table, "zero_pad": True},
        "encoder": {"prenet": prenet_init(generator, cfg.embed_size, cfg.prenet_size),
                    "CBHG": enc_cbhg},
        "decoder": {
            "prenet": prenet_init(generator, cfg.n_mels, cfg.prenet_size),
            "attention_rnn": gru_dir_init(generator, inner + M, cfg.attention_rnn_units),
            "attention": attention_init(generator, cfg.attention_rnn_units, M,
                                        cfg.attention_depth),
            "project": dense_init(generator, cfg.attention_rnn_units + M, cfg.decoder_units),
            "rnn": [gru_dir_init(generator, cfg.decoder_units, cfg.decoder_units)
                    for _ in range(cfg.decoder_layers)],
            "frames": dense_init(generator, cfg.decoder_units, cfg.reduction * cfg.n_mels)},
        "postnet": {"CBHG": post_cbhg,
                    "linear": dense_init(generator, 2 * cfg.postnet_units, cfg.n_stft)},
    }
    return params, {"encoder": {"CBHG": enc_state}, "postnet": {"CBHG": post_state}}


def init(generator: torch.Generator, cfg: TacotronConfig, device="cpu") -> Tacotron:
    return Tacotron(*init_tree(generator, cfg), cfg).to(device)


def config_from_cfg_d(cfg_d: dict) -> TacotronConfig:
    """From the ``model`` block of a configuration file (keys as the fields;
    a missing key keeps the paper's value)."""
    fields = {f.name for f in dataclasses.fields(TacotronConfig)}
    unknown = set(cfg_d) - fields
    if unknown:
        raise ValueError(f"tacotron config: unknown keys {sorted(unknown)}")
    d = dict(cfg_d)
    if "postnet_projections" in d:
        d["postnet_projections"] = tuple(d["postnet_projections"])
    return TacotronConfig(**d)
