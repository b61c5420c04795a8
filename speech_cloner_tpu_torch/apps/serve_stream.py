"""Live multi-session streaming conversion server.

Counterpart of ``speech_cloner_tpu/apps/serve_stream.py``, with the same
flags, protocol and records, plus ``--device``. Up to ``--slots`` live
sessions share one card: all sessions advance in lockstep through one
forward and one Griffin-Lim per chunk step (`pipeline/stream.StreamingCloner`
``batch=B``).

JSONL line protocol on stdin -> stdout (audio as base64 int16 mono PCM at
the feature sample rate):

    {"open": "alice"}                        -> {"opened": "alice", "slot": 0,
                                                 "latency_s": 3.02}
    {"sid": "alice", "pcm16": "<base64>"}    buffered; converted audio comes
                                             back as {"sid": "alice",
                                             "pcm16": ..., "t_s": ...} records
    {"sid": "alice", "input": "a.wav"}       convenience: feed a whole file
    {"close": "alice"}                       drain; a final trimmed chunk and
                                             {"closed": "alice", ...} follow
    {"tick": true}                           force one lockstep step (pads
                                             every shortfall with silence)

Stepping: a chunk step fires once every open (non-draining) session has a
full chunk buffered, and keeps firing to drain closing sessions. A live
frontend paces sessions at wall-clock rate and sends {"tick": true} each
chunk period instead: a session that underran is padded with silence.

Slot life cycle: a closed session's slot is reset (`reset_stream`) and
reusable at once; the new occupant re-freezes its own gain, c0, phase and
output gain, and nothing leaks across occupants. Conversion runs inline in
the reading thread: the card is a serial resource and the protocol is
request -> records.

  python -m speech_cloner_tpu_torch.apps.serve_stream --enc-ckpt ./enc_ckpt \\
      --dec-ckpt ./dec_ckpt [--slots 4] [--warm] [--bf16] [--device cuda|cpu]

``--mesh N`` shards the slots over the first N devices of ``--device``
(``pipeline/stream.StreamingCloner(mesh=...)``: slots/N sessions a device,
the weights replicated, nothing crossing devices in the steady state; the
slots must divide by N). On cuda those are cuda:0..N-1, and asking for more
cards than there are raises; on the CPU the N shards share the CPU.
``--gl-unroll`` is accepted and has no effect.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import time

import numpy as np
import torch


class _Session:
    __slots__ = ("sid", "slot", "start", "buf", "draining", "last_real",
                 "emitted")

    def __init__(self, sid: str, slot: int, start: int):
        self.sid = sid
        self.slot = slot
        self.start = start          # global sample index of its first feed
        self.buf: list[np.ndarray] = []
        self.draining = False
        self.last_real = start      # global index just past its last real sample
        self.emitted = 0            # samples already sent back to the client

    @property
    def buffered(self) -> int:
        return sum(a.size for a in self.buf)

    def take(self, n: int) -> np.ndarray:
        out, got = [], 0
        while self.buf and got < n:
            a = self.buf[0]
            if a.size <= n - got:
                out.append(self.buf.pop(0))
                got += a.size
            else:
                out.append(a[: n - got])
                self.buf[0] = a[n - got :]
                got = n
        return np.concatenate(out) if out else np.zeros(0, np.float32)


class StreamServer:
    """Slot-multiplexed lockstep streaming over one `StreamingCloner`.

    Pure request -> records core (no IO): main() wires it to stdin/stdout;
    tests drive it in process. All sessions share one global sample clock,
    the cloner's lockstep feed position, and each session's output is its
    slot's emit sliced to [session start, session end)."""

    def __init__(self, pipeline, *, slots: int = 4, chunk_frames: int = 400,
                 context_frames: int = 400, lookahead_frames: int = 200,
                 margin_frames: int = 16, seed: int = 0,
                 out_scale: float = 4.0, mesh=None):
        from ..pipeline.stream import StreamingCloner

        self.s = StreamingCloner(
            pipeline, batch=slots, chunk_frames=chunk_frames,
            context_frames=context_frames, lookahead_frames=lookahead_frames,
            margin_frames=margin_frames, seed=seed, mesh=mesh)
        self.slots = slots
        self.block = chunk_frames * self.s.hop
        self.sr = pipeline.feat_cfg.sample_rate
        self.out_scale = out_scale
        self.free = list(range(slots))
        self.sessions: dict[str, _Session] = {}
        self.fed = 0       # global samples fed per slot (the lockstep clock)
        self.emitted = 0   # global samples emitted per slot

    # ---------------------------------------------------------- requests ---

    def open(self, sid: str) -> dict:
        if sid in self.sessions:
            return {"sid": sid, "error": "session already open"}
        if not self.free:
            return {"sid": sid, "error": f"no free slot (slots={self.slots})"}
        slot = self.free.pop(0)
        self.s.reset_stream(slot)
        self.sessions[sid] = _Session(sid, slot, self.fed)
        return {"opened": sid, "slot": slot,
                "latency_s": round(self.s.latency_seconds, 3)}

    def feed(self, sid: str, samples: np.ndarray) -> dict | None:
        sess = self.sessions.get(sid)
        if sess is None:
            return {"sid": sid, "error": "unknown session"}
        if sess.draining:
            return {"sid": sid, "error": "session is closing"}
        if samples.size:
            sess.buf.append(np.asarray(samples, np.float32).reshape(-1))
        return None

    def close(self, sid: str) -> dict | None:
        sess = self.sessions.get(sid)
        if sess is None:
            return {"sid": sid, "error": "unknown session"}
        sess.draining = True
        return None

    # ---------------------------------------------------------- stepping ---

    def ready(self) -> bool:
        """True when a step should fire without waiting for more input:
        every open session can fill its chunk, or a closing session still
        has output in flight."""
        if not self.sessions:
            return False
        active = [s for s in self.sessions.values() if not s.draining]
        if active:
            return all(s.buffered >= self.block for s in active)
        return True  # only draining sessions: tick them dry

    def tick(self) -> list[dict]:
        """One lockstep chunk step: feed every slot ``block`` samples (its
        session's buffer, silence-padded on shortfall; silence for free
        slots), push, and slice each session's share of the emit."""
        x = np.zeros((self.slots, self.block), np.float32)
        for sess in self.sessions.values():
            got = sess.take(self.block)
            x[sess.slot, : got.size] = got
            if got.size:
                sess.last_real = self.fed + got.size
        out = self.s.push(x)
        self.fed += self.block

        records: list[dict] = []
        if out.shape[1]:
            lo = self.emitted
            self.emitted += out.shape[1]
            for sess in list(self.sessions.values()):
                records.extend(self._emit_for(sess, out, lo))
        return records

    def _emit_for(self, sess: _Session, out: np.ndarray, lo: int) -> list[dict]:
        """Slice session audio out of one global emit [lo, lo+n): the
        session owns [start, last_real); a draining session's final chunk
        is trimmed to its last real sample and its slot is freed."""
        hi = lo + out.shape[1]
        a = max(lo, sess.start)
        b = min(hi, sess.last_real) if sess.draining and not sess.buffered else hi
        recs: list[dict] = []
        if b > a:
            seg = out[sess.slot, a - lo : b - lo]
            pcm = np.clip(seg * self.out_scale, -1.0, 1.0)
            recs.append({
                "sid": sess.sid,
                "t_s": round((a - sess.start) / self.sr, 3),
                "pcm16": base64.b64encode(
                    (pcm * 32767.0).astype("<i2").tobytes()).decode("ascii"),
            })
            sess.emitted += b - a
        if sess.draining and not sess.buffered and hi >= sess.last_real:
            recs.append({"closed": sess.sid,
                         "seconds": round(sess.emitted / self.sr, 3)})
            del self.sessions[sess.sid]
            self.s.reset_stream(sess.slot)
            self.free.append(sess.slot)
        return recs

    def drain(self) -> list[dict]:
        """Close every session and tick until all output is flushed."""
        records = []
        for sid in list(self.sessions):
            self.close(sid)
        while self.sessions:
            records.extend(self.tick())
        return records


def _decode_pcm16(b64: str) -> np.ndarray:
    raw = np.frombuffer(base64.b64decode(b64), dtype="<i2")
    return (raw.astype(np.float32) / 32768.0).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--enc-ckpt", required=True)
    ap.add_argument("--dec-ckpt", required=True)
    ap.add_argument("--enc-cfg")
    ap.add_argument("--dec-cfg")
    ap.add_argument("--ds-cfg")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk-frames", type=int, default=400)
    ap.add_argument("--context-frames", type=int, default=400)
    ap.add_argument("--lookahead-frames", type=int, default=200)
    ap.add_argument("--margin-frames", type=int, default=16)
    ap.add_argument("--n-iter", type=int, default=25)
    ap.add_argument("--gl-momentum", type=float, default=0.99,
                    help="Fast Griffin-Lim by default; --n-iter 200 "
                         "--gl-momentum 0 restores the reference algorithm")
    ap.add_argument("--realse", type=float, default=1.2)
    ap.add_argument("--gl-unroll", type=int, default=6,
                    help="accepted for compatibility with the JAX server; no effect")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 model compute (float32 softmax and vocoder)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out-scale", type=float, default=4.0,
                    help="fixed gain from the pipeline's output level "
                         "convention (EMA mean |y| = mean_abs_amp_norm) to "
                         "int16 full scale: fixed, not per-chunk AGC, so it "
                         "never pumps")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the slot axis over the first N devices of --device "
                         "(slots %% N == 0); 0 = one device")
    ap.add_argument("--warm", action="store_true",
                    help="run one synthetic session through every step shape "
                         "before reading stdin")
    args = ap.parse_args(argv)

    from ..data.audio_io import load_audio
    from ..models import decoder as dec_m
    from ..models import encoder as enc_m
    from ..parallel.mesh import make_seq_mesh
    from ..pipeline.clone import make_pipeline
    from ..runtime.config import DEFAULT_DS_CFG, feature_config_from_cfg_d, load_cfg_d

    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    enc_cfg = (enc_m.config_from_cfg_d(load_cfg_d(args.enc_cfg))
               if args.enc_cfg else enc_m.EncoderConfig())
    dec_cfg = (dec_m.config_from_cfg_d(load_cfg_d(args.dec_cfg))
               if args.dec_cfg else dec_m.DecoderConfig())
    pipe = make_pipeline(enc_cfg, dec_cfg, feat_cfg, enc_ckpt=args.enc_ckpt,
                         dec_ckpt=args.dec_ckpt, device=args.device,
                         n_iter=args.n_iter, realse=args.realse,
                         gl_momentum=args.gl_momentum, gl_unroll=args.gl_unroll,
                         compute_dtype=torch.bfloat16 if args.bf16 else None)
    mesh = None
    if args.mesh:
        devices = None if args.device == "cuda" else ["cpu"] * args.mesh
        mesh = make_seq_mesh(args.mesh, devices=devices, axis_name="streams")
    srv = StreamServer(pipe, slots=args.slots, chunk_frames=args.chunk_frames,
                       context_frames=args.context_frames,
                       lookahead_frames=args.lookahead_frames,
                       margin_frames=args.margin_frames,
                       out_scale=args.out_scale, mesh=mesh)

    def emit(rec: dict):
        rec.setdefault("ts", round(time.time(), 3))
        sys.stdout.write(json.dumps(rec) + "\n")
        sys.stdout.flush()

    if args.warm:
        # one synthetic session through open -> steady chunk -> close, so the
        # card's library handles and workspaces of every step shape are made
        # before the first live session (the JAX server compiles them here)
        t0 = time.perf_counter()
        srv.open("__warm__")
        srv.feed("__warm__", np.full(srv.block * 2, 1e-4, np.float32))
        while srv.ready():
            srv.tick()
        srv.close("__warm__")
        srv.drain()
        emit({"warmed": True, "compile_s": round(time.perf_counter() - t0, 1)})

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except Exception as e:
            emit({"request": line[:200], "error": f"bad request: {e}"})
            continue
        rec = None
        try:
            if "open" in req:
                rec = srv.open(str(req["open"]))
            elif "close" in req:
                rec = srv.close(str(req["close"]))
            elif "tick" in req:
                for r in srv.tick():
                    emit(r)
            elif "sid" in req and "pcm16" in req:
                rec = srv.feed(str(req["sid"]), _decode_pcm16(req["pcm16"]))
            elif "sid" in req and "input" in req:
                rec = srv.feed(str(req["sid"]),
                               load_audio(req["input"], srv.sr))
            else:
                rec = {"request": line[:200], "error": "unrecognized request"}
        except Exception as e:  # one bad request must not kill the server
            rec = {"request": line[:200], "error": f"{type(e).__name__}: {e}"}
        if rec is not None:
            emit(rec)
        while srv.ready():
            for r in srv.tick():
                emit(r)
    for r in srv.drain():  # EOF: flush every live session's tail
        emit(r)


if __name__ == "__main__":
    main()
