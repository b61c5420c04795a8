"""Persistent conversion server: models load once, requests stream in.

Counterpart of ``speech_cloner_tpu/apps/serve.py``, with the same flags,
defaults and JSON records, plus ``--device``:

  stdin line protocol (one JSON result line per request on stdout):
    echo '{"input": "a.wav"}' | python -m speech_cloner_tpu_torch.apps.serve \\
        --enc-ckpt ... --dec-ckpt ... [--warm 10,60] [--bf16] [--device cuda|cpu] \\
        [--verify-ckpt ./spk_ckpt [--target-spk ID]]
    Request lines are either a bare path or {"input": path, "output": path}.

  directory watcher:
    python -m speech_cloner_tpu_torch.apps.serve --watch ./inbox --output-dir ./out \\
        --enc-ckpt ... --dec-ckpt ...
    Converts every new audio file appearing under --watch (results named
    <stem>_pred.wav; files already seen are skipped).

A checkpoint is a TF checkpoint prefix or a directory of ``<name>-<step>.npz``
(`make_pipeline`). PyTorch compiles nothing, but --warm S1,S2,... still runs
each window bucket of those durations (and the next bucket up, and with
--batch-max every power-of-two batch size) once at startup: the card's
library handles, workspaces and the kernel build are paid there, not by the
first request. The warm-up records keep the JAX server's keys (``warmed_s``,
``compile_s``, ``batch``), so a client of either server reads both.

Backpressure and robustness, as in the JAX server:
  - conversions run on a single worker thread fed by a bounded queue
    (--queue-depth); in stdin mode a full queue blocks the reader, so stdin's
    own flow control holds back the sender and every piped request
    completes; the watcher never blocks: a full queue means the file is
    retried on the next poll;
  - --timeout S emits an {"error": "timeout..."} record when a conversion
    exceeds S seconds; the conversion cannot be cancelled, so the worker
    finishes it and reports a late record with "late": true;
  - --batch-max N: when the queue holds at least --batch-backlog requests
    behind the one dequeued, the worker drains the whole queue, groups the
    requests by window bucket and converts each group in power-of-two chunks
    of at most N as one batch (`convert_batch_pcm16`: one model batch, one
    Griffin-Lim, per-clip peak norm). At trickle load every request converts
    alone;
  - a malformed stdin line, or an audio file that cannot be decoded, gives an
    error record, never a crash (watch mode marks the file done).

--verify-ckpt DIR classifies each request's source and converted audio with
the speaker-ID CNN of that checkpoint directory (``pipeline/verify.py``) and
adds the report as the record's "verification"; each request then converts
alone through ``convert`` (the waveform, not only the PCM, is needed), and
--batch-max is ignored, as in the JAX server. The server refuses to start
when DIR holds no speaker-ID checkpoint, or when --target-spk comes without
--verify-ckpt.
"""

from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import sys
import threading
import time

import numpy as np
import torch

from ..data.audio_io import load_audio, write_riff_wav
from ..models import decoder as dec_m
from ..models import encoder as enc_m
from ..pipeline.clone import make_pipeline
from ..pipeline.verify import verify_conversion
from ..runtime.checkpoint import Checkpointer
from ..runtime.config import DEFAULT_DS_CFG, feature_config_from_cfg_d, load_cfg_d

def _result(pipe, in_path: str, out_path: str, verify_ckpt: str | None = None,
            target_spk: str | None = None) -> dict:
    """Convert one file; return its JSON record (with ``verify_ckpt``, its
    speaker-ID verification too)."""
    sr = pipe.feat_cfg.sample_rate
    t_in = time.perf_counter()
    wav = load_audio(in_path, sr)
    dur = len(wav) / sr
    t0 = time.perf_counter()
    if verify_ckpt:             # the waveform, which the verification reads
        out = pipe.convert(wav)[0]
    else:
        out = pipe.convert_pcm16(wav)      # only the int16 PCM leaves the card
    wall = time.perf_counter() - t0
    write_riff_wav(out_path, out, sr, norm=True)
    rec = {"input": in_path, "output": out_path,
           "duration_s": round(dur, 3), "wall_s": round(wall, 3),
           # host cost around the conversion: decode and RIFF write
           "host_s": round(time.perf_counter() - t_in - wall, 3),
           "rtf": round(wall / max(dur, 1e-9), 5)}
    if verify_ckpt:
        rec["verification"] = verify_conversion(wav, out, verify_ckpt, pipe.feat_cfg,
                                                target_spk_id=target_spk, device=pipe.device)
    return rec


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--enc-ckpt", required=True)
    ap.add_argument("--dec-ckpt", required=True)
    ap.add_argument("--enc-cfg")
    ap.add_argument("--dec-cfg")
    ap.add_argument("--ds-cfg")
    ap.add_argument("--output-dir", default="./served")
    ap.add_argument("--n-iter", type=int, default=200)
    ap.add_argument("--realse", type=float, default=1.2)
    ap.add_argument("--gl-momentum", type=float, default=0.0)
    ap.add_argument("--gl-unroll", type=int, default=1,
                    help="accepted for compatibility with the JAX server; no effect")
    ap.add_argument("--gl-dft", choices=("fft", "matmul"), default="matmul",
                    help="Griffin-Lim transform: 'matmul' multiplies by cos/sin "
                         "bases, 'fft' uses torch.fft")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 model compute (float32 softmax and vocoder)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--warm", default="",
                    help="comma-separated clip durations (s) whose buckets run once at startup")
    ap.add_argument("--watch", help="directory to watch instead of stdin")
    ap.add_argument("--poll", type=float, default=1.0, help="watch poll seconds")
    ap.add_argument("--max-requests", type=int, default=0,
                    help="exit after N requests (0 = run forever)")
    ap.add_argument("--queue-depth", type=int, default=8,
                    help="max conversions waiting behind the one in flight")
    ap.add_argument("--batch-max", type=int, default=1,
                    help="convert up to N queued requests of one window bucket as one "
                         "batch (power-of-two chunks). 1 = off.")
    ap.add_argument("--batch-backlog", type=int, default=2,
                    help="batch only when >= N further requests are queued behind the "
                         "one dequeued; 0 = always drain and batch")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="per-request seconds before an error record (0 = none)")
    ap.add_argument("--verify-ckpt",
                    help="speaker-ID model dir: verify each conversion's speaker shift "
                         "(disables batching)")
    ap.add_argument("--target-spk", help="target voice's class in the speaker-ID model")
    args = ap.parse_args(argv)
    if args.target_spk and not args.verify_ckpt:
        ap.error("--target-spk needs --verify-ckpt")
    if args.verify_ckpt and Checkpointer(args.verify_ckpt, "speaker_id").latest_step() is None:
        ap.error(f"--verify-ckpt {args.verify_ckpt}: no speaker_id checkpoint there")
    return args


def main(argv=None):
    args = _args(argv)
    ds_cfg_d = load_cfg_d(args.ds_cfg) if args.ds_cfg else dict(DEFAULT_DS_CFG)
    feat_cfg = feature_config_from_cfg_d(ds_cfg_d)
    enc_cfg = (enc_m.config_from_cfg_d(load_cfg_d(args.enc_cfg))
               if args.enc_cfg else enc_m.EncoderConfig())
    dec_cfg = (dec_m.config_from_cfg_d(load_cfg_d(args.dec_cfg))
               if args.dec_cfg else dec_m.DecoderConfig())
    pipe = make_pipeline(enc_cfg, dec_cfg, feat_cfg, enc_ckpt=args.enc_ckpt,
                         dec_ckpt=args.dec_ckpt, device=args.device, n_iter=args.n_iter,
                         realse=args.realse, gl_momentum=args.gl_momentum,
                         gl_unroll=args.gl_unroll, gl_dft=args.gl_dft,
                         compute_dtype=torch.bfloat16 if args.bf16 else None)
    os.makedirs(args.output_dir, exist_ok=True)
    sr = feat_cfg.sample_rate
    batching = args.batch_max > 1 and not args.verify_ckpt

    # every record goes through one locked write: the reader, the worker and a
    # watchdog timer can all report at once, and print() writes the payload
    # and the newline separately
    emit_lock = threading.Lock()

    def emit(rec: dict):
        rec.setdefault("ts", round(time.time(), 3))   # lets a client cut warm-up from its window
        with emit_lock:
            sys.stdout.write(json.dumps(rec) + "\n")
            sys.stdout.flush()

    # Clips pad to whole windows (n_timesteps*hop samples, 2 s at production
    # geometry), one bucket per window count. Warm the bucket of each duration
    # and the next one up: a nominal "60 s" clip is often a few ms longer.
    warmed = set()
    for dur_s in (float(x) for x in args.warm.split(",") if x):
        n_padded = pipe.padded_length(int(dur_s * sr))
        for n_warm in (n_padded, n_padded + pipe.padded_length(0)):
            if n_warm in warmed:
                continue
            warmed.add(n_warm)
            warm_wav = np.zeros(n_warm, np.float32) + 1e-4
            t0 = time.perf_counter()
            if args.verify_ckpt:
                pipe.convert(warm_wav)
            else:
                pipe.convert_pcm16(warm_wav)
            emit({"warmed_s": round(n_warm / sr, 3),
                  "compile_s": round(time.perf_counter() - t0, 1)})
            b = 2
            while batching and b <= args.batch_max:
                t0 = time.perf_counter()
                pipe.convert_batch_pcm16([warm_wav] * b)
                emit({"warmed_s": round(n_warm / sr, 3), "batch": b,
                      "compile_s": round(time.perf_counter() - t0, 1)})
                b *= 2

    def out_path_for(in_path: str, explicit: str | None) -> str:
        if explicit:
            return explicit
        stem = os.path.splitext(os.path.basename(in_path))[0]
        return os.path.join(args.output_dir, f"{stem}_pred.wav")

    def convert_one(in_path: str, explicit_out: str | None) -> dict:
        try:
            return _result(pipe, in_path, out_path_for(in_path, explicit_out),
                           args.verify_ckpt, args.target_spk)
        except Exception as e:  # a bad request must not kill the server
            return {"input": in_path, "error": f"{type(e).__name__}: {e}"}

    def convert_chunk(chunk):
        """Convert 1..batch_max loaded requests of one bucket as one batch;
        one record each (a batch's requests share its wall time)."""
        t0 = time.perf_counter()
        if len(chunk) == 1:
            pcms = [pipe.convert_pcm16(chunk[0][3])]
        else:
            pcms = pipe.convert_batch_pcm16([c[3] for c in chunk])
        wall = time.perf_counter() - t0
        for (in_path, explicit_out, _, wav), pcm in zip(chunk, pcms):
            out_path = out_path_for(in_path, explicit_out)
            write_riff_wav(out_path, pcm, sr, norm=True)
            dur = len(wav) / sr
            emit({"input": in_path, "output": out_path, "duration_s": round(dur, 3),
                  "wall_s": round(wall, 3), "batch": len(chunk),
                  "rtf": round(wall / max(dur, 1e-9), 5)})

    def process_batched(items):
        """Load every drained request, group by window bucket, convert each
        group in power-of-two chunks of at most batch_max."""
        buckets: dict[int, list] = {}
        for in_path, explicit_out, finish in items:
            try:
                wav = load_audio(in_path, sr)
            except Exception as e:
                emit({"input": in_path, "error": f"{type(e).__name__}: {e}"})
                finish()
                continue
            buckets.setdefault(pipe.padded_length(len(wav)), []).append(
                (in_path, explicit_out, finish, wav))
        for group in buckets.values():
            while group:
                n = 1
                while n * 2 <= min(len(group), args.batch_max):
                    n *= 2
                chunk, group = group[:n], group[n:]
                try:
                    convert_chunk(chunk)
                except Exception as e:
                    for in_path, _, _, _ in chunk:
                        emit({"input": in_path, "error": f"{type(e).__name__}: {e}"})
                finally:
                    for _, _, finish, _ in chunk:
                        finish()

    # one conversion at a time; a bounded queue in front keeps ingest live and
    # memory flat under a burst
    work: queue_mod.Queue = queue_mod.Queue(maxsize=max(args.queue_depth, 1))
    done = threading.Event()

    def worker():
        while not done.is_set():
            try:
                first = work.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            items = [first]
            if batching and work.qsize() >= args.batch_backlog:
                # drain the whole queue, not batch_max items: a burst that
                # alternates buckets would otherwise give one item per bucket
                while True:
                    try:
                        items.append(work.get_nowait())
                    except queue_mod.Empty:
                        break
            try:
                t0 = time.perf_counter()
                timed_out = threading.Event()
                if args.timeout > 0:
                    inputs = [it[0] for it in items]

                    def report_timeout():
                        timed_out.set()
                        emit({"input": inputs[0] if len(inputs) == 1 else inputs,
                              "error": f"timeout after {args.timeout}s "
                                       "(conversion still running)"})
                    watchdog = threading.Timer(args.timeout, report_timeout)
                    watchdog.start()
                if batching:
                    process_batched(items)
                else:
                    in_path, explicit_out, finish = items[0]
                    try:
                        rec = convert_one(in_path, explicit_out)
                        if timed_out.is_set():
                            rec["late"] = True
                            rec["wall_s"] = round(time.perf_counter() - t0, 3)
                        emit(rec)
                    finally:
                        finish()
                if args.timeout > 0:
                    watchdog.cancel()
            except Exception as e:  # the worker must never die silently
                emit({"input": [it[0] for it in items],
                      "error": f"worker: {type(e).__name__}: {e}"})
            finally:
                for _ in items:
                    work.task_done()

    worker_t = threading.Thread(target=worker, daemon=True)
    worker_t.start()

    n_done = 0
    done_lock = threading.Lock()
    finished = threading.Event()

    def make_finish():
        def finish():
            nonlocal n_done
            with done_lock:
                n_done += 1
                if args.max_requests and n_done >= args.max_requests:
                    finished.set()
        return finish

    try:
        if args.watch:
            emit({"watching": args.watch, "output_dir": args.output_dir})
            seen: set[str] = set()
            settling: dict[str, tuple] = {}   # path -> (size, mtime) at the last poll
            while not finished.is_set():
                for name in sorted(os.listdir(args.watch)):
                    p = os.path.join(args.watch, name)
                    if p in seen or not os.path.isfile(p) or name.endswith("_pred.wav"):
                        continue
                    # convert only once (size, mtime) held across two polls: a
                    # file still being copied in would be read truncated
                    st = os.stat(p)
                    sig = (st.st_size, st.st_mtime)
                    if settling.get(p) != sig:
                        settling[p] = sig
                        continue
                    try:
                        work.put_nowait((p, None, make_finish()))
                    except queue_mod.Full:
                        continue   # retried on the next poll; the queue stays bounded
                    settling.pop(p, None)
                    seen.add(p)
                finished.wait(args.poll)
        else:
            for line in sys.stdin:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("{"):
                    try:
                        req = json.loads(line)
                        in_path, explicit_out = req["input"], req.get("output")
                    except Exception as e:
                        emit({"request": line[:200],
                              "error": f"bad request: {type(e).__name__}: {e}"})
                        continue
                else:
                    in_path, explicit_out = line, None
                # a blocking put: a full queue only delays ingest
                work.put((in_path, explicit_out, make_finish()))
                if finished.is_set():
                    break
            work.join()   # every queued conversion reported before exit
    finally:
        done.set()
        worker_t.join(timeout=5.0)


if __name__ == "__main__":
    main()
