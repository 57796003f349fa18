"""Serving benchmark (the JAX package's scripts/bench_serving.py): N
concurrent clients stream real-time-paced 80 ms chunks at a live server
running the flagship model (6-2-1024 / vocab-2048, blank-biased random
weights — the same workload proxy as libreasr_tpu_torch/bench.py) and
measure what the CLIENT observes:

- partial latency: Transcript arrival time minus the send time of the
  most recently sent chunk (bounded by chunk cadence + step + wire when
  the server keeps up; grows with server backlog when it doesn't);
- overrun: stream-close time minus last-chunk-send time (end-of-stream
  flush + any backlog the server accumulated). Sustained real time means
  overrun stays near the flush cost instead of growing with duration.

Two transports:
- `--transport grpc` (the default, as in JAX): the server runs in a
  separate process (it owns the card) behind gRPC; clients run in this
  process, or in `--procs` load-worker processes whose statistics are
  merged. It needs the `grpc` package, and raises an ImportError naming
  `--transport inproc` without it.
- `--transport inproc`: the servicer runs in this process on the card
  and each client is a thread that drives `ASRServicer.TranscribeStream`
  directly, paced from a shared start, with the same client statistics
  (no wire: the numbers leave out serialization and the socket).

Usage:
  python -m libreasr_tpu_torch.scripts.bench_serving --streams 64 --duration 20
  python -m libreasr_tpu_torch.scripts.bench_serving --transport inproc
  ... --role server --port P --streams N  (internal)

Runs on the card and raises without one. Prints one JSON line last,
then raises if any stream failed (its error is in the line).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODULE = "libreasr_tpu_torch.scripts.bench_serving"
CHUNK_SAMPLES = 1280  # 80 ms at 16 kHz


def _grpc():
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "bench_serving: the grpc transport needs the grpc package, which "
            "this environment lacks; run with --transport inproc to drive "
            "the servicer in process") from e
    return grpc


def _bundle(blank_bias: float, bundle_path: str = ""):
    """The served bundle on the card: a trained .tar.gz, or the flagship
    proxy at `blank_bias`."""
    from ..bench import build_bundle, set_blank_bias

    if bundle_path:
        # a TRAINED bundle replaces the blank-biased random proxy: real
        # weights, natural emission rate; the tokenizer stays in the
        # extraction directory while it serves
        import tempfile

        from ..api import ASRBundle

        return ASRBundle.from_bundle(bundle_path, extract_to=tempfile.mkdtemp())
    bundle = build_bundle()
    set_blank_bias(bundle, blank_bias)
    return bundle


def _engine(bundle, n_streams: int, n_buffer: int, beam: int):
    """The server's engine (int16 wire codec, the server default), warmed
    before clients arrive (the step and every chained depth), so the
    bench measures steady state. The warm state is kept: slot opens
    reset on the device."""
    from ..models.streaming import CHAIN_DEPTHS, StreamingConfig, StreamingEngine

    scfg = StreamingConfig(sr=bundle.frontend.sr, n_buffer=n_buffer,
                           beam_width=beam, transfer_dtype="int16")
    engine = StreamingEngine(bundle, n_streams=n_streams, scfg=scfg)
    engine.warmup(3, chain_depths=CHAIN_DEPTHS)
    return engine


# ---------------------------------------------------------------------------
# server role (separate process: owns the device)
# ---------------------------------------------------------------------------


def run_server(port: int, n_streams: int, n_buffer: int, beam: int,
               blank_bias: float, bundle_path: str = ""):
    from ..serving.server import make_server

    _grpc()
    bundle = _bundle(blank_bias, bundle_path)
    engine = _engine(bundle, n_streams, n_buffer, beam)
    server, servicer = make_server(
        bundle, port, workers=max(2 * n_streams, 16), engine=engine
    )
    server.start()
    print(f"READY port={port}", flush=True)
    try:
        server.wait_for_termination()
    finally:
        stats = servicer.timings.snapshot()
        print(f"TIMINGS {json.dumps(stats)}", flush=True)


# ---------------------------------------------------------------------------
# client role
# ---------------------------------------------------------------------------


class ClientStats:
    def __init__(self):
        self.partial_lat = []
        self.overrun = None
        self.n_text = 0
        self.error = None


def run_client(port: int, duration_s: float, chunk_samples: int, stats: ClientStats,
               start_barrier, seed: int, servicer=None):
    """One paced stream of seeded noise. start_barrier: a
    threading.Barrier, or a float wall-clock time every client (across
    processes) sleeps until — the multi-process load driver can't share
    a Barrier. With `servicer` the stream goes straight into its
    TranscribeStream (the inproc transport); else over gRPC to `port`."""
    from ..serving import proto

    chunk_s = chunk_samples / 16000.0
    n_chunks = int(duration_s / chunk_s)
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal(chunk_samples) * 0.1).astype(np.float32).tobytes()
    state = {"last_send": 0.0, "done_send": 0.0}

    def gen():
        if isinstance(start_barrier, float):
            dt = start_barrier - time.time()
            if dt > 0:
                time.sleep(dt)
        else:
            start_barrier.wait()
        t0 = time.perf_counter()
        for i in range(n_chunks):
            # real-time pacing against the global clock (no drift)
            target = t0 + i * chunk_s
            dt = target - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            state["last_send"] = time.perf_counter()
            yield proto.Audio(data=pcm, sr=16000)
        state["done_send"] = time.perf_counter()

    channel = None
    if servicer is not None:
        responses = servicer.TranscribeStream(gen())
    else:
        grpc = _grpc()
        channel = grpc.insecure_channel(f"localhost:{port}")
        stream = channel.stream_stream(
            f"/{proto.SERVICE}/TranscribeStream",
            request_serializer=proto.Audio.SerializeToString,
            response_deserializer=proto.Transcript.FromString,
        )
        responses = stream(gen())
    try:
        for tr in responses:
            now = time.perf_counter()
            if tr.data:
                stats.n_text += 1
                stats.partial_lat.append(now - state["last_send"])
        stats.overrun = time.perf_counter() - (state["done_send"] or time.perf_counter())
    except Exception as e:  # noqa: BLE001 — counted in the result's errors
        stats.error = repr(e)
    finally:
        if channel is not None:
            channel.close()


def _run_threads(port: int, count: int, duration_s: float, start, seed_base: int,
                 servicer=None) -> list[ClientStats]:
    stats = [ClientStats() for _ in range(count)]
    threads = [
        threading.Thread(
            target=run_client,
            args=(port, duration_s, CHUNK_SAMPLES, stats[i], start,
                  seed_base + i, servicer),
        )
        for i in range(count)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s * 3 + 120)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"bench_serving: a stream did not finish in "
                           f"{duration_s * 3 + 120:.0f} s")
    return stats


def _merge(stats: list[ClientStats]) -> dict:
    """One process's clients in a load worker's LOAD form."""
    return {
        "lat": [x for s in stats for x in s.partial_lat],
        "over": [s.overrun for s in stats if s.overrun is not None],
        "texts": sum(s.n_text for s in stats),
        "errors": [s.error for s in stats if s.error],
        "n_errors": sum(1 for s in stats if s.error),
    }


# ---------------------------------------------------------------------------
# load-worker role (one of P processes, each M threaded clients — the
# single-process thread driver saturates its own GIL past ~128 clients
# and measures the bench host, not the server)
# ---------------------------------------------------------------------------


def run_load_worker(port: int, count: int, duration_s: float,
                    start_at: float, seed_base: int):
    out = _merge(_run_threads(port, count, duration_s, start_at, seed_base))
    out["errors"] = out["errors"][:3]
    print("LOAD " + json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


def _result(a, merged: dict, procs: int, wall: float, transport: str) -> dict:
    lat, over = np.array(merged["lat"]), np.array(merged["over"])

    def pct(x, q):
        return round(float(np.percentile(x, q) * 1e3), 1) if len(x) else None

    return {
        "metric": "wire_p50_partial_latency_ms",
        "value": pct(lat, 50),
        "unit": "ms",
        "streams": a.streams,
        "blank_bias": a.blank_bias,
        "beam": a.beam,
        "duration_s": a.duration,
        "wall_s": round(wall, 1),
        "p90_ms": pct(lat, 90),
        "p99_ms": pct(lat, 99),
        "latency_samples": int(len(lat)),
        "transcript_msgs": merged["texts"],
        "overrun_p50_ms": pct(over, 50),
        "overrun_p99_ms": pct(over, 99),
        "procs": procs,
        "errors": merged["errors"][:3],
        "n_errors": merged["n_errors"],
        "transport": transport,
    }


def _bench_inproc(a) -> dict:
    """The servicer in this process (on the card), a thread per stream."""
    from ..serving.server import ASRServicer

    if a.procs > 1:
        raise ValueError("bench_serving: --transport inproc drives the "
                         "servicer from threads of this process (--procs 1)")
    bundle = _bundle(a.blank_bias, a.bundle)
    servicer = ASRServicer(bundle, engine=_engine(bundle, a.streams,
                                                  a.n_buffer, a.beam))
    try:
        t0 = time.perf_counter()
        stats = _run_threads(0, a.streams, a.duration,
                             threading.Barrier(a.streams), 0, servicer)
        wall = time.perf_counter() - t0
        print(f"[server] TIMINGS {json.dumps(servicer.timings.snapshot())}",
              file=sys.stderr)
    finally:
        servicer.stepper.shutdown()
    return _result(a, _merge(stats), 1, wall, "inproc")


def _bench_grpc(a) -> dict:
    _grpc()
    srv = subprocess.Popen(
        [sys.executable, "-m", MODULE, "--role", "server",
         "--port", str(a.port), "--streams", str(a.streams),
         "--n-buffer", str(a.n_buffer), "--beam", str(a.beam),
         "--blank-bias", str(a.blank_bias)]
        + (["--bundle", os.path.abspath(a.bundle)] if a.bundle else []),
        cwd=REPO, stdout=subprocess.PIPE, text=True,
    )
    try:
        for line in srv.stdout:
            print(f"[server] {line}", end="", file=sys.stderr)
            if line.startswith("READY"):
                break
        else:
            raise RuntimeError("server died before READY")

        procs = a.procs or max(1, -(-a.streams // 64))
        t0 = time.perf_counter()
        if procs <= 1:
            merged = _merge(_run_threads(a.port, a.streams, a.duration,
                                         threading.Barrier(a.streams), 0))
        else:
            # multi-process fan-out: P workers x M threads, synchronized
            # on a shared wall-clock start
            per = -(-a.streams // procs)
            start_at = time.time() + 5.0
            workers = []
            for w in range(procs):
                cnt = min(per, a.streams - w * per)
                if cnt <= 0:
                    break
                workers.append(subprocess.Popen(
                    [sys.executable, "-m", MODULE,
                     "--role", "load", "--port", str(a.port),
                     "--count", str(cnt), "--duration", str(a.duration),
                     "--start-at", repr(start_at),
                     "--seed-base", str(w * per)],
                    cwd=REPO, stdout=subprocess.PIPE, text=True,
                ))
            merged = {"lat": [], "over": [], "texts": 0, "errors": [],
                      "n_errors": 0}
            for w in workers:
                out, _ = w.communicate(timeout=a.duration * 3 + 300)
                for line in out.splitlines():
                    if line.startswith("LOAD "):
                        d = json.loads(line[5:])
                        for k in ("lat", "over", "errors"):
                            merged[k].extend(d[k])
                        merged["texts"] += d["texts"]
                        merged["n_errors"] += d["n_errors"]
        wall = time.perf_counter() - t0
        return _result(a, merged, procs, wall, "grpc")
    finally:
        srv.terminate()
        for line in srv.stdout:
            print(f"[server] {line}", end="", file=sys.stderr)
        srv.wait(timeout=30)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--role", default="bench",
                   choices=["bench", "server", "load"])
    p.add_argument("--transport", default="grpc", choices=["grpc", "inproc"],
                   help="grpc: a server process behind the wire; inproc: "
                        "the servicer in this process, driven by threads")
    p.add_argument("--procs", type=int, default=0,
                   help="client driver processes (0 = auto: one per 64 "
                        "clients). >1 removes the driver-side GIL "
                        "bottleneck above ~128 clients")
    p.add_argument("--count", type=int, default=0, help="(load role)")
    p.add_argument("--start-at", type=float, default=0.0, help="(load role)")
    p.add_argument("--seed-base", type=int, default=0, help="(load role)")
    p.add_argument("--streams", type=int, default=64)
    p.add_argument("--duration", type=float, default=20.0)
    p.add_argument("--n-buffer", type=int, default=1)
    p.add_argument("--beam", type=int, default=0)
    p.add_argument("--port", type=int, default=50199)
    p.add_argument("--blank-bias", type=float, default=0.0,
                   help="0 = saturated emission (decode upper bound), "
                        "6 = pure blank (lower bound)")
    p.add_argument("--bundle", default="",
                   help="serve this trained .tar.gz bundle instead of "
                        "the blank-biased random proxy")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    if a.role == "load":
        run_load_worker(a.port, a.count, a.duration, a.start_at, a.seed_base)
        return None
    from .. import resolve_device

    resolve_device(None)  # the server's card, or raise
    if a.role == "server":
        run_server(a.port, a.streams, a.n_buffer, a.beam, a.blank_bias,
                   a.bundle)
        return None
    result = _bench_inproc(a) if a.transport == "inproc" else _bench_grpc(a)
    print(json.dumps(result), flush=True)
    if result["n_errors"]:
        raise RuntimeError(f"bench_serving: {result['n_errors']} stream(s) "
                           f"failed: {result['errors']}")
    return result


if __name__ == "__main__":
    main()
