"""gRPC model server (the JAX package's serving/server.py).

One process per language (ports en:50051 de:50052 fr:50053). Every
streaming connection is a slot of one batched StreamingEngine, so all
live streams share one device step (one CUDA graph replay on the card);
the unary `Transcribe` runs `transcribe_batch`, or `transcribe_beam`
with `--beam` > 1 (kernel B, or C for an int8 bundle, on clips of 16 or
more stacked frames). `--use-lm` fuses the bundle's LM into both
(`--lm-alpha`, and `--lm-beta`, the insertion bonus of beam search).

    python -m libreasr_tpu_torch.serving.server --bundle model.tar.gz \
        [--beam 4 --use-lm --lm-alpha 0.2 --lm-beta 0.6]

The server runs on the card unless `--device cpu` is given; without a
card it raises.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from concurrent import futures

from .. import telemetry as tel
from ..utils import tensorize
from . import proto

LANG_PORTS = {"en": 50051, "de": 50052, "fr": 50053}

# the serving stages ASRServicer.timings reports, by the telemetry stage
# that times each
STAGES = {"preprocess": "server.preprocess",
          "transcribe": "server.transcribe",
          "stream_step": "stepper.step"}


class Timings:
    """Per-stage latency (mean ms and count) of the serving stages since
    this object was made, from the telemetry's stage totals: timed
    always, tracing or not, and left alone by `telemetry.reset()`."""

    def __init__(self):
        self._base = tel.stages()

    def snapshot(self) -> dict[str, dict]:
        now = tel.stages()
        out = {}
        for stage, name in STAGES.items():
            n0, s0 = self._base.get(name, (0, 0.0))
            n, s = now.get(name, (0, 0.0))
            if n > n0:
                out[stage] = {"avg_ms": 1e3 * (s - s0) / (n - n0),
                              "count": n - n0}
        return out


class StreamHandle:
    """One connection's view of a stream slot (slot id + generation).

    The generation guards against a stale pump thread acting on a slot
    after it was closed and reopened by a newer connection."""

    __slots__ = ("stepper", "slot", "gen")

    def __init__(self, stepper, slot, gen):
        self.stepper = stepper
        self.slot = slot
        self.gen = gen

    def submit(self, pcm):
        self.stepper._enqueue("pcm", self.slot, self.gen, pcm)

    def finish(self):
        self.stepper._enqueue("finish", self.slot, self.gen, None)

    def release(self):
        self.stepper._enqueue("close", self.slot, self.gen, None)

    def poll(self, timeout: float = 0.1):
        return self.stepper._poll(self.slot, timeout)


class BatchStepper:
    """Dedicated device-step thread: coalesces every connection's arrivals
    into shared batched engine steps.

    gRPC handler threads only append pcm to a staging queue and read
    per-slot delivery queues; they never touch the engine, so a slow
    step cannot head-of-line-block other connections' feeds, and N
    concurrent streams cost about one step per chunk interval. All
    engine access happens on this thread.

    Spans (while tracing is on): `stepper.queue_wait` (a pcm item's
    enqueue to its append into the engine), `stepper.dispatch`,
    `stepper.collect`, `stepper.deliver`, `stepper.step` (a wake-up that
    stepped: the `stream_step` stage, timed always) and `stepper.final`
    (a stream's finish to its tail's delivery); queue waits and finals
    carry the slot and generation."""

    def __init__(self, engine):
        self.engine = engine
        self.cv = threading.Condition()
        self._staging: list[tuple] = []
        self._delivery: list[list[str]] = [[] for _ in range(engine.n)]
        self._finished = [False] * engine.n
        self._gen = [0] * engine.n
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="asr-stepper", daemon=True
        )
        self._thread.start()

    def open(self) -> StreamHandle:
        with self.cv:
            slot = self.engine.open_slot()  # host-only bookkeeping
            self._gen[slot] += 1
            self._delivery[slot] = []
            self._finished[slot] = False
            return StreamHandle(self, slot, self._gen[slot])

    def shutdown(self):
        with self.cv:
            self._stop = True
            self.cv.notify_all()
        self._thread.join(timeout=5)

    # -- internal ----------------------------------------------------------

    def _enqueue(self, kind, slot, gen, payload):
        t = tel.now()
        with self.cv:
            self._staging.append((kind, slot, gen, payload, t))
            self.cv.notify_all()

    def _poll(self, slot, timeout):
        with self.cv:
            self.cv.wait_for(
                lambda: self._delivery[slot] or self._finished[slot],
                timeout,
            )
            text = "".join(self._delivery[slot])
            self._delivery[slot] = []
            return text, self._finished[slot]

    def _run(self):
        if os.environ.get("LIBREASR_STEP_SYNC"):
            return self._run_sync()
        return self._run_pipelined()

    def _append(self, live):
        for kind, slot, gen, pcm, t in live:
            if kind == "pcm":
                self.engine.append_samples(slot, pcm)
                tel.record("stepper.queue_wait", t, (slot, gen))

    def _finish(self, live, finished_now) -> bool:
        """This wake-up's finishes and closes, in order: a finish runs
        the final pad and steps and queues its tail. Returns whether one
        ran."""
        eng = self.engine
        stepped = False
        for kind, slot, gen, _, t in live:
            if kind == "finish":
                tail = eng.finish_slot(slot)
                stepped = True
                finished_now.append((slot, gen, tail, t))
            elif kind == "close":
                eng.close_slot(slot)
        return stepped

    def _deliver(self, finished_now):
        eng = self.engine
        with tel.span("stepper.deliver"), self.cv:
            for i in range(eng.n):
                t = eng.drain(i)
                if t:
                    self._delivery[i].append(t)
            for s, gen, tail, t_fin in finished_now:
                if tail:
                    self._delivery[s].append(tail)
                self._finished[s] = True
                tel.record("stepper.final", t_fin, (s, gen))
            self.cv.notify_all()

    def _collect(self, pending):
        with tel.span("stepper.collect"):
            self.engine.step_collect(pending)

    def _run_sync(self):
        """Synchronous step-per-wakeup (no pipeline, no pacing): an A/B
        lever for diagnosing the pipelined path; LIBREASR_STEP_SYNC=1."""
        eng = self.engine
        while True:
            with self.cv:
                self.cv.wait_for(lambda: self._staging or self._stop, 0.25)
                if self._stop:
                    return
                staging, self._staging = self._staging, []
            if not staging:
                continue
            live = [it for it in staging if it[2] == self._gen[it[1]]]
            self._append(live)
            t0 = time.perf_counter_ns()
            stepped = False
            while eng.step_ready():
                stepped = True
            finished_now = []
            stepped |= self._finish(live, finished_now)
            if stepped:
                tel.stage_since("stepper.step", t0)
            self._deliver(finished_now)

    def _dispatch(self):
        """A chained dispatch under backlog (>= 2 chunk-steps buffered
        anywhere, up to CHAIN_DEPTHS' cap), else a single step."""
        from ..models.streaming import CHAIN_DEPTHS

        eng = self.engine
        with tel.span("stepper.dispatch"):
            depth = eng.backlog_depth()
            if depth >= 2:
                kk = 2
                while kk * 2 <= min(depth, CHAIN_DEPTHS[-1]):
                    kk *= 2
                return eng.step_dispatch_chained(kk)
            return eng.step_dispatch()

    def _run_pipelined(self):
        eng = self.engine
        pending = None  # depth-1 step pipeline (StreamingEngine.step_dispatch)
        # dispatch pacing: without it the loop steps at its own (fast)
        # dispatch rate, each step coalescing only a few ms of arrivals.
        # Half a chunk interval keeps the added latency well under the
        # chunk cadence while about half the streams share every step.
        coalesce_s = eng.scfg.chunk_ms * eng.scfg.n_buffer / 2000.0
        next_dispatch = 0.0
        # chunks buffered but deferred by the pacing window: wake at the
        # deadline for them even if no further message arrives
        deferred = False
        while True:
            with self.cv:
                timeout = 0.25
                if pending is not None or deferred:
                    timeout = max(0.001, next_dispatch - time.perf_counter())
                self.cv.wait_for(lambda: self._staging or self._stop,
                                 min(timeout, 0.25))
                if self._stop:
                    return
                staging, self._staging = self._staging, []
            if not staging and pending is None and not deferred:
                continue
            # current-generation items only (per-slot order is kept: a
            # connection's pcm precedes its finish precedes its close)
            live = [it for it in staging if it[2] == self._gen[it[1]]]
            self._append(live)
            has_finish = any(it[0] in ("finish", "close") for it in live)
            t0 = time.perf_counter_ns()
            stepped = False
            if has_finish or time.perf_counter() >= next_dispatch:
                # dispatch step k+1 before collecting step k, so the
                # host's bookkeeping of k overlaps k+1's device work
                while (p := self._dispatch()) is not None:
                    stepped = True
                    if pending is not None:
                        self._collect(pending)
                    pending = p
                if stepped:
                    next_dispatch = time.perf_counter() + coalesce_s
            if pending is not None and (
                has_finish
                or (not stepped and time.perf_counter() >= next_dispatch)
            ):
                # collect before finish/close (ordering), or once the
                # pacing window passed with nothing new to overlap
                self._collect(pending)
                pending = None
            finished_now = []
            stepped |= self._finish(live, finished_now)
            # anything still buffered was deferred by pacing: the next
            # wait wakes at the pacing deadline to dispatch it
            deferred = bool(eng.ready_slots())
            if stepped:
                tel.stage_since("stepper.step", t0)
            self._deliver(finished_now)


class ASRServicer:
    """Implements ASR.ASR: unary Transcribe and TranscribeStream."""

    def __init__(self, bundle, engine=None, max_streams: int = 64,
                 beam_width: int = 0, use_lm: bool = False,
                 lm_alpha: float | None = None,
                 lm_beta: float | None = None):
        """beam_width > 1: the unary Transcribe runs beam search. An
        engine built here beams with beam_width, or else with the
        bundle's `stream.beam_width`, and fuses the LM when use_lm and
        the bundle has one. The fusion weights come from the arguments,
        else the bundle's `stream` block, else 0.1 / 0.0."""
        self.bundle = bundle
        self.beam_width = beam_width
        self.use_lm = use_lm
        sc = bundle.conf.get("stream", {}) or {}
        self.lm_alpha = sc.get("lm_alpha", 0.1) if lm_alpha is None else lm_alpha
        self.lm_beta = sc.get("lm_beta", 0.0) if lm_beta is None else lm_beta
        if engine is None:
            from ..models.streaming import StreamingConfig, StreamingEngine

            scfg = StreamingConfig(
                sr=bundle.frontend.sr,
                n_buffer=sc.get("n_buffer", 1),
                max_iters=sc.get("max_iters", 10),
                reset_thresh_ms=sc.get("reset_thresh", 4000),
                beam_width=beam_width or sc.get("beam_width", 0),
                lm_alpha=self.lm_alpha,
                # int16 PCM upload by default: half the host->device
                # bytes, lossless for 16-bit capture chains
                transfer_dtype=sc.get("transfer_dtype", "int16"),
            )
            engine = StreamingEngine(
                bundle, n_streams=sc.get("max_streams", max_streams), scfg=scfg,
                use_lm=use_lm and bundle.lm is not None)
        self.engine = engine
        self.timings = Timings()
        self.stepper = BatchStepper(engine)

    def _pcm(self, msg):
        """An Audio message's float32 pcm at the bundle's rate."""
        pcm = tensorize(msg.data)
        if msg.sr and msg.sr != self.bundle.frontend.sr:
            from ..data.audio import resample

            pcm = resample(pcm, msg.sr, self.bundle.frontend.sr)
        return pcm

    # -- unary -------------------------------------------------------------

    def Transcribe(self, request: proto.Audio, context=None) -> proto.Transcript:
        with tel.stage("server.preprocess"):
            pcm = self._pcm(request)
        with tel.stage("server.transcribe"):
            if self.beam_width > 1:
                text, _ = self.bundle.transcribe_beam(
                    pcm, beam_width=self.beam_width, use_lm=self.use_lm,
                    lm_alpha=self.lm_alpha, lm_beta=self.lm_beta)
            else:
                # greedy unary decodes without the LM, as in JAX (use_lm
                # reaches the unary call through beam search only)
                text, _ = self.bundle.transcribe(pcm)
        return proto.Transcript(data=text)

    # -- streaming -----------------------------------------------------------

    def TranscribeStream(self, request_iterator, context=None):
        """80 ms wire chunks in -> transcript fragments out. A pump thread
        drains the request iterator into the shared BatchStepper; this
        generator yields text as the stepper delivers it, including the
        end-of-stream flush (the final padded step, and in beam mode the
        best beam's uncommitted tail)."""
        try:
            handle = self.stepper.open()
        except RuntimeError:
            if context is not None:
                import grpc

                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              "no free stream slots")
            raise

        def pump():
            try:
                for msg in request_iterator:
                    handle.submit(self._pcm(msg))
            except Exception:
                pass  # the client went away: flush what arrived
            finally:
                handle.finish()

        threading.Thread(target=pump, daemon=True).start()
        try:
            while True:
                text, finished = handle.poll(timeout=0.1)
                if text:
                    yield proto.Transcript(data=text)
                elif finished:
                    break
        finally:
            handle.release()


def make_server(bundle, port: int, workers: int = 128, engine=None,
                beam_width: int = 0, use_lm: bool = False,
                lm_alpha: float | None = None, lm_beta: float | None = None):
    """A grpc server with hand-written method handlers (no generated
    stubs). Returns (server, servicer); the caller starts it."""
    import grpc

    servicer = ASRServicer(bundle, engine=engine, beam_width=beam_width,
                           use_lm=use_lm, lm_alpha=lm_alpha, lm_beta=lm_beta)
    handlers = {
        "Transcribe": grpc.unary_unary_rpc_method_handler(
            servicer.Transcribe,
            request_deserializer=proto.Audio.FromString,
            response_serializer=proto.Transcript.SerializeToString,
        ),
        "TranscribeStream": grpc.stream_stream_rpc_method_handler(
            servicer.TranscribeStream,
            request_deserializer=proto.Audio.FromString,
            response_serializer=proto.Transcript.SerializeToString,
        ),
    }
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=workers))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(proto.SERVICE, handlers),)
    )
    server.add_insecure_port(f"[::]:{port}")
    return server, servicer


def serve(lang: str = "en", port: int | None = None, config: str | None = None,
          bundle_path: str | None = None, beam: int = 0, use_lm: bool = False,
          lm_alpha: float | None = None, lm_beta: float | None = None,
          device=None):
    """Load a bundle (or a seeded random model of `config`) on `device`
    (None: cuda, raising without it), warm the stream step and serve."""
    from ..api import ASRBundle
    from ..config import parse_and_apply_config
    from ..models.streaming import CHAIN_DEPTHS

    if bundle_path:
        bundle = ASRBundle.from_bundle(bundle_path, lang_name=lang, device=device)
    else:
        conf = parse_and_apply_config(inference=True, lang=lang, path=config)
        bundle = ASRBundle.from_config(conf, lang_name=lang, device=device)
    port = port or LANG_PORTS.get(lang, 50051)
    server, servicer = make_server(bundle, port, beam_width=beam,
                                   use_lm=use_lm, lm_alpha=lm_alpha,
                                   lm_beta=lm_beta)
    servicer.engine.warmup(chain_depths=CHAIN_DEPTHS)
    server.start()
    print(f"[api-server] lang={lang} listening on :{port}"
          + (f" (beam={beam})" if beam > 1 else ""))
    server.wait_for_termination()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--lang", default="en")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--bundle", default=None, help="release tar.gz to serve")
    p.add_argument("--beam", type=int, default=0,
                   help="beam width of the unary Transcribe and of the "
                        "streaming engine (0: the bundle's stream.beam_width)")
    p.add_argument("--use-lm", action="store_true",
                   help="fuse the bundle's LM")
    p.add_argument("--lm-alpha", type=float, default=None,
                   help="LM fusion weight (default: the bundle's stream "
                        "block, else 0.1)")
    p.add_argument("--lm-beta", type=float, default=None,
                   help="token insertion bonus of beam+LM decoding")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)
    serve(a.lang, a.port, a.config, a.bundle, a.beam, a.use_lm,
          lm_alpha=a.lm_alpha, lm_beta=a.lm_beta, device=a.device)


if __name__ == "__main__":
    main()
