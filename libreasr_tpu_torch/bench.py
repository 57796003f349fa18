"""Benchmark: concurrent real-time streams per card (the JAX package's
bench.py).

Runs the flagship model (6-2-1024, vocab 2048 — the reference's english
model shape, config/base.yaml in bf16) through the batched streaming
engine on one card and measures how many 80 ms-cadence streams it
sustains in real time.

The reference serves 1 utterance per thread, 4 threads per CPU process
(api-server.py:16,139) and publishes no RTF numbers; the north star in
BASELINE.md is >= 64 real-time streams per device, so vs_baseline is
reported against 64.

Timing on the card: a step time is a host clock around steps that end
in one wait for the device (the engine's pipelined dispatch/collect, or
one chained pass of `StreamingEngine._launch`); a replay's device
time comes from CUDA events around k replays of the captured step.

    python -m libreasr_tpu_torch.bench

runs on the card and raises without one. Prints ONE JSON line last:
  {"metric": "realtime_streams_per_chip", "value": N, "unit": "streams",
   "vs_baseline": N/64, ..., "device": "<the card's name>"}
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden")

# The proxy's pinned blank-logit offset: calibrate_blank_bias's result
# for build_bundle's seeded weights (LIBREASR_BENCH_RECALIBRATE=1
# re-bisects). On an "NVIDIA H100 80GB HBM3, 700.00 W" the bisection
# lands on 0.21875 in every run, at 1.25 tokens a chunk against the
# golden BPE bundle's latched 0.4615. That rate is the bisection's own:
# its one engine carries the stream state from bias to bias. A fresh
# engine at this bias emits nothing (main reports that rate beside the
# headline as "proxy_fresh_rate"): the random model's emission rate
# follows its state, not the bias alone. The captured step runs all
# max_iters rounds masked at any bias; chip_smoke.py's bench phase
# times its replay at bias 0 and at this one and holds them equal.
BLANK_BIAS = 0.21875


def build_bundle(device=None):
    """Flagship-shaped bundle on `device` (None: the card; random weights
    from seed 0; the blank-logit bias is calibrated afterwards so the
    decode workload matches a *trained* model's token emission rate — see
    calibrate_blank_bias)."""
    from .api import ASRBundle
    from .config import DEFAULT_CONFIG, apply_overrides, open_config

    conf = open_config(DEFAULT_CONFIG)
    conf = apply_overrides(conf, ["inference"])
    conf["lm"]["enable"] = False
    conf["dtypes"]["compute"] = "bfloat16"
    return ASRBundle.from_config(conf, device=device)


def set_blank_bias(bundle, bias: float, base=None):
    """Set the joint's blank-logit bias to base + bias (base: the current
    value unless given), in place: a captured engine step reads the same
    tensor, so it decodes with the new bias without a new capture. The
    sum is taken in the bias's float32, as JAX's jnp scalar sum."""
    b = bundle.model.joint.out.bias
    with torch.no_grad():
        b0 = b[0].clone() if base is None else torch.as_tensor(
            base, dtype=b.dtype, device=b.device)
        b[0] = b0 + bias


def golden_emission_rate(device=None) -> float:
    """Tokens emitted per 80 ms chunk by the committed *trained* bundle
    (tests/fixtures/golden/model_bpe.tar.gz) transcribing its own
    utterances through the streaming engine on `device` (None: the card)
    — the reference decode workload the flagship proxy is calibrated to
    (random weights emit either nothing or max_iters per frame depending
    on the blank bias; a trained model sits between)."""
    from .api import ASRBundle
    from .data.audio import read_audio
    from .models.streaming import StreamingEngine

    with tempfile.TemporaryDirectory() as tmp:
        bundle = ASRBundle.from_bundle(
            os.path.join(GOLDEN, "model_bpe.tar.gz"), extract_to=tmp,
            device=device)
        eng = StreamingEngine(bundle, n_streams=8)
        chunk = eng.scfg.chunk_samples
        n_chunks = 16000 // chunk + 1  # + flush chunk for the frontend carry
        audio = np.zeros((8, n_chunks * chunk), np.float32)
        for i in range(8):
            pcm, _ = read_audio(os.path.join(GOLDEN, f"s-{i:03d}.wav"))
            audio[i, : pcm.shape[1]] = pcm[0]
        return latched_rate(eng, audio)


def latched_rate(eng, audio: np.ndarray) -> float:
    """Tokens per 80 ms chunk a stream actually DELIVERS: feed() applies
    the EOS latch, so post-EOS drift tokens a raw step_batch would count
    (~6x inflation on the golden clip set) are excluded. Both sides of
    the trained-bundle gate must use THIS basis — comparing a raw
    step_batch rate against a latched floor is ~6x too lenient."""
    slots = [eng.open_slot() for _ in range(audio.shape[0])]
    chunk = eng.scfg.chunk_samples
    n_chunks = audio.shape[1] // chunk
    for c in range(n_chunks):
        for i, s in enumerate(slots):
            eng.feed(s, audio[i, c * chunk : (c + 1) * chunk])
    total = sum(len(eng.emitted[s]) for s in slots)
    return total / float(len(slots) * n_chunks)


def measure_rate(eng, bundle, n: int, steps: int = 8, workload=None) -> float:
    """Tokens/chunk through the engine (noise input unless a workload —
    e.g. tone-speech for a trained bundle — is given)."""
    rng = np.random.default_rng(0)
    w = workload if workload is not None else rng.standard_normal(
        (n, eng.scfg.n_buffer, eng.scfg.chunk_samples)
    ).astype(np.float32) * 0.1
    eng.step_batch(w)  # settle after reset
    total = 0
    for _ in range(steps):
        _, lens = eng.step_batch(w)
        total += int(np.sum(lens))
    return total / float(n * steps * eng.scfg.n_buffer)


def calibrate_blank_bias(bundle, target_rate: float, n: int = 16):
    """Bisect the blank-logit offset until the proxy's emission rate on
    noise matches the trained bundle's rate (random weights with a
    hand-picked bias swing the decode inner-loop cost; tying the rate to
    a trained model pins the workload). Returns (bias, rate) and leaves
    the bundle at that bias."""
    from .models.streaming import StreamingEngine

    eng = StreamingEngine(bundle, n_streams=n)
    base = bundle.model.joint.out.bias[0].clone()
    lo, hi = 0.0, 8.0  # lo: floods tokens, hi: pure blank
    # a random joint's emission rate is nearly a step function of the
    # bias, so bisection may never land near the target; keep the
    # best candidate AT OR ABOVE it (the decode workload must not be
    # lighter than a trained model's)
    best = (0.0, measure_rate(eng, bundle, n))  # bias 0 floods: >= target
    for _ in range(9):
        mid = 0.5 * (lo + hi)
        set_blank_bias(bundle, mid, base=base)
        rate = measure_rate(eng, bundle, n)
        if rate >= target_rate:
            lo = mid
            if rate < best[1]:
                best = (mid, rate)
        else:
            hi = mid
        if abs(rate - target_rate) < 0.05:
            break
    set_blank_bias(bundle, best[0], base=base)
    return best


def _need_card(eng):
    """Device timings exist only on the card: an engine off it (no CUDA
    graph) raises instead of timing the eager step."""
    if eng.device.type != "cuda":
        raise RuntimeError("libreasr_tpu_torch.bench: device timings need "
                           "the engine's CUDA graph (a bundle on cuda)")


def device_step_time(bundle, n_streams: int, n_buffer: int = 1, k: int = 8) -> float:
    """Device seconds per engine step: CUDA events around k replays of
    the captured step (all streams valid, on noise chunks loaded by one
    step before), the median of 3 such runs. Excludes the host's staging
    and collection, which time_engine includes."""
    from .models.streaming import StreamingConfig, StreamingEngine

    scfg = StreamingConfig(sr=bundle.frontend.sr, n_buffer=n_buffer)
    eng = StreamingEngine(bundle, n_streams=n_streams, scfg=scfg)
    _need_card(eng)
    rng = np.random.default_rng(0)
    chunks = rng.standard_normal(
        (n_streams, scfg.n_buffer, scfg.chunk_samples)
    ).astype(np.float32) * 0.1
    eng.step_batch(chunks)  # loads the inputs; warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        start.record()
        eng.replay_captured(k)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k / 1e3)
    return float(np.median(times))


def device_resident_rate(bundle, n_streams: int, n_buffer: int = 1,
                         steps: int = 24, workload: np.ndarray | None = None,
                         repeats: int = 3):
    """Real-time streams the card sustains on a staged workload: the PCM
    for `steps` engine steps is encoded once into one of the engine's
    staging buffers (pinned host memory, the wire dtype) before the timed
    region; each repeat is ONE chained pass over it
    (`StreamingEngine._launch`: `steps` graph replays enqueued, each
    with its input copy and output copy, then one wait). Returns (audio
    seconds over wall seconds, the median of `repeats` passes after a
    warm one; the spread across them in %).

    workload: [steps, n, nb, chunk] pcm, or None for noise."""
    from .models.streaming import StreamingConfig, StreamingEngine

    scfg = StreamingConfig(sr=bundle.frontend.sr, n_buffer=n_buffer)
    eng = StreamingEngine(bundle, n_streams=n_streams, scfg=scfg)
    _need_card(eng)
    if workload is None:
        rng = np.random.default_rng(0)
        workload = rng.standard_normal(
            (steps, n_streams, n_buffer, scfg.chunk_samples)
        ).astype(np.float32) * 0.1
    # the stage is free again once a pass's outputs were read, and no
    # other dispatch writes into it
    st = eng._stage(steps)
    st.wire[:steps] = eng._encode_chunks(workload)
    valid = np.ones((steps, n_streams), bool)
    reset = np.zeros((steps, n_streams), bool)
    eng._launch(steps, st, valid, reset).numpy()  # warm
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        eng._launch(steps, st, valid, reset).numpy()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    spread = (max(walls) - min(walls)) / max(walls) * 100.0
    audio_s = n_streams * n_buffer * steps * scfg.chunk_samples / scfg.sr
    return audio_s / wall, float(spread)


def tone_workload(n_streams: int, n_buffer: int, chunk: int,
                  steps: int = 1) -> np.ndarray:
    """Tone-speech chunks (data/synth.py synthesis) — the decode workload
    for a TRAINED bundle: real emissions at the model's natural rate
    instead of noise-driven blanks.

    steps=1: one engine step [n, nb, chunk] (wire sweep feeds the same
    chunks every step). steps>1: [steps, n, nb, chunk] of CONTINUOUS
    per-stream audio for the device-resident run — each step advances
    through the utterance, so the decoder sees a real time series."""
    from .data.synth import WORDS, render

    rng = np.random.default_rng(1)
    need = steps * n_buffer * chunk
    out = np.zeros((n_streams, steps, n_buffer, chunk), np.float32)
    for i in range(n_streams):
        text = " ".join(
            WORDS[int(rng.integers(len(WORDS)))] for _ in range(6)
        )
        pcm = render(text, rng)
        reps = int(np.ceil(need / len(pcm)))
        out[i] = np.tile(pcm, reps)[:need].reshape(steps, n_buffer, chunk)
    out = out.transpose(1, 0, 2, 3)
    return out[0] if steps == 1 else out


def _make_engine(bundle, n_streams: int, n_buffer: int, beam_width: int = 0,
                 cache: dict | None = None):
    """Build (or fetch) an engine with the bench transfer codec (int16).
    Engines are cached across sweep passes so pass 2+ re-measures the
    SAME captured step."""
    from .models.streaming import StreamingConfig, StreamingEngine

    key = (n_streams, n_buffer, beam_width)
    if cache is not None and key in cache:
        return cache[key]
    scfg = StreamingConfig(
        sr=bundle.frontend.sr, n_buffer=n_buffer, beam_width=beam_width,
        transfer_dtype="int16",
    )
    eng = StreamingEngine(bundle, n_streams=n_streams, scfg=scfg,
                          use_lm=beam_width > 1 and bundle.lm is not None)
    if cache is not None:
        cache[key] = eng
    return eng


def time_engine(bundle, n_streams: int, iters: int = 12, n_buffer: int = 1,
                workload: np.ndarray | None = None, beam_width: int = 0,
                cache: dict | None = None) -> float:
    """Sustained wall seconds per batched stream step (n_buffer 80 ms
    chunks per stream), measured PIPELINED at depth 2: step i+1 is
    dispatched before step i's outputs are collected — the serving
    stepper's dispatch/collect overlap — so the host's staging of one
    step overlaps the device's work on the one before. The best of 2
    runs of `iters` steps, each closed by the wait for its last step."""
    eng = _make_engine(bundle, n_streams, n_buffer, beam_width, cache)
    rng = np.random.default_rng(0)
    if workload is not None:
        w = workload
    else:
        w = rng.standard_normal(
            (n_streams, eng.scfg.n_buffer, eng.scfg.chunk_samples)
        ).astype(np.float32) * 0.1
    for _ in range(3):  # warm up
        eng.step_batch(w)
    best = None
    for _ in range(2):
        prev = None
        t0 = time.perf_counter()
        for _ in range(iters):
            out = eng._step_device(w)
            if prev is not None:
                prev.numpy()  # collect step i-1 (waits until it is done)
            prev = out
        prev.numpy()
        dt = (time.perf_counter() - t0) / iters
        best = dt if best is None else min(best, dt)
    return float(best)


def beam_sweep(bundle, trained: bool, chunk_s: float, passes: int = 2,
               n_streams: int = 128) -> float:
    """Streaming beam-4 + LM shallow fusion throughput at one
    representative config (n=128, nb=2). Returns the best sustained
    real-time streams."""
    beam_bundle = bundle
    if not trained:
        # give the proxy an LM so the beam number includes shallow-
        # fusion compute (random weights: right FLOPs, right shapes),
        # beside the calibrated joint
        from .api import ASRBundle
        from .config import DEFAULT_CONFIG, apply_overrides, open_config
        from .models.lm import LM, LMConfig

        conf = open_config(DEFAULT_CONFIG)
        conf = apply_overrides(conf, ["inference"])
        conf["lm"]["path"] = "<random-bench-lm>"
        conf["dtypes"]["compute"] = "bfloat16"
        lm = LM(LMConfig.from_config(conf), seed=1, device=bundle.device)
        beam_bundle = ASRBundle(conf, bundle.model, bundle.lang,
                                bundle.device, lm)
    cache: dict = {}
    ts = []
    wk = (
        tone_workload(n_streams, 2, int(chunk_s * bundle.frontend.sr))
        if trained else None
    )
    for _ in range(passes):
        ts.append(time_engine(beam_bundle, n_streams, n_buffer=2,
                              workload=wk, beam_width=4, cache=cache))
    sustained = n_streams * chunk_s * 2 / min(ts)
    lm_on = beam_bundle.lm is not None
    print(
        f"# beam4{'+lm' if lm_on else ''} n={n_streams} nb=2: step "
        f"{min(ts)*1000:.1f} ms -> {sustained:.0f} realtime streams",
        file=sys.stderr,
    )
    return sustained


TRAINED_CANDIDATES = (
    "tmp/flagship_stream/model.tar.gz",
    "tmp/flagship_tone/model.tar.gz",
    "assets/flagship_tone_int8.tar.gz",
)


def _trained_path():
    """(the trained flagship bundle to bench, or None; LIBREASR_BENCH_
    BUNDLE). A bundle named by the variable must exist: the result line
    would otherwise misattribute the run to the proxy."""
    env_path = os.environ.get("LIBREASR_BENCH_BUNDLE")
    if env_path:
        if not os.path.exists(env_path):
            raise FileNotFoundError(
                f"LIBREASR_BENCH_BUNDLE={env_path} does not exist")
        return env_path, env_path
    found = [c for c in TRAINED_CANDIDATES if os.path.exists(c)]
    return (found[0] if found else None), None


def _trained_bundle(trained_path: str, env_path: str | None, extract_to: str,
                    device=None):
    """Load a trained bundle on `device` (None: the card) and gate it on
    its tone-speech emission rate reaching half the golden bundle's (both
    EOS-latched feed() rates). Returns (bundle, whether it is used, its
    rate, the floor)."""
    from .api import ASRBundle
    from .data.synth import WORDS, render
    from .models.streaming import StreamingEngine

    # the tokenizer stays in `extract_to` while the bundle serves
    bundle = ASRBundle.from_bundle(trained_path, extract_to=extract_to,
                                   device=device)
    # a mid-training (blank-collapsed) checkpoint emits almost nothing,
    # making the decode inner loop unrealistically light. An explicitly
    # requested bundle (env var) is used regardless, with the rate
    # printed so the run is attributable.
    eng = StreamingEngine(bundle, n_streams=8)
    chunk = eng.scfg.chunk_samples
    trng = np.random.default_rng(1)
    utts = [
        render(" ".join(WORDS[int(trng.integers(len(WORDS)))]
                        for _ in range(6)), trng)
        for _ in range(8)
    ]
    n_chunks = max(len(u) for u in utts) // chunk + 2
    audio = np.zeros((8, n_chunks * chunk), np.float32)
    for i, u in enumerate(utts):
        audio[i, : len(u)] = u
    rate = latched_rate(eng, audio)
    del eng
    floor = 0.5 * golden_emission_rate(device)
    print(f"# trained bundle tone-speech emission rate {rate:.2f} "
          f"tok/chunk (floor {floor:.2f})", file=sys.stderr)
    if rate < floor and not env_path:
        print("# trained bundle under-emits (mid-training checkpoint?)"
              " — falling back to the calibrated proxy", file=sys.stderr)
        return bundle, False, rate, floor
    print(f"# benching TRAINED flagship bundle {trained_path} on "
          f"tone-speech audio (no proxy calibration)", file=sys.stderr)
    return bundle, True, rate, floor


def main():
    from . import flops as FL
    from . import resolve_device
    from .models.streaming import StreamingEngine

    # a TRAINED flagship bundle (LIBREASR_BENCH_BUNDLE, else the first of
    # TRAINED_CANDIDATES present) replaces the calibrated random-weight
    # proxy: real weights, real emissions on matching (tone-speech) audio
    trained_path, env_path = _trained_path()
    resolve_device(None)  # the card, or raise
    device_name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    chunk_s = 0.080
    candidates = [64, 128, 256, 512]

    # the trained bundle's tokenizer lives here until main returns
    extract = tempfile.TemporaryDirectory()
    trained = False
    if trained_path:
        bundle, trained, _, _ = _trained_bundle(trained_path, env_path,
                                                extract.name)
    proxy_fresh_rate = golden_rate = None
    if not trained:
        bundle = build_bundle()
        golden_rate = golden_emission_rate()
        if os.environ.get("LIBREASR_BENCH_RECALIBRATE") == "1":
            # pin the decode workload to a trained model's emission rate
            bias, rate = calibrate_blank_bias(bundle, golden_rate)
            print(
                f"# trained-bundle emission rate {golden_rate:.4f} tok/chunk; "
                f"flagship proxy calibrated to {rate:.4f} at "
                f"blank_bias {bias:.4f}",
                file=sys.stderr,
            )
        else:
            # PINNED workload: a per-run bisection against a near-step-
            # function response would let the proxy's load drift between
            # runs. BLANK_BIAS is the bisection's result for the port's
            # seeded weights (its comment gives the rates);
            # LIBREASR_BENCH_RECALIBRATE=1 re-bisects.
            set_blank_bias(bundle, BLANK_BIAS)
            print(f"# flagship proxy at PINNED blank_bias {BLANK_BIAS} "
                  "(LIBREASR_BENCH_RECALIBRATE=1 to re-bisect)",
                  file=sys.stderr)
        # the rate a fresh engine emits at the bias the sweep runs at,
        # beside the golden bundle's: the bisection's own rate is its
        # engine's history (see BLANK_BIAS)
        proxy_fresh_rate = measure_rate(StreamingEngine(bundle, n_streams=16),
                                        bundle, 16)
        print(f"# a fresh engine at this bias emits {proxy_fresh_rate:.4f} "
              f"tok/chunk (golden latched {golden_rate:.4f})", file=sys.stderr)

    # the sweep runs PASSES full passes over every config (engines — and
    # their captured steps — cached across passes) and keeps the best
    # per config; the spread across passes is reported alongside
    PASSES = 3
    cache: dict = {}
    results: dict = {}
    for p in range(PASSES):
        for n_buffer in (1, 2):
            budget = chunk_s * n_buffer
            for n in candidates:
                wk = (
                    tone_workload(n, n_buffer, int(chunk_s * bundle.frontend.sr))
                    if trained else None
                )
                try:
                    t = time_engine(bundle, n, n_buffer=n_buffer,
                                    workload=wk, cache=cache)
                except torch.cuda.OutOfMemoryError as e:
                    print(f"# n={n} nb={n_buffer} out of memory: {e}",
                          file=sys.stderr)
                    break
                results.setdefault((n, n_buffer), []).append(t)
                if t > budget * 4:  # far past real time, stop sweeping
                    break
    best = 0.0
    spread_pct = 0.0
    for (n, n_buffer), ts in sorted(results.items(), key=lambda kv: kv[0][::-1]):
        budget = chunk_s * n_buffer
        t = min(ts)
        sustained = n * budget / t
        sp = (max(ts) - min(ts)) / max(ts) * 100.0
        print(
            f"# n={n} nb={n_buffer}: step {t*1000:.2f} ms -> "
            f"{sustained:.0f} realtime streams "
            f"(pass spread {sp:.0f}%)",
            file=sys.stderr,
        )
        if sustained > best:
            best, spread_pct = sustained, sp
    del cache

    # staged throughput: the PCM of 24 steps staged once, then one
    # chained pass of replays closed by one wait. This is the headline;
    # the pipelined sweep above (the serving stepper's protocol, host
    # staging included) is reported alongside with its spread.
    dev_best, dev_spread, dev_cfg = 0.0, 0.0, None
    for n_buffer in (1, 2):
        for n in (256, 512):
            wk = (
                tone_workload(n, n_buffer, int(chunk_s * bundle.frontend.sr),
                              steps=24)
                if trained else None
            )
            rate, sp = device_resident_rate(bundle, n, n_buffer=n_buffer,
                                            workload=wk)
            print(
                f"# device-resident n={n} nb={n_buffer}: "
                f"{rate:.0f} realtime streams (spread {sp:.1f}%)",
                file=sys.stderr,
            )
            if rate > dev_best:
                dev_best, dev_spread, dev_cfg = rate, sp, (n, n_buffer)

    # streaming BEAM search + LM: its own streams-per-card number.
    # Skipped near the wall budget (the greedy headline must never be
    # sacrificed to a beam capture).
    budget_s = float(os.environ.get("LIBREASR_BENCH_BUDGET_S", "1800"))
    if time.perf_counter() - t_start > budget_s * 0.6:
        print("# beam sweep skipped: near wall budget", file=sys.stderr)
        beam_best = 0.0
    else:
        beam_best = beam_sweep(bundle, trained, chunk_s, passes=2)

    # diagnostic: device-only step time at a representative config — the
    # gap to the pipelined sweep is the host's staging and collection —
    # plus its MFU (model FLOPs over the card's bf16 peak; decode is
    # latency/bandwidth-bound at these batch shapes, so a low MFU is
    # expected and streams per card is the capability metric)
    from .models.streaming import StreamingConfig

    dt = device_step_time(bundle, 256, n_buffer=1)
    dstep_ms = round(dt * 1000, 3)
    chunk = int(chunk_s * bundle.frontend.sr)
    fl = FL.decode_step_flops(bundle.cfg, bundle.frontend, 256, 1, chunk,
                              iters_per_frame=2.0)
    dev_mfu = FL.mfu(fl, dt)
    max_iters = StreamingConfig().max_iters
    fl_run = FL.decode_step_flops(bundle.cfg, bundle.frontend, 256, 1, chunk,
                                  iters_per_frame=float(max_iters))
    print(
        f"# device-only step @ n=256 nb=1: {dt*1000:.3f} ms "
        f"(projection: {256 * chunk_s / dt:.0f} streams, {dev_mfu} at 2 "
        f"evaluations a frame)",
        file=sys.stderr,
    )
    print(
        f"# the captured step runs max_iters={max_iters} predictor+joint "
        f"rounds a frame, all masked: {FL.mfu(fl_run, dt)} at "
        f"{max_iters} evaluations a frame",
        file=sys.stderr,
    )

    headline = dev_best if dev_best > 0 else best
    result = {
        "metric": "realtime_streams_per_chip",
        "value": round(headline, 1),
        "unit": "streams",
        "vs_baseline": round(headline / 64.0, 3),
        # which protocol produced this number — the two are not
        # directly comparable (trained bundle decodes tone speech at
        # its natural rate; the proxy decodes noise at the bisection's
        # blank bias, and a fresh engine's rate there is
        # proxy_fresh_rate, beside the golden bundle's)
        "workload": "trained-bundle" if trained else "calibrated-proxy",
        "proxy_fresh_rate": proxy_fresh_rate,
        "golden_rate": golden_rate,
        "protocol": "device-resident" if dev_best > 0 else "wire",
        "device_resident_streams": round(dev_best, 1),
        "device_resident_spread_pct": round(dev_spread, 1),
        "device_resident_cfg": dev_cfg,
        "wire_streams": round(best, 1),
        "passes": PASSES,
        "wire_pass_spread_pct": round(spread_pct, 1),
        "beam4_streams": round(beam_best, 1),
        "device_step_ms": dstep_ms,
        "device_step_mfu_pct": round(dev_mfu.mfu * 100, 3),
        "device": device_name,
    }
    print(json.dumps(result))
    extract.cleanup()
    return result


if __name__ == "__main__":
    main()
