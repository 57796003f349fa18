"""Backlog traffic through the port's StreamingEngine: every slot always
has audio buffered ahead, so the engine steps as fast as it can and the
window measures its capacity in real-time streams.

Each slot plays seeded utterances back to back. An utterance's audio is
appended ahead of the engine (`append_samples`) whenever the slot's
buffer falls under `buffer_steps[0]` steps, up to `buffer_steps[1]`;
when it has all been stepped and collected the slot is finished, closed
and opened again for the next one (`finish_slot`, `close_slot`,
`open_slot`). Dispatch follows the serving stepper's rule
(`BatchStepper`): a chain of the largest power of two up to the cap
that the deepest backlog holds (`step_dispatch_chained`), else one step
(`step_dispatch`); one dispatch is in flight while the host collects
the one before (`step_collect`). This traffic drives the engine through
its public methods only: it keeps each slot's buffered samples and its
steps in flight from what it appended and what each dispatch took.

Utterance lengths are a fixed pool, played in the seed's order, so
that every seed does the same work; the words and pauses come from the
seed. The first utterance of every slot is drawn from the pool of
residual lengths, so that slots finish at staggered times from the
start.

Spans: "append", "dispatch", "collect", "churn" around those calls,
host work only; "wait" where the host blocks on the card: for the
dispatch in flight before its collect, and, in beam mode, for the chain
in flight before a close flushes the beam (`flush_slot` reads the state
on the host). The spans count from the window's start.
Counters: steps (engine sub-steps, every slot), slot_steps (valid
slot-steps), frames decoded, tokens, utterances finished.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark import audio as A
from benchmark import weights as W
from benchmark.reference.check import Judge, Served, split_served


def build_bundle(conf: dict, leaves: dict, device):
    """The program's bundle at the configuration, with the benchmark's
    weights copied into its model (and LM)."""
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.data.language import get_language
    from libreasr_tpu_torch.models.lm import LM, LMConfig
    from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig

    model = Transducer(TransducerConfig.from_config(conf), device=device)
    W.load_into(model, leaves, "model")
    lm = None
    if (conf.get("lm") or {}).get("enable"):
        lm = LM(LMConfig.from_config(conf), device=device)
        W.load_into(lm, leaves, "lm")
    lang, _ = get_language()
    return ASRBundle(conf, model, lang, device, lm)


# what a compared number reads when there was nothing to compare
NOTHING = 1e9


class Traffic:
    def __init__(self, bench, params: dict):
        self.b = bench
        self.p = params
        self.dec = bench.config["decoding"]
        self.spans = bench.spans

    # ---- set-up ---------------------------------------------------------

    def setup(self) -> None:
        from libreasr_tpu_torch.models.streaming import (
            CHAIN_DEPTHS, StreamingConfig, StreamingEngine)

        b, p = self.b, self.p
        conf = b.config["conf"]
        self.bundle = build_bundle(conf, b.leaves, b.device)
        b.mark("bundle")
        self.scfg = StreamingConfig(
            sr=conf["sr"], n_buffer=p["n_buffer"],
            max_iters=self.dec["max_iters"],
            beam_width=self.dec["beam_width"], lm_alpha=self.dec["lm_alpha"],
            transfer_dtype=p["transfer_dtype"])
        self.eng = StreamingEngine(self.bundle, n_streams=p["streams"],
                                   scfg=self.scfg, use_lm=self.dec["use_lm"])
        self.eng.warmup(chain_depths=CHAIN_DEPTHS)
        self.chain_cap = CHAIN_DEPTHS[-1]
        b.mark("engine")
        n = p["streams"]
        self.step_samples = self.scfg.chunk_samples * p["n_buffer"]
        step_s = self.step_samples / conf["sr"]
        lo, hi = (int(round(s / step_s)) for s in p["utt_s"])
        rng = np.random.default_rng([b.seed, 1])
        pool = A.length_pool(p["pool"], lo, hi)
        self.lengths = pool[rng.permutation(len(pool))]
        first = A.length_pool(n, 1, hi)
        self.first = first[rng.permutation(n)]
        self.rng = np.random.default_rng([b.seed, 2])
        self.bank = A.AudioBank(b.seed)
        self.n_utt = 0
        self.pcm = [None] * n        # the slot's current utterance
        self.sent = np.zeros(n, np.int64)     # samples appended of it
        self.total = np.zeros(n, np.int64)    # its length
        self.meta = [None] * n       # (spec, first slot-step)
        self.slot_steps = np.zeros(n, np.int64)
        self.first_step = np.zeros(n, np.int64)  # slot-step its utterance began
        self.inflight = np.zeros(n, bool)  # sub-steps dispatched, not collected
        self.cuda = b.device.type == "cuda"
        self.records = []            # per collect: (tokens, lens, valid)
        self.closed = []             # (spec, slot, first, last slot-step, ids)
        self.counters = dict(steps=0, slot_steps=0, tokens=0, dispatches=0)
        self.pending = None
        for _ in range(n):
            self._open(self.eng.open_slot(), first=True)
        # warm the loop's every path (chains, collects, finishes and
        # reopens, the beam's flush) and let the slots' turnover settle
        # before the window: the shortest first utterances end within a
        # few dispatches
        t_end = time.perf_counter() + self.p["warm_s"]
        while time.perf_counter() < t_end or len(self.closed) < 2:
            self._iteration()
        self._drain()
        if self.cuda:
            torch.cuda.synchronize()
        b.mark("warm_loop")

    def _open(self, slot: int, first: bool = False) -> None:
        steps = int(self.first[slot] if first else
                    self.lengths[self.n_utt % len(self.lengths)])
        if not first:
            self.n_utt += 1
        spec = A.utterance(self.rng, self.bank, steps * self.step_samples,
                           tuple(self.p["pause_s"]))
        self.pcm[slot] = self.bank.render(spec)
        self.total[slot] = len(self.pcm[slot])
        self.sent[slot] = 0
        self.first_step[slot] = self.slot_steps[slot]
        self.meta[slot] = (spec, int(self.slot_steps[slot]))

    def _close_and_reopen(self, slot: int) -> None:
        eng = self.eng
        eng.finish_slot(slot)
        spec, first = self.meta[slot]
        self.closed.append((spec, slot, first, int(self.slot_steps[slot]),
                            list(map(int, eng.emitted[slot])), self.in_window))
        eng.drain(slot)
        eng.close_slot(slot)
        again = eng.open_slot()
        self._open(again)

    # ---- the loop --------------------------------------------------------

    in_window = False

    def _collect(self, pend) -> None:
        self.eng.step_collect(pend)
        out, valid, _ = pend
        packed = out.numpy()
        if valid.ndim == 1:
            valid = valid[None]
        width = self.dec["max_iters"] * self.p["n_buffer"] if not \
            self.scfg.beam_width > 1 else packed.shape[2] - 1
        lens = packed[..., -1]
        self.records.append((packed[..., :width].copy(), lens.copy(),
                             valid.copy()))
        if self.in_window:
            c = self.counters
            c["steps"] += valid.shape[0]
            c["slot_steps"] += int(valid.sum())
            c["tokens"] += int(lens[valid].sum())

    def _drain(self) -> None:
        if self.pending is not None:
            self._collect(self.pending[0])
            self.pending = None

    def _fill(self) -> np.ndarray:
        """Samples each slot holds buffered in the engine: what was
        appended of its utterance less what its dispatched steps took."""
        return self.sent - (self.slot_steps - self.first_step) * self.step_samples

    def _dispatch(self):
        """The serving stepper's rule: a chain under backlog (>= 2
        chunk-steps buffered in some slot), of the largest power of two
        the deepest backlog holds, up to the cap; else one step."""
        eng = self.eng
        depth = eng.backlog_depth()
        if depth >= 2:
            k = 2
            while k * 2 <= min(depth, self.chain_cap):
                k *= 2
            return eng.step_dispatch_chained(k)
        return eng.step_dispatch()

    def _iteration(self) -> None:
        eng, sp = self.eng, self.spans
        lo, hi = (k * self.step_samples for k in self.p["buffer_steps"])
        with sp("append"):
            fill = self._fill()
            for i in np.nonzero(fill < lo)[0]:
                pcm, s = self.pcm[i], self.sent[i]
                k = min(len(pcm) - s, hi - fill[i])
                if k > 0:
                    eng.append_samples(i, pcm[s:s + k])
                    self.sent[i] = s + k
        with sp("dispatch"):
            p = self._dispatch()
            ev = None
            if p is not None and self.cuda:
                # marks the end of the work just enqueued
                ev = torch.cuda.Event()
                ev.record()
        if p is not None:
            v = p[1]
            self.slot_steps += v.sum(0) if v.ndim == 2 else v
            if self.in_window:
                self.counters["dispatches"] += 1
        if self.pending is not None and self.pending[1] is not None:
            with sp("wait"):
                self.pending[1].synchronize()
        with sp("collect"):
            self._drain()
        self.pending = None if p is None else (p, ev)
        self.inflight = (np.zeros(len(self.sent), bool) if p is None
                         else p[1].reshape(-1, len(self.sent)).any(0))
        with sp("churn"):
            done = np.nonzero((self.sent == self.total) & (self._fill() == 0)
                              & ~self.inflight)[0]
        if len(done) and self.scfg.beam_width > 1 and self.cuda:
            with sp("wait"):
                torch.cuda.current_stream().synchronize()
        with sp("churn"):
            for i in done:
                self._close_and_reopen(int(i))

    def window(self, seconds: float, tracer=None) -> dict:
        eng = self.eng
        self.in_window = True
        n_closed0 = len(self.closed)
        r0, s0 = eng.replays, eng.steps
        self.spans.total.clear()
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            self._iteration()
            now = time.perf_counter()
            if tracer is not None:
                tracer.poll(now, {"replays": eng.replays})
            if now >= end:
                break
        self._drain()
        if tracer is not None:
            tracer.stop({"replays": eng.replays})
        t1 = time.perf_counter()
        self.in_window = False
        c = self.counters
        c["replays"] = eng.replays - r0
        c["engine_steps"] = eng.steps - s0
        c["finished"] = len(self.closed) - n_closed0
        # a traced run leaves out the time spent starting and stopping the
        # profiler
        c["window_s"] = t1 - t0 - (tracer.overhead_s if tracer is not None else 0.0)
        audio_s = c["slot_steps"] * self.step_samples / self.b.config["conf"]["sr"]
        c["audio_s"] = audio_s
        c["frames"] = c["slot_steps"] * self.p["n_buffer"]
        c["tokens_per_chunk"] = c["tokens"] / max(c["frames"], 1)
        cfg = self.b.config
        print(f"# emission: {c['tokens_per_chunk']:.4f} tokens a chunk over "
              f"{c['frames']} chunks (blank bias {cfg['blank_bias']}; pinned "
              f"rate {cfg.get('emission_rate')}, golden {cfg.get('golden_rate')})",
              file=sys.stderr)
        return {"rt_streams": audio_s / c["window_s"]}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.eng = self.bundle = None
        gc.collect()
        if self.b.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check -------------------------------------------------------

    def sample(self) -> list:
        """Utterances finished in the window, drawn from the seed: the
        longest, then others until `sample_utts`."""
        done = [c for c in self.closed if c[5]]
        if not done:
            return []
        rng = np.random.default_rng([self.b.seed, 3])
        longest = max(range(len(done)), key=lambda i: done[i][0].samples)
        rest = [i for i in rng.permutation(len(done)) if i != longest]
        pick = [longest] + rest[: self.p["sample_utts"] - 1]
        return [done[i] for i in pick]

    def served(self, picked) -> list[Served]:
        """The picked utterances' audio and each step's raw tokens, from
        the records of every collect."""
        want = {}
        for j, (spec, slot, first, last, ids, _) in enumerate(picked):
            want.setdefault(slot, []).append((first, last, j))
        steps = [[] for _ in picked]
        count = dict.fromkeys(want, 0)
        for toks, lens, valid in self.records:
            for j in range(valid.shape[0]):
                for slot in want:
                    if valid[j, slot]:
                        k = count[slot]
                        for first, last, u in want[slot]:
                            if first <= k < last:
                                steps[u].append(toks[j, slot, : lens[j, slot]].copy())
                        count[slot] = k + 1
        return [Served(pcm=torch.from_numpy(self.bank.render(spec)),
                       steps=steps[u], emitted=ids)
                for u, (spec, slot, first, last, ids, _) in enumerate(picked)]

    def scfg_dict(self) -> dict:
        s = self.scfg
        return dict(n_buffer=s.n_buffer, chunk_samples=s.chunk_samples,
                    max_iters=s.max_iters, beam_width=s.beam_width,
                    beam_buf_tokens=s.beam_buf_tokens, lm_alpha=s.lm_alpha,
                    eos=2, step_ms=s.chunk_ms * s.n_buffer,
                    thresh_ms=s.reset_thresh_ms)

    def judge_numbers(self, prec=None) -> tuple[dict, list]:
        """The numbers the check compares, and the faults found, over the
        sampled utterances; with `prec`, those of the reference at that
        precision in the program's place (the control)."""
        sc = self.scfg_dict()
        served = self.served(self.sample())
        if not served:
            return {k: NOTHING for k in ("gap", "mismatch")}, [
                "no utterance finished in the window"]
        faults = split_served(served, eos=sc["eos"], step_ms=sc["step_ms"],
                              thresh_ms=sc["thresh_ms"])
        segs = [sg for u in served for sg in u.segs]
        judge = Judge(self.b.leaves, self.b.config["conf"], sc, self.b.device,
                      prec=prec)
        if sc["beam_width"] > 1:
            r = judge.beam_gaps(served, segs)
            nums = {k: r[k] for k in ("gap", "mismatch", "steps")}
        else:
            r = judge.greedy_gaps(served, segs)
            nums = {"gap": r.get("ctrl_gap", r["gap"]) if prec else r["gap"]}
        nums["utterances"] = len(served)
        nums["segments"] = len(segs)
        nums["tokens"] = r["tokens"]
        return nums, faults + r["faults"]
