"""The comparison that decides `correct` in the stream cells.

A served utterance is judged from what the engine produced for it: the
raw tokens of every step (the packed output the step returned) and the
transcript the client got. The reference reads them only to judge them.

1. Segments. The engine restarts a stream on its open and after 4,000 ms
   without a delivered token (its silence auto-reset), and a delivered
   EOS latches the stream quiet until then. `segments` applies those
   documented rules to the served tokens, so the reference knows where
   each restart fell without reading the engine's state.
2. Features. A segment is decoded from its own first chunk on: its
   stacked frames are the batch features of its audio, and its first
   chunk's frame is pipeline warm-up, never decoded.
3. Greedy (`greedy_gaps`): teacher-forced. At every decision the engine
   made (each token of a frame, then the blank that ends it unless the
   frame used all `max_iters` rounds), the gap by which the chosen
   symbol's log-prob lies below the reference's best. The widest gap is
   the number compared.
4. Beam + LM (`beam_gaps`): teacher-forced too. The reference runs the
   engine's streaming beam search itself (frame-synchronous, K beams,
   the LM fused log-linearly, the forced commit and collapse near a full
   buffer), but at every step it takes the tokens the program committed
   in place of its own commit: it reads by how much its best beam
   outscores its best beam that agrees with them, then keeps only the
   beams that agree. The widest such gap, and the steps at which no
   beam agrees, are the numbers compared. A free-running comparison of
   transcripts cannot serve: with seeded weights the beam's choices flip
   under rounding and the transcripts part for good.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .model import LM, Frontend, Transducer

NEG = -1e30


@dataclass
class Served:
    """One utterance as the engine served it."""
    pcm: torch.Tensor            # [S] float32, the audio the slot got
    steps: list                  # raw tokens of every step, in order
    emitted: list                # the transcript's ids the client got
    segs: list = field(default_factory=list)


@dataclass
class Segment:
    utt: int
    s0: int                      # first step
    s1: int                      # one past the last step
    delivered: list              # ids delivered in these steps
    closed: bool                 # ended by the utterance's close
    latched: bool                # an EOS latched it


def segments(steps: list, *, eos: int, step_ms: int, thresh_ms: int,
             utt: int = 0) -> list[Segment]:
    """Split an utterance's steps where the engine restarts the stream:
    its open, and the step after `thresh_ms` of silence. Silence grows
    by `step_ms` in a step that delivers nothing; a step that delivers
    resets it; a step whose tokens hold EOS delivers what precedes it,
    latches the stream (later tokens are not delivered) and leaves the
    silence as it was."""
    out: list[Segment] = []
    silence, latched, pending = 0, False, True
    for s, toks in enumerate(steps):
        if pending:
            out.append(Segment(utt, s, s, [], False, False))
            silence, latched, pending = 0, False, False
        seg = out[-1]
        seg.s1 = s + 1
        toks = [int(t) for t in toks]
        if toks and not latched:
            if eos in toks:
                seg.delivered += toks[: toks.index(eos)]
                latched = seg.latched = True
                continue
            seg.delivered += toks
            silence = 0
            continue
        silence += step_ms
        if silence >= thresh_ms:
            pending = True
    if out:
        out[-1].closed = True
    return out


def split_served(served: list[Served], *, eos: int, step_ms: int,
                 thresh_ms: int) -> list[str]:
    """Segment every utterance; returns the faults found on the way: a
    client transcript that is not what the steps delivered (plus, in beam
    mode, the flushed tail)."""
    faults = []
    for i, u in enumerate(served):
        u.segs = segments(u.steps, eos=eos, step_ms=step_ms,
                          thresh_ms=thresh_ms, utt=i)
        got = [t for sg in u.segs for t in sg.delivered]
        if u.emitted[: len(got)] != got:
            faults.append(f"utterance {i}: the client's transcript is not "
                          "what the steps delivered")
    return faults


class Judge:
    """The reference's side of a stream cell's check."""

    def __init__(self, leaves: dict, conf: dict, scfg: dict, device,
                 prec=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        fe = dict(sr=conf["sr"], n_fft=conf["melkwargs"]["n_fft"],
                  n_mels=conf["melkwargs"]["n_mels"],
                  win_length=conf["win_length"], hop_length=conf["hop_length"],
                  n_stack=10, downsample=8)
        self.frontend = Frontend(fe, device)
        self.model = Transducer(leaves, conf, prec)
        self.exact = Transducer(leaves, conf) if prec else self.model
        has_lm = bool((conf.get("lm") or {}).get("enable"))
        self.lm = LM(leaves, conf, "bf16" if prec else None) if has_lm else None
        self.exact_lm = (LM(leaves, conf) if prec else self.lm) if has_lm else None
        self.device = device
        self.nb = scfg["n_buffer"]
        self.chunk = scfg["chunk_samples"]
        self.max_iters = scfg["max_iters"]
        self.bos, self.blank, self.eos = 2, 0, scfg["eos"]
        self.K = scfg.get("beam_width", 0)
        self.cap = scfg.get("beam_buf_tokens", 64)
        self.lm_alpha = scfg.get("lm_alpha", 0.1)

    # ---- shared ---------------------------------------------------------

    def _frames(self, served: list[Served], segs: list[Segment]):
        """Encoder outputs of every segment: ([B, T, H] padded, [B]
        frame counts); a segment's frame f is decoded at its chunk f+1."""
        feats, counts = [], []
        for sg in segs:
            pcm = served[sg.utt].pcm
            a = pcm[sg.s0 * self.nb * self.chunk: sg.s1 * self.nb * self.chunk]
            n = (sg.s1 - sg.s0) * self.nb - 1
            x = self.frontend(a.to(self.device))[:n]
            feats.append(x)
            counts.append(n)
        t = max(max(counts), 1)
        x = torch.zeros((len(segs), t, feats[0].shape[1]), device=self.device)
        for i, f in enumerate(feats):
            x[i, : f.shape[0]] = f
        return x, counts

    # ---- greedy ---------------------------------------------------------

    def greedy_gaps(self, served: list[Served], segs: list[Segment]):
        """Returns {"gap": widest gap of a served decision, "ctrl_gap":
        the same of the lower-precision model's choices when this judge
        has one, "tokens", "decisions", "faults"}."""
        if self.nb != 1:
            raise NotImplementedError("the greedy check reads one frame a step")
        faults = []
        segs = [sg for sg in segs if sg.s1 - sg.s0 >= 2]
        if not segs:
            return {"gap": 0.0, "tokens": 0, "decisions": 0, "faults": faults}
        with torch.no_grad():
            x, counts = self._frames(served, segs)
            enc = self.exact.encode(x)
            enc_lo = self.model.encode(x) if self.model is not self.exact else None
            rows = []   # (segment, frame, prefix length, symbol)
            ys = []
            for b, sg in enumerate(segs):
                steps = served[sg.utt].steps[sg.s0: sg.s1]
                if len(steps[0]):
                    faults.append(f"segment {b}: tokens on a warm-up frame")
                y = []
                for f in range(counts[b]):
                    toks = [int(t) for t in steps[f + 1]]
                    if len(toks) > self.max_iters:
                        faults.append(f"segment {b}: {len(toks)} tokens on one frame")
                    for t in toks:
                        rows.append((b, f, len(y), t))
                        y.append(t)
                    if len(toks) < self.max_iters:
                        rows.append((b, f, len(y), self.blank))
                ys.append(y)
            u = max(len(y) for y in ys) + 1
            yin = torch.zeros((len(segs), u), dtype=torch.long, device=self.device)
            yin[:, 0] = self.bos
            for b, y in enumerate(ys):
                if y:
                    yin[b, 1: len(y) + 1] = torch.tensor(y)
            pred = self.exact.predict(yin)
            pred_lo = self.model.predict(yin) if enc_lo is not None else None
            r = torch.tensor(rows, device=self.device)
            gaps, ctrl = [], []
            for blk in r.split(4096):
                lp = self.exact.joint(pred[blk[:, 0], blk[:, 2]],
                                      enc[blk[:, 0], blk[:, 1]])
                best = lp.max(-1).values
                gaps.append(best - lp.gather(1, blk[:, 3:4])[:, 0])
                if enc_lo is not None:
                    lo = self.model.joint(pred_lo[blk[:, 0], blk[:, 2]],
                                          enc_lo[blk[:, 0], blk[:, 1]])
                    pick = lo.argmax(-1, keepdim=True)
                    ctrl.append(best - lp.gather(1, pick)[:, 0])
            gap = torch.cat(gaps)
            out = {"gap": float(gap.max()) if len(gap) else 0.0,
                   "tokens": sum(len(y) for y in ys), "decisions": len(rows),
                   "faults": faults}
            if ctrl:
                out["ctrl_gap"] = float(torch.cat(ctrl).max())
            return out

    # ---- beam + LM ------------------------------------------------------

    def beam_gaps(self, served: list[Served], segs: list[Segment]):
        """Teacher-forced beam: the reference runs the engine's streaming
        beam over each segment, and at every step takes the program's
        committed tokens (and, at a close, its flushed tail) in place of
        its own commit. Before it does, it reads the gap between its best
        beam's score and the best score of its beams that agree with what
        the program committed; it then keeps only those beams. A step at
        which none of its beams agrees is a mismatch (the segment is not
        judged further); so is a step that commits less than every beam
        of the judge agrees on. Returns {"gap": the widest gap, "mismatch",
        "tokens", "steps", "faults"}. With a lower-precision model this
        judge's own beam, free-running at that precision, takes the
        program's place (the control)."""
        segs = [sg for sg in segs if sg.s1 - sg.s0 >= 2]
        if not segs:
            return {"gap": 0.0, "mismatch": 0, "tokens": 0, "steps": 0,
                    "faults": []}
        with torch.no_grad():
            x, counts = self._frames(served, segs)
            if self.model is not self.exact:
                commits, tails = self._beam_run(self.model, self.lm,
                                                self.model.encode(x), counts, segs)
            else:
                commits = [[[int(t) for t in st] for st in
                            served[sg.utt].steps[sg.s0: sg.s1]] for sg in segs]
                tails = [self._tail(served, sg) if sg.closed and not sg.latched
                         else None for sg in segs]
            return self._beam_run(self.exact, self.exact_lm, self.exact.encode(x),
                                  counts, segs, forced=(commits, tails))

    def _tail(self, served, sg):
        """The flushed tail of a closed segment: what the client got past
        what the steps delivered."""
        u = served[sg.utt]
        before = sum(len(s.delivered) for s in u.segs)
        return u.emitted[before:]

    def _beam_run(self, m: Transducer, lm, enc, counts, segs, forced=None):
        """The engine's streaming beam over every segment at once, from the
        encoder's outputs enc [B, T, H]. Free-running (forced None) it
        commits as the engine does and returns (every step's committed
        ids, the best beam's tail at the end) per segment; forced, it
        judges those as beam_gaps says."""
        dev, K = self.device, self.K
        B, cap = len(segs), self.cap
        margin = self.nb * self.max_iters
        bos = torch.full((B * K,), self.bos, dtype=torch.long, device=dev)
        h, pst = m.pred_step(bos, m.pred_init(B * K))
        lm_lp, lst = (lm.step(bos, lm.init(B * K, dev)) if lm is not None
                      else (None, None))
        V = m.w["joint.out.bias"].shape[0]
        st = dict(pst=pst, h=h.reshape(B, K, -1),
                  scores=torch.full((B, K), NEG, device=dev),
                  y=torch.zeros((B, K, cap), dtype=torch.long, device=dev),
                  ylen=torch.zeros((B, K), dtype=torch.long, device=dev),
                  lst=lst, lm=None if lm_lp is None else lm_lp.reshape(B, K, V))
        st["scores"][:, 0] = 0.0
        n_steps = [sg.s1 - sg.s0 for sg in segs]
        commits = [[] for _ in range(B)]
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        gaps, mismatch, tokens, steps = [], 0, 0, 0
        pos = torch.arange(cap, device=dev)
        for s in range(max(n_steps)):
            for j in range(self.nb):
                f = s * self.nb + j - 1            # frame of chunk s*nb + j
                valid = torch.tensor([0 <= f < counts[b] for b in range(B)],
                                     device=dev)
                if bool(valid.any()):
                    st = self._beam_frame(m, lm, st, enc[:, min(max(f, 0),
                                          enc.shape[1] - 1)], valid, V)
            active = torch.tensor([s < n for n in n_steps], device=dev)
            if forced is None:
                toks, lens, st = self._commit(st, margin)
                for b in range(B):
                    if s < n_steps[b]:
                        commits[b].append(toks[b, : lens[b]].tolist())
                continue
            c = [forced[0][b][s] if s < n_steps[b] else [] for b in range(B)]
            g, ok, st = self._force(st, c, margin, pos)
            judged = active & alive
            gaps += g[judged].tolist()
            mismatch += int((judged & ~ok).sum())
            alive &= ok | ~active
            steps += int(judged.sum())
            tokens += sum(len(c[b]) for b in range(B) if bool(judged[b]))
        best = st["scores"].argmax(1)
        if forced is None:
            tails = [st["y"][b, best[b], : int(st["ylen"][b, best[b]])].tolist()
                     for b in range(B)]
            return commits, tails
        # the flush at a close: the tail must be a beam's whole buffer
        c = [forced[1][b] or [] for b in range(B)]
        g, ok, _ = self._force(st, c, 0, pos, exact=True)
        judged = alive & torch.tensor([forced[1][b] is not None for b in range(B)],
                                      device=dev)
        gaps += g[judged].tolist()
        mismatch += int((judged & ~ok).sum())
        return {"gap": max(gaps) if gaps else 0.0, "mismatch": mismatch,
                "tokens": tokens, "steps": steps, "faults": []}

    def _force(self, st, c: list, margin: int, pos, exact: bool = False):
        """Judge one commit c (ids per segment) against the pool and keep
        only the beams that agree with it; `exact` (the flush) asks a
        beam's whole buffer to be c, or c and then EOS, where the client's
        tail was cut. Returns (gap [B], agreed [B], the new state)."""
        y, ylen, scores = st["y"], st["ylen"], st["scores"]
        B, K, cap = y.shape
        L = torch.tensor([len(x) for x in c], device=y.device)
        C = torch.zeros((B, cap), dtype=torch.long, device=y.device)
        for b, x in enumerate(c):
            if x:
                C[b, : len(x)] = torch.tensor(x[:cap])
        live = scores > NEG / 2
        # what the engine's rule commits from this pool: the prefix every
        # live beam agrees on, up to the best beam's length
        best = torch.where(live, scores, NEG).argmax(1)
        ref = y.gather(1, best[:, None, None].expand(B, 1, cap))
        ref_len = ylen.gather(1, best[:, None])
        agree = ((y == ref) & (pos < ylen[:, :, None])) | ~live[:, :, None]
        n_agree = torch.cumprod((agree.all(1) & (pos[None, :] < ref_len)).long(),
                                1).sum(1)
        match = (live & (ylen >= L[:, None])
                 & ((y == C[:, None, :]) | (pos >= L[:, None, None])).all(-1))
        if exact:
            nxt = y.gather(2, L.clamp(max=cap - 1)[:, None, None].expand(B, K, 1))[..., 0]
            match &= (ylen == L[:, None]) | (nxt == self.eos)
        best_all = torch.where(live, scores, NEG).max(1).values
        best_ok = torch.where(match, scores, NEG).max(1).values
        ok = match.any(1)
        gap = torch.where(ok, best_all - best_ok, torch.zeros_like(best_all))
        if not exact:
            # a commit short of what every beam agrees on is no commit
            # the engine's rule makes
            ok &= n_agree <= L
        # the engine's own force rule on the pool before the commit
        force = ylen.max(1).values >= cap - margin if margin else torch.zeros_like(ok)
        keep = torch.where(ok[:, None], match, live)
        idx = (pos[None, None, :] + L[:, None, None]).clamp(0, cap - 1)
        shifted = y.gather(2, idx.expand(B, K, cap))
        rest = ylen - L[:, None]
        shifted = torch.where(pos < rest[:, :, None], shifted, 0)
        new = dict(st, scores=torch.where(keep, scores, NEG),
                   y=torch.where(ok[:, None, None], shifted, y),
                   ylen=torch.where(ok[:, None], rest.clamp(min=0), ylen))
        if bool(force.any()):
            new = _select(force, _collapse(new, B, K), new, B, K)
        return gap, ok, new

    def _beam_frame(self, m, lm, st, h_enc, valid, V):
        B, K = st["scores"].shape
        cap = self.cap
        h_enc_k = h_enc.repeat_interleave(K, 0)
        active = valid[:, None] & (st["scores"] > NEG / 2)
        fin = dict(st, scores=torch.where(active, NEG, st["scores"]))
        cur = st
        for _ in range(self.max_iters):
            lp = m.joint(cur["h"].reshape(B * K, -1), h_enc_k).reshape(B, K, V)
            blank_scores = torch.where(active, cur["scores"] + lp[:, :, self.blank],
                                       NEG)
            fin = _merge(fin, dict(cur, scores=blank_scores), B, K)
            ext = cur["scores"][:, :, None] + lp
            if lm is not None:
                ext = ext + self.lm_alpha * cur["lm"]
            ext[:, :, self.blank] = NEG
            ext = torch.where(active[:, :, None] & (cur["ylen"] < cap)[:, :, None],
                              ext, NEG)
            top, idx = _top_k(ext.reshape(B, K * V), K)
            src, tok = idx // V, idx % V
            new_active = top > NEG / 2
            y = _take(cur["y"], src)
            ylen = cur["ylen"].gather(1, src)
            at_end = torch.arange(cap, device=y.device) == ylen[:, :, None]
            y = torch.where(at_end & new_active[:, :, None], tok[:, :, None], y)
            t = tok.reshape(B * K)
            h, pst = m.pred_step(t, _gather_flat(cur["pst"], src, B, K))
            lst, lmlp = cur["lst"], cur["lm"]
            if lm is not None:
                lmlp, lst = lm.step(t, _gather_flat(cur["lst"], src, B, K))
                lmlp = lmlp.reshape(B, K, V)
            cur = dict(pst=pst, h=h.reshape(B, K, -1), scores=top, y=y,
                       ylen=ylen + new_active.long(), lst=lst, lm=lmlp)
            active = new_active
        forced = dict(cur, scores=torch.where(active, cur["scores"], NEG))
        merged = _merge(fin, forced, B, K)
        keep = ~valid
        return _select(keep, st, merged, B, K)

    def _commit(self, st, margin: int):
        """The prefix every live beam agrees on, with the forced commit
        of the best beam's buffer (and the pool collapsed to it) when a
        buffer is within `margin` of full."""
        y, ylen, scores = st["y"], st["ylen"], st["scores"]
        B, K, cap = y.shape
        live = scores > -1e29
        best = scores.argmax(1)
        ref = y.gather(1, best[:, None, None].expand(B, 1, cap))
        ref_len = ylen.gather(1, best[:, None])
        pos = torch.arange(cap, device=y.device)
        agree = ((y == ref) & (pos < ylen[:, :, None])) | ~live[:, :, None]
        agree_all = agree.all(1) & (pos[None, :] < ref_len)
        n = torch.cumprod(agree_all.long(), 1).sum(1)
        idx = (pos[None, None, :] + n[:, None, None]).clamp(0, cap - 1)
        shifted = y.gather(2, idx.expand(B, K, cap))
        rest = ylen - n[:, None]
        shifted = torch.where(pos < rest[:, :, None], shifted, 0)
        new = dict(st, y=shifted, ylen=rest.clamp(min=0))
        toks = torch.where(pos[None, :] < n[:, None], ref[:, 0, :], 0)
        force = ylen.max(1).values >= cap - margin
        if bool(force.any()):
            toks = torch.where(force[:, None],
                               torch.where(pos[None, :] < ref_len, ref[:, 0, :], 0),
                               toks)
            n = torch.where(force, ref_len[:, 0], n)
            col = _collapse(st, B, K)
            new = _select(force, col, new, B, K)
        return toks, n, new


# ---- beam helpers: state dicts of [B, K, ...] leaves, and [B*K, ...]
# leaves under "pst" and "lst" (per layer, a tensor or an (h, c) pair)

_FLAT = ("pst", "lst")


def _tmap(fn, a, *rest):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return fn(a, *rest)
    return tuple(_tmap(fn, x, *(r[i] for r in rest)) for i, x in enumerate(a))


def _take(x, idx):
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.take_along_dim(x, idx, dim=1)


def _gather_flat(tree, idx, B, K):
    return _tmap(lambda x: _take(x.reshape(B, K, *x.shape[1:]), idx
                                 ).reshape(x.shape), tree)


def _top_k(x, k):
    """The k largest, the lower index first among ties."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _merge(a: dict, b: dict, B, K) -> dict:
    top, idx = _top_k(torch.cat([a["scores"], b["scores"]], 1), K)
    out = {}
    for key in a:
        if a[key] is None:
            out[key] = None
        elif key in _FLAT:
            out[key] = _tmap(lambda x, y: _take(
                torch.cat([x.reshape(B, K, *x.shape[1:]),
                           y.reshape(B, K, *y.shape[1:])], 1), idx).reshape(x.shape),
                a[key], b[key])
        else:
            out[key] = _take(torch.cat([a[key], b[key]], 1), idx)
    out["scores"] = top
    return out


def _select(keep, old: dict, new: dict, B, K) -> dict:
    """old where keep [B] else new."""
    kk = keep.repeat_interleave(K, 0)
    out = {}
    for key in old:
        if old[key] is None:
            out[key] = None
            continue
        m = kk if key in _FLAT else keep

        def sel(o, n, m=m):
            return torch.where(m.reshape((-1,) + (1,) * (o.dim() - 1)), o, n)
        out[key] = _tmap(sel, old[key], new[key])
    return out


def _collapse(st: dict, B, K) -> dict:
    best = st["scores"].argmax(1)
    idx = best[:, None].expand(B, K)
    out = {k: (None if v is None else
               _gather_flat(v, idx, B, K) if k in _FLAT else _take(v, idx))
           for k, v in st.items()}
    s = torch.full_like(st["scores"], NEG)
    s[:, 0] = st["scores"].gather(1, best[:, None])[:, 0]
    out.update(scores=s, y=torch.zeros_like(st["y"]),
               ylen=torch.zeros_like(st["ylen"]))
    return out
