"""Batched streaming engine: N streams advance in lockstep, one step per
80 ms chunk (the JAX package's models/streaming.py), greedy or beam
search, either with LM fusion.

The frontend is incremental and exact: a stream carries
(n_fft/2 + d*hop) samples and (n_stack - downsample + d) mel frames, so
each chunk computes exactly its new mel frames and emits one stacked
encoder frame, the same one batch transcription computes over the whole
signal (after the stream's first, warmup, frame). Per-stream reset
(slot open, and the silence auto-reset) is a masked state swap inside
the step: on reset the sample carry is the reflect padding of the
incoming chunk's head, as batch framing pads.

The step is one plain function of tensors (`StreamingEngine.step_fn`).
A step encodes one stacked frame per sub-chunk (T = 1), so the encoder
runs on the scan cells and no sequence kernel, as in the JAX package.
On the card the engine captures the step once, at construction, as one
CUDA graph over static buffers (the chunks in the wire dtype, `valid`,
`reset`, the stream state updated in place and the packed output), and
every step is one replay of it; a k-deep chained dispatch is k replays.
On the CPU the same function runs eagerly. A capture that fails raises:
there is no eager path on the card.

A model that computes in bf16 is stepped through a copy whose tower
matrices (the cells' kernels and recurrent kernels, the joint's Dense
kernels) the engine casts to bf16 once, at build: the step reads them
without a cast, and on the card their products run on the tensor cores
with float32 sums and outputs (ops/rnn.py:_mm). A float32 model is
stepped as it is.

Host side, the wire codec runs once per sample: with the int16 wire the
PCM ring holds int16, encoded as the samples are appended, and a
dispatch gathers the ready rows straight into pooled staging buffers
(pinned on the card) that the next chains reuse.

Greedy mode decodes up to `max_iters` rounds a frame (decode_frame, LM
fusion inside the same step when `use_lm`) and emits every token at
once. Beam mode (`beam_width` > 1) runs `max_iters` masked expansion
rounds a frame (beam_frame, LM state per beam) and keeps each beam's
uncommitted tokens across steps, in a [N, K, beam_buf_tokens] buffer: a
step emits the prefix every live beam agrees on, so partials never
retract, and `flush_slot` commits the best beam's tail when a stream
ends.

Over a mesh (`mesh=make_mesh(data=D, devices=[...])`, the device-list
form) the streams shard over the data axis, as JAX's engine shards them:
one sub-engine a device, with its own copy of the weights, its own
state and, on the card, its own CUDA graph; slot s lives on device
s // (N / D). A step dispatches every device's replay before it
collects any. The host side (slots, buffers, outboxes) stays one.

While tracing is on (libreasr_tpu_torch.telemetry) the engine records
spans of its dispatch's parts, its collect and its slot churn, counts
its sub-steps and rows (valid and masked, by cause), and on the card
times each chain with CUDA events for the card's idle gap before it.
Off, each costs a flag test.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import threading
import weakref
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .. import telemetry as tel
from ..ops.frontend import FrontendConfig, dft_mel_matrices
from .beam import (BeamState, beam_frame, collapse_to_best, init_beam_state,
                   repeat_rows)
from .decode import DecodeState, decode_frame, init_decode_state
from .modules import Cell, Dense
from .transducer import learnable_states

# backlog-recovery chain depths the serving stepper escalates through
# (powers of two; the last is its cap)
CHAIN_DEPTHS = (2, 4, 8)



@dataclass(frozen=True)
class StreamingConfig:
    sr: int = 16000
    chunk_ms: int = 80           # wire chunk
    n_buffer: int = 1            # chunks per device step
    max_iters: int = 10          # decode rounds per frame
    reset_thresh_ms: int = 4000  # silence auto-reset
    max_tokens_per_step: int = 32
    # beam search: tokens are committed once every live beam agrees on
    # them (prefix agreement), so partials never retract
    beam_width: int = 0          # 0/1 = greedy
    beam_buf_tokens: int = 64    # per-beam uncommitted-token window
    lm_alpha: float = 0.1
    # host->device PCM codec: "int16" halves the upload bytes (error
    # 3e-5, below any 16-bit capture chain's noise); "float32" keeps
    # stream == batch features exact
    transfer_dtype: str = "float32"

    def __post_init__(self):
        if self.transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"transfer_dtype {self.transfer_dtype!r}: "
                             "expected 'float32' or 'int16'")

    @property
    def chunk_samples(self) -> int:
        return self.sr * self.chunk_ms // 1000


def _stream_geometry(fe: FrontendConfig, chunk_samples: int):
    """Carry sizes for the exact incremental frontend.

    With hop h, window w (center c = w//2), C = chunk samples:
    - frames per chunk F = C/h;
    - frame delay d = ceil((w - c)/h) - 1 so every emitted frame's
      window is fully available;
    - sample carry = d*h + c;
    - mel carry = n_stack - downsample + d (one stacked frame per chunk).
    """
    h, w = fe.hop, fe.n_fft
    c = w // 2
    if chunk_samples % h:
        raise ValueError("the chunk must be a multiple of the hop")
    frames = chunk_samples // h
    if frames != fe.downsample:
        raise ValueError(
            "exact streaming needs one stacked frame per chunk (frames per "
            f"chunk {frames} != downsample {fe.downsample})")
    d = -(-(w - c) // h) - 1
    return frames, d, d * h + c, fe.n_stack - fe.downsample + d


def _tree_map(fn, *trees):
    """fn over the tensors of nested tuples and dataclasses of the same
    structure."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t):
        return dataclasses.replace(t, **{
            f.name: _tree_map(fn, *(getattr(x, f.name) for x in trees))
            for f in dataclasses.fields(t)})
    return tuple(_tree_map(fn, *xs) for xs in zip(*trees))


def _leaves(tree) -> list[torch.Tensor]:
    out = []
    _tree_map(lambda x: out.append(x) or x, tree)
    return out


def _select(mask, new, old):
    """Per-stream select over a state tree; mask [N]. A leaf of N*K rows
    (a beam state's predictor and LM carries) takes each stream's value
    for its K rows (repeat_rows: jnp.repeat(mask, k), not a tiling)."""
    n = mask.shape[0]

    def sel(a, b):
        m = mask if a.shape[0] == n else repeat_rows(mask, a.shape[0] // n)
        return torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return _tree_map(sel, new, old)


def _beam_committed_prefix(beam: BeamState, force_margin: int = 0):
    """The longest token prefix every live beam agrees on, per stream.

    Returns (tokens [N, cap] from the best beam, zero past the length,
    lengths [N], the beam state with that prefix dropped from every
    buffer).

    force_margin > 0 adds a saturation fallback: a stream whose largest
    uncommitted buffer is within `force_margin` tokens of capacity
    commits its best beam's whole buffer and collapses its pool to that
    beam, so that no token is dropped on a stream whose beams never
    agree."""
    n, k, cap = beam.y_buf.shape
    dev = beam.y_buf.device
    live = beam.scores > -1e29                                # [N, K]
    best = torch.argmax(beam.scores, dim=1)                   # [N]
    ref = beam.y_buf.gather(1, best[:, None, None].expand(n, 1, cap))
    ref_len = beam.y_len.gather(1, best[:, None])             # [N, 1]
    pos = torch.arange(cap, device=dev)
    # beam k agrees at position j if it is dead, or holds ref's token there
    agree = (((beam.y_buf == ref) & (pos < beam.y_len[:, :, None]))
             | ~live[:, :, None])
    agree_all = agree.all(dim=1) & (pos[None, :] < ref_len)  # [N, cap]
    commit_len = torch.cumprod(agree_all.long(), dim=1).sum(dim=1)

    # shift every beam's buffer left by commit_len
    idx = (pos[None, None, :] + commit_len[:, None, None]).clamp(0, cap - 1)
    shifted = beam.y_buf.gather(2, idx.expand(n, k, cap))
    rest = beam.y_len - commit_len[:, None]
    shifted = torch.where(pos < rest[:, :, None], shifted, 0)
    new_beam = dataclasses.replace(beam, y_buf=shifted, y_len=rest.clamp(min=0))
    committed = torch.where(pos[None, :] < commit_len[:, None], ref[:, 0, :], 0)

    if force_margin > 0:
        force = beam.y_len.max(dim=1).values >= cap - force_margin   # [N]
        committed = torch.where(
            force[:, None],
            torch.where(pos[None, :] < ref_len, ref[:, 0, :], 0), committed)
        commit_len = torch.where(force, ref_len[:, 0], commit_len)
        new_beam = _select(force, collapse_to_best(beam), new_beam)
    return committed, commit_len, new_beam


@dataclass(frozen=True)
class StreamState:
    enc_state: Any            # per encoder layer, (h, c) each [N, H]
    decode: DecodeState
    sample_carry: torch.Tensor  # [N, d*hop + n_fft/2]
    mel_carry: torch.Tensor     # [N, n_stack - downsample + d, n_mels]
    started: torch.Tensor       # [N] bool: slot has been (re)initialized
    primed: torch.Tensor        # [N] bool: first (warmup) frame consumed

    def clone(self) -> "StreamState":
        """A copy that shares no storage with this state."""
        return _tree_map(torch.clone, self)


class _Joined:
    """The outputs of every device of a mesh engine, joined along the
    streams in slot order once each has landed."""

    __slots__ = ("parts", "seq")

    def __init__(self, parts, seq):
        self.parts, self.seq = parts, seq

    def wait(self) -> None:
        for p in self.parts:
            p.wait()

    def numpy(self) -> np.ndarray:
        self.wait()
        gaps = [g for p in self.parts if (g := p.take_gap()) is not None]
        if gaps:
            # one gap a chain, as `engine.steps` counts it once: the mean
            # of the cards' idle gaps, ending at the mean enqueue time
            sec, t_enq, tid = zip(*gaps)
            tel.gap(sum(sec) / len(gaps), sum(t_enq) // len(gaps), tid[0])
        return np.concatenate([p.array() for p in self.parts], axis=1)


def _bundle_on(bundle, device):
    """A copy of `bundle` whose model (and LM) lives on `device`."""
    import copy

    model = copy.deepcopy(bundle.model).to(device)
    lm = None if bundle.lm is None else copy.deepcopy(bundle.lm).to(device)
    return type(bundle)(bundle.conf, model, bundle.lang, device, lm)


def _tensor_core_copy(model):
    """The model the engine steps, and the number of matrices cast for
    it. A model that computes in a narrow type (bf16) gets a copy whose
    towers' matrices are held in that type, cast once here: each float
    cell's kernel and recurrent kernel (encoder, predictor) and the
    joint's Dense kernels. Every other tensor, the biases included, is
    the model's own, shared: a bias set in place reaches the step. A
    float32 model is stepped as it is."""
    dt = model.cfg.compute_dtype
    if dt is None:
        return model, 0
    memo = {id(t): t for t in itertools.chain(model.parameters(),
                                               model.buffers())}
    net = copy.deepcopy(model, memo)
    cast = 0
    for mod in net.modules():
        if isinstance(mod, Cell):
            names = [k for k in ("kernel", "recurrent_kernel")
                     if isinstance(getattr(mod, k), nn.Parameter)]
        elif isinstance(mod, Dense) and mod.dtype == dt:
            names = ["kernel"]
        else:
            continue
        for k in names:
            w = getattr(mod, k).detach().to(dt)
            setattr(mod, k, nn.Parameter(w, requires_grad=False))
            cast += 1
    return net, cast


def _on_device(device: torch.device):
    """Make `device` the current card while a sub-engine enqueues work
    (a no-op on the CPU), so that the streams, events and graph captures
    made meanwhile belong to the card that holds its tensors."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


class _Stage:
    """Pooled host buffers of one chain, pinned on the card: the wire PCM
    [cap, N, n_buffer, C] (a dispatch gathers into it), the flags [cap,
    2, N] (valid, reset) and the packed outputs [cap, N, W+1]. A chain
    holds its stage until its outputs were read off it or, left unread,
    until they are dropped and the chain's end event has passed."""

    __slots__ = ("cap", "chunks", "wire", "flags", "host", "user", "done")

    def __init__(self, cap, n, n_buffer, c, width, dtype, pin):
        self.cap = cap
        self.chunks = torch.zeros((cap, n, n_buffer, c), dtype=dtype,
                                  pin_memory=pin)
        self.wire = self.chunks.numpy()
        self.flags = torch.zeros((cap, 2, n), dtype=torch.bool,
                                 pin_memory=pin)
        self.host = torch.zeros((cap, n, width), dtype=torch.int32,
                                pin_memory=pin)
        self.user = self.done = None

    def free(self) -> bool:
        out = None if self.user is None else self.user()
        if out is not None:
            return out.taken()
        return self.done is None or self.done.query()


class _Outputs:
    """The packed outputs [k, N, K+1] int32 of k sub-steps, in the
    chain's staging buffers (pinned on the card) once `done` has passed;
    read off them once, into an array of their own, which frees the
    stage for another chain.

    A chain enqueued on the card while tracing was on holds a timed
    event recorded before its first input copy (`start`, enqueued at
    host time `t_enq` by thread `tid`) and, if the chain before it was
    traced too, that chain's timed end event (`prev`): the first read of
    its outputs adds the card's idle gap between the two to the
    telemetry (a mesh engine's `_Joined`, the mean over its cards)."""

    __slots__ = ("host", "done", "seq", "start", "prev", "t_enq", "tid",
                 "_array", "__weakref__")

    def __init__(self, host, done, seq, start=None, prev=None, t_enq=0,
                 tid=0):
        self.host, self.done, self.seq = host, done, seq
        self.start, self.prev, self.t_enq, self.tid = start, prev, t_enq, tid
        self._array = None

    def wait(self) -> None:
        if self.done is not None:
            self.done.synchronize()

    def take_gap(self):
        """The card's idle gap before this chain, once it has landed and
        only once: (seconds, host ns its start was enqueued, thread), or
        None."""
        gap = None
        if self.start is not None and self.prev is not None:
            gap = (self.prev.elapsed_time(self.start) / 1e3, self.t_enq,
                   self.tid)
        self.start = self.prev = None
        return gap

    def taken(self) -> bool:
        return self._array is not None

    def array(self) -> np.ndarray:
        """The outputs, copied off the staging buffer at the first call;
        only once `done` has passed."""
        if self._array is None:
            self._array = self.host.numpy().copy()
            self.host = None
        return self._array

    def numpy(self) -> np.ndarray:
        self.wait()
        if (gap := self.take_gap()) is not None:
            tel.gap(*gap)
        return self.array()


class StreamingEngine:
    """Owns the stream state on the device, the step (a CUDA graph on
    the card) and the per-slot host buffers.

    `tensor_core_weights`: the matrices cast to the compute type at
    build (0 for a float32 model); the step reads those copies, so a
    matrix changed in place after the build is not seen by a bf16
    engine (a bias is: the step reads the model's own), and a bundle
    whose model was swapped is refused."""

    def __init__(self, bundle, n_streams: int = 64,
                 scfg: StreamingConfig | None = None, use_lm: bool = False,
                 mesh=None):
        """use_lm: fuse the bundle's LM (greedy: standardized, alpha 0.1;
        beam: log-linear, scfg.lm_alpha); as in JAX, a bundle without an
        LM decodes without. mesh: a device-list mesh whose data axis
        divides n_streams."""
        if mesh is not None and n_streams % mesh.size("data"):
            raise AssertionError("n_streams must divide the data axis")
        self.bundle = bundle
        self.n = n_streams
        self.scfg = scfg or StreamingConfig(sr=bundle.frontend.sr)
        self.beam = self.scfg.beam_width > 1
        self.use_lm = use_lm
        self.cfg = bundle.cfg
        self.frontend: FrontendConfig = bundle.frontend
        if self.frontend.deltas:
            # the delta filter is centered over time (future context);
            # serving it incrementally would silently diverge from the
            # batch/training features. Refuse instead of diverging.
            raise NotImplementedError(
                "StreamingEngine does not support frontend.deltas > 0: "
                "delta features need future frames and would make "
                "streaming features diverge from training. Set "
                "`deltas: 0` for streaming models, or decode offline "
                "via ASRBundle.transcribe."
            )
        self.device = resolve_device(bundle.device)
        # the model whose weights the step reads (a CUDA graph holds
        # their addresses): a bundle that swaps its model afterwards
        # (quantize) is refused, never served the old weights
        self.model = bundle.model
        self.fns = bundle.decoder_fns(use_lm=use_lm)
        self.tensor_core_weights = 0
        self.mesh = mesh
        self._wire = torch.int16 if self.scfg.transfer_dtype == "int16" \
            else torch.float32
        self._pin = self.device.type == "cuda" and mesh is None
        self.replays = 0  # CUDA graph replays (every step on the card)
        self.steps = 0    # device steps run
        self._seq = 0     # chains enqueued: the dispatch spans' ids
        self._prev_done = None  # the last chain's end event, if traced
        self._shard = False  # a mesh engine's part: the outer one counts
        self._shards = None
        if mesh is None:
            # the step's model: tower matrices cast once, in a bf16 model
            self._net, self.tensor_core_weights = _tensor_core_copy(self.model)
            self.fns = dataclasses.replace(
                self.fns, predict_step=self._net.predict,
                joint_step=self._net.joint_step)
            with _on_device(self.device):
                self._init_device()
        else:
            grid = mesh.device_grid()
            per = n_streams // mesh.size("data")
            self._shards = [
                StreamingEngine(_bundle_on(bundle, grid[i, 0, 0]), per,
                                self.scfg, use_lm)
                for i in range(mesh.size("data"))]
            for sh in self._shards:
                sh._shard = True
            self.tensor_core_weights = sum(sh.tensor_core_weights
                                           for sh in self._shards)
        self._init_host()

    def _init_device(self) -> None:
        """The step's device side: weights' views, static inputs, the
        stream state, the packed output and the graph."""
        (self._frames_per_chunk, _, self._sample_carry_len,
         self._mel_carry_len) = _stream_geometry(self.frontend,
                                                 self.scfg.chunk_samples)
        fe = self.frontend
        mats = dft_mel_matrices(fe.n_fft, fe.n_mels, fe.sr,
                                int(fe.win_length * fe.sr))
        self._c, self._s, self._fb = (torch.from_numpy(m).to(self.device)
                                      for m in mats)
        self._frame_idx = (torch.arange(self._frames_per_chunk)[:, None] * fe.hop
                           + torch.arange(fe.n_fft)[None, :]).to(self.device)
        # the step's static inputs (the graph holds their addresses)
        self._chunks = torch.zeros(
            (self.n, self.scfg.n_buffer, self.scfg.chunk_samples),
            dtype=self._wire, device=self.device)
        self._flags = torch.zeros((2, self.n), dtype=torch.bool,
                                  device=self.device)
        self._valid, self._reset = self._flags[0], self._flags[1]
        with torch.no_grad():
            self.state = self._init_state()
            # BOS-primed decode state: the reset template (read only)
            self._fresh_dec = self._init_decode()
            self._packed = torch.zeros((self.n, self._width), dtype=torch.int32,
                                       device=self.device)
        self._graph = self._capture() if self.device.type == "cuda" else None

    @property
    def _width(self) -> int:
        """Columns of the packed output: the tokens, then their count."""
        return 1 + (self.scfg.beam_buf_tokens if self.beam
                    else self.scfg.max_tokens_per_step)

    def _init_host(self) -> None:
        # host-side slot bookkeeping. PCM lives in ONE [N, cap] ring
        # matrix in the wire dtype with per-slot head/tail offsets:
        # append encodes the new samples into their row in place, a
        # dispatch gathers every ready slot's samples into a staging
        # buffer in one indexed copy per sub-step
        self._buf_cap = 4 * self.scfg.chunk_samples * self.scfg.n_buffer
        self._buf = np.zeros((self.n, self._buf_cap),
                             np.int16 if self._wire == torch.int16 else np.float32)
        self._head = np.zeros(self.n, np.int64)
        self._tail = np.zeros(self.n, np.int64)
        # two staging buffers: one chain in flight while the next gathers
        self._stages = [self._new_stage(CHAIN_DEPTHS[-1]) for _ in range(2)]
        self.emitted = [[] for _ in range(self.n)]
        # per-slot undelivered text: every step distributes every stepped
        # slot's new text here, so text decoded while another slot drove
        # the step is never lost
        self.outbox = [[] for _ in range(self.n)]
        self.silence_ms = np.zeros(self.n, np.int64)
        self.active = np.zeros(self.n, bool)
        self._pending_reset_arr = np.zeros(self.n, bool)
        self._flushed = np.zeros(self.n, bool)  # beam tail already committed
        # bumped when a slot resets/reopens; pipelined collects of steps
        # dispatched before the bump skip the slot (stale outputs)
        self._reset_epoch = np.zeros(self.n, np.int64)
        # latched once a stream emits EOS: post-terminal tokens are
        # suppressed until the next reset (silence auto-reset or reopen)
        self._eos_done = np.zeros(self.n, bool)
        # sub-steps dispatched but not yet collected per slot: dispatch-
        # time silence projections count them as silent (worst case)
        self._inflight = np.zeros(self.n, np.int64)

    # ---- the step --------------------------------------------------------

    def _init_decode(self) -> DecodeState | BeamState:
        cfg, scfg = self.cfg, self.scfg
        if self.beam:
            return init_beam_state(self.fns, self.n, scfg.beam_width,
                                   cfg.vocab_sz, bos=cfg.bos,
                                   max_tokens=scfg.beam_buf_tokens,
                                   device=self.device)
        return init_decode_state(self.fns, self.n, vocab_sz=cfg.vocab_sz,
                                 bos=cfg.bos,
                                 max_tokens=scfg.max_tokens_per_step,
                                 device=self.device)

    def _init_state(self) -> StreamState:
        """Zeros of the right shapes: every slot starts un-started, so
        its first step resets it from the learnable h0 and the template.
        Leaves are cloned so that none shares storage with another (the
        step copies into each in place)."""
        n, fe = self.n, self.frontend
        h0 = learnable_states(self._net, "encoder", n)
        return StreamState(
            enc_state=_tree_map(lambda x: x.new_zeros(x.shape), h0),
            decode=_tree_map(torch.clone, self._init_decode()),
            sample_carry=torch.zeros((n, self._sample_carry_len),
                                     device=self.device),
            mel_carry=torch.zeros((n, self._mel_carry_len, fe.n_mels),
                                  device=self.device),
            started=torch.zeros(n, dtype=torch.bool, device=self.device),
            primed=torch.zeros(n, dtype=torch.bool, device=self.device),
        )

    def mel_chunk(self, sample_carry, chunk):
        """[N, sc] + [N, C] -> (log-mel [N, F, M], new sample carry):
        the windowed real DFT as float32 products (TF32 off), as
        ops/frontend.py computes it."""
        buf = torch.cat([sample_carry, chunk], dim=1)
        frames = buf[:, self._frame_idx]                  # [N, F, n_fft]
        re, im = frames @ self._c, frames @ self._s
        mel = torch.log((re * re + im * im) @ self._fb + 1e-6)
        return mel, buf[:, -self._sample_carry_len:]

    def frontend_step(self, sample_carry, mel_carry, chunk):
        """One chunk through the incremental frontend. Returns (stacked
        frame [N, 1, n_mels * n_stack], sample carry, mel carry)."""
        fe = self.frontend
        mel, sample_carry = self.mel_chunk(sample_carry, chunk)
        allmel = torch.cat([mel_carry, mel], dim=1)
        win = allmel[:, : fe.n_stack, :]                  # [N, K, M]
        stacked = win.transpose(1, 2).reshape(chunk.shape[0], 1, -1)
        return stacked, sample_carry, allmel[:, fe.downsample :, :]

    def step_fn(self, state: StreamState, chunks, valid, reset):
        """One engine step as a plain function of tensors (no host sync,
        no branch on a tensor's value; `state` is not modified).
        chunks: [N, n_buffer, C] in the wire dtype; valid/reset: [N]
        bool. Returns (new state, packed [N, W+1] int32: this step's
        committed tokens and, in the last column, their count; W is
        max_tokens_per_step, or beam_buf_tokens in beam mode)."""
        fe, cfg, scfg = self.frontend, self.cfg, self.scfg
        if chunks.dtype == torch.int16:
            # dequantize the wire codec before anything reads the samples
            chunks = chunks.float() * (1.0 / 32768.0)
        n = chunks.shape[0]

        # --- per-stream reset (masked state swap) ----------------------
        do_reset = reset | ~state.started
        dec = _select(do_reset, self._fresh_dec, state.decode)
        enc_state = _select(do_reset, learnable_states(self._net, "encoder", n),
                            state.enc_state)
        # on reset the sample carry is the reflect padding of the
        # incoming chunk's head: the prefix batch framing (center=True,
        # reflect) uses, so stream features equal batch features
        reflect = chunks[:, 0, 1 : self._sample_carry_len + 1].flip(1)
        sample_carry = _select(do_reset, reflect, state.sample_carry)
        mel_carry = _select(do_reset, torch.zeros_like(state.mel_carry),
                            state.mel_carry)
        primed = state.primed & ~do_reset
        if not self.beam:
            # fresh token buffers each step: greedy emissions are per
            # step (beam buffers hold the uncommitted tokens across steps)
            dec = dataclasses.replace(dec, y_buf=torch.zeros_like(dec.y_buf),
                                      y_len=torch.zeros_like(dec.y_len))

        # --- incremental frontend + per-frame encode/decode ------------
        # a stream's first frame after a reset is pipeline warmup (its
        # stacked window reaches before the signal start): each stream
        # skips exactly one frame through `primed`
        for b in range(chunks.shape[1]):
            stacked, sc_new, mc_new = self.frontend_step(
                sample_carry, mel_carry, chunks[:, b])
            # carries advance only for streams that received a chunk
            sample_carry = torch.where(valid[:, None], sc_new, sample_carry)
            mel_carry = torch.where(valid[:, None, None], mc_new, mel_carry)
            real = primed & valid
            enc_out, enc_new = self._net.encode(stacked, state=enc_state)
            enc_state = _tree_map(
                lambda a, b_: torch.where(real[:, None], a, b_),
                enc_new, enc_state)
            if self.beam:
                dec = beam_frame(self.fns, dec, enc_out[:, 0, :], real,
                                 blank=cfg.blank, max_expand=scfg.max_iters,
                                 lm_alpha=scfg.lm_alpha, early_exit=False)
            else:
                dec = decode_frame(self.fns, dec, enc_out[:, 0, :], real,
                                   blank=cfg.blank, max_iters=scfg.max_iters,
                                   early_exit=False)
            primed = primed | valid

        if self.beam:
            # margin: the most tokens a step can append between commits
            toks, lens, dec = _beam_committed_prefix(
                dec, force_margin=scfg.n_buffer * scfg.max_iters)
        else:
            toks, lens = dec.y_buf, dec.y_len
        new_state = StreamState(
            enc_state=enc_state, decode=dec, sample_carry=sample_carry,
            mel_carry=mel_carry, started=state.started | valid | reset,
            primed=primed,
        )
        packed = torch.cat([toks.to(torch.int32),
                            lens.to(torch.int32)[:, None]], dim=1)
        return new_state, packed

    def _step_in_place(self) -> None:
        """The step on the static buffers: state and packed output
        written in place (what the CUDA graph holds)."""
        new, packed = self.step_fn(self.state, self._chunks, self._valid,
                                   self._reset)
        for dst, src in zip(_leaves(self.state), _leaves(new)):
            dst.copy_(src)
        self._packed.copy_(packed)

    def _capture(self):
        """Capture the step once as a CUDA graph. Two runs on a side
        stream first (cuBLAS workspaces, lazy allocations): with every
        slot un-started and nothing valid they change nothing a real
        step reads (each slot resets at its first step)."""
        with torch.no_grad():
            self._chunks.zero_()
            self._flags.zero_()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._step_in_place()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # a capture stream of this card: torch.cuda.graph's default
            # one is made once, on whichever card was current then
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(self.device),
                                  capture_error_mode="thread_local"):
                self._step_in_place()
        torch.cuda.synchronize(self.device)
        return graph

    # ---- host <-> device ---------------------------------------------------

    def _encode_chunks(self, chunks) -> np.ndarray:
        """Apply the host side of the transfer codec (StreamingConfig.
        transfer_dtype): float32 PCM in, wire-dtype array out."""
        chunks = np.asarray(chunks)
        if self.scfg.transfer_dtype == "int16" and chunks.dtype != np.int16:
            chunks = np.clip(chunks * 32768.0, -32768.0, 32767.0).astype(np.int16)
        return np.ascontiguousarray(chunks, dtype=np.int16 if
                                    self._wire == torch.int16 else np.float32)

    def _new_stage(self, cap: int) -> _Stage:
        scfg = self.scfg
        return _Stage(cap, self.n, scfg.n_buffer, scfg.chunk_samples,
                      self._width, self._wire, self._pin)

    def _stage(self, k: int) -> _Stage:
        """A free staging buffer for a chain of k sub-steps; a new one,
        counted (`engine.stage.fresh`), when none is."""
        for st in self._stages:
            if st.cap >= k and st.free():
                return st
        tel.count("engine.stage.fresh")
        st = self._new_stage(max(k, CHAIN_DEPTHS[-1]))
        self._stages.append(st)
        return st

    def _count_chain(self, k: int, valid, masked) -> None:
        """Telemetry of one chain: its sub-steps, valid rows and the
        masked rows by cause (rows + masked = N * k); masked None: a
        caller's own mask (warm-up, step_batch), closed slots counted as
        inactive and open ones as empty."""
        valid = np.asarray(valid, bool)
        if masked is None:
            off = ~valid
            masked = {"inactive": int((off & ~self.active).sum()),
                      "empty": int((off & self.active).sum())}
        tel.count("engine.steps", k)
        tel.count("engine.rows", int(valid.sum()))
        for why in ("inactive", "empty", "short", "gated"):
            tel.count("engine.rows_masked." + why, masked.get(why, 0))

    def _run_chain(self, k: int, chunks, valid, reset,
                   masked: dict | None = None):
        """Run k steps in order, one graph replay each on the card.
        chunks: [k, N, n_buffer, C] PCM, encoded here into a staging
        buffer; valid/reset: [k, N] bool; masked: the masked rows by
        cause, for the telemetry. Nothing waits for the device: the
        returned outputs land on the host when their event passes."""
        with tel.span("engine.dispatch.encode", self._seq + 1):
            st = self._stage(k)
            st.wire[:k] = self._encode_chunks(chunks)
        return self._launch(k, st, np.asarray(valid, bool),
                            np.asarray(reset, bool), masked)

    def _launch(self, k: int, st: _Stage, valid, reset, masked=None):
        """Enqueue a chain of k steps whose wire PCM is in `st`: the flags
        into `st`, then per sub-step the input copies, the replay and the
        output copy into `st`."""
        if self.bundle.model is not self.model:
            raise RuntimeError(
                "libreasr_tpu_torch: the bundle's model changed (quantize?) "
                "after this StreamingEngine was built; build a new engine")
        self._seq += 1
        if not self._shard and tel.on():
            self._count_chain(k, valid, masked)
        if self._shards is not None:
            # every device's replays are enqueued before any is collected
            per = self.n // len(self._shards)
            chunks = st.wire[:k]
            parts = []
            for i, sh in enumerate(self._shards):
                rows = slice(i * per, (i + 1) * per)
                parts.append(sh._run_chain(k, chunks[:, rows], valid[:, rows],
                                           reset[:, rows]))
            self.replays = sum(sh.replays for sh in self._shards)
            self.steps += k
            return _Joined(parts, self._seq)
        cuda = self.device.type == "cuda"
        seq = self._seq
        with tel.span("engine.dispatch.stage", seq):
            fl = st.flags[:k]
            flags = fl.numpy()
            flags[:, 0] = valid
            flags[:, 1] = reset
            ch = st.chunks[:k]
            host = st.host[:k]
        # traced on the card: timed events around the chain, for the
        # card's idle gap before it
        timed = cuda and tel.on()
        start = prev = None
        t_enq = tid = 0
        with tel.span("engine.dispatch.enqueue", seq), torch.no_grad(), \
                _on_device(self.device):
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(self.device))
                t_enq, tid = tel.now(), threading.get_ident()
                prev = self._prev_done
            for j in range(k):
                # sub-step j's inputs into the step's static buffers; on
                # the card these are stream-ordered async copies
                self._chunks.copy_(ch[j], non_blocking=True)
                self._flags.copy_(fl[j], non_blocking=True)
                if cuda:
                    self._graph.replay()
                    self.replays += 1
                else:
                    self._step_in_place()
                self.steps += 1
                host[j].copy_(self._packed, non_blocking=True)
            done = None
            if cuda:
                done = torch.cuda.Event(enable_timing=timed)
                done.record(torch.cuda.current_stream(self.device))
        self._prev_done = done if timed else None
        out = _Outputs(host, done, seq, start, prev, t_enq, tid)
        st.user, st.done = weakref.ref(out), done
        return out

    def replay_captured(self, k: int) -> None:
        """Replay the captured step k times on the inputs the last step
        loaded: the device side of k steps, without their input and
        output copies. Nothing waits for the device. Only on the card."""
        if self._shards is not None or self._graph is None:
            raise RuntimeError("libreasr_tpu_torch: replay_captured needs the "
                               "engine's CUDA graph (one card, a bundle on cuda)")
        self._prev_done = None  # no idle gap across these replays
        with torch.no_grad(), _on_device(self.device):
            for _ in range(k):
                self._graph.replay()
                self.replays += 1
                self.steps += 1

    def _step_device(self, chunks, valid=None, reset=None) -> _Outputs:
        """Launch one step; returns its outputs ([1, N, K+1] once done).
        No host sync. chunks: [N, n_buffer, chunk_samples]."""
        n = self.n
        valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
        reset = np.zeros(n, bool) if reset is None else np.asarray(reset, bool)
        return self._run_chain(1, np.asarray(chunks)[None], valid[None],
                               reset[None])

    def step_batch(self, chunks: np.ndarray, valid=None, reset=None):
        """Advance all streams. chunks: [N, n_buffer, chunk_samples].
        Returns (tokens [N, K], token counts [N]): this step's emissions
        per stream."""
        with tel.span("engine.dispatch", self._seq + 1):
            out = self._step_device(chunks, valid, reset)
        packed = self._collected(out)[0]
        return packed[:, :-1], packed[:, -1]

    def _collected(self, out) -> np.ndarray:
        """A chain's outputs once landed, for the callers that wait at
        once (step_batch, warm-up), under the collect spans."""
        with tel.span("engine.collect", out.seq):
            with tel.span("engine.collect.wait"):
                out.wait()
            return out.numpy()

    # ---- serving-facing slot API -----------------------------------------

    def open_slot(self) -> int:
        with tel.span("engine.open_slot") as sp:
            for i in range(self.n):
                if not self.active[i]:
                    if sp is not None:
                        sp.id = i
                    self.active[i] = True
                    self._head[i] = self._tail[i] = 0
                    self.emitted[i] = []
                    self.outbox[i] = []
                    self.silence_ms[i] = 0
                    self._eos_done[i] = False
                    self._flushed[i] = False
                    self._pending_reset_arr[i] = True
                    self._reset_epoch[i] += 1  # invalidate in-flight collects
                    self._inflight[i] = 0  # fresh stream: old steps are stale
                    return i
        raise RuntimeError("no free stream slots")

    def close_slot(self, slot: int):
        with tel.span("engine.close_slot", slot):
            self.flush_slot(slot)
            self.active[slot] = False

    def flush_slot(self, slot: int):
        """Beam mode: commit the best beam's uncommitted tail when the
        stream ends, cut at EOS, into `emitted` and the outbox (so that
        the wire sees it too), and mark the slot for reset. Greedy
        emissions are committed every step: nothing to do.

        The tail is read from the state on the host, which waits for
        every replay enqueued so far. A replay in which this slot is not
        valid leaves its beam state as it was, so those are harmless;
        but the slot's own dispatched steps must have been collected
        first, or their committed tokens would land after the tail:
        with any in flight this raises."""
        with tel.span("engine.flush_slot", slot):
            self._flush(slot)

    def _flush(self, slot: int):
        if not self.beam or self._eos_done[slot] or self._flushed[slot]:
            return
        if self._inflight[slot]:
            raise RuntimeError(
                f"flush_slot({slot}): {int(self._inflight[slot])} dispatched "
                "step(s) of this slot are not collected yet")
        self._flushed[slot] = True
        owner, row = self, slot
        if self._shards is not None:
            owner, row = divmod(slot, self.n // len(self._shards))
            owner = self._shards[owner]
        beam = owner.state.decode
        with tel.span("engine.flush_slot.read", slot):
            best = int(torch.argmax(beam.scores[row]))
            n_rest = int(beam.y_len[row, best])
            ids = beam.y_buf[row, best, :n_rest].tolist() if n_rest > 0 else []
        if n_rest > 0:
            eos = getattr(self.bundle.lang, "eos", None)
            if eos is not None and eos in ids:
                ids = ids[: ids.index(eos)]
                self._eos_done[slot] = True
            if ids:
                self.emitted[slot].extend(ids)
                self.outbox[slot].append(self.bundle.lang.denumericalize(ids))
            # the next step of this slot starts from a fresh beam state
            self._pending_reset_arr[slot] = True

    @property
    def _pending_reset(self):
        return self._pending_reset_arr

    @property
    def samples_per_step(self) -> int:
        return self.scfg.chunk_samples * self.scfg.n_buffer

    @property
    def sample_buf(self):
        """Read-only per-slot views of the buffered PCM (tests,
        debugging). The storage is the [N, cap] ring matrix."""
        return [self._buf[i, self._head[i] : self._tail[i]]
                for i in range(self.n)]

    def _fill(self):
        return self._tail - self._head

    def _windows(self) -> np.ndarray:
        """[N, cap - need + 1, need] view of the ring: [i, h] is the step
        of samples slot i holds from offset h on."""
        b, need = self._buf, self.samples_per_step
        return np.lib.stride_tricks.as_strided(
            b, (b.shape[0], b.shape[1] - need + 1, need),
            (b.strides[0], b.strides[1], b.strides[1]), writeable=False)

    def append_samples(self, slot: int, pcm: np.ndarray):
        """Buffer float32 PCM for a slot: with the int16 wire the codec
        (StreamingConfig.transfer_dtype, as `_encode_chunks` applies it)
        runs here, on these samples, into the ring."""
        with tel.span("engine.append", slot):
            pcm = np.asarray(pcm, np.float32)
            t, n = int(self._tail[slot]), len(pcm)
            if t + n > self._buf.shape[1]:
                h = int(self._head[slot])
                if t - h + n <= self._buf.shape[1]:
                    # compact: slide the unread tail to the front (.copy():
                    # the ranges may overlap)
                    self._buf[slot, : t - h] = self._buf[slot, h:t].copy()
                else:
                    # a slot outran the consumer: grow every row
                    tel.count("engine.ring_grows")
                    cap = self._buf.shape[1]
                    while t - h + n > cap:
                        cap *= 2
                    nb = np.zeros((self.n, cap), self._buf.dtype)
                    nb[:, : self._buf.shape[1]] = self._buf
                    self._buf = nb
                    self._buf[slot, : t - h] = self._buf[slot, h:t].copy()
                self._tail[slot] = t = t - h
                self._head[slot] = 0
            dst = self._buf[slot, t : t + n]
            if dst.dtype == np.int16:
                x = pcm * np.float32(32768.0)
                np.clip(x, -32768.0, 32767.0, out=x)
                np.copyto(dst, x, casting="unsafe")  # truncates, as astype
            else:
                dst[...] = pcm
            self._tail[slot] = t + n

    def ready_slots(self):
        need = self.samples_per_step
        return list(np.nonzero(self.active & (self._fill() >= need))[0])

    def step_dispatch(self):
        """Phase 1 of a coalesced step: consume every full buffered chunk
        and launch the step without reading its outputs. Returns a
        pending record (or None if nothing is ready); the caller may
        dispatch the next step before collecting this one."""
        scfg = self.scfg
        need = self.samples_per_step
        with tel.span("engine.dispatch", self._seq + 1):
            with tel.span("engine.dispatch.gather"):
                # a slot whose in-flight steps may cross its silence
                # threshold waits for their collect: the auto-reset they
                # would set has to apply before the slot steps again
                step_ms = scfg.chunk_ms * scfg.n_buffer
                gated = (self._inflight > 0) & (
                    self.silence_ms + self._inflight * step_ms
                    >= scfg.reset_thresh_ms)
                has = self._fill() >= need
                valid = self.active & has & ~gated
                if not valid.any():
                    return None
                rows = np.nonzero(valid)[0]
                st = self._stage(1)
                cv = st.wire[0].reshape(self.n, need)
                head = self._head[rows]
                cv[rows] = self._windows()[rows, head]
                cv[~valid] = 0
                self._head[rows] = head + need
                reset = self._pending_reset & valid
            masked = None
            if tel.on():
                act = self.active
                masked = {"inactive": int((~act).sum()),
                          "empty": int((act & ~has).sum()),
                          "gated": int((act & has & gated).sum())}
            out = self._launch(1, st, valid[None], reset[None], masked)
            self._eos_done[reset] = False
            # a reset invalidates any step dispatched before it
            self._reset_epoch[reset] += 1
            self._pending_reset_arr[valid] = False
            self._inflight[valid] += 1
            return (out, valid, self._reset_epoch.copy())

    def _silence_gated(self, i: int) -> bool:
        """True when slot i's worst-case silence, counting every in-flight
        sub-step as silent, has reached the auto-reset threshold."""
        if self._inflight[i] == 0:
            return False
        step_ms = self.scfg.chunk_ms * self.scfg.n_buffer
        worst = int(self.silence_ms[i]) + int(self._inflight[i]) * step_ms
        return worst >= self.scfg.reset_thresh_ms

    def backlog_depth(self) -> int:
        """Max full chunk-steps buffered across active slots: the serving
        stepper's chaining signal."""
        need = self.samples_per_step
        depths = np.where(self.active, self._fill() // need, 0)
        return int(depths.max(initial=0))

    def step_dispatch_chained(self, k: int):
        """Consume up to k buffered chunk-steps per slot in one dispatch
        (k replays of the step's graph). Slots with shorter backlogs ride
        along (valid masked per sub-step); emissions match k sequential
        steps exactly. Returns a pending record for step_collect, or None
        when nothing is ready."""
        scfg = self.scfg
        need = self.samples_per_step
        with tel.span("engine.dispatch", self._seq + 1):
            with tel.span("engine.dispatch.gather"):
                depth = self._fill() // need
                ahead = np.where(self.active, np.minimum(depth, k),
                                 0).astype(np.int64)
                # resets apply only at a chain's first sub-step, so each
                # slot's depth is capped at the steps until its silence
                # threshold could cross (in-flight sub-steps counted as
                # silent): the crossing then falls on the chain's last
                # sub-step at the earliest, and its reset applies at the
                # next dispatch, the sequential cadence
                step_ms = scfg.chunk_ms * scfg.n_buffer
                sil = self.silence_ms + self._inflight * step_ms
                m = -(-(scfg.reset_thresh_ms - sil) // step_ms)
                avail = np.minimum(ahead, np.maximum(m, 0))
                if not avail.any():
                    return None
                valid = np.arange(k)[:, None] < avail[None, :]       # [k, N]
                st = self._stage(k)
                cv = st.wire[:k].reshape(k, self.n, need)
                win, head = self._windows(), self._head
                for j in range(k):
                    rows = np.nonzero(valid[j])[0]
                    cv[j, rows] = win[rows, head[rows] + j * need]
                cv[~valid] = 0
                self._head += avail * need
                # a slot's backlog is contiguous, so its first sub-step is
                # j=0: pending resets apply there only
                v0 = valid[0]
                reset = np.zeros((k, self.n), bool)
                reset[0] = self._pending_reset & v0
            masked = None
            if tel.on():
                act, some = self.active, self.active & (depth > 0)
                masked = {"inactive": k * int((~act).sum()),
                          "empty": k * int((act & (depth == 0)).sum()),
                          "short": int((k - ahead)[some].sum()),
                          "gated": int((ahead - avail).sum())}
            out = self._launch(k, st, valid, reset, masked)
            r0 = reset[0]
            self._eos_done[r0] = False
            self._reset_epoch[r0] += 1
            self._pending_reset_arr[v0] = False
            self._inflight += avail
            return (out, valid, self._reset_epoch.copy())

    def step_collect(self, pending) -> None:
        """Phase 2: wait for a dispatched step's outputs and distribute
        each stepped slot's new text into its outbox. Takes single-step
        ([N] valid) and chained ([k, N] valid) records; chained sub-steps
        distribute in order."""
        out, valid, epochs = pending
        with tel.span("engine.collect", out.seq):
            with tel.span("engine.collect.wait"):
                out.wait()
            packed = out.numpy()
            with tel.span("engine.collect.distribute"):
                sub = (valid.sum(axis=0) if valid.ndim == 2
                       else valid.astype(np.int64))
                # a reopened slot's new occupant owns the zeroed in-flight
                # count: an old occupant's collect must not decrement it
                sub = np.where(epochs == self._reset_epoch, sub, 0)
                self._inflight = np.maximum(self._inflight - sub, 0)
                if valid.ndim == 2:
                    for j in range(valid.shape[0]):
                        if valid[j].any():
                            self._distribute(packed[j], valid[j], epochs)
                    return
                self._distribute(packed[0], valid, epochs)

    def _distribute(self, packed, valid, epochs) -> None:
        toks, lens = packed[:, :-1], packed[:, -1]
        scfg = self.scfg
        eos = getattr(self.bundle.lang, "eos", None)
        live = valid & (epochs == self._reset_epoch)
        # Python touches only slots that emitted (or hit EOS)
        emitting = live & (lens > 0) & ~self._eos_done
        eos_now = np.zeros(self.n, bool)  # latched this step: silence
        for i in np.nonzero(emitting)[0]:  # counter untouched
            ids = list(toks[i, : lens[i]])
            if eos is not None and eos in ids:
                # EOS ends the utterance: truncate and latch
                ids = ids[: ids.index(eos)]
                self._eos_done[i] = True
                eos_now[i] = True
                emitting[i] = False
            if ids:
                self.emitted[i].extend(ids)
                self.outbox[i].append(self.bundle.lang.denumericalize(ids))
        self.silence_ms[emitting] = 0
        silent = live & ~emitting & ~eos_now
        self.silence_ms[silent] += scfg.chunk_ms * scfg.n_buffer
        crossed = silent & (self.silence_ms >= scfg.reset_thresh_ms)
        self._pending_reset_arr[crossed] = True
        self.silence_ms[crossed] = 0

    def step_ready(self) -> bool:
        """Run one step over every slot with a full buffered chunk and
        distribute the new text. Returns whether a step ran."""
        pending = self.step_dispatch()
        if pending is None:
            return False
        self.step_collect(pending)
        return True

    def warmup(self, iters: int = 2, chain_depths: tuple = ()) -> None:
        """Run the step before traffic arrives (all slots valid, zeros),
        keeping the state: slot opens mark a pending reset, so each
        slot's first real step re-initializes it. chain_depths: also run
        a chained dispatch of each depth, nothing valid (the state is
        untouched)."""
        nb, c = self.scfg.n_buffer, self.scfg.chunk_samples
        for _ in range(max(iters, 1)):
            self.step_batch(np.zeros((self.n, nb, c), np.float32))
        for k in chain_depths:
            k = int(k)
            with tel.span("engine.dispatch", self._seq + 1):
                out = self._run_chain(k, np.zeros((k, self.n, nb, c), np.float32),
                                      np.zeros((k, self.n), bool),
                                      np.zeros((k, self.n), bool))
            self._collected(out)

    def drain(self, slot: int) -> str:
        """Pop this slot's undelivered text."""
        text = "".join(self.outbox[slot])
        self.outbox[slot] = []
        return text

    def feed(self, slot: int, pcm: np.ndarray) -> str:
        """Feed pcm into a slot; runs steps for every complete chunk
        across all slots; returns newly decoded text for this slot
        (including text from steps driven by other slots)."""
        self.append_samples(slot, pcm)
        while self._tail[slot] - self._head[slot] >= self.samples_per_step:
            self.step_ready()
        return self.drain(slot)

    def finish_slot(self, slot: int) -> str:
        """Stream end: zero-pad the sub-chunk sample remainder, run the
        final step(s) and return everything undelivered."""
        with tel.span("engine.finish_slot", slot):
            if not self.active[slot]:
                return self.drain(slot)
            need = self.samples_per_step
            rem = self._tail[slot] - self._head[slot]
            if rem > 0 and rem % need:
                self.append_samples(slot, np.zeros(need - rem % need,
                                                   np.float32))
            while self._tail[slot] - self._head[slot] >= need:
                self.step_ready()
            self.flush_slot(slot)
            return self.drain(slot)

    def transcript(self, slot: int) -> str:
        return self.bundle.lang.denumericalize(self.emitted[slot])
