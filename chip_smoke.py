#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libreasr_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (any failure raises and exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the CUDA sources (csrc/*.cu) with nvcc;
  3. kernel: the LSTM sequence kernel against its plain PyTorch twin on
     the card, with and without the streamed cell state, at the golden
     and the full-width shapes, a batch of 300 (one launch) and of 600
     (two batch slices), and an H whose slice of R is read from L2
     (tolerance KERNEL_TOL); one cooperative launch per call and slice,
     and a rerun on the same inputs gives the same bits;
  4. golden: the committed golden bundle must transcribe its 8 clips
     exactly, at 1 s (scan path) and zero-padded to 3 s (kernel path);
  5. full width: a seeded random model of config/base.yaml (6-layer
     LSTM encoder, H 1024, V 2048, bf16 compute) runs the main path:
     transcribe_batch on 16 ragged 6 s clips and encode without lengths,
     with the launch counts read around that run (one launch of kernel
     B, or A, per encoder layer); its encoder output
     is held against the same model on the CPU (tolerance ENC_TOL), and
     the path is timed;
  6. kernel_int8: the int8 LSTM sequence kernel against its twin on the
     card, with pack semantics (lengths 0 and T), at the shapes of 3 up
     to N 64, one H off 64 (98), a batch of 300 (one launch), of 600 (two
     batch slices) and an H whose slice of R is read from L2 (4096): bit
     for bit (and within INT8_TOL), one cooperative launch per call and
     slice, and a rerun gives the same bits; the port's int8_matmul on
     the card equals its CPU result bit for bit; the kernel's quantization
     of h (a reciprocal and one exact correction) equals the IEEE
     quotient's on 2**32 seeded pairs;
  7. golden_int8: the golden bundle quantized by the port, and that
     bundle saved by the port and reloaded, each transcribe the 8 clips
     exactly at 1 s (no int8 kernel launch) and padded to 3 s (one
     launch per encoder layer, 2);
  8. golden_bpe: the BPE golden bundle transcribes its 8 clips exactly,
     at 1 s and padded to 3 s;
  9. full_width_int8: the model of 5, quantized by the port, runs
     transcribe_batch on the same clips: 6 int8 kernel launches (one per
     encoder layer) and none of the bf16-R kernel; its encoder output is held against the
     same int8 model on the CPU (tolerance INT8_ENC_TOL), and the path
     is timed;
 10. kernel_joint: the joint log-prob kernels F, G, H against their twins
     on the card, with bf16 and float32 W_out, at a golden-like shape,
     one with U1 > 96 and every dimension off its tile, and the main
     path's (N 16, T 49, U1 41, J 1024, V 2048), with ragged lengths,
     labels padded with -1 past each length and a label equal to the
     blank (tolerances JOINT_*); G and H take F's lse, and each twin the
     same lse as its kernel; with bf16 W_out, F, G and H also across
     chunk boundaries (a small scratch cap, at a mid shape and at the
     main one; no lattice here has rows a multiple of the 128-row tile),
     F against its chunked twin and the same bits as in one chunk; F, G
     and H run twice on the same inputs give the same bits; then
     rnnt_loss_fused on the kernels against its chunked path on the card
     (loss relative error < 1e-3, every gradient's cosine > 0.999);
 11. kernel_train: the LSTM training kernels D (forward) and E (backward)
     against their twins on the card, bf16 and float32 R, at the main
     path's shape (N 16, T 49, H 1024), a golden-like one (N 3, T 37,
     H 96), a ragged one (N 13, H 100: off the batch tile and the vector
     path), the small model's H 64 and T 1 (tolerances TRAIN_*); D and E
     are one cooperative launch a call, and a rerun of D gives the same
     bits; E also at N 300, D at N 600, one launch per batch slice; D at
     an H whose slice of R is read from L2 (2048);
 12. train_full_width: the training main path, 4 Learner steps of the
     config/base.yaml model as written (bf16 compute, the encoder's LSTM
     layers on kernels D and E; accumulation over 2 batches and an
     8-step schedule) on 16 ragged 2.5-4 s clips: losses finite, D 6 and
     E 6 launches a step, F/G/H once a step each, A/B/C never,
     parameters updated on steps 2 and 4 only; step time and its split,
     peak memory;
 13. train_scan_route: the earlier path, the encoder on its scan cells
     (use_pallas_train false), 3 steps from the same weights and batches:
     its first step's loss and every gradient against the D/E route's
     (TRAIN_ROUTE_*), and its step time;
 14. train_small_cuda_vs_cpu: 2 steps of a small float32 model (float32 R
     on kernels D and E on the card, their twins on the CPU) from the same
     weights and batches (tolerances SMALL_*);
 15. train_cli: `python -m libreasr_tpu_torch.train` (its main, in this
     process) at full width on a corpus of noise WAVs written here: 2
     steps with an eval and a bundle export, then a resume to step 3;
     the bundle reloads on cuda and transcribes; then 2 steps with
     --chain-steps 2 (one chain) against 2 single steps: the same
     parameters bit for bit;
 15c. options_full_width: the options the JAX config accepts, at full
     width on the clips of 5: delta features (feature_sz 2560; the card's
     features against the CPU's within FRONTEND_TOL; transcribe_batch, B
     6 launches, median of 7), an LN encoder (scan cells: no A/B launch)
     and the same bundle int8 (no C launch), an add-joint bundle in
     float32 (transcribe_batch and transcribe_beam K 4, B 6 launches
     each; sharpened as in 22, greedy and beam on the card's encoder
     output equal the CPU's on every row), a StreamingEngine of N 64 on
     an LN + add bundle (4 graph replays against the uncaptured step,
     replay ms) and Joint.int8_step on add raising;
 15d. options_train_full_width: on the train batches of 12, 3 steps each
     of ranger_adabelief, lamb and apollo (D, E 6 launches, F, G, H 1 a
     step), 3 steps with deltas, an LN encoder and the add joint (the
     lattice loss on the scan cells, no kernel), 2 AdaHessian steps on
     the scan route (step ms, peak memory), and one AdaHessian step on
     the D/E route raising its ValueError;
 15a. train_tone_stream: the port's tone recipe
     (libreasr_tpu_torch.scripts.train_tone_stream) in this process at
     full width: base.yaml as the recipe sets it (layer norms, carries
     at 0.25, no augmentation, V 2048), a BPE tokenizer of 64 trained by
     the port, the ladder from the sampled histogram (3 buckets, bs 16),
     100 steps of the streamed corpus with dev evals at 50 and 100, the
     best-WER export, then the held-out test split greedy and with beam
     search (K 4): step ms, the host's wait for each batch, dev and test
     WER/CER (test by length), eval ms, launches, peak memory; every loss
     finite, the median loss of the last 50 steps below that of the first
     20, D, E, F, G, H launched in training and B in the evals, the
     bundle reloads on cuda with the trained tokenizer, and both test
     evals score every row the test split emits;
 15b. evaluate_wer: make_tone_corpus writes 16 test WAVs and their CSV,
     and `libreasr_tpu_torch.scripts.evaluate_wer --beam 4` scores them
     with that bundle (WER and WER[...] lines); --use-lm raises;
 16. joint_timing and train_kernel_timing (F's, G's and H's launches each
     by device time under torch.profiler): F, G, H and D, E timed at the
     main path's shapes beside their twins and, for D and E, cuDNN's bf16
     LSTM in training (forward, backward) as the yardstick; for H also
     torch.matmul of its two bf16 products alone, as context;
 17. streaming_golden: the golden clips through the StreamingEngine on the
     card (8 slots, 80 ms chunks), char, char int8 (quantized by the
     port, saved and reloaded) and BPE: exact; every step one CUDA graph
     replay, and no kernel launch on the step path (T = 1: scan cells);
 18. streaming_full_width: the model of 5 (bf16 compute, seeded) in
     engines of N 64 and N 512 slots (int16 transfer, the server's
     default): the first 8 steps as graph replays against the
     uncaptured step function called on a copy of the state (tokens
     equal; both timed), then 6 s ragged noise clips in 80 ms chunks
     through step_dispatch / step_collect, pipelined, 5 passes: the
     step's host ms (median of the passes' medians, p90), the device ms
     of a replay (CUDA events), the real-time share (step ms / 80),
     tokens per chunk and peak memory;
 18a. flops: no timed run of its own: the MFU of 12's step median
     (libreasr_tpu_torch/flops.py's train_step_flops at N 16, T 49, U 40,
     over the card's bf16 peak) beside train_step_ceiling's speed of
     light and its breakdown, and of 18's replays at N 64 and N 512
     (decode_step_flops, 1 + the tokens a chunk evaluations a frame; the
     FLOPs of the graph's max_iters rounds beside); the table gives the
     card 989e12 bf16 FLOP/s, and every bound helper of the kernels line
     reads that table (each halves with its peaks doubled);
 19. serving: ASRServicer in this process (no gRPC socket) with the golden
     bundle: unary Transcribe exact on a clip padded to 3 s, kernel B in
     2 launches (C for the port-quantized bundle), and two concurrent
     TranscribeStream calls exact; then the model of 5 behind a servicer
     built from its config's stream block (64 slots): a unary 6 s clip
     (B once per encoder layer), and 64 concurrent TranscribeStream
     generators fed at real-time pace for 6 s each, with the partial
     latency (arrival of a transcript minus the send of the latest
     chunk) p50/p90 and the overrun (stream close minus last send), as
     scripts/bench_serving.py defines them;
 20. golden_beam: the golden beam and LM cases on the card, exact: char
     beam (K 3), BPE beam + LM (K 3, alpha 0.2, beta 0.6) and BPE greedy
     + LM offline at 1 s (no kernel launch) and padded to 3 s (B twice),
     through engines (one graph replay a step; the beam flush of an
     unpadded stream) and through servicers (unary and streams);
 21. full_width_beam: the model of 5 with config/base.yaml's LM (6
     layers, 1024 wide, seeded) on the clips of 5: transcribe_beam (K 4,
     3 rounds) without and with the LM, transcribe_batch with greedy LM
     fusion, and int8 transcribe_beam, each counted (B 6 launches a
     call, C 6 for int8) and timed (median of 7, the spread, RTF, peak
     memory, tokens a frame);
 22. full_width_beam_emitting: that model with its joint sharpened
     (_make_emitting; seeded, the joint is near uniform and no beam
     emits): tokens a frame, transcribe_beam with and without the LM
     timed, then beam search on the card's encoder output against the
     same model and LM on the CPU (rows whose tokens match, at least
     BEAM_ROWS_EQUAL; the largest score gap, at most BEAM_SCORE_GAP);
 23. streaming_full_width_beam: the sharpened model and LM in an engine
     of 64 slots, K 4, 10 rounds a frame, alpha 0.2, int16 transfer:
     graph replays against the uncaptured step (tokens equal, decode
     state within 1e-6, commits and forced commits counted), then 5
     pipelined passes: step host ms, a replay's device ms, real-time
     share, peak memory, tokens committed and flushed, no kernel launch;
 24. serving_beam: the sharpened model behind ASRServicer(beam 4, LM,
     alpha 0.2, beta 0.6): a unary 6 s clip (B 6 launches) and 64
     streams paced at real time for 6 s each: partial latency p50/p90
     against BASELINE.md's < 300 ms p50 bar, and overrun.
 25. data_tools (host): a LibriSpeech-shaped tree of 24 16-bit FLAC files
     (mono and stereo, every stereo mode, LPC and FIXED subframes, written
     by tests/helpers/flac_writer.py) and, where the host has lame and
     mpg123, a common-voice tree of 8 MP3s, through the port's
     create_dataset (a process pool of 2), split, the CSV builder and
     inspect's statistics: every FLAC decodes to its source samples
     exactly and its STREAMINFO MD5 verifies; files, rows, seconds and
     whether the MP3/Ogg libraries are there;
 26. train_ctc_full_width: base.yaml with model.name CTCModel (features
     1280, d 128, 8 heads, 8 layers, V 2048) trained by CTCLearner (adamw)
     on the batches of 12 (N 16, T 49, labels cut to 16), 8 steps: losses finite and
     falling, no kernel launch, step ms and split, peak memory; the
     greedy CTC evaluate on a batch; one small step card against CPU
     (CTC_*); the training CLI with model.name CTCModel on the data_tools
     CSVs, 2 steps ([ctc] epoch, [train] done);
 27. train_lm_full_width: the port's train_lm at base.yaml's LM width
     (1024, 1024, 6 layers, V 2048), bs 768, seq len 64, 20 steps on the
     tone corpus's sentences: the valid loss falls, no kernel launch, step
     ms, peak memory; the saved lm.msgpack in a bundle loads through
     from_bundle with log-probs equal to the trained model's; one small
     step card against CPU (LM_*);
 28. soak: tests/test_soak.py's engine soak on the card (golden char
     bundle, 4 slots, graph replays): 8 repetitions of "hello world", a
     silent slot (at most 12 tokens), a slot closed mid-utterance, the
     sample buffers under a chunk and the slots recycled; chunks,
     seconds and host ms a step.
 28a. recipe_960: the port's LibriSpeech-960 recipe
     (libreasr_tpu_torch.scripts.train_960) at full width (base.yaml as
     written) on a FLAC tree in LibriSpeech's layout written here (48
     train, 8 dev and 8 test clips of 2-2.8 and 4.4-5.4 s noise): CSVs, a BPE tokenizer
     of 64, a 2-bucket ladder, 8 steps with an eval every 4, the first
     launch of the training CLI ending at step 4 and raising, the
     recipe's relaunch resuming there; D, E 6 and F, G, H 1 launches a
     step, B in the evals, the bundle reloads on cuda and transcribes,
     the test split's WER printed; step ms, the run's seconds;
 29. dist_train_full_width: an NCCL group of one rank (tcp://127.0.0.1,
     a free port) and Learner(mesh=make_mesh(data=1)) at base.yaml's
     width on train_full_width's batches (accumulation 1), 3 steps
     against the plain Learner from the same seed: the loss and every
     parameter and batch statistic equal bit for bit (an axis of one
     rank has no group, so the step exchanges nothing, as GSPMD's;
     scripts/multi_gpu_check.py runs the collectives across cards),
     D, E 6 and F, G, H 1 launches a step
     on both; step ms of both, the NCCL version; then a checkpoint saved
     under the mesh restores into a plain Learner, whose next step
     equals the mesh Learner's bit for bit;
 30. train_cli_dist: the CLI on train_cli's corpus with --dist-coordinator
     127.0.0.1:PORT --dist-procs 1 --dist-pid 0 --steps 2: NCCL starts
     inside it, one process builds no mesh, and the run ends as the plain
     CLI's (eval, `[train] done:`) with the parameters and done line of
     the plain 2-step run of 15 bit for bit; then a resume to step 3;
 31. streaming_mesh: engines of 64 over the mesh devices=[cuda:0, cuda:0]
     (two graphs of 32; [cuda:0, cuda:1] where two cards are visible)
     on the same ragged int16 streams: greedy in bf16 against two
     engines of 32 (the slots that differ from an engine of 64 logged,
     with the state leaves where an engine of 32 first parts from it
     and the step's products over 64 streams against their first 32
     alone: the frontend's float32 DFT, the recurrent product in bf16
     and float32, each with its differing elements and GEMM kernels;
     near-tied bf16 argmaxes part on such differences), greedy and
     beam K 4 + LM on the
     sharpened joint of 22 in float32 against the engine of 64: tokens
     equal on every slot, graph replays only, replay ms of each; then
     ASRServicer on a mesh engine of the golden char bundle: two streams
     exact;
 32. import_reference: a seeded reference-layout state_dict at base.yaml's
     shapes and a youtokentome model of 2048 ids, packed as the
     reference's release tar.gz and imported by
     libreasr_tpu_torch.scripts.import_reference on the card:
     transcribe_batch on the clips of 5 launches B 6 times, the encoder
     output is within ENC_TOL of the same bundle on the CPU, and the
     bundle reloaded transcribes the same.
 33. bench: the port's benchmark harness (libreasr_tpu_torch/bench.py and
     libreasr_tpu_torch/scripts/bench_*.py) at full width, with fewer
     repetitions: the golden BPE bundle's latched emission rate on the
     card; the bisection (calibrate_blank_bias) of the proxy (base.yaml
     in bf16, seed 0) landing on the pinned BLANK_BIAS at a rate at or
     above it; a fresh engine's rate at that bias, and biases set after
     its capture (0, 8, 0) changing its replays' emissions; time_engine at N 64 and
     512, device_resident_rate at N 512, device_step_time at N 256 and
     at N 512 at the pinned bias and at 0, alternated, the two equal
     within BENCH_BIAS_REL_TOL (time_engine's step over the replay at
     N 512);
     bench_serving --transport inproc, 64 streams of 6 s at its default
     blank bias 0 (flooding: at the pinned bias fresh streams emit no
     text, so there would be no partial to time); bench_train_step (D, E 6 and F, G, H 1 launches a step, none
     of A-C), bench_step_parts and bench_loss_parts at k 4, reps 3; and
     bench_pallas --quick and --train --quick: every reading finite.
Then the script's own wall seconds (every phase, the build included;
and those of 15a-15b, of 25-28, of 28a, of 29-32 and of 33),
one JSON line with every kernel's numbers (B and C also with their
launches a transcribe_beam), and as the last line
{"ok": true, "device": {...}}.

Exits non-zero without a result when CUDA is unavailable or when the
port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "fixtures", "golden")
GOLDEN_TEXTS = [
    "yes", "no", "hello world", "stop now",
    "go left", "turn right", "one two", "three four",
]
# kernel vs twin: the two differ only in float32 summation order over
# the H-long dot products (bf16 x bf16 products are exact in float32).
# That difference, of a few float32 ulps, can flip the bf16 rounding of
# an element of h at the next step; one flip moves h by one bf16 ulp
# (2**-8 relative) and v by |R| times that, ~4e-4 at H = 100 with
# entries of R ~ 1/sqrt(H). A flip moves every gate of its row, which
# seeds further flips, so at H = 1024 over tens of steps most elements
# carry a difference of ~1e-5 while a few reach ~1e-3 (measured on an
# H100: mean 3e-5, max 9e-4 at N 16, T 74). A wrong gate, index or
# state hand-over shows as errors of 1e-1 and more.
KERNEL_TOL = 4e-3
KERNEL_TOL_MEAN = 2e-4
# full-width encoder, cuda vs cpu on the same features: the same bf16
# flips, seeded by summation order in the projections and the
# recurrence, through 6 layers (measured on an H100: max 8e-5, mean 5e-6)
ENC_TOL_MAX = KERNEL_TOL
ENC_TOL_MEAN = KERNEL_TOL_MEAN
# int8 kernel vs its twin: both compute the pre-activation v bit for
# bit alike from the same h (IEEE quotient for the scale, round half to
# even, exact int32 sums, no FMA contraction in the epilogue). They
# differ in expf/tanhf against PyTorch's own, by an ulp or so of h. Such
# a difference can move h/hscale across a .5 boundary at the next step
# and flip one element of hq by 1, which moves v by hscale * |R| (~2e-4
# at H 1024, up to ~1e-3) and then spreads through the row as the bf16
# flips of kernels A and B do, so the same bound applies. A wrong gate,
# scale or state hand-over shows as errors of 1e-1 and more.
INT8_TOL = KERNEL_TOL
INT8_TOL_MEAN = KERNEL_TOL_MEAN
# full-width int8 encoder, cuda vs cpu: the same flips through 6 layers
# (int8_matmul, the input projections, is bit-exact on both devices)
INT8_ENC_TOL_MAX = KERNEL_TOL
INT8_ENC_TOL_MEAN = KERNEL_TOL_MEAN
# training kernels D, E vs their twins. D is kernel B's recurrence with
# the pre-activations streamed out: with bf16 R the same bf16 flips of h
# spread through R (measured on an H100 at N 16, T 49, H 1024: max 9.6e-4
# on v); with float32 R nothing is rounded and the two differ in
# summation order alone (~1e-7). E rounds dv to bf16 before dv @ R^T, so
# a summation-order difference in one step's dh can flip a bf16 rounding
# of dv at the next, which spreads through R^T the same way (measured:
# 1.1e-3 of the largest dh0). E is held relative to each output's
# largest entry: its values scale with the cotangents. A wrong gate,
# index or reverse-time hand-over shows as errors of 1e-1 and more.
TRAIN_FWD_TOL = KERNEL_TOL
TRAIN_FWD_TOL_MEAN = KERNEL_TOL_MEAN
TRAIN_BWD_TOL = 4e-3
TRAIN_BWD_TOL_MEAN = 2e-4
# (N, T, H): golden-like, ragged (N off the batch tile, H off the vector
# path), the small model's width, one step, the main path's (last)
TRAIN_KERNEL_CASES = [(3, 37, 96), (13, 37, 100), (4, 49, 64), (16, 1, 1024),
                      (16, 49, 1024)]
# E at a batch above one launch's epilogue owners (2 slices of bf16 R)
TRAIN_BWD_SLICED_CASE = (300, 13, 1024)
# D alone: a batch above one launch's epilogue owners (2 slices), and an
# H whose slice of R does not fit shared memory (read from L2)
TRAIN_FWD_EXTRA_CASES = [(600, 9, 1024), (8, 9, 2048)]


def log(phase: str, **kw) -> None:
    print(f"{phase}: " + json.dumps(kw, sort_keys=True), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> list[float]:
    import torch

    fn()  # warm-up
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def roofline_ms(nbytes: float, ops: float, dtype: str = "bfloat16") -> tuple[float, str]:
    """Least time on the card for `nbytes` moved and `ops` done: the larger
    of the two over the card's published peaks (its memory rate and
    `dtype`'s tensor rate, from libreasr_tpu_torch/flops.py's table), and
    which of the two bounds it."""
    from libreasr_tpu_torch import flops

    tb = nbytes / flops.device_hbm_bw("cuda") * 1e3
    to = ops / flops.device_peak_flops("cuda", dtype) * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def lstm_bound_ms(n: int, t: int, h: int, stream_c: bool) -> tuple[float, str]:
    """Least time for one sequence call: inputs read once (wx f32, R
    bf16, h0, c0), outputs written once (y, and yc or cT), against the
    bf16 tensor rate for the 2*N*T*H*4H recurrent flops."""
    nbytes = 4 * n * t * 4 * h + 2 * h * 4 * h + 2 * 4 * n * h + 4 * n * t * h
    nbytes += 4 * n * t * h if stream_c else 4 * n * h
    return roofline_ms(nbytes, 2.0 * n * t * h * 4 * h)


def lstm_int8_bound_ms(n: int, t: int, h: int) -> tuple[float, str]:
    """Least time for one int8 sequence call: wx f32, R int8, its scales
    and h0, c0 read once, y and yc written once, against the int8
    tensor rate for the 2*N*T*H*4H recurrent operations."""
    nbytes = (4 * n * t * 4 * h + h * 4 * h + 4 * 4 * h + 2 * 4 * n * h
              + 2 * 4 * n * t * h)
    return roofline_ms(nbytes, 2.0 * n * t * h * 4 * h, "int8")


def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(out, flush=True)
    return out


def phase_build() -> None:
    from libreasr_tpu_torch.ops.kernels import build

    names = sorted(f[: -len(".cu")] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith(".cu"))
    seconds = build.build(names)
    ptxas = {}
    for name in names:
        with open(build.library_path(name)[: -len(".so")] + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f if "registers" in ln
                           or "spill" in ln]
    log("build", seconds=seconds, ptxas=ptxas)


def _pack_from_twin(y, yc, h0, c0, lengths):
    import torch

    t = y.shape[1]
    valid = torch.arange(t, device=y.device)[None, :] < lengths[:, None]
    rows = torch.arange(y.shape[0], device=y.device)
    idx = torch.clamp(lengths - 1, 0, t - 1)
    empty = (lengths == 0)[:, None]
    return (torch.where(valid[..., None], y, torch.zeros_like(y)),
            torch.where(empty, h0, y[rows, idx]),
            torch.where(empty, c0, yc[rows, idx]))


def phase_kernel(seed: int) -> dict:
    """Kernel vs twin at several shapes, with the launches of each call
    and a rerun on the same inputs (bit-identical); returns the largest
    error per kernel name."""
    import torch

    from libreasr_tpu_torch.ops.kernels import build
    from libreasr_tpu_torch.ops.kernels.lstm import (
        LAUNCHES, batch_slices, fwd_plan, lstm_pack, lstm_seq, lstm_seq_reference,
    )
    from libreasr_tpu_torch.ops.rnn import LSTMParams

    gen = torch.Generator().manual_seed(seed)
    # (N, T, H): golden encoder (T 37), N off the batch tile, an H off
    # the 8-column vector path, the full-width main path, a long batch, a
    # batch above one launch's (row, unit) owners (two slices), an H whose
    # R slice does not fit shared memory (read from L2)
    cases = [(8, 37, 96), (13, 37, 96), (5, 17, 100), (16, 74, 1024),
             (64, 200, 1024), (300, 37, 1024), (600, 9, 1024), (16, 20, 2048)]
    worst = {"lstm_seq": 0.0, "lstm_seq_cseq": 0.0}
    sms = build.sm_count(0)
    for n, t, h in cases:
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen) * scale).cuda()

        wx = rnd(n, t, 4 * h)
        r = rnd(h, 4 * h, scale=1.0 / h ** 0.5)
        h0, c0 = rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
        slices = batch_slices(n, fwd_plan, h, sms)
        plan = fwd_plan(slices[0][1], h, sms)
        errs, launches, identical = {}, {}, {}
        for stream_c, name in ((False, "lstm_seq"), (True, "lstm_seq_cseq")):
            before = LAUNCHES[name]
            got = lstm_seq(wx, r, h0, c0, stream_c=stream_c)
            launches[name] = LAUNCHES[name] - before
            again = lstm_seq(wx, r, h0, c0, stream_c=stream_c)
            ref = lstm_seq_reference(wx, r, h0, c0, stream_c)
            torch.cuda.synchronize()
            pairs = [(a, b) for a, b in zip(got, ref) if a is not None]
            err = max(float((a - b).abs().max()) for a, b in pairs)
            errs[name] = err
            errs[name + "_mean"] = max(float((a - b).abs().mean())
                                       for a, b in pairs)
            identical[name] = all(torch.equal(a, b) for a, b in zip(got, again)
                                  if a is not None)
            worst[name] = max(worst[name], err)
        # pack semantics, lengths with 0 and T
        lengths = torch.randint(0, t + 1, (n,), generator=gen)
        lengths[0], lengths[-1] = 0, t
        lengths = lengths.cuda()
        x = rnd(n, t, h)
        params = LSTMParams(rnd(h, 4 * h, scale=1.0 / h ** 0.5), r,
                                 rnd(4 * h, scale=0.1))
        y, (hf, cf) = lstm_pack(x, (h0, c0), params, lengths)
        wx2 = (x @ params.kernel + params.bias).contiguous()
        ry, ryc, _, _ = lstm_seq_reference(wx2, r, h0, c0, True)
        ref = _pack_from_twin(ry, ryc, h0, c0, lengths)
        torch.cuda.synchronize()
        errs["pack"] = max(float((a - b).abs().max())
                           for a, b in zip((y, hf, cf), ref))
        errs["pack_mean"] = max(float((a - b).abs().mean())
                                for a, b in zip((y, hf, cf), ref))
        worst["lstm_seq_cseq"] = max(worst["lstm_seq_cseq"], errs["pack"])
        log("kernel", n=n, t=t, h=h, abs_err=errs, tol_max=KERNEL_TOL,
            tol_mean=KERNEL_TOL_MEAN, launches_per_call=launches,
            slices=len(slices), grid=plan.grid, units=plan.units, kw=plan.kw,
            r_resident=plan.resident, rerun_bit_identical=identical)
        bad = {k: v for k, v in errs.items() if not v <= (
            KERNEL_TOL_MEAN if k.endswith("_mean") else KERNEL_TOL)}
        if bad:
            raise AssertionError(f"kernel vs twin at {(n, t, h)}: {bad}")
        if set(launches.values()) != {len(slices)} or not all(identical.values()):
            raise AssertionError(f"kernel at {(n, t, h)}: launches {launches} for "
                                 f"{len(slices)} slices, rerun identical {identical}")
    return worst


def _golden_check(name: str, bundle, kernel: str) -> None:
    """The golden clips at 1 s (T 12: the scan cells, no kernel launch)
    and zero-padded to 3 s with the true lengths (T 37: `kernel` once per
    encoder layer), with the launch
    counts read around each call; raises unless both give the 8 texts
    exactly with those counts."""
    import numpy as np

    from libreasr_tpu_torch.data.audio import read_wav
    from libreasr_tpu_torch.ops.kernels import lstm as klstm

    audio = np.zeros((8, 48000), np.float32)
    for i in range(8):
        pcm, sr = read_wav(os.path.join(GOLDEN, f"s-{i:03d}.wav"))
        assert sr == 16000, sr
        audio[i, :16000] = pcm[0]
    lengths = np.full(8, 16000)
    got = {}
    for label, clips in (("1s", audio[:, :16000]), ("3s", audio)):
        klstm.reset_launches()
        texts, _ = bundle.transcribe_batch(clips, lengths)
        got[label] = (texts, dict(klstm.LAUNCHES))
    want_3s = {k: 0 for k in klstm.LAUNCHES}
    want_3s[kernel] = bundle.cfg.enc_num_layers
    log(name, texts_1s=got["1s"][0], texts_3s=got["3s"][0],
        launches_1s=got["1s"][1], launches_3s=got["3s"][1],
        expected_launches_3s=want_3s)
    if got["1s"][0] != GOLDEN_TEXTS or got["3s"][0] != GOLDEN_TEXTS:
        raise AssertionError(f"{name}: golden transcripts differ")
    if any(got["1s"][1].values()) or got["3s"][1] != want_3s:
        raise AssertionError(f"{name}: kernel launch counts differ from "
                             "the dispatch rule")


def phase_golden() -> None:
    from libreasr_tpu_torch.api import ASRBundle

    with tempfile.TemporaryDirectory() as tmp:
        bundle = ASRBundle.from_bundle(os.path.join(GOLDEN, "model.tar.gz"),
                                       extract_to=tmp, device="cuda")
    _golden_check("golden", bundle, "lstm_seq_cseq")


def phase_golden_int8() -> None:
    """The golden bundle quantized by the port, then saved by the port
    and reloaded: both run the int8 kernel at 3 s."""
    from libreasr_tpu_torch.api import ASRBundle

    with tempfile.TemporaryDirectory() as tmp:
        bundle = ASRBundle.from_bundle(os.path.join(GOLDEN, "model.tar.gz"),
                                       extract_to=tmp, device="cuda").quantize()
        _golden_check("golden_int8_quantized", bundle, "lstm_seq_int8")
        path = bundle.save(os.path.join(tmp, "int8.tar.gz"))
        reloaded = ASRBundle.from_bundle(path, extract_to=os.path.join(tmp, "re"),
                                         device="cuda")
    if reloaded.conf.get("quantized_cells") is not True:
        raise AssertionError("the saved bundle lost quantized_cells")
    _golden_check("golden_int8_reloaded", reloaded, "lstm_seq_int8")


def phase_golden_bpe() -> None:
    from libreasr_tpu_torch.api import ASRBundle

    with tempfile.TemporaryDirectory() as tmp:
        bundle = ASRBundle.from_bundle(os.path.join(GOLDEN, "model_bpe.tar.gz"),
                                       extract_to=tmp, device="cuda")
    _golden_check("golden_bpe", bundle, "lstm_seq_cseq")


def _full_width_clips(bundle, seed: int):
    """16 ragged clips of up to 6 s of seeded noise (at least 3 s, the
    first one full), on the host and on the card, and their features."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.ops.frontend import features_batch

    sr = bundle.frontend.sr
    rng = np.random.default_rng(seed)
    n, s = 16, 6 * sr
    lengths = rng.integers(s // 2, s + 1, n)
    lengths[0] = s
    audio = (rng.standard_normal((n, s)) * 0.1).astype(np.float32)
    audio *= np.arange(s)[None, :] < lengths[:, None]
    audio_d = torch.from_numpy(audio).cuda()
    lengths_d = torch.from_numpy(lengths).cuda()
    with torch.inference_mode():
        feats, flens = features_batch(audio_d, lengths_d, bundle.frontend)
    return audio, lengths, audio_d, lengths_d, feats, flens


def _time_path(bundle, audio, lengths, audio_d, lengths_d, feats, flens,
               reps: int = 7) -> dict:
    """Medians of `reps` runs on the host clock around synchronize: the
    whole transcribe_batch call, and its three stages on device-resident
    inputs."""
    import torch

    from libreasr_tpu_torch.models.decode import greedy_decode
    from libreasr_tpu_torch.ops.frontend import features_batch

    cfg = bundle.cfg
    tb_runs = wall_ms(lambda: bundle.transcribe_batch(audio, lengths), reps)
    with torch.inference_mode():
        fe_runs = wall_ms(lambda: features_batch(audio_d, lengths_d,
                                                 bundle.frontend), reps)
        enc_runs = wall_ms(lambda: bundle.model.encode(feats, lengths=flens),
                           reps)
        enc_out, _ = bundle.model.encode(feats, lengths=flens)
        dec_state = []
        dec_runs = wall_ms(lambda: dec_state.append(greedy_decode(
            bundle.decoder_fns(use_lm=False), enc_out, flens, blank=cfg.blank, bos=cfg.bos,
        )[3]), reps)
    iters = dec_state[-1].sum_iters
    audio_s = float(lengths.sum()) / bundle.frontend.sr
    tb_ms = statistics.median(tb_runs)
    return dict(
        transcribe_batch_ms_median=tb_ms, transcribe_batch_ms_runs=tb_runs,
        frontend_ms_median=statistics.median(fe_runs),
        encode_ms_median=statistics.median(enc_runs), encode_ms_runs=enc_runs,
        decode_ms_median=statistics.median(dec_runs), decode_ms_runs=dec_runs,
        decode_rounds_per_row={"min": int(iters.min()), "max": int(iters.max())},
        audio_seconds=audio_s, real_time_factor=tb_ms / 1e3 / audio_s,
    )


def phase_full_width(seed: int, card: str, worst_err: dict) -> list[dict]:
    import numpy as np
    import torch

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.ops.kernels import lstm as klstm

    conf = parse_and_apply_config(inference=True)
    bundle = ASRBundle.from_config(conf, seed=seed, device="cuda")
    cfg = bundle.cfg
    audio, lengths, audio_d, lengths_d, feats, flens = _full_width_clips(
        bundle, seed)
    n = len(lengths)

    # the main path, counted: transcribe_batch (lengths -> kernel B) and
    # encode without lengths (kernel A)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    klstm.reset_launches()
    texts, metrics = bundle.transcribe_batch(audio, lengths)
    bundle.encode(feats)
    torch.cuda.synchronize()
    launches = dict(klstm.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    t_enc = feats.shape[1]
    want = {"lstm_seq": cfg.enc_num_layers, "lstm_seq_cseq": cfg.enc_num_layers,
            "lstm_seq_int8": 0}
    if launches != want:
        raise AssertionError(f"main-path launches {launches}, expected {want}")
    align = np.asarray(metrics["alignment_score"])
    if len(texts) != n or not np.isfinite(align).all():
        raise AssertionError("transcribe_batch output malformed")

    # encoder output, cuda vs the same seeded model on the cpu
    enc_cuda, _ = bundle.encode(feats, flens)
    cpu = ASRBundle.from_config(conf, seed=seed, device="cpu")
    enc_cpu, _ = cpu.encode(feats.cpu(), flens.cpu())
    diff = (enc_cuda.float().cpu() - enc_cpu.float()).abs()
    enc_err = {"max_abs": float(diff.max()), "mean_abs": float(diff.mean())}
    finite = bool(torch.isfinite(enc_cuda).all())
    log("full_width_check", shape=list(enc_cuda.shape), finite=finite,
        enc_cuda_vs_cpu=enc_err, tol_max=ENC_TOL_MAX, tol_mean=ENC_TOL_MEAN,
        launches=launches, texts_sample=texts[:2])
    if not finite or enc_err["max_abs"] > ENC_TOL_MAX \
            or enc_err["mean_abs"] > ENC_TOL_MEAN:
        raise AssertionError(f"full-width encoder cuda vs cpu: {enc_err}")

    stages = _time_path(bundle, audio, lengths, audio_d, lengths_d, feats,
                        flens)

    # the sequence kernel alone at this path's shape (layer 1's inputs)
    layer = bundle.model.encoder.rnn_stack.layer(1)
    p = layer.cell.params()
    h_sz = cfg.hidden_sz
    gen = torch.Generator().manual_seed(seed + 1)
    x1 = (torch.randn((n, t_enc, h_sz), generator=gen) * 0.5).cuda()
    wx = (x1 @ p.kernel + p.bias).contiguous()
    h0 = layer.h0[0].expand(n, h_sz).contiguous()
    c0 = layer.h0[1].expand(n, h_sz).contiguous()
    with torch.inference_mode():
        # yardstick, never called by the port: cuDNN's LSTM in bf16 on the
        # same layer (it also computes x @ W), gates permuted to i,f,g,o
        ref_lstm = torch.nn.LSTM(h_sz, h_sz, batch_first=True, device="cuda",
                                 dtype=torch.bfloat16)
        perm = torch.cat([torch.arange(0, h_sz), torch.arange(2 * h_sz, 3 * h_sz),
                          torch.arange(h_sz, 2 * h_sz),
                          torch.arange(3 * h_sz, 4 * h_sz)]).cuda()
        ref_lstm.weight_ih_l0.copy_(p.kernel.t()[perm])
        ref_lstm.weight_hh_l0.copy_(p.recurrent_kernel.t()[perm])
        ref_lstm.bias_ih_l0.copy_(p.bias[perm])
        ref_lstm.bias_hh_l0.zero_()
        ref_lstm.flatten_parameters()
        x1b = x1.bfloat16()
        hx = (h0[None].bfloat16(), c0[None].bfloat16())
        library_ms = cuda_ms(lambda: ref_lstm(x1b, hx), reps=20)
        pack_ms = cuda_ms(lambda: klstm.lstm_pack(x1, (h0, c0), p), reps=20)
        rows = []
        for stream_c, name, line in ((False, "lstm_seq", 138),
                                     (True, "lstm_seq_cseq", 206)):
            ms = cuda_ms(lambda: klstm.lstm_seq(wx, p.recurrent_kernel, h0, c0,
                                                stream_c=stream_c), reps=20)
            plain_ms = cuda_ms(lambda: klstm.lstm_seq_reference(
                wx, p.recurrent_kernel, h0, c0, stream_c), reps=5)
            bound, bound_by = lstm_bound_ms(n, t_enc, h_sz, stream_c)
            rows.append({
                "name": name, "route": "cuda",
                "source": "libreasr_tpu_torch/csrc/lstm_seq.cu",
                "replaces": f"libreasr_tpu/ops/pallas/lstm.py:{line}",
                "launches": launches[name], "max_abs_err": worst_err[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": library_ms,
            })
    log("full_width", card=card, n=n, t_enc=t_enc, hidden=h_sz,
        vocab=cfg.vocab_sz, enc_layers=cfg.enc_num_layers, **stages,
        lstm_pack_layer_ms=pack_ms, peak_memory_mib=peak_mib,
        kernel_ms={r["name"]: r["ms"] for r in rows},
        twin_ms={r["name"]: r["plain_ms"] for r in rows},
        yardstick_cudnn_lstm_bf16_ms=library_ms)
    return rows


def phase_kernel_int8(seed: int) -> float:
    """The int8 kernel vs its twin, with the launches of each call and a
    rerun on the same inputs (bit-identical), and the port's int8
    products on the card vs on the host; returns the kernel's largest
    error."""
    import torch

    from libreasr_tpu_torch.ops.kernels import build
    from libreasr_tpu_torch.ops.kernels.lstm import (
        LAUNCHES, batch_slices, fwd_plan, int8_quotient_check, lstm_pack,
        lstm_seq_int8, lstm_seq_int8_reference, pack_k4,
    )
    from libreasr_tpu_torch.ops.quant import (
        QuantizedTensor, int8_matmul, quantize,
    )
    from libreasr_tpu_torch.ops.rnn import LSTMParams

    gen = torch.Generator().manual_seed(seed + 2)

    # quantize and int8_matmul: bit for bit alike on both devices, at
    # K 1280 with every product at +-127**2 (sums above 2**24) and on
    # gaussian inputs of the full-width layer-0 projection's shape
    k = 1280
    sign = torch.randint(0, 2, (16, k), generator=gen).float() * 2 - 1
    q = (torch.randint(0, 2, (k, 64), generator=gen) * 254 - 127).to(torch.int8)
    scale = torch.rand((1, 64), generator=gen) * 0.01 + 1e-3
    w = torch.randn((k, 4096), generator=gen) / k ** 0.5
    x = torch.randn((16, 74, k), generator=gen)
    exact = {}
    for label, xx, qt in (("pm127", sign, QuantizedTensor(q, scale)),
                          ("gaussian", x, quantize(w))):
        host = int8_matmul(xx, qt)
        card = int8_matmul(xx.cuda(), QuantizedTensor(qt.q.cuda(),
                                                      qt.scale.cuda()))
        exact[label] = bool(torch.equal(host, card.cpu()))
    wq_host, wq_card = quantize(w), quantize(w.cuda())
    exact["quantize"] = bool(torch.equal(wq_host.q, wq_card.q.cpu())
                             and torch.equal(wq_host.scale, wq_card.scale.cpu()))
    log("int8_exact", cuda_equals_cpu=exact)
    if not all(exact.values()):
        raise AssertionError(f"int8 products differ between devices: {exact}")

    # the kernel's quantization of h against the IEEE quotient's, on 2**32
    # seeded pairs: no quantized value may differ
    quot = int8_quotient_check(2**32)
    torch.cuda.synchronize()
    log("int8_quotient_check", pairs=2**32, counts=quot)
    if quot["hq_differ"] or quot["differ_above_4_ulps"]:
        raise AssertionError(f"kernel C's quantization of h is not exact: {quot}")

    # (N, T, H): phase_kernel's cases, one H off the 64-k granule, a batch
    # of 300 (one launch), of 600 (two batch slices), and an H whose slice
    # of R does not fit shared memory (read from L2)
    cases = [(8, 37, 96), (13, 37, 96), (5, 17, 100), (16, 74, 1024),
             (64, 200, 1024), (3, 17, 98), (300, 37, 1024), (600, 9, 1024),
             (16, 20, 4096)]
    worst = 0.0
    sms = build.sm_count(0)
    for n, t, h in cases:
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen) * scale).cuda()

        wx = rnd(n, t, 4 * h)
        r = quantize(rnd(h, 4 * h, scale=1.0 / h ** 0.5))
        r = QuantizedTensor(r.q, r.scale, pack_k4(r.q))
        h0, c0 = rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
        slices = batch_slices(n, fwd_plan, h, sms, 1)
        plan = fwd_plan(slices[0][1], h, sms, 1)
        before = LAUNCHES["lstm_seq_int8"]
        got = lstm_seq_int8(wx, r.q, r.scale, h0, c0, rq_packed=r.packed)
        launches = LAUNCHES["lstm_seq_int8"] - before
        again = lstm_seq_int8(wx, r.q, r.scale, h0, c0, rq_packed=r.packed)
        ref = lstm_seq_int8_reference(wx, r.q, r.scale, h0, c0)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = {"seq": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
                "seq_mean": max(float((a - b).abs().mean())
                                for a, b in zip(got, ref))}
        # pack semantics with an int8 input projection, lengths 0 and T
        lengths = torch.randint(0, t + 1, (n,), generator=gen)
        lengths[0], lengths[-1] = 0, t
        lengths = lengths.cuda()
        x = rnd(n, t, h)
        params = LSTMParams(quantize(rnd(h, 4 * h, scale=1.0 / h ** 0.5)), r,
                            rnd(4 * h, scale=0.1))
        y, (hf, cf) = lstm_pack(x, (h0, c0), params, lengths)
        wx2 = (int8_matmul(x, params.kernel) + params.bias).contiguous()
        ry, ryc = lstm_seq_int8_reference(wx2, r.q, r.scale, h0, c0)
        ref = _pack_from_twin(ry, ryc, h0, c0, lengths)
        torch.cuda.synchronize()
        errs["pack"] = max(float((a - b).abs().max())
                           for a, b in zip((y, hf, cf), ref))
        errs["pack_mean"] = max(float((a - b).abs().mean())
                                for a, b in zip((y, hf, cf), ref))
        worst = max(worst, errs["seq"], errs["pack"])
        log("kernel_int8", n=n, t=t, h=h, abs_err=errs, tol_max=INT8_TOL,
            tol_mean=INT8_TOL_MEAN, launches_per_call=launches,
            slices=len(slices), grid=plan.grid, units=plan.units, kw=plan.kw,
            r_resident=plan.resident, rerun_bit_identical=identical)
        bad = {k: v for k, v in errs.items() if not v <= (
            INT8_TOL_MEAN if k.endswith("_mean") else INT8_TOL)}
        if bad:
            raise AssertionError(f"int8 kernel vs twin at {(n, t, h)}: {bad}")
        # the design is bit-exact (module docstring of csrc/lstm_seq_int8.cu)
        if any(errs.values()) or launches != len(slices) or not identical:
            raise AssertionError(f"int8 kernel at {(n, t, h)}: errors {errs} "
                                 f"(expected 0.0), launches {launches} for "
                                 f"{len(slices)} slices, rerun identical {identical}")
    return worst


def phase_full_width_int8(seed: int, card: str, worst_err: float) -> dict:
    """The full-width model of phase_full_width, quantized by the port:
    transcribe_batch is the main path, counted; returns kernel C's row."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.ops.kernels import lstm as klstm
    from libreasr_tpu_torch.ops.quant import int8_matmul

    conf = parse_and_apply_config(inference=True)
    bundle = ASRBundle.from_config(conf, seed=seed, device="cuda").quantize()
    cfg = bundle.cfg
    audio, lengths, audio_d, lengths_d, feats, flens = _full_width_clips(
        bundle, seed)
    n, t_enc, h_sz = len(lengths), feats.shape[1], cfg.hidden_sz

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    klstm.reset_launches()
    texts, metrics = bundle.transcribe_batch(audio, lengths)
    torch.cuda.synchronize()
    launches = dict(klstm.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = {"lstm_seq": 0, "lstm_seq_cseq": 0,
            "lstm_seq_int8": cfg.enc_num_layers}
    if launches != want:
        raise AssertionError(f"int8 main-path launches {launches}, "
                             f"expected {want}")
    align = np.asarray(metrics["alignment_score"])
    if len(texts) != n or not np.isfinite(align).all():
        raise AssertionError("int8 transcribe_batch output malformed")

    # encoder output, cuda vs the same int8 model on the cpu (twin)
    enc_cuda, _ = bundle.encode(feats, flens)
    cpu = ASRBundle.from_config(conf, seed=seed, device="cpu").quantize()
    enc_cpu, _ = cpu.encode(feats.cpu(), flens.cpu())
    diff = (enc_cuda.float().cpu() - enc_cpu.float()).abs()
    enc_err = {"max_abs": float(diff.max()), "mean_abs": float(diff.mean())}
    finite = bool(torch.isfinite(enc_cuda).all())
    log("full_width_int8_check", shape=list(enc_cuda.shape), finite=finite,
        enc_cuda_vs_cpu=enc_err, tol_max=INT8_ENC_TOL_MAX,
        tol_mean=INT8_ENC_TOL_MEAN, launches=launches, texts_sample=texts[:2])
    if not finite or enc_err["max_abs"] > INT8_ENC_TOL_MAX \
            or enc_err["mean_abs"] > INT8_ENC_TOL_MEAN:
        raise AssertionError(f"full-width int8 encoder cuda vs cpu: {enc_err}")

    stages = _time_path(bundle, audio, lengths, audio_d, lengths_d, feats,
                        flens)

    # the int8 kernel alone at this path's shape (layer 1's inputs)
    layer = bundle.model.encoder.rnn_stack.layer(1)
    p = layer.cell.params()
    r = p.recurrent_kernel
    gen = torch.Generator().manual_seed(seed + 1)
    x1 = (torch.randn((n, t_enc, h_sz), generator=gen) * 0.5).cuda()
    with torch.inference_mode():
        wx = (int8_matmul(x1, p.kernel) + p.bias).contiguous()
        h0 = layer.h0[0].expand(n, h_sz).contiguous()
        c0 = layer.h0[1].expand(n, h_sz).contiguous()
        pack_ms = cuda_ms(lambda: klstm.lstm_pack(x1, (h0, c0), p), reps=20)
        ms = cuda_ms(lambda: klstm.lstm_seq_int8(
            wx, r.q, r.scale, h0, c0, rq_packed=r.packed), reps=20)
        plain_ms = cuda_ms(lambda: klstm.lstm_seq_int8_reference(
            wx, r.q, r.scale, h0, c0), reps=5)
    bound, bound_by = lstm_int8_bound_ms(n, t_enc, h_sz)
    # library_ms: no PyTorch call computes an int8 LSTM on the card
    # (cuDNN's RNNs take float types only; the quantized LSTM runs on
    # the CPU), so there is no yardstick for this row
    row = {
        "name": "lstm_seq_int8", "route": "cuda",
        "source": "libreasr_tpu_torch/csrc/lstm_seq_int8.cu",
        "replaces": "libreasr_tpu/ops/pallas/lstm.py:295",
        "launches": launches["lstm_seq_int8"], "max_abs_err": worst_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None,
    }
    log("full_width_int8", card=card, n=n, t_enc=t_enc, hidden=h_sz,
        vocab=cfg.vocab_sz, enc_layers=cfg.enc_num_layers, **stages,
        lstm_pack_layer_ms=pack_ms, peak_memory_mib=peak_mib,
        kernel_ms=ms, twin_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
    return row


# joint kernels F, G, H vs their twins: both compute the same float32
# sums over J (logits) and V (dlogits @ W_out^T) and over rows (dW, db)
# in another order, and both round h and dlogits to W_out's type. The
# order difference (~1e-6 relative in float32) and a tanhf/expf ulp
# against PyTorch's can flip a bf16 rounding of h or dlogits, which moves
# one term of a sum by 2**-9 of itself: a few 1e-5 of the lp values
# (~|8|) and of each gradient's largest entry. Bounds: lp and lse 2e-3
# absolute; every gradient 2e-3 of its largest entry. A wrong index,
# mask or one-hot shows as errors of 1e-1 and more.
JOINT_LP_TOL = 2e-3
JOINT_GRAD_TOL = 2e-3
# fused loss on the kernels against the chunked path on the card, the
# rule of scripts/check_kernels.py for the TPU kernels
FUSED_REL_TOL = 1e-3
FUSED_MIN_COS = 0.999
# (N, T, U1, J, V): golden-like; U1 above 96 with T, U1, J and V off
# every tile (BT 4/2, BU 8, J chunk 64, V tiles 64/32); the main path
JOINT_CASES = [(3, 13, 9, 96, 40), (2, 11, 101, 200, 300),
               (16, 49, 41, 1024, 2048)]
# F, G and H with bf16 W_out under a small scratch cap: H in 5 chunks of
# 640 rows at a mid shape (3,108 rows, 6 row groups) and 4 of 9,344 at the
# main one; G in 2 and 4 chunks of frame groups; F in 1 chunk at the mid
# shape and 2 (30,720 + 1,424 rows) at the main one
JOINT_CHUNK_CASES = [((4, 37, 21, 256, 512), 4 * 2**20),
                     ((16, 49, 41, 1024, 2048), 64 * 2**20)]



def _joint_inputs(n, t, u1, j, v, gen, w_dtype):
    """Seeded projections and weights at the joint's scale, ragged frame
    and label lengths (one of each full), labels padded with -1 past each
    length, a label equal to the blank, and the loss's own cotangents
    (zero outside each lattice)."""
    import torch

    from libreasr_tpu_torch.ops.kernels.joint_lp import joint_lp_fwd_reference
    from libreasr_tpu_torch.ops.rnnt_loss import (
        backward_betas, forward_alphas, occupancies, terminal_gather,
    )

    enc = torch.randn((n, t, j), generator=gen) * 0.5
    pred = torch.randn((n, u1, j), generator=gen) * 0.5
    w = (torch.randn((j, v), generator=gen) / j ** 0.5).to(w_dtype)
    b = torch.randn((v,), generator=gen) * 0.1
    labels = torch.randint(1, v, (n, u1 - 1), generator=gen).to(torch.int32)
    fl = torch.randint(max(1, t // 2), t + 1, (n,), generator=gen)
    yl = torch.randint(0, u1, (n,), generator=gen)
    fl[0], yl[-1] = t, u1 - 1
    labels[torch.arange(u1 - 1)[None, :] >= yl[:, None]] = -1
    labels[0, 0] = 0
    cuda = [x.cuda() for x in (enc, pred, w, b, labels)]
    lpb, lpe, _ = joint_lp_fwd_reference(*cuda)
    fl, yl = fl.cuda(), yl.cuda()
    alpha, lpe_m = forward_alphas(lpb, lpe, yl)
    beta = backward_betas(lpb, lpe_m, fl, yl)
    log_z = terminal_gather(alpha, lpb, fl, yl)
    occ_b, occ_e = occupancies(lpb, lpe_m, alpha, beta, fl, yl, log_z)
    return (*cuda, (-occ_b).contiguous(), (-occ_e).contiguous(), fl, yl)


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else 1.0


def phase_kernel_joint(seed: int) -> dict:
    """F, G, H against their twins on the card, in bf16 and float32
    W_out, at JOINT_CASES, G and H with F's lse; with bf16 W_out across
    chunks at JOINT_CHUNK_CASES and twice on the same inputs; then
    rnnt_loss_fused on the kernels against the chunked path. Returns the
    largest error per kernel."""
    import torch

    from libreasr_tpu_torch.ops import fused_loss as fl_mod
    from libreasr_tpu_torch.ops.kernels import build
    from libreasr_tpu_torch.ops.kernels import joint_lp as kj

    def abs_err(a, r):
        return float((a - r).abs().max()) if r.numel() else 0.0

    def rel_err(a, r):
        return abs_err(a, r) / max(float(r.abs().max()), 1e-30)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    lp_names = ("lp_blank", "lp_emit", "lse")
    gen = torch.Generator().manual_seed(seed + 3)
    worst = {"joint_lp_fwd": 0.0, "joint_lp_dx": 0.0, "joint_lp_dw": 0.0}
    for n, t, u1, j, v in JOINT_CASES:
        for w_dtype in (torch.bfloat16, torch.float32):
            enc, pred, w, b, lab, gb, ge, _, _ = _joint_inputs(
                n, t, u1, j, v, gen, w_dtype)
            got_f = kj.joint_lp_fwd(enc, pred, w, b, lab)
            ref_f = kj.joint_lp_fwd_reference(enc, pred, w, b, lab)
            lse = got_f[2]
            got_g = kj.joint_lp_dx(enc, pred, w, b, lab, gb, ge, lse)
            ref_g = kj.joint_lp_dx_reference(enc, pred, w, b, lab, gb, ge, lse)
            got_h = kj.joint_lp_dw(enc, pred, w, b, lab, gb, ge, lse)
            ref_h = kj.joint_lp_dw_reference(enc, pred, w, b, lab, gb, ge, lse)
            torch.cuda.synchronize()
            errs = {k: abs_err(a, r) for k, a, r in zip(lp_names, got_f, ref_f)}
            errs.update({k: rel_err(a, r) for k, a, r in zip(
                ("d_enc_proj", "d_pred_proj", "d_w_out", "d_b_out"),
                (*got_g, *got_h), (*ref_g, *ref_h))})
            finite = all(bool(torch.isfinite(x).all())
                         for x in (*got_f, *got_g, *got_h))
            log("kernel_joint", n=n, t=t, u1=u1, j=j, v=v,
                w_dtype=str(w_dtype), padded_label_rows=int((lab < 0).any(1).sum()),
                finite=finite, err=errs, tol_lp_abs=JOINT_LP_TOL,
                tol_grad_rel=JOINT_GRAD_TOL)
            worst["joint_lp_fwd"] = max(worst["joint_lp_fwd"],
                                        *(errs[k] for k in lp_names))
            worst["joint_lp_dx"] = max(worst["joint_lp_dx"], errs["d_enc_proj"],
                                       errs["d_pred_proj"])
            worst["joint_lp_dw"] = max(worst["joint_lp_dw"], errs["d_w_out"],
                                       errs["d_b_out"])
            bad = {k: e for k, e in errs.items() if not e <= (
                JOINT_LP_TOL if k in lp_names else JOINT_GRAD_TOL)}
            if bad or not finite:
                raise AssertionError(f"joint kernels vs twins at "
                                     f"{(n, t, u1, j, v, w_dtype)}: {bad}")

    # F, G and H with bf16 W_out across chunk boundaries (a scratch cap set
    # here, far below the main path's), and twice on the same inputs; F's
    # outputs are the same bits as in one chunk (a row's sums do not
    # depend on the chunk that holds it)
    f_chunks = 0
    for (n, t, u1, j, v), cap in JOINT_CHUNK_CASES:
        enc, pred, w, b, lab, gb, ge, _, _ = _joint_inputs(
            n, t, u1, j, v, gen, torch.bfloat16)
        fplan = kj.lp_plan(n, t, u1, j, v, cap=cap)
        got_f = kj.joint_lp_fwd(enc, pred, w, b, lab, scratch_cap=cap)
        again_f = kj.joint_lp_fwd(enc, pred, w, b, lab, scratch_cap=cap)
        whole_f = kj.joint_lp_fwd(enc, pred, w, b, lab)
        ref_f = kj.joint_lp_fwd_chunked_reference(enc, pred, w, b, lab, fplan)
        torch.cuda.synchronize()
        errs = {k: abs_err(a, r) for k, a, r in zip(lp_names, got_f, ref_f)}
        identical = same(got_f, again_f)
        as_one_chunk = same(got_f, whole_f)
        log("kernel_joint_fwd_chunks", n=n, t=t, u1=u1, j=j, v=v, scratch_cap=cap,
            chunks=len(fplan.chunks), chunk_rows=fplan.chunk_rows, err=errs,
            rerun_bit_identical=identical, bit_identical_to_one_chunk=as_one_chunk,
            tol_lp_abs=JOINT_LP_TOL)
        worst["joint_lp_fwd"] = max(worst["joint_lp_fwd"], *errs.values())
        f_chunks = max(f_chunks, len(fplan.chunks))
        if not identical or not as_one_chunk or not max(errs.values()) <= JOINT_LP_TOL:
            raise AssertionError(f"F across chunks at {(n, t, u1, j, v)}: {errs}, "
                                 f"identical {identical}, as one chunk {as_one_chunk}")
        lse = got_f[2]
        gplan = kj.dx_plan(n, t, u1, j, v, cap=cap)
        got_g = kj.joint_lp_dx(enc, pred, w, b, lab, gb, ge, lse, scratch_cap=cap)
        again_g = kj.joint_lp_dx(enc, pred, w, b, lab, gb, ge, lse, scratch_cap=cap)
        ref_g = kj.joint_lp_dx_reference(enc, pred, w, b, lab, gb, ge, lse)
        torch.cuda.synchronize()
        errs = {k: rel_err(a, r)
                for k, a, r in zip(("d_enc_proj", "d_pred_proj"), got_g, ref_g)}
        identical = same(got_g, again_g)
        log("kernel_joint_dx_chunks", n=n, t=t, u1=u1, j=j, v=v, scratch_cap=cap,
            chunks=len(gplan.chunks), chunk_rows=gplan.chunk_rows, err=errs,
            rerun_bit_identical=identical, tol_grad_rel=JOINT_GRAD_TOL)
        worst["joint_lp_dx"] = max(worst["joint_lp_dx"], *errs.values())
        if len(gplan.chunks) < 2 or not identical or \
                not max(errs.values()) <= JOINT_GRAD_TOL:
            raise AssertionError(f"G across chunks at {(n, t, u1, j, v)}: "
                                 f"{errs}, identical {identical}")
        plan = kj.dw_plan(n, t, u1, j, v, cap=cap, sms=build.sm_count(0))
        got = kj.joint_lp_dw(enc, pred, w, b, lab, gb, ge, lse, scratch_cap=cap)
        ref = kj.joint_lp_dw_reference(enc, pred, w, b, lab, gb, ge, lse)
        again = kj.joint_lp_dw(enc, pred, w, b, lab, gb, ge, lse, scratch_cap=cap)
        torch.cuda.synchronize()
        errs = {k: rel_err(a, r) for k, a, r in zip(("d_w_out", "d_b_out"), got, ref)}
        identical = same(got, again)
        log("kernel_joint_chunks", n=n, t=t, u1=u1, j=j, v=v, rows=plan.rows,
            scratch_cap=cap, chunks=len(plan.chunks), chunk_rows=plan.chunk_rows,
            groups=plan.groups, err=errs, rerun_bit_identical=identical,
            tol_grad_rel=JOINT_GRAD_TOL)
        worst["joint_lp_dw"] = max(worst["joint_lp_dw"], *errs.values())
        if len(plan.chunks) < 2 or not identical or \
                not max(errs.values()) <= JOINT_GRAD_TOL:
            raise AssertionError(f"H across chunks at {(n, t, u1, j, v)}: "
                                 f"{errs}, identical {identical}")
    if f_chunks < 2:
        raise AssertionError("no JOINT_CHUNK_CASES cap cut F into chunks")
    n, t, u1, j, v = JOINT_CASES[-1]
    enc, pred, w, b, lab, gb, ge, _, _ = _joint_inputs(n, t, u1, j, v, gen,
                                                      torch.bfloat16)
    first_f = kj.joint_lp_fwd(enc, pred, w, b, lab)
    second_f = kj.joint_lp_fwd(enc, pred, w, b, lab)
    lse = first_f[2]
    first_g = kj.joint_lp_dx(enc, pred, w, b, lab, gb, ge, lse)
    second_g = kj.joint_lp_dx(enc, pred, w, b, lab, gb, ge, lse)
    first = kj.joint_lp_dw(enc, pred, w, b, lab, gb, ge, lse)
    second = kj.joint_lp_dw(enc, pred, w, b, lab, gb, ge, lse)
    torch.cuda.synchronize()
    identical = {"F": same(first_f, second_f), "G": same(first_g, second_g),
                 "H": same(first, second)}
    log("kernel_joint_rerun", n=n, t=t, u1=u1, j=j, v=v,
        rerun_bit_identical=identical)
    if not all(identical.values()):
        raise AssertionError(f"F, G or H differs between two runs on the same "
                             f"inputs: {identical}")

    # the fused loss: kernels against the chunked path, on the card
    for n, t, u1, j, v in JOINT_CASES:
        for cdt in (torch.bfloat16, None):
            h = 48
            x = [torch.randn(s, generator=gen) * sc for s, sc in (
                ((n, t, h), 1.0), ((n, u1, h), 1.0), ((h, j), h ** -0.5),
                ((j,), 0.1), ((h, j), h ** -0.5), ((j, v), j ** -0.5),
                ((v,), 0.1))]
            lab = torch.randint(1, v, (n, u1 - 1), generator=gen)
            lab[0, 0] = 0
            fl = torch.randint(max(1, t // 2), t + 1, (n,), generator=gen)
            yl = torch.randint(0, u1, (n,), generator=gen)
            fl[0], yl[-1] = t, u1 - 1
            out = {}
            for route in ("kernels", "chunked"):
                ts = [a.cuda().requires_grad_() for a in x]
                loss = fl_mod._fused(ts[0], ts[1], fl_mod.JointParams(*ts[2:]),
                                     lab.cuda(), fl.cuda(), yl.cuda(), 0, 16,
                                     cdt, route)
                loss.sum().backward()
                out[route] = (loss.detach(), [a.grad for a in ts])
            lk, gk = out["kernels"]
            lc, gc = out["chunked"]
            rel = float(((lk - lc).abs() / lc.abs().clamp_min(1e-9)).max())
            cos = [_cosine(a, b) for a, b in zip(gk, gc)]
            log("kernel_joint_fused", n=n, t=t, u1=u1, j=j, v=v,
                compute_dtype=str(cdt), loss_rel_err=rel, grad_cosines=cos,
                tol_rel=FUSED_REL_TOL, min_cos=FUSED_MIN_COS)
            if not rel < FUSED_REL_TOL or not min(cos) > FUSED_MIN_COS:
                raise AssertionError(f"fused loss kernels vs chunked at "
                                     f"{(n, t, u1, j, v, cdt)}: {rel} {cos}")
    return worst


def joint_bound_ms(kind: str, n, t, u1, j, v, w_bytes: int = 2):
    """Least time for one call of F ("fwd"), G ("dx") or H ("dw") at the
    main path's shape: each input read once, each output written once
    (F writes lp_blank, lp_emit and lse; G and H read that lse), against
    the bf16 tensor rate for the products the function needs on its
    R = N T U1 rows (F: the logits, 2 R J V flops; G and H: the logits
    and one more product of that size each)."""
    r, u = n * t * u1, u1 - 1
    inputs = 4 * n * t * j + 4 * n * u1 * j + w_bytes * j * v + 4 * v + 4 * n * u
    cot = 4 * r + 4 * n * t * u
    nbytes = {"fwd": inputs + 8 * r + 4 * n * t * u,
              "dx": inputs + cot + 4 * n * t * j + 4 * n * u1 * j + 4 * r,
              "dw": inputs + cot + 4 * r + 4 * j * v + 4 * v}[kind]
    return roofline_ms(nbytes, (2.0 if kind == "fwd" else 4.0) * r * j * v)


def joint_rows(seed: int, worst: dict, launches: dict) -> list[dict]:
    """F, G and H timed at the main path's shape (bf16 W_out), beside
    their twins, G and H with F's lse; the rows of the kernels line, each
    with its device launches a call. cuBLAS's bf16 product of the same
    [R, J] x [J, V] shape is printed as context: no single PyTorch call
    computes these kernels' function."""
    import torch

    from libreasr_tpu_torch.ops.kernels import build
    from libreasr_tpu_torch.ops.kernels import joint_lp as kj

    n, t, u1, j, v = JOINT_CASES[-1]
    gen = torch.Generator().manual_seed(seed + 4)
    enc, pred, w, b, lab, gb, ge, _, _ = _joint_inputs(n, t, u1, j, v, gen,
                                                      torch.bfloat16)
    _, _, lse = kj.joint_lp_fwd(enc, pred, w, b, lab)
    calls = {
        "joint_lp_fwd": ("fwd", 341, lambda: kj.joint_lp_fwd(enc, pred, w, b, lab),
                         lambda: kj.joint_lp_fwd_reference(enc, pred, w, b, lab)),
        "joint_lp_dx": ("dx", 394,
                        lambda: kj.joint_lp_dx(enc, pred, w, b, lab, gb, ge, lse),
                        lambda: kj.joint_lp_dx_reference(enc, pred, w, b, lab, gb,
                                                         ge, lse)),
        "joint_lp_dw": ("dw", 429,
                        lambda: kj.joint_lp_dw(enc, pred, w, b, lab, gb, ge, lse),
                        lambda: kj.joint_lp_dw_reference(enc, pred, w, b, lab, gb,
                                                         ge, lse)),
    }
    a = torch.randn((n * t * u1, j), device="cuda").bfloat16()
    dq = torch.randn((n * t * u1, v), device="cuda").bfloat16()
    cublas_ms = cuda_ms(lambda: a @ w, reps=20)
    # context for H: its two bf16 products alone, [R, J] x [J, V] and
    # [J, R] x [R, V] (no softmax, no scratch); the port never calls them
    matmul_h_ms = cublas_ms + cuda_ms(lambda: a.t() @ dq, reps=20)
    rows, times = [], {}
    with torch.inference_mode():
        for name, (kind, line, kernel, twin) in calls.items():
            ms = cuda_ms(kernel, reps=10)
            plain_ms = cuda_ms(twin, reps=3, warmup=1)
            bound, bound_by = joint_bound_ms(kind, n, t, u1, j, v)
            times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound}
            rows.append({
                "name": name, "route": "cuda",
                "source": "libreasr_tpu_torch/csrc/joint_lp.cu",
                "replaces": f"libreasr_tpu/ops/pallas/joint_lp.py:{line}",
                "launches": launches[name], "max_abs_err": worst[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": None,
            })
    # F's launches (w(h), the logits product with its (max, sum) and picks
    # epilogue, the fold), G's (w(h), the dlogits product, the dh product,
    # the partials' fold) and H's (w(h), the logits product, dW, the
    # fold): device ms a call by kernel, and device launches a call
    from torch.profiler import ProfilerActivity, profile

    def launch_ms(fn, reps=5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mark = "(anonymous namespace)::"
        events = [e for e in prof.key_averages() if mark in e.key]
        return ({e.key.split(mark, 1)[1].split("(")[0]:
                 e.self_device_time_total / (reps * 1e3) for e in events},
                sum(e.count for e in events) / reps)

    per_call = {name: launch_ms(kernel) for name, (_, _, kernel, _) in calls.items()}
    for row in rows:
        row["device_launches_per_call"] = per_call[row["name"]][1]
    log("joint_timing", n=n, t=t, u1=u1, j=j, v=v, rows=n * t * u1,
        w_dtype="bfloat16", kernels=times,
        f_launch_ms=per_call["joint_lp_fwd"][0], g_launch_ms=per_call["joint_lp_dx"][0],
        h_launch_ms=per_call["joint_lp_dw"][0],
        device_launches_per_call={k: c for k, (_, c) in per_call.items()},
        context_cublas_bf16_rows_x_w_ms=cublas_ms,
        context_matmul_bf16_h_products_ms=matmul_h_ms,
        f_scratch_bytes=kj.lp_plan(n, t, u1, j, v, kj.DW_SCRATCH_CAP).scratch_bytes,
        g_scratch_bytes=kj.dx_plan(n, t, u1, j, v, kj.DW_SCRATCH_CAP).scratch_bytes,
        h_scratch_bytes=kj.dw_plan(n, t, u1, j, v, kj.DW_SCRATCH_CAP,
                                   build.sm_count(0)).scratch_bytes)
    return rows


TRAIN_STEPS = 4


def _train_batches(cfg, frontend, seed: int, n: int = 16, steps: int = TRAIN_STEPS):
    """Seeded ragged 2.5-4 s clips of noise (the 4 s bucket, one clip
    full) with 20-40 random labels in [1, V), on the card."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.training.learner import Batch

    rng = np.random.default_rng(seed)
    s, u = 4 * frontend.sr, 40
    out = []
    for _ in range(steps):
        lengths = rng.integers(s * 5 // 8, s + 1, n)
        lengths[0] = s
        audio = (rng.standard_normal((n, s)) * 0.1).astype(np.float32)
        audio *= np.arange(s)[None, :] < lengths[:, None]
        ylen = rng.integers(20, u + 1, n)
        labels = rng.integers(1, cfg.vocab_sz, (n, u))
        labels *= np.arange(u)[None, :] < ylen[:, None]
        out.append(Batch(*(torch.from_numpy(x).cuda()
                           for x in (audio, lengths, labels, ylen))))
    return out


def _timed(name: str, fn, times: dict):
    import torch

    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    return run


def train_conf(accumulate: int = 2, use_train_kernel: bool = True) -> dict:
    """config/base.yaml for training: the model block as written (the
    encoder's LSTM layers on kernels D and E), gradient accumulation over
    2 batches and an 8-step schedule, so that 4 steps update twice;
    use_train_kernel False puts the encoder on its scan cells."""
    from libreasr_tpu_torch.config import parse_and_apply_config

    conf = parse_and_apply_config()
    if not use_train_kernel:
        conf["model"]["encoder"]["use_pallas_train"] = False
    conf["accumulate_n_batches"] = accumulate
    conf["training"]["total_steps"] = 8
    return conf


def _keep_first_grads(learner) -> list:
    """Make `learner` keep (a copy of) the gradients of its next step."""
    kept = []
    backward = learner.backward

    def keep(loss):
        out = backward(loss)
        if not kept:
            kept.extend(g.detach().clone() for g in out[0])
        return out

    learner.backward = keep
    return kept


def phase_train_full_width(seed: int, card: str) -> dict:
    """The main path: 4 Learner steps of the base.yaml model. Returns
    the launch counts of that run, the first step's loss and gradients,
    the step's median time, its shape (N, T frames, U labels) and the
    model's config."""
    import math

    import torch

    from libreasr_tpu_torch.ops.kernels import joint_lp as kj
    from libreasr_tpu_torch.ops.kernels import lstm as klstm
    from libreasr_tpu_torch.ops.kernels import lstm_train as klt
    from libreasr_tpu_torch.training.learner import Learner

    learner = Learner.from_config(train_conf(), device="cuda", seed=seed)
    cfg = learner.cfg
    batches = _train_batches(cfg, learner.frontend, seed)
    times: dict = {}
    for part, label in (("features", "frontend"), ("forward", "forward"),
                        ("loss", "loss"), ("backward", "backward"),
                        ("optimize", "optimizer")):
        setattr(learner, part, _timed(label, getattr(learner, part), times))
    grads = _keep_first_grads(learner)
    losses, changed = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    klstm.reset_launches()
    klt.reset_launches()
    kj.reset_launches()
    for b in batches:
        before = [p.detach().clone() for p in learner.params]
        step = _timed("step", learner.step, times)
        metrics = step(b)
        losses.append(float(metrics["loss"]))
        changed.append(any(not torch.equal(a, p.detach())
                           for a, p in zip(before, learner.params)))
        del before
    torch.cuda.synchronize()
    joint_launches, lstm_launches = dict(kj.LAUNCHES), dict(klstm.LAUNCHES)
    train_launches = dict(klt.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    t_enc = int(learner.frontend.out_length(torch.tensor(4 * learner.frontend.sr)))
    med = {k: statistics.median(v[1:]) for k, v in times.items()}
    step_ms = med.pop("step")
    layers = cfg.enc_num_layers
    want_train = {"lstm_train_fwd": TRAIN_STEPS * layers,
                  "lstm_train_bwd": TRAIN_STEPS * layers}
    log("train_full_width", card=card, n=16, t_enc=t_enc, u=40,
        hidden=cfg.hidden_sz, vocab=cfg.vocab_sz, enc_layers=layers,
        compute_dtype=str(cfg.compute_dtype), losses=losses,
        params_changed=changed, joint_launches=joint_launches,
        lstm_launches=lstm_launches, train_kernel_launches=train_launches,
        expected_train_kernel_launches=want_train,
        step_ms_median_last3=step_ms, split_ms_median_last3=med,
        step_ms_runs=times["step"], peak_memory_mib=peak_mib)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if joint_launches != {k: TRAIN_STEPS for k in kj.LAUNCHES}:
        raise AssertionError(f"joint kernel launches {joint_launches}")
    if any(lstm_launches.values()):
        raise AssertionError(f"eval LSTM kernels ran in training: {lstm_launches}")
    if train_launches != want_train:
        raise AssertionError(f"training LSTM kernel launches {train_launches}, "
                             f"expected {want_train}")
    if changed != [i % 2 == 1 for i in range(TRAIN_STEPS)]:
        raise AssertionError(f"parameters changed at steps {changed}, "
                             "expected on accumulation boundaries only")
    return {"launches": {**joint_launches, **train_launches},
            "loss0": losses[0], "grads0": grads, "step_ms": step_ms,
            "shape": {"n": 16, "t": t_enc, "u": 40}, "cfg": cfg}


# the scan route against the D/E route, one step from the same weights,
# batch and random draws, bf16 compute: the forward differs in summation
# order and the bf16 flips it causes; the backward also in where bf16
# rounds (the scan's autograd rounds dh = dv @ R^T to bf16, kernel E
# rounds dv before the product). Loss 1e-3 relative; every gradient
# tensor's cosine against the other route's at least 0.999.
TRAIN_ROUTE_LOSS_REL = 1e-3
TRAIN_ROUTE_MIN_COS = 0.999


def phase_train_scan_route(seed: int, card: str, ref: dict) -> None:
    """The encoder on its scan cells (the earlier path), 3 steps of the
    main path's batches: step 1 against the D/E route's step 1, and the
    step time (median of steps 2-3)."""
    import torch

    from libreasr_tpu_torch.ops.kernels import lstm_train as klt
    from libreasr_tpu_torch.training.learner import Learner

    learner = Learner.from_config(train_conf(use_train_kernel=False),
                                  device="cuda", seed=seed)
    batches = _train_batches(learner.cfg, learner.frontend, seed, steps=3)
    grads = _keep_first_grads(learner)
    klt.reset_launches()
    times: dict = {}
    losses = [float(_timed("step", learner.step, times)(b)["loss"])
              for b in batches]
    launches = dict(klt.LAUNCHES)
    names = [n for n, _ in learner.model.named_parameters()]
    cos = {n: _cosine(a, b) for n, a, b in zip(names, grads, ref["grads0"])}
    loss_rel = abs(losses[0] - ref["loss0"]) / abs(ref["loss0"])
    scan_ms = statistics.median(times["step"][1:])
    log("train_scan_route", card=card, losses=losses, loss0_de_route=ref["loss0"],
        loss_rel_err=loss_rel, grad_cos_min=min(cos.values()),
        grad_cos_lowest={n: c for n, c in sorted(cos.items(), key=lambda x: x[1])[:6]},
        train_kernel_launches=launches, step_ms_runs=times["step"],
        scan_step_ms_median_last2=scan_ms, de_route_step_ms_median_last3=ref["step_ms"],
        tol_loss_rel=TRAIN_ROUTE_LOSS_REL, min_cos=TRAIN_ROUTE_MIN_COS)
    if any(launches.values()):
        raise AssertionError(f"the scan route launched D/E: {launches}")
    if not (loss_rel <= TRAIN_ROUTE_LOSS_REL
            and min(cos.values()) >= TRAIN_ROUTE_MIN_COS):
        raise AssertionError("scan route and D/E route disagree")


# small model, cuda vs cpu: float32 compute, so the two differ only in
# summation order (cuBLAS, the joint kernels' SIMT float32 products and
# the DP against PyTorch's CPU kernels): loss 1e-4 relative, every
# gradient 1e-3 of its largest entry, parameters 1e-5 absolute after 2
# steps (each step moves a parameter by at most ~lr = 5e-4 here).
SMALL_LOSS_TOL = 1e-4
SMALL_GRAD_TOL = 1e-3
SMALL_PARAM_TOL = 1e-5


def phase_train_small_cuda_vs_cpu(seed: int) -> None:
    """float32 compute, so R is float32 on kernels D and E (T 49) on the
    card and on their twins on the CPU."""
    import torch

    from libreasr_tpu_torch.ops.kernels import lstm_train as klt
    from libreasr_tpu_torch.training.learner import Learner

    conf = train_conf(accumulate=1)
    m = conf["model"]
    m.update(hidden_sz=64, out_sz=48, joint_sz=40, embed_sz=32, vocab_sz=50)
    m["encoder"].update(num_layers=2, dropout=0.0)
    m["predictor"].update(num_layers=1, dropout=0.0)
    conf["dtypes"]["compute"] = "float32"
    conf["transforms"]["features"] = [
        s for s in conf["transforms"]["features"]
        if s["name"] in ("LogMelSpectrogram", "StackDownsample")]
    runs = {}
    klt.reset_launches()
    for dev in ("cuda", "cpu"):
        learner = Learner.from_config(conf, device=dev, seed=seed)
        grads = []
        backward = learner.backward

        def keep(loss, backward=backward, grads=grads):
            out = backward(loss)
            grads.append([g.detach().cpu() for g in out[0]])
            return out

        learner.backward = keep
        batches = _train_batches(learner.cfg, learner.frontend, seed, n=4,
                                 steps=2)
        losses = [float(learner.step(tuple(x.to(dev) for x in b))["loss"])
                  for b in batches]
        runs[dev] = (losses, grads, [p.detach().cpu() for p in learner.params])
    launches = dict(klt.LAUNCHES)
    (lc, gc, pc), (lh, gh, ph) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for sa, sb in zip(gc, gh) for a, b in zip(sa, sb))
    param_abs = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    log("train_small_cuda_vs_cpu", losses_cuda=lc, losses_cpu=lh,
        loss_rel_err=loss_rel, grad_rel_err=grad_rel, param_abs_err=param_abs,
        tol_loss_rel=SMALL_LOSS_TOL, tol_grad_rel=SMALL_GRAD_TOL,
        tol_param_abs=SMALL_PARAM_TOL, train_kernel_launches_cuda=launches)
    if not all(launches.values()):
        raise AssertionError(f"small cuda run missed kernels D/E: {launches}")
    if not (loss_rel <= SMALL_LOSS_TOL and grad_rel <= SMALL_GRAD_TOL
            and param_abs <= SMALL_PARAM_TOL):
        raise AssertionError("small train step: cuda and cpu disagree")


def _train_kernel_inputs(n, t, h, gen, r_dtype):
    """Seeded inputs of D and E at the scale of a layer: wx ~ N(0, 1),
    R ~ N(0, 1/H), states ~ N(0, 0.25); the twin's forward gives v and
    c_seq, cotangents ~ N(0, 0.01)."""
    import torch

    from libreasr_tpu_torch.ops.kernels import lstm_train as klt

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    wx, h0, c0 = rnd(n, t, 4 * h), rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
    r = rnd(h, 4 * h, scale=h ** -0.5).to(r_dtype)
    _, c_seq, v = klt.lstm_train_fwd_reference(wx, r, h0, c0)
    dy, dc = rnd(n, t, h, scale=0.1), rnd(n, t, h, scale=0.1)
    cprev = torch.cat([c0[:, None], c_seq[:, :-1]], 1).contiguous()
    return (wx, r, h0, c0), (dy, dc, v, c_seq, cprev, r)


def phase_kernel_train(seed: int) -> dict:
    """D and E against their twins at TRAIN_KERNEL_CASES, bf16 and float32
    R, one cooperative launch a call (per slice), D bit-identical on a
    rerun; D also at TRAIN_FWD_EXTRA_CASES; returns the largest error per
    kernel."""
    import torch

    from libreasr_tpu_torch.ops.kernels import build
    from libreasr_tpu_torch.ops.kernels import lstm_train as klt

    gen = torch.Generator().manual_seed(seed + 5)
    sms = build.sm_count(0)
    worst = {"lstm_train_fwd": 0.0, "lstm_train_bwd": 0.0}

    def run_fwd(fwd_in):
        """D against its twin: errors, launches against the plan's slices,
        and whether a rerun gives the same bits."""
        (n, _, _), r = fwd_in[0].shape, fwd_in[1]
        slices = klt.batch_slices(n, klt.fwd_plan, r.shape[0], sms, r.element_size())
        before = klt.LAUNCHES["lstm_train_fwd"]
        got = klt.lstm_train_fwd(*fwd_in)
        launches = klt.LAUNCHES["lstm_train_fwd"] - before
        again = klt.lstm_train_fwd(*fwd_in)
        ref = klt.lstm_train_fwd_reference(*fwd_in)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("y", "c_seq", "v"), got, ref):
            d = (a - b).abs()
            errs[name], errs[name + "_mean"] = float(d.max()), float(d.mean())
        identical = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        return got, errs, finite, {"launches": launches, "slices": len(slices),
                                   "rerun_bit_identical": identical}

    for n, t, h in TRAIN_KERNEL_CASES:
        for r_dtype in (torch.bfloat16, torch.float32):
            fwd_in, bwd_in = _train_kernel_inputs(n, t, h, gen, r_dtype)
            got_f, errs, finite_f, fwd_run = run_fwd(fwd_in)
            before = klt.LAUNCHES["lstm_train_bwd"]
            got_b = klt.lstm_train_bwd(*bwd_in)
            bwd_launches = klt.LAUNCHES["lstm_train_bwd"] - before
            ref_b = klt.lstm_train_bwd_reference(*bwd_in)
            torch.cuda.synchronize()
            for name, a, r in zip(("dv", "dh0", "dc0"), got_b, ref_b):
                scale = max(float(r.abs().max()), 1e-30)
                d = (a - r).abs()
                errs[name] = float(d.max()) / scale
                errs[name + "_mean"] = float(d.mean()) / scale
            finite = finite_f and all(bool(torch.isfinite(x).all()) for x in got_b)
            log("kernel_train", n=n, t=t, h=h, r_dtype=str(r_dtype),
                finite=finite, err=errs, bwd_launches=bwd_launches, fwd=fwd_run,
                tol_fwd_abs=TRAIN_FWD_TOL,
                tol_fwd_mean=TRAIN_FWD_TOL_MEAN, tol_bwd_rel=TRAIN_BWD_TOL,
                tol_bwd_mean_rel=TRAIN_BWD_TOL_MEAN)
            worst["lstm_train_fwd"] = max(worst["lstm_train_fwd"], errs["y"],
                                          errs["c_seq"], errs["v"])
            worst["lstm_train_bwd"] = max(worst["lstm_train_bwd"], errs["dv"],
                                          errs["dh0"], errs["dc0"])
            bad = {}
            for k, e in errs.items():
                fwd = k.split("_mean")[0] in ("y", "c_seq", "v")
                mean = k.endswith("_mean")
                tol = ((TRAIN_FWD_TOL_MEAN if mean else TRAIN_FWD_TOL) if fwd
                       else (TRAIN_BWD_TOL_MEAN if mean else TRAIN_BWD_TOL))
                if not e <= tol:
                    bad[k] = e
            if (bad or not finite or bwd_launches != 1 or fwd_run["launches"] != 1
                    or not fwd_run["rerun_bit_identical"]):
                raise AssertionError(f"training kernels vs twins at "
                                     f"{(n, t, h, r_dtype)}: {bad}, E launches "
                                     f"{bwd_launches}, D {fwd_run}")
    # D alone past one launch's batch and past the resident range
    for n, t, h in TRAIN_FWD_EXTRA_CASES:
        for r_dtype in (torch.bfloat16, torch.float32):
            fwd_in, _ = _train_kernel_inputs(n, t, h, gen, r_dtype)
            size = fwd_in[1].element_size()
            plan = klt.fwd_plan(klt.batch_slices(n, klt.fwd_plan, h, sms, size)[0][1],
                                h, sms, size)
            _, errs, finite, fwd_run = run_fwd(fwd_in)
            log("kernel_train_fwd", n=n, t=t, h=h, r_dtype=str(r_dtype),
                finite=finite, err=errs, fwd=fwd_run, grid=plan.grid,
                units=plan.units, kw=plan.kw, r_resident=plan.resident,
                tol_fwd_abs=TRAIN_FWD_TOL, tol_fwd_mean=TRAIN_FWD_TOL_MEAN)
            worst["lstm_train_fwd"] = max(worst["lstm_train_fwd"], errs["y"],
                                          errs["c_seq"], errs["v"])
            bad = {k: e for k, e in errs.items() if not e <= (
                TRAIN_FWD_TOL_MEAN if k.endswith("_mean") else TRAIN_FWD_TOL)}
            if (bad or not finite or fwd_run["launches"] != fwd_run["slices"]
                    or not fwd_run["rerun_bit_identical"]):
                raise AssertionError(f"D at {(n, t, h, r_dtype)}: {bad}, {fwd_run}")
    # E at a batch above one launch's (row, unit) owners: one cooperative
    # launch per slice that bwd_plan takes
    n, t, h = TRAIN_BWD_SLICED_CASE
    for r_dtype in (torch.bfloat16, torch.float32):
        _, bwd_in = _train_kernel_inputs(n, t, h, gen, r_dtype)
        slices = klt.batch_slices(n, klt.bwd_plan, h, bwd_in[-1].element_size(),
                                  build.sm_count(0))
        before = klt.LAUNCHES["lstm_train_bwd"]
        got_b = klt.lstm_train_bwd(*bwd_in)
        bwd_launches = klt.LAUNCHES["lstm_train_bwd"] - before
        ref_b = klt.lstm_train_bwd_reference(*bwd_in)
        torch.cuda.synchronize()
        errs = {}
        for name, a, r in zip(("dv", "dh0", "dc0"), got_b, ref_b):
            scale = max(float(r.abs().max()), 1e-30)
            d = (a - r).abs()
            errs[name] = float(d.max()) / scale
            errs[name + "_mean"] = float(d.mean()) / scale
        log("kernel_train_sliced", n=n, t=t, h=h, r_dtype=str(r_dtype),
            slices=[rows for _, rows in slices], bwd_launches=bwd_launches,
            err=errs, tol_bwd_rel=TRAIN_BWD_TOL, tol_bwd_mean_rel=TRAIN_BWD_TOL_MEAN)
        worst["lstm_train_bwd"] = max(worst["lstm_train_bwd"], errs["dv"],
                                      errs["dh0"], errs["dc0"])
        bad = {k: e for k, e in errs.items() if not e <= (
            TRAIN_BWD_TOL_MEAN if k.endswith("_mean") else TRAIN_BWD_TOL)}
        if bad or len(slices) < 2 or bwd_launches != len(slices):
            raise AssertionError(f"E over batch slices at {(n, t, h, r_dtype)}: "
                                 f"{bad}, {bwd_launches} launches for {slices}")
    return worst


def train_kernel_bound_ms(kind: str, n: int, t: int, h: int, r_bytes: int = 2):
    """Least time for one call of D ("fwd") or E ("bwd"): each input read
    once, each output written once, against the bf16 tensor rate for the
    2 N T H 4H flops of the recurrent products (D: one per step; E: T - 1
    carries and dh0)."""
    seq, gseq, state = 4 * n * t * h, 4 * n * t * 4 * h, 4 * n * h
    r = r_bytes * h * 4 * h
    nbytes = {"fwd": gseq + r + 2 * state + 2 * seq + gseq,
              "bwd": 4 * seq + gseq + r + gseq + 2 * state}[kind]
    return roofline_ms(nbytes, 2.0 * n * t * h * 4 * h)


def train_kernel_rows(seed: int, worst: dict, launches: dict) -> list[dict]:
    """D and E timed at the main path's shape (N 16, T 49, H 1024, bf16
    R) beside their twins; the yardstick is cuDNN's bf16 LSTM of that
    shape in training (it also computes x @ W): its forward for D, its
    backward (inputs and weights) for E. Rows of the kernels line."""
    import torch

    from libreasr_tpu_torch.ops.kernels import lstm_train as klt

    n, t, h = TRAIN_KERNEL_CASES[-1]
    gen = torch.Generator().manual_seed(seed + 6)
    fwd_in, bwd_in = _train_kernel_inputs(n, t, h, gen, torch.bfloat16)
    ref = torch.nn.LSTM(h, h, batch_first=True, device="cuda",
                        dtype=torch.bfloat16).train()
    x = torch.randn((n, t, h), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    hx = tuple(torch.zeros((1, n, h), device="cuda", dtype=torch.bfloat16)
               for _ in range(2))
    lib_fwd = cuda_ms(lambda: ref(x, hx), reps=20)
    out = ref(x, hx)[0]
    g = torch.randn_like(out)
    wrt = [x, *ref.parameters()]
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, wrt, g, retain_graph=True),
                      reps=20)
    rows, times = [], {}
    with torch.inference_mode():
        for name, kind, line, kernel, twin, lib in (
            ("lstm_train_fwd", "fwd", 441, lambda: klt.lstm_train_fwd(*fwd_in),
             lambda: klt.lstm_train_fwd_reference(*fwd_in), lib_fwd),
            ("lstm_train_bwd", "bwd", 492, lambda: klt.lstm_train_bwd(*bwd_in),
             lambda: klt.lstm_train_bwd_reference(*bwd_in), lib_bwd),
        ):
            ms = cuda_ms(kernel, reps=20)
            plain_ms = cuda_ms(twin, reps=5)
            bound, bound_by = train_kernel_bound_ms(kind, n, t, h)
            times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                           "library_ms": lib}
            rows.append({
                "name": name, "route": "cuda",
                "source": "libreasr_tpu_torch/csrc/lstm_train.cu",
                "replaces": f"libreasr_tpu/ops/pallas/lstm.py:{line}",
                "launches": launches[name], "max_abs_err": worst[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": lib,
            })
    log("train_kernel_timing", n=n, t=t, h=h, r_dtype="bfloat16", kernels=times)
    return rows


TRAIN_CLI_CLIPS = {"train": 40, "valid": 8}


def _write_noise_corpus(root: str, seed: int) -> None:
    """Seeded noise WAVs of 2.5-3.75 s with short word labels, and the
    dataset CSVs (file,xstart,xlen,label,ylen,sr,bad) of each split."""
    import wave

    import numpy as np

    rng = np.random.default_rng(seed)
    words = ["yes", "no", "stop", "go", "up", "down", "left", "right"]
    for split, count in TRAIN_CLI_CLIPS.items():
        lines = ["file,xstart,xlen,label,ylen,sr,bad"]
        for i in range(count):
            s = int(rng.integers(40000, 60001))
            pcm = (rng.standard_normal(s) * 0.1).clip(-1, 1)
            name = f"{split}-{i:03d}.wav"
            with wave.open(os.path.join(root, name), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((pcm * 32767).astype(np.int16).tobytes())
            label = " ".join(rng.choice(words, 2))
            lines.append(f"{name},0,{s / 16.0},{label},{len(label)},16000,False")
        with open(os.path.join(root, f"asr-dataset-{split}.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _chain_steps_check(conf_path: str, tmp: str) -> dict:
    """The CLI's --chain-steps 2 against two single steps, each from a
    fresh start: the same parameters bit for bit, as two single-step runs
    repeat each other bit for bit on an H100. Every clip of the noise
    corpus falls in one bucket, so the chain takes the first two batches
    in the single steps' order: on the card this holds the CLI's chain
    wiring on CUDA and the card's repeatability. The buffering across
    bucket shapes and the remainder are tests/test_torch_train_cli.py's."""
    import contextlib
    import io

    import torch

    from libreasr_tpu_torch import train
    from libreasr_tpu_torch.training.learner import Learner

    calls = []
    real = Learner.step_chained

    def counting(self, batches):
        calls.append(len(batches))
        return real(self, batches)

    states, secs, done = {}, {}, {}
    Learner.step_chained = counting
    try:
        for name, extra in (("chained", ["--chain-steps", "2"]), ("single", [])):
            d = os.path.join(tmp, name)
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                train.main(_cli_args(conf_path, d) + ["--steps", "2", *extra])
            secs[name] = time.perf_counter() - t0
            done[name] = _done_line(buf.getvalue())
            states[name] = torch.load(os.path.join(d, "train_state.pt"),
                                      map_location="cpu", weights_only=True)["model"]
    finally:
        Learner.step_chained = real
    a, b = states["chained"], states["single"]
    out = dict(chained_calls=calls, seconds=secs,
               bit_equal=all(torch.equal(x, b[k]) for k, x in a.items()),
               max_abs=max(float((x.double() - b[k].double()).abs().max())
                           for k, x in a.items() if x.is_floating_point()))
    if calls != [2] or not out["bit_equal"]:
        raise AssertionError(f"--chain-steps 2 against single steps: {out}")
    return out, {"state": b, "done": done["single"]}


def _cli_args(conf_path: str, d: str) -> list:
    """The CLI flags of a 2-step run from a fresh start with one eval, at
    its end (the chain check's and train_cli_dist's)."""
    return ["--config", conf_path, "--ckpt", d, "--logdir", d + "_runs",
            "--eval-batches", "1", "--eval-every", "1000"]


def _done_line(out: str) -> str:
    return next(ln for ln in out.splitlines() if ln.startswith("[train] done"))


def _train_cli_conf(tmp: str, seed: int) -> str:
    """train_cli's corpus of noise WAVs in `tmp` and its config there
    (base.yaml's model as written, accumulation 1). Returns its path."""
    import yaml

    from libreasr_tpu_torch.config import parse_and_apply_config

    _write_noise_corpus(tmp, seed)
    conf = parse_and_apply_config()
    conf.update(datasets=["noise"], dataset_paths={"noise": tmp},
                accumulate_n_batches=1,
                tokenizer={"model_file": os.path.join(tmp, "none")})
    path = os.path.join(tmp, "conf.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return path


def phase_train_cli(seed: int, card: str) -> dict:
    """The training CLI at full width: base.yaml's model as written, the
    noise corpus, accumulation 1 so that every step updates. Returns the
    plain 2-step run of the chain check: its parameters and done line."""
    import contextlib
    import io

    import numpy as np
    import torch
    import yaml

    from libreasr_tpu_torch import train
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.ops.kernels import lstm_train as klt

    with tempfile.TemporaryDirectory() as tmp:
        path = _train_cli_conf(tmp, seed)
        with open(path) as f:
            conf = yaml.safe_load(f)
        bundle_path = os.path.join(tmp, "bundle.tar.gz")
        common = ["--config", path, "--ckpt", os.path.join(tmp, "ckpt"),
                  "--logdir", os.path.join(tmp, "runs"), "--eval-batches", "1"]
        outs, secs = [], []
        klt.reset_launches()
        for extra in (["--steps", "2", "--eval-every", "1",
                       "--bundle-out", bundle_path], ["--steps", "3"]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                train.main(common + extra)
            secs.append(time.perf_counter() - t0)
            outs.append(buf.getvalue())
        launches = dict(klt.LAUNCHES)
        bundle = ASRBundle.from_bundle(bundle_path, extract_to=os.path.join(tmp, "x"),
                                       device="cuda")
        rng = np.random.default_rng(seed)
        audio = (rng.standard_normal((2, 48000)) * 0.1).astype(np.float32)
        texts, metrics = bundle.transcribe_batch(audio, np.array([48000, 30000]))
        chain, plain = _chain_steps_check(path, tmp)
    first, second = outs
    lines = [ln for o in outs for ln in o.splitlines()
             if ln.startswith(("[eval]", "[train] resumed", "[train] done"))]
    log("train_cli", card=card, seconds=secs, lines=lines,
        train_kernel_launches=launches, bundle_texts=texts,
        bundle_hidden=bundle.cfg.hidden_sz, chain_steps=chain)
    ok = ("[eval]" in first and "wer=" in first and "done: step=2" in first
          and "resumed" in second and "done: step=3" in second
          and "done: step=2" not in second and all(launches.values())
          and len(texts) == 2 and bundle.cfg.hidden_sz == conf["model"]["hidden_sz"]
          and np.isfinite(np.asarray(metrics["alignment_score"])).all())
    if not ok:
        raise AssertionError("training CLI: " + "\n".join(outs))
    return plain


# --- the Transducer options the JAX config and CLI accept -------------------

# the card's delta features against the CPU's: the frontend's own bound
# (tests/test_torch_frontend.py: the DFT products' summation order, a few
# 1e-6 in the log-mel; a delta of window 3 is a half difference of two)
FRONTEND_TOL = 1e-4
OPTION_REPS = 3           # transcribe timings of the option bundles (deltas: 7)
OPTION_TRAIN_STEPS = 3
OPTION_OPTIMIZERS = ("ranger_adabelief", "lamb", "apollo")
ADAHESSIAN_STEPS = 2
OPTION_STREAMS = 64


def _options_conf(*, deltas: int = 0, layer_norm: bool = False,
                  joint: str = "concat", compute: str | None = None,
                  inference: bool = True) -> dict:
    """config/base.yaml at full width with the options set: delta
    features (feature_sz follows), LayerNorm-LSTM encoder cells, the
    joint method, the compute type."""
    from libreasr_tpu_torch.config import parse_and_apply_config

    conf = parse_and_apply_config(inference=inference)
    if deltas:
        conf["deltas"] = deltas
        conf["model"]["feature_sz"] = (conf["melkwargs"]["n_mels"] * (1 + deltas)
                                       * 10)
    conf["model"]["encoder"]["layer_norm"] = layer_norm
    conf["model"]["joint"]["method"] = joint
    if compute:
        conf["dtypes"]["compute"] = compute
    return conf


def phase_options_full_width(seed: int, card: str) -> None:
    """The serving options at full width on the 16 ragged 6 s clips:
    delta features (the card's features against the CPU's; B 6 launches a
    transcribe_batch), an LN encoder (the scan cells: no A/B launch) and
    the same bundle int8 (no C launch), an add-joint bundle (B 6 launches;
    greedy and beam K 4 on the card against the CPU in float32, every row
    equal), a StreamingEngine of N 64 on an LN + add bundle (a replay
    against the uncaptured step), and Joint.int8_step on add raising."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.models.beam import beam_decode
    from libreasr_tpu_torch.models.decode import greedy_decode
    from libreasr_tpu_torch.models.streaming import StreamingConfig, StreamingEngine
    from libreasr_tpu_torch.ops.frontend import features_batch

    layers = 6
    row = {"card": card}

    # delta features: 2560-dim frames, the encoder on kernel B
    conf = _options_conf(deltas=1)
    bundle = ASRBundle.from_config(conf, seed=seed, device="cuda")
    audio, lengths, audio_d, lengths_d, feats, flens = _full_width_clips(bundle, seed)
    cpu_feats, cpu_flens = features_batch(torch.from_numpy(audio),
                                          torch.from_numpy(lengths), bundle.frontend)
    feat_err = float((feats.cpu() - cpu_feats).abs().max())
    (texts, metrics), launches = _counted(
        lambda: bundle.transcribe_batch(audio, lengths))
    ms = wall_ms(lambda: bundle.transcribe_batch(audio, lengths), 7)
    row["deltas"] = dict(feature_sz=int(feats.shape[-1]), features_max_abs=feat_err,
                         tol=FRONTEND_TOL, launches=launches,
                         transcribe_batch_ms_median=statistics.median(ms),
                         transcribe_batch_ms_runs=ms)
    if feat_err > FRONTEND_TOL or not torch.equal(flens.cpu(), cpu_flens) \
            or feats.shape[-1] != 2560 or launches != {"lstm_seq_cseq": layers} \
            or not np.isfinite(np.asarray(metrics["alignment_score"])).all():
        raise AssertionError(f"options deltas: {row['deltas']}")
    del bundle, feats

    # LayerNorm-LSTM encoder: the scan cells, float and int8
    bundle = ASRBundle.from_config(_options_conf(layer_norm=True), seed=seed,
                                   device="cuda")
    for name in ("layer_norm", "layer_norm_int8"):
        if name == "layer_norm_int8":
            bundle.quantize()
        (texts, metrics), launches = _counted(
            lambda: bundle.transcribe_batch(audio, lengths))
        ms = wall_ms(lambda: bundle.transcribe_batch(audio, lengths), OPTION_REPS)
        row[name] = dict(launches=launches, transcribe_batch_ms_median=statistics.median(ms),
                         transcribe_batch_ms_runs=ms)
        if launches or len(texts) != 16 \
                or not np.isfinite(np.asarray(metrics["alignment_score"])).all():
            raise AssertionError(f"options {name}: {row[name]}")
    del bundle

    # the add joint, float32 so that the card and the CPU decode alike,
    # sharpened so that it emits (_make_emitting)
    add = {d: ASRBundle.from_config(_options_conf(joint="add", compute="float32"),
                                    seed=seed, device=d) for d in ("cuda", "cpu")}
    for b in add.values():
        _make_emitting(b)
    bundle, cfg = add["cuda"], add["cuda"].cfg
    (texts, _), greedy_launches = _counted(lambda: bundle.transcribe_batch(audio, lengths))
    (btexts, scores), beam_launches = _counted(
        lambda: bundle.transcribe_beam(audio, lengths, beam_width=BEAM_WIDTH))
    g_ms = wall_ms(lambda: bundle.transcribe_batch(audio, lengths), OPTION_REPS)
    b_ms = wall_ms(lambda: bundle.transcribe_beam(audio, lengths,
                                                  beam_width=BEAM_WIDTH), OPTION_REPS)
    with torch.inference_mode():
        enc_out, flens = bundle._encode_audio(audio, lengths)
        kw = dict(vocab_sz=cfg.vocab_sz, blank=cfg.blank, bos=cfg.bos)
        greedy = [greedy_decode(b.decoder_fns(use_lm=False), e, f, **kw)[:2]
                  for b, e, f in ((add["cuda"], enc_out, flens),
                                  (add["cpu"], enc_out.cpu(), flens.cpu()))]
        beams = [beam_decode(b.decoder_fns(use_lm=False), e, f, beam_width=BEAM_WIDTH,
                             max_expand=BEAM_EXPAND, **kw)
                 for b, e, f in ((add["cuda"], enc_out, flens),
                                 (add["cpu"], enc_out.cpu(), flens.cpu()))]
    (gt, gl), (ht, hl) = ((t.cpu(), n.cpu()) for t, n in greedy)
    (ct, cl, cs), (bt, bl, bs) = ((t.cpu(), n.cpu(), s.cpu()) for t, n, s in beams)
    greedy_rows = sum(bool(gl[i] == hl[i] and torch.equal(gt[i, : gl[i]], ht[i, : hl[i]]))
                      for i in range(len(gl)))
    beam_rows = sum(bool(cl[i] == bl[i] and torch.equal(ct[i, : cl[i]], bt[i, : bl[i]]))
                    for i in range(len(cl)))
    gap = float((cs - bs).abs().max())
    row["add_joint"] = dict(
        compute="float32", greedy_launches=greedy_launches, beam_launches=beam_launches,
        transcribe_batch_ms_median=statistics.median(g_ms), transcribe_batch_ms_runs=g_ms,
        transcribe_beam_ms_median=statistics.median(b_ms), transcribe_beam_ms_runs=b_ms,
        greedy_tokens=int(gl.sum()), beam_tokens=int(cl.sum()),
        greedy_rows_equal=greedy_rows, beam_rows_equal=beam_rows,
        beam_max_score_gap=gap, score_gap_max=BEAM_SCORE_GAP,
        texts_sample=texts[:2])
    want = {"lstm_seq_cseq": layers}
    if greedy_launches != want or beam_launches != want or greedy_rows != 16 \
            or beam_rows != 16 or gap > BEAM_SCORE_GAP or not int(gl.sum()) \
            or not np.isfinite(scores).all():
        raise AssertionError(f"options add joint: {row['add_joint']}")
    try:
        bundle.model.joint.int8_step()
    except ValueError as e:
        row["add_joint"]["int8_step_raises"] = str(e)
    else:
        raise AssertionError("Joint.int8_step on the add joint did not raise")
    del add, bundle, enc_out

    # a StreamingEngine on an LN + add bundle: one CUDA graph a step
    bundle = ASRBundle.from_config(_options_conf(layer_norm=True, joint="add"),
                                   seed=seed, device="cuda")
    scfg = StreamingConfig(sr=bundle.frontend.sr, transfer_dtype="int16",
                           max_iters=bundle.conf["stream"]["max_iters"])
    _reset_kernel_launches()
    eng = StreamingEngine(bundle, n_streams=OPTION_STREAMS, scfg=scfg)
    first = _eager_vs_graph(eng, _stream_clips(OPTION_STREAMS, seed + 1), steps=4)
    launches = {k: v for k, v in _kernel_launches().items() if v}
    replay_ms = cuda_ms(lambda: eng._graph.replay(), reps=20)
    row["streaming_ln_add"] = dict(n_streams=OPTION_STREAMS, replay_device_ms=replay_ms,
                                   graph_replays=eng.replays, steps=eng.steps,
                                   kernel_launches=launches, **first)
    if eng.replays != eng.steps or launches:
        raise AssertionError(f"options streaming: {row['streaming_ln_add']}")
    del eng, bundle
    torch.cuda.empty_cache()
    log("options_full_width", **row)


def phase_options_train_full_width(seed: int, card: str) -> None:
    """The training options at full width on the train batches (N 16, T
    49): 3 steps each of ranger_adabelief, lamb and apollo on the D/E +
    F/G/H route (D and E 6 launches a step, F, G, H one); 3 steps with
    deltas, an LN encoder and the add joint together (the lattice loss
    on the scan cells: no kernel); 2 AdaHessian steps on the scan route
    (use_pallas_train false), with step ms and peak memory; and one
    AdaHessian step on the D/E route, which must raise."""
    import math

    import torch

    from libreasr_tpu_torch.training.learner import Learner

    row = {"card": card, "n": 16}

    def run(conf, steps, name, want=None):
        learner = Learner.from_config(conf, device="cuda", seed=seed)
        batches = _train_batches(learner.cfg, learner.frontend, seed, steps=steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, launches = [], [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, counts = _counted(lambda: learner.step(b))
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(counts)
        out = dict(losses=losses, step_ms_runs=ms,
                   step_ms_median_after_first=statistics.median(ms[1:]),
                   launches_per_step=launches,
                   peak_memory_mib=torch.cuda.max_memory_allocated() / 2**20)
        row[name] = out
        if not all(math.isfinite(x) for x in losses) \
                or any(c != (want or {}) for c in launches):
            raise AssertionError(f"options train {name}: {out}, launches "
                                 f"expected {want or {}}")
        del learner, batches

    route = {"lstm_train_fwd": 6, "lstm_train_bwd": 6, "joint_lp_fwd": 1,
             "joint_lp_dx": 1, "joint_lp_dw": 1}
    for name in OPTION_OPTIMIZERS:
        conf = train_conf(accumulate=1)
        conf["training"]["optimizer"] = name
        run(conf, OPTION_TRAIN_STEPS, name, route)
    conf = _options_conf(deltas=1, layer_norm=True, joint="add", inference=False)
    conf["accumulate_n_batches"] = 1
    conf["loss"]["fused"] = False
    run(conf, OPTION_TRAIN_STEPS, "deltas_layer_norm_add")
    conf = train_conf(accumulate=1, use_train_kernel=False)
    conf["training"]["optimizer"] = "adahessian"
    conf["loss"]["fused"] = False
    run(conf, ADAHESSIAN_STEPS, "adahessian_scan_route")
    conf = train_conf(accumulate=1)
    conf["training"]["optimizer"] = "adahessian"
    conf["loss"]["fused"] = False
    learner = Learner.from_config(conf, device="cuda", seed=seed)
    batch = _train_batches(learner.cfg, learner.frontend, seed, steps=1)[0]
    try:
        learner.step(batch)
    except ValueError as e:
        if "use_pallas_train: false" not in str(e):
            raise
        row["adahessian_kernel_route_raises"] = str(e)
    else:
        raise AssertionError("AdaHessian on the D/E route did not raise")
    del learner, batch
    torch.cuda.empty_cache()
    log("options_train_full_width", **row)


# the tone recipe in chip_smoke: steps, dev evals, beam width of the
# second test eval (scripts/run_tone_recipe.py runs it longer); 100
# steps keep the whole script within about two minutes of its time
# before these phases
TONE_STEPS = 100
TONE_EVAL_EVERY = 50
TONE_EVAL_BATCHES = 4
TONE_VOCAB = 64
TONE_BEAM = 4


def phase_train_tone_stream(card: str, out: str, *,
                            steps: int = TONE_STEPS,
                            eval_every: int = TONE_EVAL_EVERY,
                            eval_batches: int = TONE_EVAL_BATCHES,
                            phase: str = "train_tone_stream") -> str:
    """The port's tone recipe (libreasr_tpu_torch.scripts.train_tone_stream)
    in this process at full width: config/base.yaml with the recipe's
    settings and its seed (42), a BPE tokenizer of TONE_VOCAB trained by
    the port, the ladder from the sampled histogram; `steps` steps with a
    dev eval every `eval_every` (timed with the best-WER checkpoint's
    save), the best-WER export and the recipe's final test eval, then the
    held-out test split greedy and with beam search (K TONE_BEAM) on the
    reloaded bundle, timed alike, and where the two decodes part. Each
    step is timed with a sync on its loss, and the host's wait for the
    next batch between steps (evals excluded). Returns the bundle."""
    import io

    import numpy as np
    import torch
    import yaml

    from libreasr_tpu_torch import train
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.data.bpe import BPELanguage
    from libreasr_tpu_torch.data.synth import ToneStreamDataset
    from libreasr_tpu_torch.scripts import train_tone_stream as recipe
    from libreasr_tpu_torch.training import learner as lmod
    from libreasr_tpu_torch.training.evaluate import evaluate_bundle

    steps_ms, waits_ms, losses, evals = [], [], [], []
    last_end = [None]
    real_step, real_eval = lmod.Learner.step, train._run_eval

    def timed_step(self, batch):
        t0 = time.perf_counter()
        if last_end[0] is not None:
            waits_ms.append((t0 - last_end[0]) * 1e3)
        metrics = real_step(self, batch)
        losses.append(float(metrics["loss"]))  # syncs the step
        last_end[0] = time.perf_counter()
        steps_ms.append((last_end[0] - t0) * 1e3)
        return metrics

    def timed_eval(learner, lang, valid_ds, logger, step, *a):
        t0 = time.perf_counter()
        res = real_eval(learner, lang, valid_ds, logger, step, *a)
        evals.append({"step": step, "wer": res.wer, "cer": res.cer, "n": res.n,
                      "ms_with_save": (time.perf_counter() - t0) * 1e3})
        last_end[0] = None  # the next wait is not the loader's
        return res

    argv = ["--out", out, "--steps", str(steps), "--eval-every", str(eval_every),
            "--eval-batches", str(eval_batches), "--vocab-sz", str(TONE_VOCAB),
            "--retries", "1", "--device", "cuda",
            "--config", os.path.join(HERE, "config", "base.yaml")]
    buf = io.StringIO()
    _reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    lmod.Learner.step, train._run_eval = timed_step, timed_eval
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            recipe.main(argv)
    except BaseException:
        print(buf.getvalue()[-8000:], file=sys.stderr)
        raise
    finally:
        lmod.Learner.step, train._run_eval = real_step, real_eval
    run_s = time.perf_counter() - t0
    train_launches = _kernel_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    text = buf.getvalue()
    ladder = [ln.strip() for ln in text.splitlines() if ln.startswith("  max ")]

    conf = yaml.safe_load(open(os.path.join(out, "tone_stream.yaml")))
    tok_file = os.path.join(out, "tokenizer.bpe-model")
    bundle_path = os.path.join(out, "model.tar.gz")
    test_rows = sum(len(b.audio) for b in ToneStreamDataset.from_config(
        conf, BPELanguage(tok_file), "test"))
    recipe_test = [ln for ln in text.splitlines() if ln.startswith("[tone-stream] TEST")]
    bundle = ASRBundle.from_bundle(bundle_path, device="cuda",
                                   extract_to=os.path.join(out, "x"))
    tests, preds = {}, {}
    for name, beam in (("greedy", 0), ("beam", TONE_BEAM)):
        _reset_kernel_launches()
        t1 = time.perf_counter()
        res = evaluate_bundle(bundle, iter(ToneStreamDataset.from_config(
            conf, bundle.lang, "test")), beam_width=beam, keep_samples=test_rows)
        torch.cuda.synchronize()
        tests[name] = {"wer": res.wer, "cer": res.cer, "n": res.n,
                       "by_length": res.by_length, "samples": res.samples[:3],
                       "ms": (time.perf_counter() - t1) * 1e3,
                       "b_launches": _kernel_launches()["lstm_seq_cseq"]}
        preds[name] = res.samples
    # where beam search and greedy part: the beam's text a prefix of
    # greedy's (a truncation), shorter, or longer
    differ = [(g, b) for g, b in zip(preds["greedy"], preds["beam"])
              if g["pred"] != b["pred"]]
    beam_vs_greedy = {
        "differ": len(differ),
        "beam_prefix_of_greedy": sum(g["pred"].startswith(b["pred"])
                                     for g, b in differ),
        "beam_shorter": sum(len(b["pred"]) < len(g["pred"]) for g, b in differ),
        "beam_longer": sum(len(b["pred"]) > len(g["pred"]) for g, b in differ),
        "examples": [{"target": g["target"], "greedy": g["pred"],
                      "beam": b["pred"]} for g, b in differ[:8]],
    }
    fills = [w for w in waits_ms if w > 500.0]  # an epoch's first window
    first = statistics.median(losses[:20])
    last = statistics.median(losses[-50:])
    log(phase, card=card, steps=len(losses), run_s=run_s, ladder=ladder,
        step_ms_median=statistics.median(steps_ms[1:]),
        step_ms_p90=float(np.percentile(steps_ms[1:], 90)), step_ms_first=steps_ms[0],
        batch_wait_ms_median=statistics.median(waits_ms),
        batch_wait_ms_p90=float(np.percentile(waits_ms, 90)),
        batch_wait_ms_max=max(waits_ms),
        host_wait_share=sum(waits_ms) / (sum(waits_ms) + sum(steps_ms[1:])),
        window_fills=len(fills), window_fill_ms_sum=sum(fills),
        recipe_test=recipe_test, beam_vs_greedy=beam_vs_greedy,
        loss_first20_median=first, loss_last50_median=last,
        loss_every_50=losses[::50], dev_evals=evals, test=tests,
        test_rows=test_rows, eval_utts=conf["synth_tone"]["eval_utts"],
        train_kernel_launches=train_launches, peak_memory_mib=peak_mib,
        vocab=len(bundle.lang), model_vocab=bundle.cfg.vocab_sz)
    want = ("lstm_train_fwd", "lstm_train_bwd", "joint_lp_fwd", "joint_lp_dx",
            "joint_lp_dw", "lstm_seq_cseq")
    checks = {
        "every step, every loss finite": len(losses) == steps
        and all(map(math.isfinite, losses)),
        "loss falls (median of the last 50 < of the first 20)": last < first,
        "D, E, F, G, H and B launched": all(train_launches[k] > 0 for k in want),
        "dev evals ran": len(evals) >= 1,
        # every test row the batcher emits (a bucket's leftover of one is
        # dropped, as in JAX), B launched in both evals
        "test evals score every emitted row": all(
            t["b_launches"] > 0 and t["n"] == test_rows for t in tests.values())
        and conf["synth_tone"]["eval_utts"] - len(conf["buckets"]) <= test_rows,
        "the recipe's own test eval is the greedy one": len(recipe_test) == 1
        and f"wer={tests['greedy']['wer']:.3f} " in recipe_test[0],
        "the bundle reloads with the trained tokenizer":
        isinstance(bundle.lang, BPELanguage) and bundle.device.type == "cuda"
        and bundle.lang.vocab == BPELanguage(tok_file).vocab,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{phase}: {failed}")
    return bundle_path


def phase_evaluate_wer(seed: int, bundle_path: str) -> None:
    """make_tone_corpus writes a test split of 16 WAVs and its CSV;
    evaluate_wer scores it with the tone bundle and beam search (K 4):
    the WER and WER[...] lines are printed; --use-lm raises."""
    import io

    from libreasr_tpu_torch.scripts import evaluate_wer, make_tone_corpus

    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            make_tone_corpus.main(["--out", tmp, "--train", "0", "--valid", "0",
                                   "--test", "16", "--seed", str(seed)])
        split = os.path.join(tmp, "test-clean")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = evaluate_wer.main(["--dataset", split, "--bundle", bundle_path,
                                     "--beam", str(TONE_BEAM)])
        secs = time.perf_counter() - t0
        try:
            evaluate_wer.main(["--dataset", split, "--use-lm"])
            refused = False
        except NotImplementedError:
            refused = True
    lines = buf.getvalue().splitlines()
    log("evaluate_wer", seconds=secs, n=res.n, wer=res.wer, cer=res.cer,
        lines=[ln for ln in lines if "WER" in ln], use_lm_refused=refused)
    if not (refused and res.n == 16
            and any(ln.startswith("[eval] n=16 WER=") for ln in lines)
            and any(ln.startswith("  WER[") for ln in lines)):
        raise AssertionError("evaluate_wer:\n" + "\n".join(lines))


STREAM_CHUNK = 1280  # 80 ms at 16 kHz
STREAM_PASSES = 5
STREAM_WIDTHS = (64, 512)
SERVING_STREAMS = 64


def _kernel_launches() -> dict:
    from libreasr_tpu_torch.ops.kernels import joint_lp as kjoint
    from libreasr_tpu_torch.ops.kernels import lstm as klstm
    from libreasr_tpu_torch.ops.kernels import lstm_train as klt

    return {**klstm.LAUNCHES, **kjoint.LAUNCHES, **klt.LAUNCHES}


def _reset_kernel_launches() -> None:
    from libreasr_tpu_torch.ops.kernels import joint_lp as kjoint
    from libreasr_tpu_torch.ops.kernels import lstm as klstm
    from libreasr_tpu_torch.ops.kernels import lstm_train as klt

    for m in (klstm, kjoint, klt):
        m.reset_launches()


def _golden_audio(seconds: int = 1):
    import numpy as np

    from libreasr_tpu_torch.data.audio import read_wav

    audio = np.zeros((8, seconds * 16000), np.float32)
    for i in range(8):
        audio[i, :16000] = read_wav(os.path.join(GOLDEN, f"s-{i:03d}.wav"))[0][0]
    return audio


def _golden_bundles(tmp: str):
    """(name, bundle) on the card: char, char int8 (quantized by the
    port, saved and reloaded), BPE. Each bundle extracts to a directory
    of its own."""
    from libreasr_tpu_torch.api import ASRBundle

    def load(name, sub):
        return ASRBundle.from_bundle(os.path.join(GOLDEN, name), device="cuda",
                                     extract_to=os.path.join(tmp, sub))

    q = load("model.tar.gz", "q").quantize()
    saved = q.save(os.path.join(tmp, "int8.tar.gz"))
    int8 = ASRBundle.from_bundle(saved, device="cuda",
                                 extract_to=os.path.join(tmp, "int8"))
    if int8.conf.get("quantized_cells") is not True:
        raise AssertionError("the saved bundle lost quantized_cells")
    return [("char", load("model.tar.gz", "char")), ("int8", int8),
            ("bpe", load("model_bpe.tar.gz", "bpe"))]


def phase_streaming_golden() -> None:
    """The golden clips through the engine on the card, 8 slots: exact,
    one graph replay a step, no kernel launch."""
    import numpy as np

    from libreasr_tpu_torch.models.streaming import StreamingEngine

    audio = _golden_audio()
    with tempfile.TemporaryDirectory() as tmp:
        for name, bundle in _golden_bundles(tmp):
            _reset_kernel_launches()
            eng = StreamingEngine(bundle, n_streams=8)
            slots = [eng.open_slot() for _ in range(8)]
            for off in range(0, 16000, STREAM_CHUNK):
                for i, s in enumerate(slots):
                    eng.feed(s, audio[i, off : off + STREAM_CHUNK])
            for s in slots:  # flush the frontend's carried tail
                eng.feed(s, np.zeros(STREAM_CHUNK, np.float32))
            texts = [eng.transcript(s) for s in slots]
            launches = {k: v for k, v in _kernel_launches().items() if v}
            log("streaming_golden", bundle=name, texts=texts, steps=eng.steps,
                graph_replays=eng.replays, kernel_launches=launches)
            if texts != GOLDEN_TEXTS:
                raise AssertionError(f"streaming_golden {name}: {texts}")
            if eng.replays != eng.steps or not eng.steps or launches:
                raise AssertionError(f"streaming_golden {name}: {eng.steps} "
                                     f"steps, {eng.replays} replays, "
                                     f"launches {launches}")


def _stream_clips(n: int, seed: int, sr: int = 16000, seconds: int = 6):
    """n ragged clips of seeded noise, 3 to `seconds` s (the first full),
    each a whole number of chunks."""
    import numpy as np

    rng = np.random.default_rng(seed)
    steps = seconds * sr // STREAM_CHUNK
    lengths = rng.integers(steps // 2, steps + 1, n) * STREAM_CHUNK
    lengths[0] = steps * STREAM_CHUNK
    audio = (rng.standard_normal((n, steps * STREAM_CHUNK)) * 0.1).astype(np.float32)
    return [audio[i, : lengths[i]] for i in range(n)]


def _eager_vs_graph(eng, clips, steps: int = 8, state_tol=None) -> dict:
    """The first `steps` steps as graph replays (engine.step_batch), and
    the uncaptured step function on a copy of the state with the same
    inputs: tokens equal, and with `state_tol` the decode state's leaves
    within it too; host ms of each, around a synchronize."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.models.streaming import _leaves

    n, c = eng.n, STREAM_CHUNK
    ref = eng.state.clone()
    ones = torch.ones(n, dtype=torch.bool, device=eng.device)
    zeros = torch.zeros(n, dtype=torch.bool, device=eng.device)
    graph_ms, eager_ms, tokens, state_diff = [], [], 0, 0.0
    for k in range(steps):
        chunks = np.stack([x[k * c : (k + 1) * c] for x in clips])[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, lens = eng.step_batch(chunks)
        graph_ms.append((time.perf_counter() - t0) * 1e3)
        wire = torch.from_numpy(eng._encode_chunks(chunks)).to(eng.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            ref, packed = eng.step_fn(ref, wire, ones, zeros)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        packed = packed.cpu().numpy()
        if not (np.array_equal(lens, packed[:, -1])
                and np.array_equal(toks, packed[:, :-1])):
            raise AssertionError(f"graph replay and uncaptured step differ at "
                                 f"step {k} (N {n})")
        if state_tol is not None:
            state_diff = max([state_diff] + [
                float((a.double() - b.double()).abs().max())
                for a, b in zip(_leaves(eng.state.decode), _leaves(ref.decode))])
            if state_diff > state_tol:
                raise AssertionError(f"graph and uncaptured decode states differ "
                                     f"by {state_diff} at step {k} (N {n})")
        tokens += int(lens.sum())
    out = {"graph_step_ms": graph_ms, "eager_step_ms": eager_ms,
           "graph_step_ms_median": statistics.median(graph_ms[1:]),
           "eager_step_ms_median": statistics.median(eager_ms[1:]),
           "tokens_equal_steps": steps, "tokens": tokens}
    if state_tol is not None:
        out.update(decode_state_max_diff=state_diff, decode_state_tol=state_tol)
    return out


def _pipelined_pass(eng, clips) -> tuple[list[float], int, int, int]:
    """One pass of the clips through fresh slots, a chunk per slot a
    step, dispatch k+1 before collect k. Returns (host ms a step, chunk
    steps, tokens committed by the steps, tokens the closing flushes
    added: beam mode only)."""
    c = STREAM_CHUNK
    slots = [eng.open_slot() for _ in clips]
    steps = max(len(x) for x in clips) // c
    pending, host_ms = None, []
    for k in range(steps):
        for s, x in zip(slots, clips):
            if (k + 1) * c <= len(x):
                eng.append_samples(s, x[k * c : (k + 1) * c])
        t0 = time.perf_counter()
        p = eng.step_dispatch()
        if pending is not None:
            eng.step_collect(pending)
        pending = p
        host_ms.append((time.perf_counter() - t0) * 1e3)
    eng.step_collect(pending)
    tokens = sum(len(eng.emitted[s]) for s in slots)
    for s in slots:
        eng.close_slot(s)
    flushed = sum(len(eng.emitted[s]) for s in slots) - tokens
    return host_ms, sum(len(x) // c for x in clips), tokens, flushed


def phase_streaming_full_width(seed: int, card: str) -> dict:
    """Returns, a width, the replay's device ms and the tokens a chunk,
    and the model's and frontend's configs (the flops phase reads them)."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.models.streaming import StreamingConfig, StreamingEngine

    conf = parse_and_apply_config(inference=True)
    bundle = ASRBundle.from_config(conf, seed=seed, device="cuda")
    scfg = StreamingConfig(sr=bundle.frontend.sr, transfer_dtype="int16",
                           max_iters=conf["stream"]["max_iters"])
    readings = {"cfg": bundle.cfg, "frontend": bundle.frontend, "scfg": scfg}
    for n in STREAM_WIDTHS:
        clips = _stream_clips(n, seed + n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # tensors earlier phases left allocated (the model's among them)
        before_mib = torch.cuda.memory_allocated() / 2**20
        _reset_kernel_launches()
        t0 = time.perf_counter()
        eng = StreamingEngine(bundle, n_streams=n, scfg=scfg)
        build_s = time.perf_counter() - t0
        first = _eager_vs_graph(eng, clips)
        passes, chunk_steps, tokens = [], 0, 0
        for _ in range(STREAM_PASSES):
            ms, cs, tk, _ = _pipelined_pass(eng, clips)
            passes.append(ms)
            chunk_steps, tokens = chunk_steps + cs, tokens + tk
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        launches = {k: v for k, v in _kernel_launches().items() if v}
        replay_ms = cuda_ms(lambda: eng._graph.replay(), reps=20)
        medians = [statistics.median(p) for p in passes]
        every = sorted(x for p in passes for x in p)
        step_ms = statistics.median(medians)
        row = dict(
            card=card, n_streams=n, transfer_dtype=scfg.transfer_dtype,
            max_iters=scfg.max_iters, build_and_capture_s=build_s,
            step_host_ms_median=step_ms, step_host_ms_pass_medians=medians,
            step_host_ms_mean=statistics.fmean(every),
            step_host_ms_p90=every[int(0.9 * (len(every) - 1))],
            replay_device_ms=replay_ms, real_time_share=step_ms / scfg.chunk_ms,
            tokens_per_chunk=tokens / max(chunk_steps, 1),
            steps=eng.steps, graph_replays=eng.replays,
            peak_memory_mib=peak_mib, memory_before_mib=before_mib,
            kernel_launches=launches, **first)
        log("streaming_full_width", **row)
        if eng.replays != eng.steps or launches or not np.isfinite(step_ms):
            raise AssertionError(f"streaming_full_width N {n}: {eng.steps} steps, "
                                 f"{eng.replays} replays, launches {launches}")
        readings[n] = {"replay_device_ms": replay_ms,
                       "tokens_per_chunk": row["tokens_per_chunk"]}
        del eng
        torch.cuda.empty_cache()
    return readings


def _stream_through(servicer, clips, sr: int = 16000, paced: bool = False):
    """Each clip through servicer.TranscribeStream in a thread of its
    own, in 80 ms chunks, at real-time pace from a shared start when
    `paced`. Returns (texts, partial latencies s, overruns s, errors)."""
    import threading

    from libreasr_tpu_torch.serving import proto

    n = len(clips)
    texts, lat, over, errors = [None] * n, [[] for _ in range(n)], [None] * n, []
    start = time.perf_counter() + 0.5

    def client(i):
        sent = {"last": 0.0, "done": 0.0}

        def gen():
            for k, off in enumerate(range(0, len(clips[i]), STREAM_CHUNK)):
                if paced:
                    dt = start + k * STREAM_CHUNK / sr - time.perf_counter()
                    if dt > 0:
                        time.sleep(dt)
                sent["last"] = time.perf_counter()
                yield proto.Audio(
                    data=clips[i][off : off + STREAM_CHUNK].tobytes(), sr=sr)
            sent["done"] = time.perf_counter()

        parts = []
        try:
            for tr in servicer.TranscribeStream(gen()):
                if tr.data:
                    lat[i].append(time.perf_counter() - sent["last"])
                    parts.append(tr.data)
            over[i] = time.perf_counter() - sent["done"]
            texts[i] = "".join(parts)
        except Exception as e:  # reported below, fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serving: a stream did not finish in 120 s")
    return texts, [x for li in lat for x in li], over, errors


# the stages ASRServicer.timings reports once a unary call and a stream ran
SERVING_STAGES = {"preprocess", "transcribe", "stream_step"}


def phase_serving(seed: int, card: str) -> None:
    import numpy as np
    import torch

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.serving import proto
    from libreasr_tpu_torch.serving.server import ASRServicer

    audio3 = _golden_audio(3)
    with tempfile.TemporaryDirectory() as tmp:
        for name, bundle in _golden_bundles(tmp):
            servicer = ASRServicer(bundle)
            try:
                _reset_kernel_launches()
                unary = servicer.Transcribe(proto.Audio(data=audio3[2].tobytes(),
                                                        sr=16000)).data
                launches = {k: v for k, v in _kernel_launches().items() if v}
                clips = [audio3[2, :16000], audio3[3, :16000]]
                texts, _, _, errors = _stream_through(servicer, clips)
            finally:
                servicer.stepper.shutdown()
            kernel = "lstm_seq_int8" if name == "int8" else "lstm_seq_cseq"
            want = {kernel: bundle.cfg.enc_num_layers}
            log("serving_golden", bundle=name, unary_3s=unary, streams=texts,
                kernel_launches_unary=launches, expected=want, errors=errors)
            if unary != "hello world" or launches != want \
                    or texts != ["hello world", "stop now"] or errors:
                raise AssertionError(f"serving_golden {name} failed")

    conf = parse_and_apply_config(inference=True)
    bundle = ASRBundle.from_config(conf, seed=seed, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    before_mib = torch.cuda.memory_allocated() / 2**20
    servicer = ASRServicer(bundle)
    try:
        eng = servicer.engine
        clip = _stream_clips(1, seed)[0]
        _reset_kernel_launches()
        t0 = time.perf_counter()
        unary = servicer.Transcribe(proto.Audio(data=clip.tobytes(), sr=16000)).data
        unary_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in _kernel_launches().items() if v}
        want = {"lstm_seq_cseq": bundle.cfg.enc_num_layers}
        rng = np.random.default_rng(seed)
        clips = [(rng.standard_normal(6 * 16000) * 0.1).astype(np.float32)
                 for _ in range(SERVING_STREAMS)]
        steps0 = eng.steps
        texts, lat, over, errors = _stream_through(servicer, clips, paced=True)
        stream_launches = {k: v for k, v in _kernel_launches().items() if v}
        timings = servicer.timings.snapshot()
    finally:
        servicer.stepper.shutdown()
    lat_ms = np.array(lat) * 1e3
    over_ms = np.array([o for o in over if o is not None]) * 1e3
    log("serving", card=card, n_streams=eng.n, transfer_dtype=eng.scfg.transfer_dtype,
        unary_6s_ms=unary_ms, unary_kernel_launches=launches,
        paced_streams=len(clips), seconds_each=6,
        partial_latency_ms_p50=float(np.percentile(lat_ms, 50)) if len(lat_ms) else None,
        partial_latency_ms_p90=float(np.percentile(lat_ms, 90)) if len(lat_ms) else None,
        partials=len(lat_ms),
        overrun_ms_p50=float(np.percentile(over_ms, 50)) if len(over_ms) else None,
        overrun_ms_p90=float(np.percentile(over_ms, 90)) if len(over_ms) else None,
        steps=eng.steps - steps0, graph_replays=eng.replays, stage_timings=timings,
        peak_memory_mib=torch.cuda.max_memory_allocated() / 2**20,
        memory_before_mib=before_mib, errors=errors[:3])
    if launches != want or stream_launches != want or errors \
            or len(over_ms) != len(clips) or not len(lat_ms) \
            or any(t is None for t in texts) or set(timings) != SERVING_STAGES:
        raise AssertionError("serving at full width failed")


# beam search and LM fusion: the golden test's weights (K 3 there), and
# the full-width cells' K 4, 3 expansion rounds offline, 7 timed runs
GOLDEN_BEAM = 3
LM_ALPHA, LM_BETA = 0.2, 0.6
BEAM_WIDTH, BEAM_EXPAND, BEAM_REPS = 4, 3, 7
BEAM_STREAMS = 64
# the seeded joint sharpened so that beams emit (_make_emitting), and
# the card's beam search against the CPU's there
EMIT_GAIN, EMIT_MASK = 256.0, 64.0
BEAM_ROWS_EQUAL, BEAM_SCORE_GAP = 16, 1e-3


def _counted(fn):
    """fn() with every kernel launch count set to 0 just before and read
    just after. Returns (result, {kernel: launches} of those launched)."""
    import torch

    torch.cuda.synchronize()
    _reset_kernel_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _kernel_launches().items() if v}


def _feed_through(eng, slot, pcm, pad: bool) -> str:
    """pcm into one engine slot in 80 ms chunks (one zero chunk after it
    when `pad`), then finish_slot (the final padded step and the beam
    flush) and close. Returns every text the slot delivered."""
    import numpy as np

    text = "".join(eng.feed(slot, pcm[off : off + STREAM_CHUNK])
                   for off in range(0, len(pcm), STREAM_CHUNK))
    if pad:
        text += eng.feed(slot, np.zeros(STREAM_CHUNK, np.float32))
    text += eng.finish_slot(slot)
    eng.close_slot(slot)
    return text


def phase_golden_beam() -> None:
    """The five golden beam and LM cases on the card, offline, through
    the engine (one graph replay a step) and through the servicer:
    char beam (K 3), BPE beam + LM (K 3, alpha 0.2, beta 0.6) and BPE
    greedy + LM. Offline at 1 s (no kernel launch) and padded to 3 s
    (kernel B once per encoder layer); the beam flush of an unpadded
    stream; raises unless every transcript is exact."""
    import numpy as np

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.models.streaming import StreamingConfig, StreamingEngine
    from libreasr_tpu_torch.serving import proto
    from libreasr_tpu_torch.serving.server import ASRServicer

    audio3 = _golden_audio(3)
    lengths = np.full(8, 16000)
    lm_kw = dict(use_lm=True, lm_alpha=LM_ALPHA, lm_beta=LM_BETA)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        char = ASRBundle.from_bundle(os.path.join(GOLDEN, "model.tar.gz"),
                                     device="cuda",
                                     extract_to=os.path.join(tmp, "char"))
        bpe = ASRBundle.from_bundle(os.path.join(GOLDEN, "model_bpe.tar.gz"),
                                    device="cuda",
                                    extract_to=os.path.join(tmp, "bpe"))
    if char.lm is not None or bpe.lm is None:
        raise AssertionError("golden_beam: the char bundle has no LM, the BPE one has")
    offline = {
        "beam": lambda a: char.transcribe_beam(a, lengths, beam_width=GOLDEN_BEAM)[0],
        "beam_lm": lambda a: bpe.transcribe_beam(a, lengths,
                                                 beam_width=GOLDEN_BEAM, **lm_kw)[0],
        "greedy_lm": lambda a: bpe.transcribe_batch(a, lengths, use_lm=True)[0],
    }
    for name, fn in offline.items():
        for label, clips, want in (("1s", audio3[:, :16000], {}),
                                   ("3s", audio3, {"lstm_seq_cseq": 2})):
            texts, launches = _counted(lambda: fn(clips))
            log("golden_beam_offline", case=name, clips=label, texts=texts,
                kernel_launches=launches, expected_launches=want)
            if texts != GOLDEN_TEXTS or launches != want:
                failures.append(f"offline {name} {label}")

    # the engine cases of tests/test_golden_decode.py and test_serving.py:
    # beam flush with no padding (clips 2 and 3), beam + LM on clip 2
    # with a zero chunk after it (the one the JAX package pins: as in
    # JAX, the streaming beam has no insertion bonus, and clip 3 decodes
    # to nothing), greedy + LM on clips 2 and 3 padded
    pcm = {i: audio3[i, :16000] for i in (2, 3)}
    want2 = ["hello world", "stop now"]
    engines = {
        "beam": (StreamingEngine(char, n_streams=2, scfg=StreamingConfig(
            beam_width=GOLDEN_BEAM)), False, want2),
        "beam_lm": (StreamingEngine(bpe, n_streams=4, use_lm=True,
                                    scfg=StreamingConfig(beam_width=GOLDEN_BEAM,
                                                         lm_alpha=LM_ALPHA)),
                    True, want2[:1]),
        "greedy_lm": (StreamingEngine(bpe, n_streams=4, use_lm=True), True, want2),
    }
    for name, (eng, pad, want) in engines.items():
        got, launches = _counted(lambda: [_feed_through(eng, eng.open_slot(),
                                                        pcm[i], pad)
                                          for i in (2, 3)[: len(want)]])
        log("golden_beam_engine", case=name, texts=got, steps=eng.steps,
            graph_replays=eng.replays, kernel_launches=launches)
        if got != want or eng.replays != eng.steps or not eng.steps or launches:
            failures.append(f"engine {name}")

    # unary beam (+ LM) on the clip padded to 3 s, then streams: the char
    # clips unpadded (the beam flush over the wire), the BPE one padded
    zero = np.zeros(STREAM_CHUNK, np.float32)
    servicers = {
        "beam": (ASRServicer(char, engine=engines["beam"][0],
                             beam_width=GOLDEN_BEAM), [pcm[2], pcm[3]]),
        "beam_lm": (ASRServicer(bpe, engine=engines["beam_lm"][0],
                                beam_width=GOLDEN_BEAM, **lm_kw),
                    [np.concatenate([pcm[2], zero])]),
    }
    for name, (servicer, clips) in servicers.items():
        try:
            unary, launches = _counted(lambda: servicer.Transcribe(proto.Audio(
                data=audio3[2].tobytes(), sr=16000)).data)
            texts, _, _, errors = _stream_through(servicer, clips)
        finally:
            servicer.stepper.shutdown()
        log("golden_beam_servicer", case=name, unary_3s=unary,
            kernel_launches_unary=launches, streams=texts, errors=errors)
        ok = [t is not None and t.endswith(w) for t, w in zip(texts, want2)]
        if unary != "hello world" or launches != {"lstm_seq_cseq": 2} \
                or not all(ok) or len(ok) != len(clips) or errors:
            failures.append(f"servicer {name}")
    if failures:
        raise AssertionError(f"golden_beam: {failures}")


def _lm_bundle(seed: int, device: str = "cuda", compute: str | None = None):
    """config/base.yaml as written, seeded, with its `lm:` block's LM (6
    layers, 1024 wide, V 2048, tied; seed + 1) handed to the bundle: the
    config names no LM path, and from_config builds an LM only from one.
    `compute` overrides the config's compute dtype (the same weights)."""
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.models.lm import LM, LMConfig

    conf = parse_and_apply_config(inference=True)
    if compute is not None:
        conf["dtypes"]["compute"] = compute
    b = ASRBundle.from_config(conf, seed=seed, device=device)
    lm = LM(LMConfig.from_config(conf), seed=seed + 1, device=device)
    return ASRBundle(b.conf, b.model, b.lang, b.device, lm)


def phase_full_width_beam(seed: int, card: str, bundle) -> dict:
    """The full-width model with its LM on the 16 ragged 6 s clips:
    transcribe_beam (K 4, 3 rounds) without and with the LM (alpha 0.2,
    beta 0.6), transcribe_batch with greedy LM fusion, and transcribe_beam
    on the port-quantized towers; each counted (B 6 launches, C 6 for
    int8), then timed (median of 7 with the spread) with its RTF and
    peak memory. Returns B's and C's launches a call."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.config import parse_and_apply_config

    cfg = bundle.cfg
    audio, lengths, _, _, _, flens = _full_width_clips(bundle, seed)
    audio_s = float(lengths.sum()) / bundle.frontend.sr
    flens_total = int(flens.sum())
    beam_kw = dict(beam_width=BEAM_WIDTH, max_expand=BEAM_EXPAND)
    lm_kw = dict(use_lm=True, lm_alpha=LM_ALPHA, lm_beta=LM_BETA)
    qbundle = ASRBundle.from_config(parse_and_apply_config(inference=True),
                                    seed=seed, device="cuda").quantize()
    L = cfg.enc_num_layers
    # each case: the user's call, timed, and the token-level call under
    # it (token ids; a char vocabulary drops ids past its symbols)
    runs = {
        "beam": (lambda: bundle.transcribe_beam(audio, lengths, **beam_kw),
                 lambda: bundle.beam_tokens(audio, lengths, **beam_kw),
                 {"lstm_seq_cseq": L}),
        "beam_lm": (lambda: bundle.transcribe_beam(audio, lengths, **beam_kw,
                                                   **lm_kw),
                    lambda: bundle.beam_tokens(audio, lengths, **beam_kw, **lm_kw),
                    {"lstm_seq_cseq": L}),
        "greedy_lm": (lambda: bundle.transcribe_batch(audio, lengths, use_lm=True),
                      lambda: bundle.decode_tokens(audio, lengths, use_lm=True),
                      {"lstm_seq_cseq": L}),
        "beam_int8": (lambda: qbundle.transcribe_beam(audio, lengths, **beam_kw),
                      lambda: qbundle.beam_tokens(audio, lengths, **beam_kw),
                      {"lstm_seq_int8": L}),
    }
    out = {}
    for name, (fn, tokens_fn, want) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        (texts, second), launches = _counted(fn)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        finite = bool(np.isfinite(second if name != "greedy_lm"
                                  else second["alignment_score"]).all())
        if launches != want or len(texts) != len(lengths) or not finite:
            raise AssertionError(f"full_width_beam {name}: launches {launches} "
                                 f"(expected {want}), finite {finite}")
        ms = wall_ms(fn, BEAM_REPS)
        med = statistics.median(ms)
        tokens = int(tokens_fn()[1].sum())
        out[name] = launches
        log("full_width_beam", card=card, case=name, n=len(lengths),
            beam_width=BEAM_WIDTH if "beam" in name else None,
            max_expand=BEAM_EXPAND,
            # greedy fusion's alpha is transcribe_batch's fixed 0.1
            lm_alpha={"beam_lm": LM_ALPHA, "greedy_lm": 0.1}.get(name),
            lm_beta=LM_BETA if name == "beam_lm" else None,
            ms_median=med, ms_runs=ms, ms_min=min(ms), ms_max=max(ms),
            audio_seconds=audio_s, real_time_factor=med / 1e3 / audio_s,
            peak_memory_mib=peak_mib, kernel_launches=launches,
            tokens=tokens, tokens_per_frame=tokens / float(flens_total),
            texts_sample=texts[:2])
    del qbundle
    return out


def _make_emitting(bundle) -> None:
    """Sharpen the seeded joint in place so that beams emit: its output
    layer scaled by EMIT_GAIN, and the ids the bundle's vocabulary
    cannot spell (specials, and a char vocabulary's ids past its
    symbols) lowered by EMIT_MASK. Seeded, the joint is near uniform over V 2048: a
    token costs about log 2048, the all-blank beam wins every frame, and
    no commit, forced commit or flush would run. Sharpened, a beam emits
    where a token leads the joint, as a trained model's does, and what
    it emits spells text, so that a client sees partials."""
    import torch

    out = bundle.model.joint.out
    blank = bundle.cfg.blank
    mute = torch.tensor([i != blank and not bundle.lang.denumericalize([i])
                         for i in range(bundle.cfg.vocab_sz)],
                        device=out.bias.device)
    with torch.no_grad():
        out.kernel.mul_(EMIT_GAIN)
        out.bias.mul_(EMIT_GAIN)
        out.bias[mute] -= EMIT_MASK


@contextlib.contextmanager
def _count_commits(counts: dict):
    """Count, in the uncaptured steps run inside, the streams whose beam
    buffers forced a commit (counts["forced"]) and the tokens committed
    (counts["committed"]): a wrapper of the engine's commit function
    (the captured graph does not call Python)."""
    from libreasr_tpu_torch.models import streaming

    orig = streaming._beam_committed_prefix

    def counted(beam, force_margin=0):
        cap = beam.y_buf.shape[-1]
        full = beam.y_len.max(dim=1).values >= cap - force_margin
        toks, lens, rest = orig(beam, force_margin)
        counts["forced"] += int(full.sum()) if force_margin > 0 else 0
        counts["committed"] += int(lens.sum())
        return toks, lens, rest

    streaming._beam_committed_prefix = counted
    try:
        yield counts
    finally:
        streaming._beam_committed_prefix = orig


def phase_full_width_beam_emitting(seed: int, card: str, bundle) -> None:
    """The model and LM of full_width_beam with the joint sharpened
    (_make_emitting): tokens a frame of beam, beam + LM and greedy + LM
    on the 16 clips, transcribe_beam with and without the LM timed
    (median of 7), then beam search on the card's encoder output, the
    same model and LM sharpened alike in float32 on the card and on the
    CPU: rows whose tokens match (at least BEAM_ROWS_EQUAL of 16) and
    the largest score gap (at most BEAM_SCORE_GAP)."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.models.beam import beam_decode

    cfg = bundle.cfg
    audio, lengths, _, _, _, flens = _full_width_clips(bundle, seed)
    audio_s = float(lengths.sum()) / bundle.frontend.sr
    frames = float(flens.sum())
    beam_kw = dict(beam_width=BEAM_WIDTH, max_expand=BEAM_EXPAND)
    lm_kw = dict(use_lm=True, lm_alpha=LM_ALPHA, lm_beta=LM_BETA)
    row = dict(card=card, emit_gain=EMIT_GAIN, emit_mask=EMIT_MASK,
               greedy_lm_tokens_per_frame=float(bundle.decode_tokens(
                   audio, lengths, use_lm=True)[1].sum()) / frames)
    for name, kw in (("beam", {}), ("beam_lm", lm_kw)):
        (texts, scores), launches = _counted(
            lambda: bundle.transcribe_beam(audio, lengths, **beam_kw, **kw))
        want = {"lstm_seq_cseq": cfg.enc_num_layers}
        if launches != want or not np.isfinite(scores).all():
            raise AssertionError(f"full_width_beam_emitting {name}: launches "
                                 f"{launches}, scores {scores}")
        ms = wall_ms(lambda: bundle.transcribe_beam(audio, lengths, **beam_kw,
                                                    **kw), BEAM_REPS)
        tokens = int(bundle.beam_tokens(audio, lengths, **beam_kw, **kw)[1].sum())
        row[name] = dict(ms_median=statistics.median(ms), ms_runs=ms,
                         real_time_factor=statistics.median(ms) / 1e3 / audio_s,
                         tokens_per_frame=tokens / frames, texts_sample=texts[:2])
        if not tokens:
            raise AssertionError(f"full_width_beam_emitting {name}: no token")
    log("full_width_beam_emitting", **row)

    # the card's decode against the CPU's on the card's encoder output,
    # both in float32: in bf16 the sharpened logits (up to ~50) round by
    # 0.25, so near-tied beams part between the two and the comparison
    # would hold only what they share
    f32 = {d: _lm_bundle(seed, device=d, compute="float32")
           for d in ("cuda", "cpu")}
    for b in f32.values():
        _make_emitting(b)
    with torch.inference_mode():
        enc_out, flens = bundle._encode_audio(audio, lengths)
        enc_out = enc_out.float()
        for name, use_lm in (("beam", False), ("beam_lm", True)):
            kw = dict(vocab_sz=cfg.vocab_sz, blank=cfg.blank, bos=cfg.bos,
                      **beam_kw, max_tokens=256,
                      lm_alpha=LM_ALPHA, lm_beta=LM_BETA)
            ct, cl, cs = beam_decode(f32["cuda"].decoder_fns(use_lm=use_lm),
                                     enc_out, flens, **kw)
            t0 = time.perf_counter()
            ht, hl, hs = beam_decode(f32["cpu"].decoder_fns(use_lm=use_lm),
                                     enc_out.cpu(), flens.cpu(), **kw)
            cpu_s = time.perf_counter() - t0
            ct, cl, cs = ct.cpu(), cl.cpu(), cs.cpu()
            match = sum(bool(cl[i] == hl[i] and torch.equal(ct[i, : cl[i]],
                                                            ht[i, : hl[i]]))
                        for i in range(len(cl)))
            gap = float((cs - hs).abs().max())
            log("full_width_beam_cuda_vs_cpu", case=name, compute="float32",
                rows=len(cl), rows_tokens_equal=match,
                rows_equal_min=BEAM_ROWS_EQUAL, max_score_gap=gap,
                score_gap_max=BEAM_SCORE_GAP, tokens_cuda=int(cl.sum()),
                tokens_cpu=int(hl.sum()),
                score_range=[float(cs.min()), float(cs.max())],
                cpu_seconds=cpu_s)
            if not (torch.isfinite(cs).all() and torch.isfinite(hs).all()) \
                    or match < BEAM_ROWS_EQUAL or gap > BEAM_SCORE_GAP \
                    or not int(cl.sum()):
                raise AssertionError(f"full_width_beam_emitting {name}: card "
                                     f"against CPU, {match} rows equal, gap {gap}")
    del f32


def phase_streaming_full_width_beam(seed: int, card: str, bundle) -> None:
    """The sharpened model and LM (_make_emitting) in an engine of 64
    slots, K 4, 10 rounds a frame, alpha 0.2, int16 transfer: as many
    steps as the shortest clip has chunks as graph replays against the
    uncaptured step on a copy of the state (tokens equal, the decode
    state within 1e-6; commits and forced commits counted), then 5
    pipelined passes of ragged 3-6 s noise clips: the step's host ms, a
    replay's device ms, the real-time share, peak memory, tokens
    committed and flushed at close; no kernel launch (T = 1)."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.models.streaming import StreamingConfig, StreamingEngine

    scfg = StreamingConfig(sr=bundle.frontend.sr, transfer_dtype="int16",
                           max_iters=bundle.conf["stream"]["max_iters"],
                           beam_width=BEAM_WIDTH, lm_alpha=LM_ALPHA)
    n = BEAM_STREAMS
    clips = _stream_clips(n, seed + 7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_mib = torch.cuda.memory_allocated() / 2**20
    _reset_kernel_launches()
    t0 = time.perf_counter()
    eng = StreamingEngine(bundle, n_streams=n, scfg=scfg, use_lm=True)
    build_s = time.perf_counter() - t0
    with _count_commits({"forced": 0, "committed": 0}) as eager:
        first = _eager_vs_graph(eng, clips, min(len(x) for x in clips)
                                // STREAM_CHUNK, state_tol=1e-6)
    passes, chunk_steps, tokens, flushed = [], 0, 0, 0
    for _ in range(STREAM_PASSES):
        ms, cs, tk, fl = _pipelined_pass(eng, clips)
        passes.append(ms)
        chunk_steps, tokens, flushed = chunk_steps + cs, tokens + tk, flushed + fl
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    launches = {k: v for k, v in _kernel_launches().items() if v}
    replay_ms = cuda_ms(lambda: eng._graph.replay(), reps=20)
    medians = [statistics.median(p) for p in passes]
    every = sorted(x for p in passes for x in p)
    step_ms = statistics.median(medians)
    log("streaming_full_width_beam", card=card, n_streams=n,
        beam_width=scfg.beam_width, lm_alpha=scfg.lm_alpha, use_lm=True,
        transfer_dtype=scfg.transfer_dtype, max_iters=scfg.max_iters,
        emit_gain=EMIT_GAIN, emit_mask=EMIT_MASK,
        build_and_capture_s=build_s, step_host_ms_median=step_ms,
        step_host_ms_pass_medians=medians, step_host_ms_mean=statistics.fmean(every),
        step_host_ms_p90=every[int(0.9 * (len(every) - 1))],
        replay_device_ms=replay_ms, real_time_share=step_ms / scfg.chunk_ms,
        tokens_per_chunk=tokens / max(chunk_steps, 1),
        flushed_tokens=flushed, eager_committed_tokens=eager["committed"],
        eager_forced_commits=eager["forced"], steps=eng.steps,
        graph_replays=eng.replays, peak_memory_mib=peak_mib,
        memory_before_mib=before_mib, kernel_launches=launches, **first)
    if eng.replays != eng.steps or launches or not np.isfinite(step_ms) \
            or not tokens or not flushed or not eager["forced"]:
        raise AssertionError(f"streaming_full_width_beam: {eng.steps} steps, "
                             f"{eng.replays} replays, launches {launches}, "
                             f"{tokens} committed, {flushed} flushed, "
                             f"{eager['forced']} forced commits")
    del eng
    torch.cuda.empty_cache()


def phase_serving_beam(seed: int, card: str, bundle) -> None:
    """The sharpened model and LM (_make_emitting) behind ASRServicer(beam 4, LM,
    alpha 0.2, beta 0.6), its engine from the config's stream block (64
    slots): one unary 6 s clip (transcribe_beam: kernel B once per
    encoder layer), then 64 streams paced at real time for 6 s each:
    partial latency p50/p90 and overrun against BASELINE.md's < 300 ms
    p50 bar."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.serving import proto
    from libreasr_tpu_torch.serving.server import ASRServicer

    torch.cuda.reset_peak_memory_stats()
    before_mib = torch.cuda.memory_allocated() / 2**20
    servicer = ASRServicer(bundle, beam_width=BEAM_WIDTH, use_lm=True,
                           lm_alpha=LM_ALPHA, lm_beta=LM_BETA)
    try:
        eng = servicer.engine
        clip = _stream_clips(1, seed)[0]
        t0 = time.perf_counter()
        unary, launches = _counted(lambda: servicer.Transcribe(
            proto.Audio(data=clip.tobytes(), sr=16000)).data)
        unary_ms = (time.perf_counter() - t0) * 1e3
        rng = np.random.default_rng(seed + 1)
        clips = [(rng.standard_normal(6 * 16000) * 0.1).astype(np.float32)
                 for _ in range(BEAM_STREAMS)]
        steps0 = eng.steps
        (texts, lat, over, errors), stream_launches = _counted(
            lambda: _stream_through(servicer, clips, paced=True))
        timings = servicer.timings.snapshot()
    finally:
        servicer.stepper.shutdown()
    want = {"lstm_seq_cseq": bundle.cfg.enc_num_layers}
    lat_ms = np.array(lat) * 1e3
    over_ms = np.array([o for o in over if o is not None]) * 1e3
    p50 = float(np.percentile(lat_ms, 50)) if len(lat_ms) else None
    log("serving_beam", card=card, n_streams=eng.n, beam_width=eng.scfg.beam_width,
        use_lm=eng.use_lm, lm_alpha=eng.scfg.lm_alpha, lm_beta=servicer.lm_beta,
        transfer_dtype=eng.scfg.transfer_dtype, unary_6s_ms=unary_ms,
        unary_kernel_launches=launches, paced_streams=len(clips), seconds_each=6,
        partial_latency_ms_p50=p50,
        partial_latency_ms_p90=float(np.percentile(lat_ms, 90)) if len(lat_ms) else None,
        partials=len(lat_ms), p50_under_300ms=None if p50 is None else p50 < 300,
        overrun_ms_p50=float(np.percentile(over_ms, 50)) if len(over_ms) else None,
        overrun_ms_p90=float(np.percentile(over_ms, 90)) if len(over_ms) else None,
        tokens=int(sum(len(t) for t in texts if t)), steps=eng.steps - steps0,
        graph_replays=eng.replays, stage_timings=timings,
        peak_memory_mib=torch.cuda.max_memory_allocated() / 2**20,
        memory_before_mib=before_mib, errors=errors[:3])
    if launches != want or stream_launches or errors or p50 is None \
            or len(over_ms) != len(clips) or any(t is None for t in texts) \
            or eng.replays != eng.steps or set(timings) != SERVING_STAGES:
        raise AssertionError("serving_beam at full width failed")


# --- compressed audio and the dataset tools, the CTC family, LM training,
# --- and the engine soak: no kernel of A-H lies on these paths -------------

DATA_FLAC = 24          # LibriSpeech-shaped FLAC files (every third stereo)
DATA_MP3 = 8            # common-voice MP3 clips, where the host has lame
CTC_STEPS = 8           # the 4 train batches twice: the loss must fall
# the train batches' labels cut to 16 tokens for CTC: 40 labels in as few
# as 31 frames make a row infeasible, and its loss (~1e5, optax's
# log_epsilon) would swamp what the step learns
CTC_MAX_LABELS = 16
# CTC card vs CPU, one step of a small float32 model from the same
# weights and batch: the same float32 sums in another order (cuBLAS's
# against the CPU's GEMMs; TF32 off): loss 1e-5 relative, every gradient
# within 1e-4 of its tensor's largest entry (the key biases, whose true
# gradient is 0, hold float32 noise: floored at 1e-6 of the largest
# gradient), features within FRONTEND_TOL
CTC_SMALL = dict(d_model=32, n_heads=2, n_layers=2, vocab_sz=64, dropout=0.0)
CTC_LOSS_REL = 1e-5
CTC_GRAD_REL = 1e-4
LM_STEPS = 20
LM_EVAL_EVERY = 5
LM_SENTENCES = 20000
# LM card vs CPU, one step at a small width (V 64, 32 wide, 2 layers,
# dropout 0): the scan cells' float32 GEMMs in another order: held as
# the CTC step (CTC_LOSS_REL, CTC_GRAD_REL)
LM_SMALL = dict(vocab_sz=64, embed_sz=32, hidden_sz=32, num_layers=2, p=0.0)
SOAK_REPS = 8


def _write_flac_file(job: tuple) -> None:
    """One file of _flac_tree (a process pool's task)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from helpers.flac_writer import write_flac

    path, x, method, stereo = job
    write_flac(path, x, 16000, method=method, blocksize=4096, stereo=stereo)


def _flac_tree(root: str, rng, count: int = DATA_FLAC,
               samples: tuple = (40000, 60001), workers: int = 1) -> list:
    """LibriSpeech layout (<spk>/<chapter>/<id>.flac + .trans.txt) of
    `count` seeded noise clips of two speakers, of samples[0] to
    samples[1] - 1 samples at 16 kHz (2.5-3.75 s), or, where `samples`
    is a list, of samples[k]'s for speaker k; 16-bit, mono and (every
    third) stereo, written with the tests' FLAC writer: LPC and FIXED
    subframes, every stereo mode. The writer is pure Python (~0.5 s a 4 s
    clip): with `workers` > 1 the files are written by a spawned process
    pool. Returns (path, int16 samples)."""
    import concurrent.futures as cf
    import multiprocessing as mp

    import numpy as np

    words = ["yes", "no", "stop", "go", "up", "down", "left", "right"]
    modes = ["left_side", "right_side", "mid_side", "independent"]
    out, jobs = [], []
    spans = samples if isinstance(samples, list) else [samples, samples]
    for spk in range(2):
        d = os.path.join(root, str(100 + spk), "10")
        os.makedirs(d)
        lines = []
        for i in range(count // 2):
            utt = f"{100 + spk}-10-{i:04d}"
            n = int(rng.integers(*spans[spk]))
            ch = 2 if i % 3 == 0 else 1
            x = np.clip(np.round(rng.standard_normal((ch, n)) * 3000),
                        -32768, 32767).astype(np.int64)
            method = "lpc" if i % 4 == 0 else f"fixed{i % 5}"
            path = os.path.join(d, f"{utt}.flac")
            jobs.append((path, x, method, modes[i % 4] if ch == 2 else "independent"))
            out.append((path, x))
            lines.append(f"{utt} {' '.join(rng.choice(words, 2)).upper()}")
        with open(os.path.join(d, f"{100 + spk}-10.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    if workers > 1:
        with cf.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
            list(ex.map(_write_flac_file, jobs))
    else:
        for job in jobs:
            _write_flac_file(job)
    return out


def _mp3_tree(root: str, rng) -> int:
    import numpy as np

    from libreasr_tpu_torch.data.audio import write_mp3

    clips = os.path.join(root, "clips")
    os.makedirs(clips)
    rows = ["client_id\tpath\tsentence"]
    for i in range(DATA_MP3):
        pcm = (rng.standard_normal(int(rng.integers(40000, 60001))) * 0.1).clip(-1, 1)
        write_mp3(os.path.join(clips, f"cv_{i:03d}.mp3"), pcm.astype(np.float32), 16000)
        rows.append(f"c\tcv_{i:03d}.mp3\tclip number {i}")
    with open(os.path.join(root, "validated.tsv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return DATA_MP3


def _data_conf(corpus: str) -> dict:
    from libreasr_tpu_torch.config import parse_and_apply_config

    conf = parse_and_apply_config()
    conf.update(datasets=["libri"], dataset_paths={"libri": corpus},
                accumulate_n_batches=1, tokenizer={"model_file": ""})
    return conf


def phase_data_tools(seed: int, card: str, root: str) -> str:
    """Host: a LibriSpeech-shaped FLAC tree (and a common-voice MP3 tree
    where the host has lame and mpg123) through the port's create_dataset
    (a process pool of 2), split, the CSV builder and inspect's
    statistics; every FLAC decodes to its source samples exactly and its
    STREAMINFO MD5 verifies. Returns the LibriSpeech dataset directory."""
    import contextlib
    import io

    import numpy as np

    from libreasr_tpu_torch.data import audio as audio_io
    from libreasr_tpu_torch.data import inspect as port_inspect
    from libreasr_tpu_torch.data.batching import ASRDataset
    from libreasr_tpu_torch.data.create_dataset import create_dataset
    from libreasr_tpu_torch.data.language import get_language
    from libreasr_tpu_torch.data.split import split_dataset

    rng = np.random.default_rng(seed)
    times = {}
    t0 = time.perf_counter()
    libri = os.path.join(root, "libri")
    files = _flac_tree(libri, rng)
    have_mp3, have_ogg = audio_io.have_mp3(), audio_io.have_ogg()
    cv = os.path.join(root, "cv")
    n_mp3 = _mp3_tree(cv, rng) if have_mp3 else 0
    times["write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = md5_ok = 0
    for path, x in files:
        pcm, sr = audio_io.read_audio(path)
        exact += int(sr == 16000 and np.array_equal(
            np.round(pcm * 32768).astype(np.int64), x))
        md5_ok += int(audio_io.verify_flac_md5(path))
    times["decode_verify"] = time.perf_counter() - t0
    quiet = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        rows = create_dataset(libri, "librispeech", workers=2, pool="process")
        cv_rows = (create_dataset(cv, "common-voice", workers=2, pool="process")
                   if have_mp3 else [])
    times["create_dataset"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        parts = split_dataset(libri, valid=0.25, test=0.0)
    times["split"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    conf = _data_conf(libri)
    ds = ASRDataset.from_config(conf, get_language()[0], "train")
    pipe = port_inspect.pipeline_statistics(ds, n_items=32)
    batches = port_inspect.batch_statistics(ds)
    times["builder_inspect"] = time.perf_counter() - t0
    log("data_tools", card=card, flac_files=len(files), flac_exact=exact,
        flac_md5_verified=md5_ok, mp3_files=n_mp3, have_mp3=have_mp3,
        have_ogg=have_ogg, rows=len(rows), bad_rows=sum(r["bad"] for r in rows),
        cv_rows=len(cv_rows), cv_bad_rows=sum(r["bad"] for r in cv_rows),
        split={k: len(v) for k, v in parts.items()}, builder_rows=len(ds.builder),
        pipeline_statistics=pipe, batch_statistics=batches, seconds=times)
    if exact != len(files) or md5_ok != len(files):
        raise AssertionError(f"data_tools: {exact} exact, {md5_ok} MD5 of {len(files)}")
    if len(rows) != len(files) or any(r["bad"] for r in rows):
        raise AssertionError(f"data_tools: rows {rows}")
    if have_mp3 and (len(cv_rows) != n_mp3 or any(r["bad"] for r in cv_rows)):
        raise AssertionError(f"data_tools: common-voice rows {cv_rows}")
    if not 0 < pipe.get("items", 0) == len(ds.builder) or not batches:
        raise AssertionError(f"data_tools: inspect {pipe} {batches}")
    return libri


def _ctc_conf() -> dict:
    from libreasr_tpu_torch.config import parse_and_apply_config

    conf = parse_and_apply_config()
    conf["model"]["name"] = "CTCModel"
    conf["accumulate_n_batches"] = 1
    return conf


def _grad_gap(a, b) -> float:
    """The largest gradient difference over CTC_GRAD_REL of its tensor's
    largest entry, that entry floored at 1e-2 of the largest of all (the
    CTC key biases' true gradient is 0): <= 1 passes."""
    top = max(float(g.abs().max()) for g in b)
    return max(float((x.cpu() - y.cpu()).abs().max())
               / (CTC_GRAD_REL * max(float(y.abs().max()), 1e-2 * top, 1e-30))
               for x, y in zip(a, b))


def ctc_setup(seed: int):
    """The CTC main path's learner and batches: base.yaml as a CTCModel
    on the card, adamw at the config's lr over CTC_STEPS, SpecAugment as
    configured; the 4 train batches of 12 with labels cut to
    CTC_MAX_LABELS. Returns (learner, batches)."""
    import torch

    from libreasr_tpu_torch.models.ctc import CTCConfig, CTCModel
    from libreasr_tpu_torch.ops.frontend import FrontendConfig
    from libreasr_tpu_torch.training.ctc_learner import CTCLearner
    from libreasr_tpu_torch.training.optimizers import build_optimizer, make_lr_schedule

    conf = _ctc_conf()
    cfg = CTCConfig.from_config(conf)
    frontend = FrontendConfig.from_config(conf)
    sched = make_lr_schedule({**conf["training"], "total_steps": CTC_STEPS})
    learner = CTCLearner(CTCModel(cfg, seed=seed, device="cuda"),
                         build_optimizer("adamw", sched), frontend, seed=seed)
    batches = []
    for b in _train_batches(cfg, frontend, seed):
        keep = torch.arange(b.labels.shape[1], device=b.labels.device)[None] < CTC_MAX_LABELS
        batches.append(b._replace(labels=b.labels * keep,
                                  label_len=b.label_len.clamp(max=CTC_MAX_LABELS)))
    return learner, batches


def phase_train_ctc_full_width(seed: int, card: str, corpus: str) -> None:
    """The CTC family at full width: base.yaml with model.name CTCModel
    (features 1280, d 128, 8 heads, 8 layers, V 2048, dropout 0.1), adamw
    at the config's lr on the train batches of 12 (N 16, T 49; labels cut
    to CTC_MAX_LABELS) for CTC_STEPS steps: losses finite, the mean of the last 4 below that of
    the first 4 (the same batches), no kernel launch; step time, its
    split and peak memory; the greedy evaluate on a batch; one step card
    against CPU at a small width; then the training CLI with model.name
    CTCModel on the data_tools CSVs for 2 steps."""
    import contextlib
    import io

    import torch
    import yaml

    from libreasr_tpu_torch import train
    from libreasr_tpu_torch.data.language import get_language

    learner, batches = ctc_setup(seed)
    cfg, frontend = learner.cfg, learner.frontend
    times: dict = {}
    for part, label in (("features", "frontend"), ("loss", "forward_loss"),
                        ("backward", "backward"), ("optimize", "optimizer")):
        setattr(learner, part, _timed(label, getattr(learner, part), times))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_launches()
    losses = []
    for i in range(CTC_STEPS):
        m = _timed("step", learner.step, times)(batches[i % len(batches)])
        losses.append(float(m["loss"]))
    launches = {k: v for k, v in _kernel_launches().items() if v}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    lang, _ = get_language()
    t0 = time.perf_counter()
    res = learner.evaluate([batches[0]], lang)
    eval_ms = (time.perf_counter() - t0) * 1e3
    med = {k: statistics.median(v[1:]) for k, v in times.items()}
    small = _ctc_small_cuda_vs_cpu(seed)
    with tempfile.TemporaryDirectory() as tmp:
        cconf = _ctc_conf()
        cconf.update(datasets=["libri"], dataset_paths={"libri": corpus},
                     tokenizer={"model_file": ""})
        path = os.path.join(tmp, "ctc.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cconf, f)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train.main(["--config", path, "--steps", "2", "--eval-batches", "1",
                        "--ckpt", os.path.join(tmp, "ck"),
                        "--logdir", os.path.join(tmp, "runs")])
        cli_s = time.perf_counter() - t0
    cli = [ln for ln in buf.getvalue().splitlines()
           if ln.startswith(("[ctc]", "[train] done"))]
    log("train_ctc_full_width", card=card, n=16, t_enc=int(frontend.out_length(
        torch.tensor(4 * frontend.sr))), d_model=cfg.d_model, heads=cfg.n_heads,
        layers=cfg.n_layers, vocab=cfg.vocab_sz, feature_sz=cfg.feature_sz,
        losses=losses, step_ms_median_after_first=med.pop("step"),
        split_ms_median_after_first=med, step_ms_runs=times["step"],
        peak_memory_mib=peak_mib, kernel_launches=launches, eval=res,
        eval_ms=eval_ms, small_cuda_vs_cpu=small, cli_lines=cli,
        cli_seconds=cli_s)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_ctc_full_width: losses {losses}")
    if not sum(losses[-4:]) < sum(losses[:4]):
        raise AssertionError(f"train_ctc_full_width: the loss did not fall {losses}")
    if launches:
        raise AssertionError(f"train_ctc_full_width: kernels launched {launches}")
    if res["n"] != 16:
        raise AssertionError(f"train_ctc_full_width: eval {res}")
    if not (any(ln.startswith("[ctc] epoch") for ln in cli)
            and any(ln.startswith("[train] done: step=2") for ln in cli)):
        raise AssertionError(f"train_ctc_full_width CLI: {buf.getvalue()}")


def _ctc_small_cuda_vs_cpu(seed: int) -> dict:
    """One CTCLearner step on the card and on the CPU, a small float32
    model from the same weights and batch, dropout 0, no SpecAugment:
    features, loss and every gradient (module docs: CTC_*)."""
    import numpy as np
    import torch

    from libreasr_tpu_torch.models.ctc import CTCConfig, CTCModel
    from libreasr_tpu_torch.ops.frontend import FrontendConfig
    from libreasr_tpu_torch.training.ctc_learner import CTCLearner
    from libreasr_tpu_torch.training.learner import Batch
    from libreasr_tpu_torch.training.optimizers import build_optimizer

    cfg = CTCConfig(feature_sz=1280, **CTC_SMALL)
    fe = FrontendConfig(cut_max_front=0, cut_max_back=0, time_masks=0, freq_masks=0)
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((4, 24000)) * 0.1).astype(np.float32)
    b = (audio, np.array([24000, 20000, 16000, 12000]),
         rng.integers(1, cfg.vocab_sz, (4, 6)), np.array([6, 5, 3, 1]))
    out = {}
    for dev in ("cuda", "cpu"):
        learner = CTCLearner(CTCModel(cfg, seed=seed, device=dev),
                             build_optimizer("adamw", 1e-3), fe, seed=seed)
        kept = []
        backward = learner.backward

        def keep(loss, backward=backward, kept=kept):
            grads, finite = backward(loss)
            kept.extend(g.detach().cpu() for g in grads)
            return grads, finite

        learner.backward = keep
        batch = Batch(*(torch.from_numpy(np.asarray(x)) for x in b))
        feats = learner.features(Batch(*(x.to(dev) for x in batch)))[0].cpu()
        m = learner.step(batch)
        out[dev] = (float(m["loss"]), kept, feats)
    (lc, gc, fc), (lh, gh, fh) = out["cuda"], out["cpu"]
    res = {"loss_cuda": lc, "loss_cpu": lh, "loss_rel": abs(lc - lh) / abs(lh),
           "grad_gap": _grad_gap(gc, gh),
           "features_max_abs": float((fc - fh).abs().max())}
    if not (res["loss_rel"] <= CTC_LOSS_REL and res["grad_gap"] <= 1.0
            and res["features_max_abs"] <= FRONTEND_TOL):
        raise AssertionError(f"train_ctc small cuda vs cpu: {res}")
    return res


def _lm_small_cuda_vs_cpu(seed: int, corpus_ids) -> dict:
    """One LMTrainer step on the card and on the CPU at a small width,
    from the same weights and batch (module docs: LM_*)."""
    import torch

    from libreasr_tpu_torch.models.lm import LM, LMConfig
    from libreasr_tpu_torch.train_lm import LMTrainer, batch_stream, lm_optimizer

    x, y = next(batch_stream(corpus_ids, 16, 32, seed=seed))
    out = {}
    for dev in ("cuda", "cpu"):
        tr = LMTrainer(LM(LMConfig(**LM_SMALL), seed=seed, device=dev),
                       lm_optimizer(1e-2, 10))
        loss, grads = tr.grads(x, y)
        tr.apply(grads)
        out[dev] = (float(loss), [g.detach().cpu() for g in grads])
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    res = {"loss_cuda": lc, "loss_cpu": lh, "loss_rel": abs(lc - lh) / abs(lh),
           "grad_gap": _grad_gap(gc, gh)}
    if not (res["loss_rel"] <= CTC_LOSS_REL and res["grad_gap"] <= 1.0):
        raise AssertionError(f"train_lm small cuda vs cpu: {res}")
    return res


def write_lm_corpus(path: str, seed: int) -> str:
    """LM_SENTENCES of the tone corpus's sentences, one a line."""
    import numpy as np

    from libreasr_tpu_torch.data.synth import sentences

    with open(path, "w") as f:
        f.write("\n".join(sentences(np.random.default_rng(seed), LM_SENTENCES)) + "\n")
    return path


def phase_train_lm_full_width(seed: int, card: str) -> None:
    """The LM that the beam phases serve, trained at its width
    (base.yaml's lm: embed 1024, hidden 1024, 6 layers, V 2048) by the
    port's train_lm at its defaults (bs 768, seq len 64) for LM_STEPS
    steps on the tone corpus's sentences (char ids): the valid loss
    falls, no kernel launch; step ms (median after the first), peak
    memory, the printed valid_loss and ppl; the saved lm.msgpack in a
    bundle loads through from_bundle on the card with log-probs equal
    to the in-memory model's; one step card against CPU at a small
    width."""
    import contextlib
    import io

    import numpy as np
    import torch

    from libreasr_tpu_torch import train_lm
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.checkpoint import msgpack_restore, save_bundle
    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.convert import export_variables
    from libreasr_tpu_torch.data.language import get_language
    from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig

    conf = parse_and_apply_config(inference=True)
    lmc = conf["lm"]
    times: dict = {}
    step = train_lm.LMTrainer.step
    train_lm.LMTrainer.step = _timed("step", step, times)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = write_lm_corpus(os.path.join(tmp, "text.txt"), seed)
        out = os.path.join(tmp, "lm.msgpack")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                res = train_lm.main([
                    "--corpus", corpus, "--steps", str(LM_STEPS),
                    "--eval-every", str(LM_EVAL_EVERY),
                    "--embed-sz", str(lmc["embed_sz"]), "--hidden-sz", str(lmc["hidden_sz"]),
                    "--num-layers", str(lmc["num_layers"]),
                    "--vocab-sz", str(lmc["vocab_sz"]), "--out", out])
        finally:
            train_lm.LMTrainer.step = step
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in _kernel_launches().items() if v}
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        lm = res["trainer"].lm.eval()
        bundle_path = os.path.join(tmp, "bundle.tar.gz")
        model = Transducer(TransducerConfig.from_config(conf), seed=seed)
        with open(out, "rb") as f:
            lm_vars = msgpack_restore(f.read())
        save_bundle(bundle_path, "en", export_variables(model), conf,
                    lm_variables=lm_vars)
        bundle = ASRBundle.from_bundle(bundle_path, extract_to=os.path.join(tmp, "x"),
                                       device="cuda")
        y = torch.from_numpy(np.random.default_rng(seed).integers(
            0, lmc["vocab_sz"], (8, 16))).cuda()
        with torch.no_grad():
            same = float((bundle.lm(y)[0] - lm(y)[0]).abs().max())
        ids = train_lm.corpus_ids(corpus, get_language()[0])
    small = _lm_small_cuda_vs_cpu(seed, ids)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[lm]")]
    vl = res["valid_losses"]
    log("train_lm_full_width", card=card, bs=768, seq_len=64, steps=LM_STEPS,
        embed=lmc["embed_sz"], hidden=lmc["hidden_sz"], layers=lmc["num_layers"],
        vocab=lmc["vocab_sz"], corpus_tokens=int(len(ids)), lines=lines,
        valid_losses=vl, step_ms_median_after_first=statistics.median(times["step"][1:]),
        step_ms_runs=times["step"], seconds=run_s, peak_memory_mib=peak_mib,
        kernel_launches=launches, bundle_lm_logprob_max_abs=same,
        small_cuda_vs_cpu=small)
    if not (len(vl) == LM_STEPS // LM_EVAL_EVERY and vl[-1] < vl[0]
            and all(math.isfinite(v) for v in vl)):
        raise AssertionError(f"train_lm_full_width: valid losses {vl}")
    if launches or same != 0.0 or bundle.lm.cfg.hidden_sz != lmc["hidden_sz"]:
        raise AssertionError(f"train_lm_full_width: launches {launches}, "
                             f"bundle LM gap {same}")


def phase_soak(card: str) -> None:
    """tests/test_soak.py's soak on the card: the golden char bundle in a
    StreamingEngine of 4 slots, every step one CUDA graph replay: SOAK_REPS
    repetitions of "hello world", a silent slot, a slot closed
    mid-utterance; the silent slot emits at most 12 tokens, every sample
    buffer stays under a chunk, the slots are recycled."""
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.data.audio import read_wav
    from libreasr_tpu_torch.models.streaming import StreamingEngine

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from helpers.soak import check_soak, golden_audio, run_soak

    audio = golden_audio(read_wav(os.path.join(GOLDEN, "s-002.wav"))[0][0])
    with tempfile.TemporaryDirectory() as tmp:
        bundle = ASRBundle.from_bundle(os.path.join(GOLDEN, "model.tar.gz"),
                                       device="cuda", extract_to=tmp)
        eng = StreamingEngine(bundle, n_streams=4)
        _reset_kernel_launches()
        res = run_soak(eng, audio, reps=SOAK_REPS)
        launches = {k: v for k, v in _kernel_launches().items() if v}
        silent = len(eng.emitted[res["silence"]])
        log("soak", card=card, chunks=res["chunks"], seconds=res["seconds"], steps=eng.steps,
            graph_replays=eng.replays, host_ms_per_step=res["seconds"] / eng.steps * 1e3,
            transcripts=res["transcripts"], silent_slot_tokens=silent,
            churn_cycles=res["churn_cycles"], kernel_launches=launches,
            sample_buf=[len(b) for b in eng.sample_buf])
        check_soak(eng, res, reps=SOAK_REPS)
        if eng.replays != eng.steps or not eng.steps or launches:
            raise AssertionError(f"soak: {eng.steps} steps, {eng.replays} "
                                 f"replays, launches {launches}")


# --- FLOP accounting, and the LibriSpeech-960 recipe ------------------------

# the recipe's mock LibriSpeech tree: {split: utterances} of FLAC, one
# speaker's clips 2-2.8 s, the other's 4.4-5.4 s. With drop_last and the
# 2-bucket ladder (bs 24, the population of a bucket), an epoch must
# fill a bucket or the CLI ends the run; the gap keeps all 24 short clips
# in the first bucket under speed perturbation (+-10%), however the
# filesystem orders the speakers' directories. Clips spread evenly over
# 2-6 s left some epochs on the H100 with no full bucket.
RECIPE_SPLITS = {"train-clean-100": 48, "dev-clean": 8, "test-clean": 8}
RECIPE_SAMPLES = [(32000, 44801), (70400, 86401)]
RECIPE_WRITERS = 8  # the card machine's cores
RECIPE_STEPS = 8
RECIPE_CRASH_AT = 4


def _bounds_follow_the_table(peaks: dict) -> dict:
    """Every bound helper at the main path's shapes, then again with the
    card's entry of libreasr_tpu_torch/flops.py's table doubled in place
    (restored after): each bound must halve, so it reads that table and
    no peak of its own."""
    calls = {
        "lstm_seq_cseq": lambda: lstm_bound_ms(16, 49, 1024, True)[0],
        "lstm_seq_int8": lambda: lstm_int8_bound_ms(16, 49, 1024)[0],
        "joint_lp_fwd": lambda: joint_bound_ms("fwd", 16, 49, 41, 1024, 2048)[0],
        "joint_lp_dx": lambda: joint_bound_ms("dx", 16, 49, 41, 1024, 2048)[0],
        "joint_lp_dw": lambda: joint_bound_ms("dw", 16, 49, 41, 1024, 2048)[0],
        "lstm_train_fwd": lambda: train_kernel_bound_ms("fwd", 16, 49, 1024)[0],
        "lstm_train_bwd": lambda: train_kernel_bound_ms("bwd", 16, 49, 1024)[0],
    }
    before = {k: f() for k, f in calls.items()}
    saved = dict(peaks)
    try:
        for k in peaks:
            peaks[k] = 2 * peaks[k]
        after = {k: f() for k, f in calls.items()}
    finally:
        peaks.update(saved)
    return {k: {"bound_ms": before[k], "with_doubled_peaks_ms": after[k]}
            for k in calls}


def phase_flops(card: str, train: dict, stream: dict) -> None:
    """MFU of medians that earlier phases measured (no timed run of its
    own), from libreasr_tpu_torch/flops.py: train_full_width's step median
    (N 16, T 49, U 40) against train_step_flops and the bf16 peak, beside
    train_step_ceiling's speed of light; streaming_full_width's replay at
    N 64 and N 512 against decode_step_flops with iters_per_frame = 1 +
    the tokens a chunk that phase counted (the model's work; the graph
    runs max_iters rounds a frame, whose FLOPs are logged beside). Checks
    that the table gives this card 989e12 bf16 FLOP/s, that the shares lie
    in (0, 1), that the step is no faster than its speed of light, and
    that every bound helper reads the table's peaks."""
    from libreasr_tpu_torch import flops

    peaks = flops.device_peaks("cuda")
    bf16 = flops.device_peak_flops("cuda")
    cfg, sh = train["cfg"], train["shape"]
    n, t, u = sh["n"], sh["t"], sh["u"]
    step_s = train["step_ms"] / 1e3
    fl = flops.train_step_flops(cfg, n, t, u)
    m = flops.mfu(fl, step_s, "cuda")
    ceil = flops.train_step_ceiling(cfg, n, t, u)
    train_row = {
        **sh, "step_ms": train["step_ms"], "flops": fl, "mfu": m.mfu,
        "achieved_tflops": m.achieved / 1e12, "sol_ms": ceil["sol_s"] * 1e3,
        "compute_sol_ms": ceil["compute_sol_s"] * 1e3,
        "bandwidth_sol_ms": ceil["bandwidth_sol_s"] * 1e3,
        "compute_breakdown_ms": {k: v * 1e3 for k, v in
                                 ceil["compute_breakdown_s"].items()},
        "traffic_bytes": ceil["traffic_bytes"],
        "step_over_sol": step_s / ceil["sol_s"],
        "mfu_at_sol": fl / (ceil["sol_s"] * bf16),
    }
    scfg, streams = stream["scfg"], {}
    for w in STREAM_WIDTHS:
        r = stream[w]
        iters = 1.0 + r["tokens_per_chunk"]
        args = (stream["cfg"], stream["frontend"], w, scfg.n_buffer, STREAM_CHUNK)
        fl_w = flops.decode_step_flops(*args, iters_per_frame=iters)
        executed = flops.decode_step_flops(*args, iters_per_frame=scfg.max_iters)
        mw = flops.mfu(fl_w, r["replay_device_ms"] / 1e3, "cuda")
        streams[w] = {"replay_device_ms": r["replay_device_ms"],
                      "iters_per_frame": iters, "flops": fl_w, "mfu": mw.mfu,
                      "achieved_tflops": mw.achieved / 1e12,
                      "flops_at_max_iters": executed,
                      "share_at_max_iters": executed / (r["replay_device_ms"] / 1e3) / bf16}
    bounds = _bounds_follow_the_table(peaks)
    log("flops", card=card, peaks=peaks, train_step=train_row,
        streaming=streams, bounds=bounds)
    shares = [train_row["mfu"]] + [v["mfu"] for v in streams.values()]
    checks = {
        "the table gives this card the H100 SXM's bf16 peak": bf16 == 989e12,
        "every share in (0, 1)": all(0.0 < x < 1.0 for x in shares),
        "the step is no faster than its speed of light": step_s >= ceil["sol_s"],
        "every bound halves with the table's peaks doubled": all(
            math.isclose(b["with_doubled_peaks_ms"], b["bound_ms"] / 2, rel_tol=1e-12)
            for b in bounds.values()),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"flops: {failed}")


def phase_recipe_960(seed: int, card: str, root: str) -> None:
    """The port's LibriSpeech-960 recipe (libreasr_tpu_torch.scripts.
    train_960) in this process at full width: config/base.yaml as written,
    on a LibriSpeech-shaped FLAC tree written here (RECIPE_SPLITS, 2-5.4 s
    noise clips with two-word labels; data_tools' writer): create_dataset
    per split, the merged CSVs, a BPE tokenizer of 64, the ladder from the
    histogram (2 buckets), RECIPE_STEPS steps with an eval every 4, the
    export and the test split's WER. The first launch of the training CLI
    ends at step RECIPE_CRASH_AT and then raises; the recipe launches it
    again, and it resumes there. Checks the resume, D and E 6 launches and
    F, G, H one a train step, B in the evals, and the bundle reloading on
    cuda and transcribing; the WER of noise is printed, not held."""
    import io

    import numpy as np
    import torch

    from libreasr_tpu_torch import train
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.scripts import evaluate_wer
    from libreasr_tpu_torch.scripts import train_960 as recipe
    from libreasr_tpu_torch.training import learner as lmod

    rng = np.random.default_rng(seed + 960)
    t0 = time.perf_counter()
    corpus = os.path.join(root, "LibriSpeech")
    for split, count in RECIPE_SPLITS.items():
        _flac_tree(os.path.join(corpus, split), rng, count=count,
                   samples=RECIPE_SAMPLES, workers=RECIPE_WRITERS)
    write_s = time.perf_counter() - t0
    out = os.path.join(root, "work")
    steps_ms, launches_at_step, calls, secs = [], [], [], {}
    real_step, real_main = lmod.Learner.step, train.main
    real_csvs, real_eval = recipe.build_csvs, evaluate_wer.main

    def timed(name, fn):
        def run(*a, **k):
            t1 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                secs.setdefault(name, []).append(time.perf_counter() - t1)
        return run

    def timed_step(self, batch):
        t1 = time.perf_counter()
        metrics = real_step(self, batch)
        float(metrics["loss"])  # syncs the step
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        launches_at_step.append(_kernel_launches())
        return metrics

    def crash_once(argv):
        calls.append(list(argv))
        if len(calls) > 1:
            return real_main(argv)
        i = argv.index("--steps")
        real_main(argv[: i + 1] + [str(RECIPE_CRASH_AT)] + argv[i + 2:])
        raise RuntimeError(f"injected crash at step {RECIPE_CRASH_AT}")

    argv = ["--root", corpus, "--out", out,
            "--config", os.path.join(HERE, "config", "base.yaml"),
            "--vocab-sz", "64", "--accumulate", "1", "--n-buckets", "2",
            "--steps", str(RECIPE_STEPS), "--eval-every", "4",
            "--eval-batches", "1", "--chain-steps", "1", "--workers", "2",
            "--retries", "2", "--device", "cuda"]
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_launches()
    lmod.Learner.step, train.main = timed_step, timed("train_cli", crash_once)
    recipe.build_csvs = timed("build_csvs", real_csvs)
    evaluate_wer.main = timed("final_eval", real_eval)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            recipe.main(argv)
    except BaseException:
        print(buf.getvalue()[-8000:], file=sys.stderr)
        raise
    finally:
        lmod.Learner.step, train.main = real_step, real_main
        recipe.build_csvs, evaluate_wer.main = real_csvs, real_eval
    run_s = time.perf_counter() - t0
    launches = _kernel_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    text = buf.getvalue()

    _reset_kernel_launches()
    t0 = time.perf_counter()
    bundle = ASRBundle.from_bundle(os.path.join(out, "model.tar.gz"), device="cuda",
                                   extract_to=os.path.join(out, "x"))
    clip = (rng.standard_normal(48000) * 0.1).astype(np.float32)
    texts, _ = bundle.transcribe_batch(clip[None], np.array([48000]))
    reload_b = _kernel_launches()["lstm_seq_cseq"]
    reload_s = time.perf_counter() - t0
    # train-kernel launches of each step alone (evals launch none of them)
    per_step, prev = [], {k: 0 for k in launches}
    for cur in launches_at_step:
        per_step.append({k: cur[k] - prev[k] for k in
                         ("lstm_train_fwd", "lstm_train_bwd", "joint_lp_fwd",
                          "joint_lp_dx", "joint_lp_dw")})
        prev = cur
    layers = bundle.cfg.enc_num_layers
    want_step = {"lstm_train_fwd": layers, "lstm_train_bwd": layers,
                 "joint_lp_fwd": 1, "joint_lp_dx": 1, "joint_lp_dw": 1}
    keep = ("[train-960]", "[train] resumed", "[train] done", "[eval] step",
            "[eval] n=", "  max ")
    lines = [ln for ln in text.splitlines() if ln.startswith(keep)]
    log("recipe_960", card=card, splits=RECIPE_SPLITS, steps=len(steps_ms),
        step_ms=steps_ms, step_ms_median=statistics.median(steps_ms[1:]),
        launches=launches, reload_b_launches=reload_b, peak_memory_mib=peak_mib,
        write_corpus_s=write_s, run_s=run_s, run_split_s=secs,
        reload_and_transcribe_s=reload_s, lines=lines,
        artifacts=sorted(os.listdir(out)), bundle_texts=texts,
        bundle_hidden=bundle.cfg.hidden_sz, bundle_vocab=len(bundle.lang))
    ckpt = os.path.join(out, "ckpt")
    checks = {
        "two launches of the CLI, the same arguments": len(calls) == 2
        and calls[0] == calls[1],
        "the crash was caught and resumed":
        f"[train-960] run crashed (RuntimeError: injected crash at step "
        f"{RECIPE_CRASH_AT}); resuming from {ckpt} (1/2)" in text
        and f"[train] resumed from {ckpt} at step {RECIPE_CRASH_AT}" in text,
        "the first launch ended at the crash step, the second at the last":
        f"[train] done: step={RECIPE_CRASH_AT} " in text
        and f"[train] done: step={RECIPE_STEPS} " in text,
        "every step ran": len(steps_ms) == RECIPE_STEPS,
        "D, E 6 and F, G, H 1 launches a step":
        all(s == want_step for s in per_step),
        "B launched in the evals": launches["lstm_seq_cseq"] > 0,
        "the final WER line": "[train-960] final test-split WER:" in text
        and "[eval] n=8 WER=" in text,
        "every artifact": all(os.path.exists(os.path.join(out, f)) for f in (
            "asr-dataset-train.csv", "asr-dataset-valid.csv", "asr-dataset-test.csv",
            "tokenizer.bpe-model", "train960.yaml", "model.tar.gz")),
        "the bundle reloads on cuda at full width and transcribes":
        bundle.device.type == "cuda" and bundle.cfg.hidden_sz == 1024
        and len(texts) == 1 and reload_b == layers,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"recipe_960: {failed}\n" + "\n".join(lines))


# --- multi-GPU training and serving, and the reference importer -------------

DIST_STEPS = 3
MESH_STREAMS = 64
# base.yaml's shapes in the reference's names
REF_SHAPES = dict(feature_sz=1280, embed_sz=512, vocab_sz=2048, hidden_sz=1024,
                  joint_sz=1024, enc_layers=6, pred_layers=2)


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _nccl_world_of_one() -> None:
    """An NCCL process group of one rank on this card, on a free port."""
    from libreasr_tpu_torch.parallel import distributed as dist

    dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")


def _timed_step(learner, batch) -> tuple[float, float, dict]:
    """One step, counted and timed: (loss, ms, launches of that step)."""
    import torch

    torch.cuda.synchronize()
    _reset_kernel_launches()
    t0 = time.perf_counter()
    loss = float(learner.step(batch)["loss"])
    torch.cuda.synchronize()
    return loss, (time.perf_counter() - t0) * 1e3, {
        k: v for k, v in _kernel_launches().items() if v}


def _bit_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def phase_dist_train_full_width(seed: int, card: str) -> None:
    """train_full_width's Learner on an NCCL group of one rank
    (Learner(mesh=make_mesh(data=1)): row-scoped draws run; an axis of
    one rank has no group, so no collective does, as under GSPMD) against
    the plain Learner from the same seed, 3 steps on the same batches
    (accumulation 1): the same loss and parameters bit for bit, the same
    D, E, F, G, H launches a step; then a checkpoint saved under the mesh
    restores into a plain Learner whose next step equals the mesh
    Learner's bit for bit."""
    import torch
    import torch.distributed as tdist

    from libreasr_tpu_torch.parallel.mesh import make_mesh
    from libreasr_tpu_torch.training.checkpoint import (restore_train_state,
                                                        save_train_state)
    from libreasr_tpu_torch.training.learner import Learner

    _nccl_world_of_one()
    try:
        mesh = make_mesh(data=1)
        plain = Learner.from_config(train_conf(accumulate=1), device="cuda", seed=seed)
        meshed = Learner.from_config(train_conf(accumulate=1), device="cuda",
                                     seed=seed, mesh=mesh)
        batches = _train_batches(plain.cfg, plain.frontend, seed,
                                 steps=DIST_STEPS + 1)
        layers = plain.cfg.enc_num_layers
        want = {"lstm_train_fwd": layers, "lstm_train_bwd": layers,
                "joint_lp_fwd": 1, "joint_lp_dx": 1, "joint_lp_dw": 1}
        steps = []
        for b in batches[:DIST_STEPS]:
            lp, msp, np_ = _timed_step(plain, b)
            lm, msm, nm = _timed_step(meshed, b)
            steps.append(dict(loss_plain=lp, loss_mesh=lm, ms_plain=msp,
                              ms_mesh=msm, launches_plain=np_, launches_mesh=nm))
        same = [_bit_equal(plain.params, meshed.params),
                _bit_equal(list(plain.model.buffers()), list(meshed.model.buffers()))]
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            save_train_state(tmp, meshed)
            save_s = time.perf_counter() - t0
            restored = Learner.from_config(train_conf(accumulate=1), device="cuda",
                                           seed=seed + 1)
            restore_train_state(tmp, restored)
        l_mesh, _, _ = _timed_step(meshed, batches[DIST_STEPS])
        l_rest, _, _ = _timed_step(restored, batches[DIST_STEPS])
        # the host's cost of one collective (a data-parallel step makes
        # 45: the batch norms' sums, the loss's gathers, the flat
        # gradient, the counts; at one rank it makes none)
        one = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            tdist.all_reduce(one)
        torch.cuda.synchronize()
        nccl_call_us = (time.perf_counter() - t0) / 200 * 1e6
        resumed = dict(loss_mesh=l_mesh, loss_restored=l_rest,
                       params_equal=_bit_equal(meshed.params, restored.params),
                       save_s=save_s)
        log("dist_train_full_width", card=card, backend=tdist.get_backend(),
            nccl_version=".".join(map(str, torch.cuda.nccl.version())),
            world=tdist.get_world_size(), mesh=mesh.shape, n=16, steps=steps,
            nccl_all_reduce_host_us=nccl_call_us,
            params_bit_equal=same[0], batch_stats_bit_equal=same[1],
            expected_launches_per_step=want, resumed=resumed,
            step_ms_median_plain=statistics.median(x["ms_plain"] for x in steps[1:]),
            step_ms_median_mesh=statistics.median(x["ms_mesh"] for x in steps[1:]))
        bad = [x for x in steps if x["loss_plain"] != x["loss_mesh"]
               or x["launches_plain"] != want or x["launches_mesh"] != want]
        if bad or not all(same) or l_mesh != l_rest or not resumed["params_equal"]:
            raise AssertionError(f"dist_train_full_width: steps {bad}, params and "
                                 f"statistics equal {same}, resumed {resumed}")
        del plain, meshed, restored
        torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()


def phase_train_cli_dist(seed: int, card: str, plain: dict) -> None:
    """`python -m libreasr_tpu_torch.train` (its main, in this process)
    with --dist-coordinator 127.0.0.1:PORT --dist-procs 1 --dist-pid 0 on
    train_cli's corpus: NCCL starts inside the CLI; with one process the
    CLI builds no mesh and ends as the plain CLI does (an eval and the
    `[train] done:` line), and its 2 steps leave the parameters of the
    plain CLI's 2-step run (train_cli's chain check) bit for bit, with
    its done line; then a resume to step 3."""
    import contextlib
    import io

    import torch
    import torch.distributed as tdist

    from libreasr_tpu_torch import train

    outs, secs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = _train_cli_conf(tmp, seed)
        d = os.path.join(tmp, "ckpt")
        for steps in ("2", "3"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    train.main(_cli_args(path, d) + [
                        "--steps", steps, "--dist-coordinator",
                        f"127.0.0.1:{_free_port()}", "--dist-procs", "1",
                        "--dist-pid", "0"])
                backend = tdist.get_backend()
            finally:
                if tdist.is_initialized():
                    tdist.destroy_process_group()
            secs.append(time.perf_counter() - t0)
            outs.append(buf.getvalue())
            if steps == "2":
                state = torch.load(os.path.join(d, "train_state.pt"),
                                   map_location="cpu", weights_only=True)["model"]
                equal = set(state) == set(plain["state"]) and all(
                    torch.equal(v, plain["state"][k]) for k, v in state.items())
                done2 = _done_line(outs[0])
    log("train_cli_dist", card=card, backend=backend, seconds=secs,
        done_dist=done2, done_plain=plain["done"], params_bit_equal=equal,
        resumed=[ln for ln in outs[1].splitlines()
                 if ln.startswith(("[train] resumed", "[train] done"))])
    if not (equal and done2 == plain["done"] and backend == "nccl"
            and "multi-host" not in "".join(outs) and "[eval]" in outs[0]
            and "resumed" in outs[1] and "done: step=3" in outs[1]):
        raise AssertionError("train_cli_dist: " + "\n".join(outs))


def _state_gaps(whole, part, rows: slice) -> dict:
    """Where an engine's state (rows `rows` of `whole`) and a smaller
    engine's (`part`) part after the same steps: each leaf that differs,
    by its path, with its largest difference (or count of differing
    entries for integer leaves)."""
    import dataclasses

    import torch

    out = {}

    def walk(path, a, b):
        if isinstance(a, torch.Tensor):
            a = a[rows]
            if a.shape != b.shape:
                return
            if a.dtype.is_floating_point:
                gap = float((a.float() - b.float()).abs().max())
            else:
                gap = int((a != b).sum())
            if gap:
                out[path] = gap
        elif dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                walk(f"{path}.{f.name}", getattr(a, f.name), getattr(b, f.name))
        elif isinstance(a, (tuple, list)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(f"{path}[{i}]", x, y)

    walk("state", whole, part)
    return out


def _mesh_vs_single(bundle, scfg, mesh, clips, use_lm: bool,
                    per_device: bool = False) -> dict:
    """An engine of MESH_STREAMS over `mesh` against the single engine of
    MESH_STREAMS on the same streams, step by step, and with `per_device`
    also against single engines of each device's share of the slots (the
    same shapes as the mesh's graphs): tokens and counts equal on every
    slot against the engines the check holds (the per-device ones when
    given, else the single one; the single engine's differing slots are
    counted either way, and with `per_device` the state leaves where the
    first device's engine parts from the single one after steps 1 and
    2); replay ms of the single engine and of the mesh engine (every
    device's graph in turn)."""
    import numpy as np

    from libreasr_tpu_torch.models.streaming import StreamingEngine

    c, n = STREAM_CHUNK, MESH_STREAMS
    d = mesh.size("data")
    single = StreamingEngine(bundle, n_streams=n, scfg=scfg, use_lm=use_lm)
    meshed = StreamingEngine(bundle, n_streams=n, scfg=scfg, use_lm=use_lm,
                             mesh=mesh)
    parts = [StreamingEngine(bundle, n_streams=n // d, scfg=scfg, use_lm=use_lm)
             for _ in range(d)] if per_device else []
    lengths = np.array([len(x) for x in clips])
    steps = int(lengths.max()) // c
    _reset_kernel_launches()
    tokens, differ, gaps = 0, set(), {}
    for k in range(steps):
        chunks = np.zeros((n, 1, c), np.float32)
        for i, x in enumerate(clips):
            chunks[i, 0, : len(x[k * c:(k + 1) * c])] = x[k * c:(k + 1) * c]
        valid = lengths >= (k + 1) * c
        t1, l1 = single.step_batch(chunks, valid=valid)
        t2, l2 = meshed.step_batch(chunks, valid=valid)
        differ |= set(np.nonzero((l1 != l2) | (t1 != t2).any(1))[0].tolist())
        if parts:
            rows = [slice(i * (n // d), (i + 1) * (n // d)) for i in range(d)]
            got = [e.step_batch(chunks[r], valid=valid[r]) for e, r in zip(parts, rows)]
            t1 = np.concatenate([g[0] for g in got])
            l1 = np.concatenate([g[1] for g in got])
            if k < 2:
                gaps[f"after_step_{k + 1}"] = _state_gaps(single.state,
                                                          parts[0].state, rows[0])
        if not (np.array_equal(l1, l2) and np.array_equal(t1, t2)):
            rows = np.nonzero((l1 != l2) | (t1 != t2).any(1))[0]
            raise AssertionError(f"streaming_mesh: step {k}, slots {rows.tolist()} "
                                 "differ from the engines they are held to")
        tokens += int(l2.sum())
    launches = {k: v for k, v in _kernel_launches().items() if v}
    if parts:
        gaps["products_n_against_n_over_2"] = _gemm_rows(single, 0)
    out = dict(steps=steps, tokens=tokens, kernel_launches=launches,
               held_to="engines of N/D" if parts else f"the engine of {n}",
               state_gaps_to_engine_of_n=gaps,
               slots_differing_from_engine_of_n=sorted(differ),
               replays_single=single.replays, replays_mesh=meshed.replays,
               shards=len(meshed._shards),
               replay_ms_single=cuda_ms(lambda: single._graph.replay(), reps=20),
               **_mesh_replay_ms(meshed))
    if launches or single.replays != steps or meshed.replays != steps * len(
            meshed._shards) or not tokens:
        raise AssertionError(f"streaming_mesh: {out}")
    return out


def _mesh_replay_ms(meshed, reps: int = 20) -> dict:
    """The replay ms of every sub-engine's graph in turn: on CUDA events
    when one card holds them all, else on the host's clock with every
    card synchronized (the cards replay side by side)."""
    import torch

    devs = sorted({sh.device for sh in meshed._shards}, key=str)

    def run():
        for sh in meshed._shards:
            with torch.cuda.device(sh.device):
                sh._graph.replay()

    if len(devs) == 1:
        return dict(replay_ms_mesh=cuda_ms(run, reps=reps),
                    replay_clock="cuda events")
    run()
    for d in devs:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    for d in devs:
        torch.cuda.synchronize(d)
    return dict(replay_ms_mesh=(time.perf_counter() - t0) * 1e3 / reps,
                replay_clock="host wall, every card synchronized")


def _gemm_rows(engine, seed: int) -> dict:
    """The products a streaming step runs on every stream, over the
    engine's n streams against its first n/2 alone (seeded inputs): the
    frontend's float32 DFT and mel products (`mel_chunk` on one chunk),
    and the first encoder layer's recurrent product h @ R in bf16 and in
    float32. For each: how many of those rows' elements differ, the
    largest difference, and the kernels each launches (torch.profiler)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = engine.n
    rng = np.random.default_rng(seed)
    carry = torch.zeros((n, engine._sample_carry_len), device="cuda")
    chunk = torch.from_numpy((rng.standard_normal((n, STREAM_CHUNK)) * 0.1)
                             .astype(np.float32)).cuda()
    r = engine.model.encoder.rnn_stack.layer(0).cell.params().recurrent_kernel.detach()
    h = torch.from_numpy(rng.standard_normal((n, r.shape[0])).astype(np.float32)).cuda()
    cases = {"frontend_float32": lambda k: engine.mel_chunk(carry[:k], chunk[:k])[0],
             "recurrent_bfloat16": lambda k: h[:k].bfloat16() @ r.bfloat16(),
             "recurrent_float32": lambda k: h[:k] @ r}
    out = {}
    for name, fn in cases.items():
        got, names = {}, {}
        for rows in (n, n // 2):
            with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
                got[rows] = fn(rows)
                torch.cuda.synchronize()
            names[str(rows)] = sorted({
                e.key[:90] for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and ("gemm" in e.key.lower() or "nvjet" in e.key or "splitK" in e.key)})
        diff = (got[n][: n // 2].float() - got[n // 2].float()).abs()
        out[name] = dict(rows=[n, n // 2], elements=int(diff.numel()),
                         elements_differing=int((diff > 0).sum()),
                         max_abs=float(diff.max()), gemm_kernels=names)
    return out


def phase_streaming_mesh(seed: int, card: str, devices=None) -> None:
    """Engines of 64 streams over the mesh `devices` (default [cuda:0,
    cuda:0]: two sub-engines of 32, two weight copies, two CUDA graphs;
    [cuda:0, cuda:1] where two cards are visible) on the same ragged 3-6
    s int16 streams: greedy on the model of 5 in bf16 against engines of
    each device's share (a batch of 32 may take another cuBLAS kernel
    than one of 64, and near-tied bf16 argmaxes part then: the slots
    that differ from the engine of 64 are logged, with where the state
    first parts and _gemm_rows's products at both batches); greedy, and
    beam K 4 + LM, on the sharpened joint (_make_emitting) in float32
    against the engine of 64. Tokens equal on every slot. Then
    ASRServicer on a mesh engine of the golden char bundle (8 slots, 4 a
    device): two streams exact."""
    import dataclasses

    import torch

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.models.streaming import StreamingConfig, StreamingEngine
    from libreasr_tpu_torch.parallel.mesh import make_mesh
    from libreasr_tpu_torch.serving.server import ASRServicer

    if devices is None:
        devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(2)]
    mesh = make_mesh(data=len(devices), devices=devices)
    clips = _stream_clips(MESH_STREAMS, seed + 11)
    conf = parse_and_apply_config(inference=True)
    bundle = ASRBundle.from_config(conf, seed=seed, device="cuda")
    scfg = StreamingConfig(sr=bundle.frontend.sr, transfer_dtype="int16",
                           max_iters=conf["stream"]["max_iters"])
    greedy = _mesh_vs_single(bundle, scfg, mesh, clips, use_lm=False,
                             per_device=True)
    del bundle
    lm_bundle = _lm_bundle(seed, compute="float32")
    _make_emitting(lm_bundle)
    greedy32 = _mesh_vs_single(lm_bundle, scfg, mesh, clips, use_lm=False)
    beam = _mesh_vs_single(lm_bundle, dataclasses.replace(
        scfg, beam_width=BEAM_WIDTH, lm_alpha=LM_ALPHA), mesh, clips, use_lm=True)
    del lm_bundle
    torch.cuda.empty_cache()
    audio = _golden_audio()
    with tempfile.TemporaryDirectory() as tmp:
        golden = ASRBundle.from_bundle(os.path.join(GOLDEN, "model.tar.gz"),
                                       device="cuda", extract_to=tmp)
        eng = StreamingEngine(golden, n_streams=8, mesh=mesh)
        servicer = ASRServicer(golden, engine=eng)
        try:
            texts, _, _, errors = _stream_through(servicer, [audio[2], audio[3]])
        finally:
            servicer.stepper.shutdown()
    log("streaming_mesh", card=card, mesh=mesh.shape,
        devices=[str(d) for d in mesh.devices], n_streams=MESH_STREAMS,
        greedy_bf16=greedy, greedy_float32_sharpened=greedy32,
        beam_lm_float32_sharpened=beam, beam_width=BEAM_WIDTH,
        serving_golden=texts, serving_replays=eng.replays, serving_steps=eng.steps,
        errors=errors)
    if texts != ["hello world", "stop now"] or errors \
            or eng.replays != len(eng._shards) * eng.steps:
        raise AssertionError(f"streaming_mesh serving: {texts} {errors}")


def phase_import_reference(seed: int, card: str) -> None:
    """A seeded state_dict in the reference's layout at base.yaml's
    shapes (6x1024 LSTM encoder with batch norms, 2-layer NBRC predictor,
    joint 1024, V 2048) and a youtokentome model of 2048 ids, packed as
    the reference's release tar.gz and imported by the port's script on
    the card: transcribe_batch on the 16 clips of 5 launches B once per
    encoder layer; the encoder output against the same bundle on the CPU
    within ENC_TOL; the bundle reloaded transcribes the same."""
    import copy
    import tarfile

    import numpy as np
    import torch

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.compat.yttm_import import write_yttm_model
    from libreasr_tpu_torch.scripts import import_reference

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from helpers.reference_layout import reference_state_dict, yttm_vocabulary

    t_pack = time.perf_counter()
    sd = reference_state_dict(np.random.default_rng(seed), **REF_SHAPES)
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "en")
        os.makedirs(d)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(d, "model.pth"))
        del sd
        write_yttm_model(os.path.join(d, "tokenizer.yttm-model"),
                         *yttm_vocabulary(REF_SHAPES["vocab_sz"]))
        archive = os.path.join(tmp, "libreasr-model-en.tar.gz")
        with tarfile.open(archive, "w:gz", compresslevel=1) as tar:
            tar.add(d, arcname="en")
        out = os.path.join(tmp, "imported.tar.gz")
        pack_s = time.perf_counter() - t_pack
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            import_reference.main(["--archive", archive, "--out", out, "--config",
                                   os.path.join(HERE, "config", "base.yaml")])
        import_s = time.perf_counter() - t0
        bundle = ASRBundle.from_bundle(out, device="cuda",
                                       extract_to=os.path.join(tmp, "x"))
        cfg = bundle.cfg
        audio, lengths, _, _, feats, flens = _full_width_clips(bundle, seed)
        (texts, _), launches = _counted(lambda: bundle.transcribe_batch(audio, lengths))
        enc_cuda, _ = bundle.encode(feats, flens)
        cpu = ASRBundle(bundle.conf, copy.deepcopy(bundle.model).cpu(), bundle.lang,
                        torch.device("cpu"))
        enc_cpu, _ = cpu.encode(feats.cpu(), flens.cpu())
        diff = (enc_cuda.float().cpu() - enc_cpu.float()).abs()
        enc_err = {"max_abs": float(diff.max()), "mean_abs": float(diff.mean())}
        again = ASRBundle.from_bundle(out, device="cuda",
                                      extract_to=os.path.join(tmp, "y"))
        texts2, _ = again.transcribe_batch(audio, lengths)
        want = {"lstm_seq_cseq": cfg.enc_num_layers}
        log("import_reference", card=card, pack_s=pack_s, import_s=import_s,
            phase_s=time.perf_counter() - t_pack,
            enc_layers=cfg.enc_num_layers, hidden=cfg.hidden_sz,
            pred=[cfg.pred_num_layers, cfg.pred_rnn_type], joint=cfg.joint_sz,
            vocab=cfg.vocab_sz, tokenizer_vocab=len(bundle.lang),
            compute_dtype=str(cfg.compute_dtype), launches=launches,
            expected_launches=want, enc_cuda_vs_cpu=enc_err, tol_max=ENC_TOL_MAX,
            tol_mean=ENC_TOL_MEAN, texts_sample=texts[:2],
            reloaded_texts_equal=texts2 == texts,
            chars=sum(len(t) for t in texts))
        if launches != want or texts2 != texts \
                or len(bundle.lang) != REF_SHAPES["vocab_sz"] \
                or not bool(torch.isfinite(enc_cuda).all()) \
                or enc_err["max_abs"] > ENC_TOL_MAX \
                or enc_err["mean_abs"] > ENC_TOL_MEAN:
            raise AssertionError(f"import_reference: launches {launches}, "
                                 f"encoder {enc_err}, reloaded {texts2 == texts}")


BENCH_K, BENCH_REPS = 4, 3      # chained steps and repetitions of the step scripts
BENCH_PALLAS_K = 2              # chained calls of bench_pallas (the scans are slow)
BENCH_SERVING_STREAMS, BENCH_SERVING_SECONDS = 64, 6
# the N 512 replay timed at each of two blank biases, alternated; the two
# medians must agree within the larger of either bias's range and 2% of
# the pinned one: an early exit from the masked decode rounds would save
# most of the step, far more than the 2% that the CUDA-event times of
# one step on fresh engines may differ by
BENCH_BIAS_RUNS, BENCH_BIAS_REL_TOL = 3, 0.02


def _finite(phase: str, readings: dict) -> None:
    bad = {k: v for k, v in readings.items()
           if not (isinstance(v, (int, float)) and math.isfinite(v))}
    if bad:
        raise AssertionError(f"{phase}: readings not finite: {bad}")


def phase_bench(card: str) -> None:
    """The benchmark harness at full width, fewer repetitions (33)."""
    import io

    import torch

    from libreasr_tpu_torch import bench
    from libreasr_tpu_torch.models.streaming import StreamingEngine
    from libreasr_tpu_torch.scripts import (bench_loss_parts, bench_pallas,
                                            bench_serving, bench_step_parts,
                                            bench_train_step)

    golden = bench.golden_emission_rate()
    bundle = bench.build_bundle()
    base = bundle.model.joint.out.bias[0].clone()
    # the pinned bias is the bisection's result, at its rate
    bias, proxy = bench.calibrate_blank_bias(bundle, golden)
    # a fresh engine at that bias, then biases set after its capture:
    # flooding, pure blank, flooding again
    eng = StreamingEngine(bundle, n_streams=16)
    rates = {"fresh_at_pinned": bench.measure_rate(eng, bundle, 16)}
    for name, b in (("at_0", 0.0), ("at_8", 8.0), ("at_0_again", 0.0)):
        bench.set_blank_bias(bundle, b, base=base)
        rates[name] = bench.measure_rate(eng, bundle, 16)
    bench.set_blank_bias(bundle, bench.BLANK_BIAS, base=base)
    replays, steps = eng.replays, eng.steps
    del eng
    log("bench_rates", card=card, golden_latched_rate=golden,
        calibrated_bias=bias, calibrated_rate=proxy,
        pinned_bias=bench.BLANK_BIAS, rates_n16=rates, graph_replays=replays,
        steps=steps)
    if bias != bench.BLANK_BIAS or not proxy >= golden:
        raise AssertionError(f"bench: the bisection gave {bias} at {proxy} "
                             f"tokens a chunk (pinned {bench.BLANK_BIAS}, "
                             f"golden {golden})")
    if not (rates["at_8"] < min(rates["at_0"], rates["at_0_again"])
            and replays == steps):
        raise AssertionError(f"bench: a bias set after the capture did not "
                             f"reach the replays: {rates}")
    cache: dict = {}
    steps_ms = {}
    for n in (64, 512):
        steps_ms[n] = bench.time_engine(bundle, n, cache=cache) * 1e3
        log("bench_time_engine", card=card, n_streams=n, step_ms=steps_ms[n],
            streams=n * 80 / steps_ms[n])
    _finite("bench_time_engine", steps_ms)
    del cache
    rate, spread = bench.device_resident_rate(bundle, 512)
    log("bench_device_resident", card=card, n_streams=512, streams=rate,
        spread_pct=spread)
    # the replay at N 512 at the pinned bias and at 0 (flooding),
    # alternated: the captured step runs all max_iters rounds masked, so
    # the bias the sweep runs at must not move its device time
    by_bias = {"pinned": [], "0": []}
    for _ in range(BENCH_BIAS_RUNS):
        for name, b in (("pinned", bench.BLANK_BIAS), ("0", 0.0)):
            bench.set_blank_bias(bundle, b, base=base)
            by_bias[name].append(bench.device_step_time(bundle, 512) * 1e3)
    bench.set_blank_bias(bundle, bench.BLANK_BIAS, base=base)
    med = {name: statistics.median(v) for name, v in by_bias.items()}
    tol = max([max(v) - min(v) for v in by_bias.values()]
              + [BENCH_BIAS_REL_TOL * med["pinned"]])
    replay = {256: bench.device_step_time(bundle, 256) * 1e3,
              512: med["pinned"]}
    log("bench_device_step", card=card, replay_ms=replay,
        replay_ms_n512_by_bias=by_bias, bias_gap_ms=med["0"] - med["pinned"],
        bias_tol_ms=tol,
        time_engine_over_replay_n512=steps_ms[512] / replay[512])
    if not abs(med["0"] - med["pinned"]) <= tol:
        raise AssertionError(f"bench: the replay at N 512 takes {med['0']} ms "
                             f"at bias 0 and {med['pinned']} at "
                             f"{bench.BLANK_BIAS} (tolerance {tol})")
    _finite("bench_device", {"streams": rate, "spread": spread,
                             **{f"replay_{n}": v for n, v in replay.items()}})
    del bundle
    torch.cuda.empty_cache()

    def quiet(fn, argv):
        """A script's main, its printed lines kept for the log."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(argv)
        return out, buf.getvalue().splitlines()

    serving, _ = quiet(bench_serving.main, [
        "--transport", "inproc", "--streams", str(BENCH_SERVING_STREAMS),
        "--duration", str(BENCH_SERVING_SECONDS)])
    log("bench_serving", card=card, **serving)
    _finite("bench_serving", {k: serving[k] for k in
                              ("value", "p90_ms", "overrun_p50_ms")})
    torch.cuda.empty_cache()

    k = ["--k", str(BENCH_K), "--reps", str(BENCH_REPS)]
    _reset_kernel_launches()
    train, lines = quiet(bench_train_step.main, k)
    launches = {n: v for n, v in _kernel_launches().items() if v}
    per_step = {n: v / train["steps"] for n, v in launches.items()}
    log("bench_train_step", card=card, **train, launches=launches,
        launches_a_step=per_step, lines=lines)
    want = {"lstm_train_fwd": 6, "lstm_train_bwd": 6, "joint_lp_fwd": 1,
            "joint_lp_dx": 1, "joint_lp_dw": 1}
    if per_step != want:
        raise AssertionError(f"bench_train_step launched {per_step} a step, "
                             f"expected {want}")
    _finite("bench_train_step", {"ms": train["ms"], "mfu": train["mfu"]})
    torch.cuda.empty_cache()
    for name, main in (("bench_step_parts", bench_step_parts.main),
                       ("bench_loss_parts", bench_loss_parts.main)):
        parts, _ = quiet(main, k)
        log(name, card=card, ms=parts)
        _finite(name, parts)
        torch.cuda.empty_cache()
    pk = ["--quick", "--k", str(BENCH_PALLAS_K), "--reps", str(BENCH_REPS)]
    for name, argv in (("bench_pallas", pk),
                       ("bench_pallas_train", pk + ["--train"])):
        out, lines = quiet(bench_pallas.main, argv)
        log(name, card=card, max_err=out["max_err"], table=lines)
        _finite(name, {"max_err": out["max_err"],
                       **{f"row{i}_{j}": x for i, r in enumerate(out["rows"])
                          for j, x in enumerate(r)}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "libreasr_tpu_torch")):
        print("chip_smoke: libreasr_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    worst = phase_kernel(args.seed)
    torch.cuda.synchronize()
    phase_golden()
    torch.cuda.synchronize()
    rows = phase_full_width(args.seed, card, worst)
    torch.cuda.synchronize()
    worst_int8 = phase_kernel_int8(args.seed)
    torch.cuda.synchronize()
    phase_golden_int8()
    phase_golden_bpe()
    torch.cuda.synchronize()
    rows.append(phase_full_width_int8(args.seed, card, worst_int8))
    torch.cuda.synchronize()
    worst_joint = phase_kernel_joint(args.seed)
    torch.cuda.synchronize()
    worst_train = phase_kernel_train(args.seed)
    torch.cuda.synchronize()
    main_train = phase_train_full_width(args.seed, card)
    torch.cuda.synchronize()
    phase_train_scan_route(args.seed, card, main_train)
    launches = main_train.pop("launches")
    train_flops = {k: main_train[k] for k in ("step_ms", "shape", "cfg")}
    del main_train
    torch.cuda.synchronize()
    phase_train_small_cuda_vs_cpu(args.seed)
    torch.cuda.synchronize()
    plain_cli = phase_train_cli(args.seed, card)
    torch.cuda.synchronize()
    phase_options_full_width(args.seed, card)
    torch.cuda.synchronize()
    phase_options_train_full_width(args.seed, card)
    torch.cuda.synchronize()
    t_tone = time.perf_counter()
    with tempfile.TemporaryDirectory() as tone:
        bundle_path = phase_train_tone_stream(card, tone)
        phase_evaluate_wer(args.seed, bundle_path)
    tone_s = time.perf_counter() - t_tone
    torch.cuda.synchronize()
    phase_streaming_golden()
    stream = phase_streaming_full_width(args.seed, card)
    phase_flops(card, train_flops, stream)
    del stream, train_flops
    phase_serving(args.seed, card)
    torch.cuda.synchronize()
    phase_golden_beam()
    lm_bundle = _lm_bundle(args.seed)
    beam_launches = phase_full_width_beam(args.seed, card, lm_bundle)
    for row in rows:  # B and C per transcribe_beam, float and int8
        key = "beam_int8" if row["name"] == "lstm_seq_int8" else "beam"
        row["launches_transcribe_beam"] = beam_launches[key].get(row["name"], 0)
    _make_emitting(lm_bundle)
    phase_full_width_beam_emitting(args.seed, card, lm_bundle)
    phase_streaming_full_width_beam(args.seed, card, lm_bundle)
    phase_serving_beam(args.seed, card, lm_bundle)
    del lm_bundle
    torch.cuda.synchronize()
    t_new = time.perf_counter()
    with tempfile.TemporaryDirectory() as data:
        corpus = phase_data_tools(args.seed, card, data)
        phase_train_ctc_full_width(args.seed, card, corpus)
    torch.cuda.synchronize()
    phase_train_lm_full_width(args.seed, card)
    torch.cuda.synchronize()
    phase_soak(card)
    torch.cuda.synchronize()
    new_s = time.perf_counter() - t_new
    t_recipe = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        phase_recipe_960(args.seed, card, tmp)
    torch.cuda.synchronize()
    recipe_s = time.perf_counter() - t_recipe
    t_dist = time.perf_counter()
    phase_dist_train_full_width(args.seed, card)
    torch.cuda.synchronize()
    phase_train_cli_dist(args.seed, card, plain_cli)
    del plain_cli
    torch.cuda.synchronize()
    phase_streaming_mesh(args.seed, card)
    torch.cuda.synchronize()
    phase_import_reference(args.seed, card)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t_dist
    t_bench = time.perf_counter()
    phase_bench(card)
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t_bench
    rows += joint_rows(args.seed, worst_joint, launches)
    rows += train_kernel_rows(args.seed, worst_train, launches)
    torch.cuda.synchronize()
    # every phase, the build included, and the shares of some groups
    log("wall", seconds=time.perf_counter() - t_start, tone_phases_seconds=tone_s,
        data_ctc_lm_soak_seconds=new_s, recipe_960_seconds=recipe_s,
        dist_mesh_import_seconds=dist_s, bench_seconds=bench_s)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
