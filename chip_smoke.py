#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libreasr_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (any failure raises and exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the CUDA sources (csrc/*.cu) with nvcc;
  3. kernel: the LSTM sequence kernel against its plain PyTorch twin on
     the card, with and without the streamed cell state, at the golden
     and the full-width shapes (tolerance KERNEL_TOL);
  4. golden: the committed golden bundle must transcribe its 8 clips
     exactly, at 1 s (scan path) and zero-padded to 3 s (kernel path);
  5. full width: a seeded random model of config/base.yaml (6-layer
     LSTM encoder, H 1024, V 2048, bf16 compute) runs the main path:
     transcribe_batch on 16 ragged 6 s clips and encode without lengths,
     with the launch counts read around that run; its encoder output
     is held against the same model on the CPU (tolerance ENC_TOL), and
     the path is timed;
  6. kernel_int8: the int8 LSTM sequence kernel against its twin on the
     card, with pack semantics (lengths 0 and T), at the shapes of 3 and
     one H off its 4-column vector path (tolerance INT8_TOL); the port's
     int8_matmul on the card equals its CPU result bit for bit;
  7. golden_int8: the golden bundle quantized by the port, and that
     bundle saved by the port and reloaded, each transcribe the 8 clips
     exactly at 1 s (no int8 kernel launch) and padded to 3 s (2 layers
     x 37 launches);
  8. golden_bpe: the BPE golden bundle transcribes its 8 clips exactly,
     at 1 s and padded to 3 s;
  9. full_width_int8: the model of 5, quantized by the port, runs
     transcribe_batch on the same clips: 6 x 74 int8 kernel launches and
     none of the bf16-R kernel; its encoder output is held against the
     same int8 model on the CPU (tolerance INT8_ENC_TOL), and the path
     is timed.
Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}.

Exits non-zero without a result when CUDA is unavailable or when the
port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
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
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12


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


def lstm_bound_ms(n: int, t: int, h: int, stream_c: bool) -> tuple[float, str]:
    """Least time for one sequence call: inputs read once (wx f32, R
    bf16, h0, c0), outputs written once (y, and yc or cT), against the
    bf16 tensor rate for the 2*N*T*H*4H recurrent flops."""
    nbytes = 4 * n * t * 4 * h + 2 * h * 4 * h + 2 * 4 * n * h + 4 * n * t * h
    nbytes += 4 * n * t * h if stream_c else 4 * n * h
    flops = 2.0 * n * t * h * 4 * h
    tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def lstm_int8_bound_ms(n: int, t: int, h: int) -> tuple[float, str]:
    """Least time for one int8 sequence call: wx f32, R int8, its scales
    and h0, c0 read once, y and yc written once, against the int8
    tensor rate for the 2*N*T*H*4H recurrent operations."""
    nbytes = (4 * n * t * 4 * h + h * 4 * h + 4 * 4 * h + 2 * 4 * n * h
              + 2 * 4 * n * t * h)
    ops = 2.0 * n * t * h * 4 * h
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_INT8_OPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


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
    """Kernel vs twin at several shapes; returns the largest error per
    kernel name."""
    import torch

    from libreasr_tpu_torch.ops.kernels.lstm import (
        lstm_pack, lstm_seq, lstm_seq_reference,
    )
    from libreasr_tpu_torch.ops.rnn import LSTMParams

    gen = torch.Generator().manual_seed(seed)
    # (N, T, H): golden encoder (T 37), N off the batch tile, an H off
    # the 8-column vector path, the full-width main path, a long batch
    cases = [(8, 37, 96), (13, 37, 96), (5, 17, 100), (16, 74, 1024),
             (64, 200, 1024)]
    worst = {"lstm_seq": 0.0, "lstm_seq_cseq": 0.0}
    for n, t, h in cases:
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen) * scale).cuda()

        wx = rnd(n, t, 4 * h)
        r = rnd(h, 4 * h, scale=1.0 / h ** 0.5)
        h0, c0 = rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
        errs = {}
        for stream_c, name in ((False, "lstm_seq"), (True, "lstm_seq_cseq")):
            got = lstm_seq(wx, r, h0, c0, stream_c=stream_c)
            ref = lstm_seq_reference(wx, r, h0, c0, stream_c)
            torch.cuda.synchronize()
            pairs = [(a, b) for a, b in zip(got, ref) if a is not None]
            err = max(float((a - b).abs().max()) for a, b in pairs)
            errs[name] = err
            errs[name + "_mean"] = max(float((a - b).abs().mean())
                                       for a, b in pairs)
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
            tol_mean=KERNEL_TOL_MEAN)
        bad = {k: v for k, v in errs.items() if not v <= (
            KERNEL_TOL_MEAN if k.endswith("_mean") else KERNEL_TOL)}
        if bad:
            raise AssertionError(f"kernel vs twin at {(n, t, h)}: {bad}")
    return worst


def _golden_check(name: str, bundle, kernel: str) -> None:
    """The golden clips at 1 s (T 12: the scan cells, no kernel launch)
    and zero-padded to 3 s with the true lengths (T 37: `kernel` once per
    step of each encoder layer), with the launch counts read around each
    call; raises unless both give the 8 texts exactly with those counts."""
    import numpy as np
    import torch

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
    t_3s = int(bundle.frontend.out_length(torch.tensor(48000)))
    want_3s = {k: 0 for k in klstm.LAUNCHES}
    want_3s[kernel] = bundle.cfg.enc_num_layers * t_3s
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
            bundle.decoder_fns(), enc_out, flens, blank=cfg.blank, bos=cfg.bos,
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
    want = {"lstm_seq": cfg.enc_num_layers * t_enc,
            "lstm_seq_cseq": cfg.enc_num_layers * t_enc, "lstm_seq_int8": 0}
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
        for stream_c, name, line in ((False, "lstm_seq", 73),
                                     (True, "lstm_seq_cseq", 41)):
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
    """The int8 kernel vs its twin, and the port's int8 products on the
    card vs on the host; returns the kernel's largest error."""
    import torch

    from libreasr_tpu_torch.ops.kernels.lstm import (
        lstm_pack, lstm_seq_int8, lstm_seq_int8_reference, pack_k4,
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

    # (N, T, H): phase_kernel's cases, and one H off the 4-column vector path
    cases = [(8, 37, 96), (13, 37, 96), (5, 17, 100), (16, 74, 1024),
             (64, 200, 1024), (3, 17, 98)]
    worst = 0.0
    for n, t, h in cases:
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen) * scale).cuda()

        wx = rnd(n, t, 4 * h)
        r = quantize(rnd(h, 4 * h, scale=1.0 / h ** 0.5))
        r = QuantizedTensor(r.q, r.scale, pack_k4(r.q))
        h0, c0 = rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
        got = lstm_seq_int8(wx, r.q, r.scale, h0, c0, rq_packed=r.packed)
        ref = lstm_seq_int8_reference(wx, r.q, r.scale, h0, c0)
        torch.cuda.synchronize()
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
            tol_mean=INT8_TOL_MEAN)
        bad = {k: v for k, v in errs.items() if not v <= (
            INT8_TOL_MEAN if k.endswith("_mean") else INT8_TOL)}
        if bad:
            raise AssertionError(f"int8 kernel vs twin at {(n, t, h)}: {bad}")
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
            "lstm_seq_int8": cfg.enc_num_layers * t_enc}
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
        "replaces": "libreasr_tpu/ops/pallas/lstm.py:243",
        "launches": launches["lstm_seq_int8"], "max_abs_err": worst_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None,
    }
    log("full_width_int8", card=card, n=n, t_enc=t_enc, hidden=h_sz,
        vocab=cfg.vocab_sz, enc_layers=cfg.enc_num_layers, **stages,
        lstm_pack_layer_ms=pack_ms, peak_memory_mib=peak_mib,
        kernel_ms=ms, twin_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
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
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
