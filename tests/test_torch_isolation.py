"""The port stands alone and never falls back silently:
- no module of libreasr_tpu_torch, nor chip_smoke.py, imports jax, flax,
  the JAX package, pandas or tensorboardX (the machine with the card
  has none of the last two), and its C++ and CUDA sources include none
  of the JAX package's;
- entry points default to cuda and raise without it;
- the kernel wrappers take their plain twins only for CPU tensors, and a
  failed kernel build raises;
- a library is named by the hash of its source and every header, so an
  edited header never serves a stale build;
- a model in training never runs the eval kernels, and where the JAX
  package trains through its kernels D and E the port does too, raising
  on a device it has no kernel for instead of taking the scan silently;
- on a machine with a card, the kernels match their twins (marked
  `cuda`, skipped here)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import libreasr_tpu_torch
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.config import parse_and_apply_config
from libreasr_tpu_torch.ops.kernels import build
from libreasr_tpu_torch.ops.kernels import joint_lp as kjoint
from libreasr_tpu_torch.ops.kernels import lstm as klstm
from libreasr_tpu_torch.training.learner import Learner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "libreasr_tpu_torch")
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden", "model.tar.gz")
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|libreasr_tpu|pandas|tensorboardX)(\.|\s|$)", re.M)


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_imports_in_sources():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for m in FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import libreasr_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'libreasr_tpu', 'pandas', 'tensorboardX'))\n"
        "assert len(mods) >= 62, mods\n"
        "assert {'libreasr_tpu_torch.ops.quant', 'libreasr_tpu_torch.data.bpe',"
        " 'libreasr_tpu_torch.ops.rnnt_loss', 'libreasr_tpu_torch.ops.fused_loss',"
        " 'libreasr_tpu_torch.ops.kernels.joint_lp',"
        " 'libreasr_tpu_torch.training.learner',"
        " 'libreasr_tpu_torch.training.optimizers',"
        " 'libreasr_tpu_torch.training.debug',"
        " 'libreasr_tpu_torch.ops.kernels.lstm_train', 'libreasr_tpu_torch.train',"
        " 'libreasr_tpu_torch.data.builder', 'libreasr_tpu_torch.data.transforms',"
        " 'libreasr_tpu_torch.data.batching', 'libreasr_tpu_torch.training.metrics',"
        " 'libreasr_tpu_torch.training.evaluate', 'libreasr_tpu_torch.training.callbacks',"
        " 'libreasr_tpu_torch.training.checkpoint',"
        " 'libreasr_tpu_torch.models.streaming', 'libreasr_tpu_torch.utils',"
        " 'libreasr_tpu_torch.models.lm', 'libreasr_tpu_torch.models.beam',"
        " 'libreasr_tpu_torch.serving.proto', 'libreasr_tpu_torch.serving.server',"
        " 'libreasr_tpu_torch.serving.bridge', 'libreasr_tpu_torch.serving.client',"
        " 'libreasr_tpu_torch.data.synth', 'libreasr_tpu_torch.scripts',"
        " 'libreasr_tpu_torch.scripts.train_tone_stream',"
        " 'libreasr_tpu_torch.scripts.make_tone_corpus',"
        " 'libreasr_tpu_torch.scripts.evaluate_wer',"
        " 'libreasr_tpu_torch.parallel.mesh', 'libreasr_tpu_torch.parallel.distributed',"
        " 'libreasr_tpu_torch.parallel.pipeline', 'libreasr_tpu_torch.parallel.rows',"
        " 'libreasr_tpu_torch.parallel.collectives',"
        " 'libreasr_tpu_torch.compat.torch_import', 'libreasr_tpu_torch.compat.yttm_import',"
        " 'libreasr_tpu_torch.scripts.import_reference',"
        " 'libreasr_tpu_torch.flops', 'libreasr_tpu_torch.scripts.train_960',"
        " 'libreasr_tpu_torch.scripts.convert',"
        " 'libreasr_tpu_torch.scripts.download_corpora'}"
        " <= set(mods), mods\n"
        "print('OK', len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        libreasr_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ASRBundle.from_bundle(GOLDEN, extract_to=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ASRBundle.from_config(seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ASRBundle.from_config({"quantized_cells": True}, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Learner.from_config(parse_and_apply_config(), seed=0)
    assert libreasr_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_streaming_and_serving_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The streaming engine runs on its bundle's device (a bundle made
    for the card raises without one), and the server loads its bundle on
    the card unless told otherwise."""
    from libreasr_tpu_torch.models.streaming import StreamingEngine
    from libreasr_tpu_torch.serving import server

    bundle = ASRBundle.from_bundle(GOLDEN, extract_to=str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(bundle, n_streams=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.serve(bundle_path=GOLDEN)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main(["--bundle", GOLDEN])


def test_no_module_calls_torch_distributed_at_import():
    """Importing every module of the port (and chip_smoke) starts no
    process group and runs no collective: each is a function call."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import torch.distributed as d\n"
        "def trap(name):\n"
        "    def f(*a, **k):\n"
        "        raise SystemExit(f'torch.distributed.{name} called at import')\n"
        "    return f\n"
        "for name in ('init_process_group', 'new_group', 'all_reduce', 'all_gather',"
        " 'broadcast', 'send', 'recv', 'barrier', 'get_rank', 'get_world_size'):\n"
        "    setattr(d, name, trap(name))\n"
        "import libreasr_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('OK', d.is_initialized())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "OK False"


def test_multi_gpu_and_import_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """initialize() on cuda asks for NCCL and raises without it (never
    gloo, never the CPU); the import script and the training CLI's
    multi-process start default to cuda; a mesh engine of cuda devices
    never builds on the CPU."""
    from libreasr_tpu_torch import train
    from libreasr_tpu_torch.models.streaming import StreamingEngine
    from libreasr_tpu_torch.parallel import distributed as dist
    from libreasr_tpu_torch.parallel.mesh import make_mesh
    from libreasr_tpu_torch.scripts import import_reference

    store = f"file://{tmp_path / 'store'}"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        dist.initialize(store, 1, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        import_reference.main(["--archive", str(tmp_path / "none.tar.gz")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--dist-coordinator", store, "--dist-procs", "1"])
    bundle = ASRBundle.from_bundle(GOLDEN, extract_to=str(tmp_path), device="cpu")
    mesh = make_mesh(data=2, devices=["cuda:0", "cuda:0"])
    with pytest.raises((RuntimeError, AssertionError)):
        StreamingEngine(bundle, n_streams=2, mesh=mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        dist.initialize(store, 1, 0)
    assert not torch.distributed.is_initialized()


def test_wrapper_has_no_fallback_off_the_cpu():
    x = torch.empty((2, 3, 16), device="meta")
    h = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        klstm.lstm_seq(x, torch.empty((4, 16), device="meta"), h, h)
    rq = torch.empty((4, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        klstm.lstm_seq_int8(x, rq, torch.empty((1, 16), device="meta"), h, h)
    enc, pred = torch.empty((2, 5, 8), device="meta"), torch.empty((2, 4, 8), device="meta")
    w, b = torch.empty((8, 6), device="meta"), torch.empty((6,), device="meta")
    lab = torch.empty((2, 3), dtype=torch.int32, device="meta")
    g = torch.empty((2, 5, 4), device="meta")
    for fn, args in ((kjoint.joint_lp_fwd, ()), (kjoint.joint_lp_dx, (g, g[..., :3], g)),
                     (kjoint.joint_lp_dw, (g, g[..., :3], g))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(enc, pred, w, b, lab, *args)


def test_library_name_hashes_headers(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = build.library_path("k")
    (csrc / "common.cuh").write_text("// header\n")
    with_header = build.library_path("k")
    (csrc / "common.cuh").write_text("// header, edited\n")
    assert len({before, with_header, build.library_path("k")}) == 3


def test_native_sources_stand_alone():
    """The port's C++ and CUDA sources include only system headers and
    each other: the BPE trainer is the port's own copy, not the JAX
    package's native library."""
    csrc = os.path.join(PKG, "csrc")
    names = sorted(os.listdir(csrc))
    assert "bpe_train.cpp" in names
    for name in names:
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', src, re.M):
            assert inc in names, (name, inc)
        assert "libreasr_tpu/" not in src.replace("libreasr_tpu_torch/", ""), name


def test_host_library_name_hashes_source(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "h.cpp").write_text("// host\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = build.host_library_path("h")
    assert build.host_library_path("h") == before
    (csrc / "h.cpp").write_text("// host, edited\n")
    edited = build.host_library_path("h")
    assert edited != before
    # a library that another compiler built is not current: the name
    # covers the compiler's path and the version and target it reports
    names = [edited]
    for where, version in (("a", "12.2.0"), ("a", "13.3.0"), ("b", "13.3.0")):
        cxx = tmp_path / where / "g++"
        cxx.parent.mkdir(exist_ok=True)
        cxx.write_text(f"#!/bin/sh\necho {version}\necho x86_64-linux-gnu\n")
        cxx.chmod(0o755)
        build.compiler_identity.cache_clear()
        monkeypatch.setattr(build, "HOST_CXX", str(cxx))
        names.append(build.host_library_path("h"))
        assert build.host_library_path("h") == names[-1]
    build.compiler_identity.cache_clear()
    assert len(set(names)) == 4


@pytest.mark.parametrize("name", ["lstm_seq", "lstm_seq_int8", "joint_lp",
                                  "lstm_train"])
def test_failed_build_raises(name, monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no such architecture' >&2\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no such architecture"):
        build.build([name])
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,h", [(10, 20, 96), (3, 5, 100), (16, 30, 1024)])
def test_kernel_matches_twin_on_cuda(n, t, h):
    """Tolerance as in chip_smoke.py: summation order, and the bf16
    rounding flips of h that it can cause (max 4e-3, mean 2e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(n + t + h)
    wx = torch.tensor(rng.standard_normal((n, t, 4 * h)), dtype=torch.float32).cuda()
    r = torch.tensor(rng.standard_normal((h, 4 * h)) / np.sqrt(h),
                     dtype=torch.float32).cuda()
    h0 = torch.tensor(rng.standard_normal((n, h)) * 0.5, dtype=torch.float32).cuda()
    c0 = torch.tensor(rng.standard_normal((n, h)) * 0.5, dtype=torch.float32).cuda()
    for stream_c, name in ((False, "lstm_seq"), (True, "lstm_seq_cseq")):
        before = klstm.LAUNCHES[name]
        got = klstm.lstm_seq(wx, r, h0, c0, stream_c=stream_c)
        want = klstm.lstm_seq_reference(wx, r, h0, c0, stream_c)
        torch.cuda.synchronize()
        assert klstm.LAUNCHES[name] == before + 1  # one cooperative launch
        for a, b in zip(got, want):
            if a is None:
                assert b is None
                continue
            d = (a - b).abs()
            assert float(d.max()) <= 4e-3 and float(d.mean()) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,h,slices", [(8, 37, 96, 1), (300, 20, 1024, 1),
                                          (600, 6, 1024, 2)],
                         ids=["golden", "n300", "sliced"])
def test_seq_kernel_matches_twin_and_reruns_on_cuda(n, t, h, slices):
    """Kernels A and B (one persistent cooperative launch per batch slice)
    against their twin, tolerance as in chip_smoke.py (KERNEL_TOL: the
    summation order and the bf16 flips of h it can cause, max 4e-3, mean
    2e-4), and a rerun on the same inputs gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(n + t + h)

    def rnd(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32).cuda()

    wx, r = rnd(n, t, 4 * h), rnd(h, 4 * h, scale=h ** -0.5)
    h0, c0 = rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
    for stream_c, name in ((False, "lstm_seq"), (True, "lstm_seq_cseq")):
        before = klstm.LAUNCHES[name]
        got = klstm.lstm_seq(wx, r, h0, c0, stream_c=stream_c)
        assert klstm.LAUNCHES[name] == before + slices
        again = klstm.lstm_seq(wx, r, h0, c0, stream_c=stream_c)
        want = klstm.lstm_seq_reference(wx, r, h0, c0, stream_c)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, again):
            if a is None:
                assert b is None and c is None
                continue
            assert torch.equal(a, c)
            d = (a - b).abs()
            assert float(d.max()) <= 4e-3 and float(d.mean()) <= 2e-4

@pytest.mark.cuda
@pytest.mark.parametrize("n,t,h", [(10, 20, 96), (3, 5, 98), (16, 30, 1024),
                                   (300, 7, 1024), (600, 3, 1024), (4, 6, 4096)])
def test_int8_kernel_matches_twin_on_cuda(n, t, h):
    """Bit for bit: both compute the pre-activation v alike from the same
    h (IEEE quotient for the scale, round half to even, exact int32 sums,
    no FMA contraction in the epilogue), and on the card the twin's
    sigmoid and tanh meet the kernel's expf/tanhf (chip_smoke.py reads
    0.0 at every case; INT8_TOL, 4e-3, bounds what a flip would move).
    One cooperative launch per batch slice (N 600: two), R's slice read
    from L2 at H 4096, and a rerun gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from libreasr_tpu_torch.ops.kernels import build
    from libreasr_tpu_torch.ops.quant import quantize

    rng = np.random.default_rng(n + t + h)
    wx = torch.tensor(rng.standard_normal((n, t, 4 * h)), dtype=torch.float32).cuda()
    r = quantize(torch.tensor(rng.standard_normal((h, 4 * h)) / np.sqrt(h),
                              dtype=torch.float32).cuda())
    h0 = torch.tensor(rng.standard_normal((n, h)) * 0.5, dtype=torch.float32).cuda()
    c0 = torch.tensor(rng.standard_normal((n, h)) * 0.5, dtype=torch.float32).cuda()
    packed = klstm.pack_k4(r.q)
    slices = klstm.batch_slices(n, klstm.fwd_plan, h, build.sm_count(0), 1)
    before = klstm.LAUNCHES["lstm_seq_int8"]
    got = klstm.lstm_seq_int8(wx, r.q, r.scale, h0, c0, rq_packed=packed)
    assert klstm.LAUNCHES["lstm_seq_int8"] == before + len(slices)
    again = klstm.lstm_seq_int8(wx, r.q, r.scale, h0, c0, rq_packed=packed)
    want = klstm.lstm_seq_int8_reference(wx, r.q, r.scale, h0, c0)
    torch.cuda.synchronize()
    assert len(slices) == (2 if n == 600 else 1)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)
        assert float((a - b).abs().max()) == 0.0
    with pytest.raises(ValueError, match="rq_packed"):
        klstm.lstm_seq_int8(wx, r.q, r.scale, h0, c0)


@pytest.mark.cuda
def test_int8_kernel_quantizes_h_as_the_ieee_quotient_on_cuda():
    """Kernel C forms h / hscale from a reciprocal and one exact
    correction, and takes the IEEE quotient only near a half-integer: on
    2**28 seeded pairs no quantized value differs from clip(rint(IEEE
    quotient)), and no quotient is more than 4 ulps off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    counts = klstm.int8_quotient_check(2**28)
    assert counts["hq_differ"] == 0 and counts["differ_above_4_ulps"] == 0
    assert counts["ieee_fallbacks"] < 2**28 // 1000


def test_training_kernel_path_raises_off_the_cpu():
    """use_pallas_train (the JAX default) in training routes an LSTM layer
    to kernels D and E: off the CPU and off CUDA that raises (no silent
    scan), below the kernel's T it takes the scan cells, and on the CPU it
    runs LSTMTrainCore on the twins."""
    from libreasr_tpu_torch.models.modules import RNNLayer

    layer = RNNLayer(8, 16, torch.Generator().manual_seed(0),
                     use_train_kernel=True).to("meta").train()
    x = torch.empty((2, 16, 8), device="meta")
    with pytest.raises(ValueError, match="lstm_train_fwd: unsupported device"):
        layer(x)
    short = torch.empty((2, 15, 8), device="meta")  # below the kernel's T
    assert layer(short)[0].shape == (2, 15, 16)
    cpu = RNNLayer(8, 16, torch.Generator().manual_seed(0),
                   use_train_kernel=True).train()
    y, _ = cpu(torch.zeros((2, 16, 8)))
    assert y.shape == (2, 16, 16)
    assert type(y.grad_fn).__name__ == "LSTMTrainCoreBackward"


def test_training_encoder_never_runs_the_eval_kernels(monkeypatch):
    """An encoder whose layers take the sequence kernels in eval trains
    through the scan cells: with the kernel wrappers made to raise, a
    training forward still runs, and its gradient reaches every cell
    matrix, bias and learnable h0."""
    from libreasr_tpu_torch.models.modules import Encoder

    def boom(*a, **k):
        raise AssertionError("eval kernel called")

    monkeypatch.setattr(klstm, "lstm_seq", boom)
    monkeypatch.setattr(klstm, "lstm_seq_int8", boom)
    enc = Encoder(12, 16, 10, torch.Generator().manual_seed(0), num_layers=2,
                  use_kernel=True, dropout=0.0)
    x = torch.randn((3, 20, 12), generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([20, 17, 16])
    with pytest.raises(AssertionError, match="eval kernel"):
        enc.eval()(x, lengths=lengths)
    out, _ = enc.train()(x, lengths=lengths)
    out.pow(2).sum().backward()
    for name, p in enc.named_parameters():
        if ".layer" in name:
            assert p.grad is not None and p.grad.abs().max() > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,t,u1,j,v", [(3, 13, 9, 96, 40), (2, 11, 101, 200, 300)])
def test_joint_kernels_match_twins_on_cuda(n, t, u1, j, v, w_dtype):
    """F, G, H against their twins; tolerances as in chip_smoke.py
    (JOINT_LP_TOL, JOINT_GRAD_TOL: summation order and the bf16
    rounding flips it can cause)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(n + t + u1)

    def rnd(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32).cuda()

    enc, pred = rnd(n, t, j, scale=0.5), rnd(n, u1, j, scale=0.5)
    w = rnd(j, v, scale=j ** -0.5).to(getattr(torch, w_dtype))
    b = rnd(v, scale=0.1)
    lab = torch.tensor(rng.integers(0, v, (n, u1 - 1)), dtype=torch.int32).cuda()
    lab[0, 0] = 0
    gb, ge = rnd(n, t, u1, scale=0.1), rnd(n, t, u1 - 1, scale=0.1)
    before = dict(kjoint.LAUNCHES)
    got = [*kjoint.joint_lp_fwd(enc, pred, w, b, lab)]
    got += kjoint.joint_lp_dx(enc, pred, w, b, lab, gb, ge, got[2])
    got += kjoint.joint_lp_dw(enc, pred, w, b, lab, gb, ge, got[2])
    want = [*kjoint.joint_lp_fwd_reference(enc, pred, w, b, lab)]
    want += kjoint.joint_lp_dx_reference(enc, pred, w, b, lab, gb, ge, got[2])
    want += kjoint.joint_lp_dw_reference(enc, pred, w, b, lab, gb, ge, got[2])
    torch.cuda.synchronize()
    assert all(kjoint.LAUNCHES[k] == before[k] + 1 for k in before)
    for i, (a, r) in enumerate(zip(got, want)):
        err = float((a - r).abs().max())
        bound = 2e-3 if i in (0, 1, 2) else 2e-3 * float(r.abs().max())
        assert err <= bound, (i, err)
