"""The port does all that the JAX package does: every public function and
class (top-level, not starting with "_") of every module of
libreasr_tpu/, and of every root script that imports the package, has a
counterpart of the same name in the same place under libreasr_tpu_torch/
(a root script's in the package: train.py -> libreasr_tpu_torch/train.py,
scripts/x.py -> libreasr_tpu_torch/scripts/x.py). RENAMED lists the
counterparts that live under another name or module, LEFT_OUT the names
the port leaves out, each with its reason. Both lists are checked too:
every entry names a name the JAX package has, and every renamed
counterpart exists, so neither can go stale. Read by parsing the sources
(ast): nothing is imported."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "libreasr_tpu")
PORT_PKG = os.path.join(ROOT, "libreasr_tpu_torch")

# "jax module:name" -> "port module:name", paths relative to each package
# (root scripts by their repo path)
RENAMED = {
    "flops.py:jnp_itemsize": "flops.py:compute_itemsize",
    "data/audio.py:edit_distance": "training/metrics.py:edit_distance",
    # the JAX package's stdlib fallback beside its native reader; the
    # port's WAV reader is that pure-Python one
    "data/audio.py:read_wav_py": "data/audio.py:read_wav",
    # the port keeps the bundle format beside its other top-level modules
    "training/checkpoint.py:load_bundle": "checkpoint.py:load_bundle",
    "training/checkpoint.py:read_bundle_conf": "checkpoint.py:read_bundle_conf",
    "training/checkpoint.py:save_bundle": "checkpoint.py:save_bundle",
    # the host libraries (audio codecs, BPE) are built from csrc/ by g++
    # at first use, through one loader
    "native/__init__.py:audio_lib": "ops/kernels/build.py:load_host",
    "native/__init__.py:bpe_lib": "ops/kernels/build.py:load_host",
    # the Pallas entry points: kernels A-H of PERF.md, each hand-written
    # for Hopper in csrc/ and called through these wrappers
    "ops/pallas/lstm.py:lstm_seq_pallas": "ops/kernels/lstm.py:lstm_seq",          # A
    "ops/pallas/lstm.py:lstm_forward_pallas": "ops/kernels/lstm.py:lstm_seq",      # A
    "ops/pallas/lstm.py:lstm_pack_pallas": "ops/kernels/lstm.py:lstm_pack",        # B, C
    "ops/pallas/lstm.py:lstm_train_core": "ops/kernels/lstm_train.py:LSTMTrainCore",   # D, E
    "ops/pallas/lstm.py:lstm_pack_train_pallas": "ops/kernels/lstm_train.py:lstm_pack_train",
    "ops/pallas/joint_lp.py:joint_lp_fwd_pallas": "ops/kernels/joint_lp.py:joint_lp_fwd",  # F
    "ops/pallas/joint_lp.py:joint_lp_bwd_pallas": "ops/kernels/joint_lp.py:joint_lp_dx",   # G
    "ops/pallas/joint_lp.py:joint_lp_bwd_pallas#dw": "ops/kernels/joint_lp.py:joint_lp_dw",  # H
}

FLAX_INIT = "a flax initializer: a torch module makes its parameters when it is built"
FLAX_STATE = ("a flax/optax state class: the port's Learner and optimizers keep "
              "their state in torch tensors")
JIT_STEP = ("a maker of a jit-compiled step: the port's Learner.step, "
            "CTCLearner.step and evaluate run the step itself")
GSPMD = ("a GSPMD sharding object or placement: the port places each rank's "
         "rows and replicas itself (parallel/mesh.py:shard_batch, "
         "parallel/distributed.py:global_batch, replicate_tree)")
UNCALLED = "a helper of utils.py that no module of the JAX package calls"
BENCH = "the benchmark's harness: it waits for the port's benchmark"
CHIP_CHECK = ("the JAX package's TPU entry points and kernel check: "
              "chip_smoke.py is the port's (it builds and checks kernels A-H "
              "on the card)")

LEFT_OUT = {
    "models/transducer.py:init_transducer": FLAX_INIT,
    "models/ctc.py:init_ctc": FLAX_INIT,
    "models/lm.py:init_lm": FLAX_INIT,
    "ops/rnn.py:init_lstm": FLAX_INIT,
    "ops/rnn.py:init_gru": FLAX_INIT,
    "ops/rnn.py:init_layernorm_lstm": FLAX_INIT,
    "training/ctc_learner.py:CTCTrainState": FLAX_STATE,
    "training/optimizers.py:AdaHessianState": FLAX_STATE,
    "training/optimizers.py:ApolloState": FLAX_STATE,
    "training/optimizers.py:LookaheadState": FLAX_STATE,
    "training/learner.py:create_train_state": FLAX_STATE,
    "training/learner.py:make_train_step": JIT_STEP,
    "training/ctc_learner.py:make_ctc_train_step": JIT_STEP,
    "training/evaluate.py:make_eval_step": JIT_STEP,
    "parallel/mesh.py:batch_sharding": GSPMD,
    "parallel/mesh.py:place_state": GSPMD,
    "parallel/mesh.py:replicated": GSPMD,
    "ops/fused_loss.py:joint_params_from_flax":
        "reads the joint's flax parameter tree: the port's fused loss takes "
        "the Joint module's tensors",
    "ops/quant.py:quantize_tree":
        "quantizes every wide kernel of a pytree; no caller in the JAX "
        "package: bundles carry int8 cells, which the port's "
        "quantize_rnn_cells makes",
    "ops/quant.py:dequantize_tree": "the inverse of quantize_tree, likewise uncalled",
    "models/modules.py:ResidualAdapter": "nothing in the JAX package uses it",
    "utils.py:enable_compilation_cache":
        "XLA's persistent compile cache: the port's kernels are cached in "
        "libreasr_tpu_torch/build/ by the hash of their sources",
    "utils.py:log_softmax": UNCALLED + " (the port calls torch.log_softmax)",
    "utils.py:n_params": UNCALLED,
    "utils.py:check_finite": UNCALLED,
    "utils.py:standardize": UNCALLED + " (models/decode.py keeps its own, as the port's does)",
    "utils.py:make_lengths_mask": UNCALLED,
    # root scripts, whole
    "bench.py": BENCH,
    "scripts/bench_loss_parts.py": BENCH,
    "scripts/bench_pallas.py": BENCH,
    "scripts/bench_serving.py": BENCH,
    "scripts/bench_step_parts.py": BENCH,
    "scripts/bench_train_step.py": BENCH,
    "__graft_entry__.py": CHIP_CHECK,
    "scripts/check_kernels.py": CHIP_CHECK,
}
# not a public name, and not ported: the v5e peak tables and the MXU row
# cap of libreasr_tpu/flops.py (PEAK_BF16, HBM_BW, MXU_ROWS, _cap) are
# properties of the TPU; libreasr_tpu_torch/flops.py has the H100's
# (PEAKS) and no row cap (train_step_ceiling's docstring says why)


def _public(path: str) -> set:
    tree = ast.parse(open(path).read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _imports_jax_package(path: str) -> bool:
    for n in ast.walk(ast.parse(open(path).read())):
        mods = ([a.name for a in n.names] if isinstance(n, ast.Import)
                else [n.module or ""] if isinstance(n, ast.ImportFrom) else [])
        if any(m == "libreasr_tpu" or m.startswith("libreasr_tpu.") for m in mods):
            return True
    return False


def _jax_modules() -> dict:
    """{key: (jax path, port path)}: the package's modules by their path in
    it, root scripts by their path in the repo."""
    out = {}
    for d, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), JAX_PKG)
                out[rel] = (os.path.join(JAX_PKG, rel), os.path.join(PORT_PKG, rel))
    for sub in ("", "scripts"):
        for f in sorted(os.listdir(os.path.join(ROOT, sub))):
            rel = os.path.join(sub, f)
            path = os.path.join(ROOT, rel)
            if f.endswith(".py") and _imports_jax_package(path):
                out[rel] = (path, os.path.join(PORT_PKG, rel))
    return out


MODULES = _jax_modules()


def test_the_walk_finds_the_package_and_its_scripts():
    assert len(MODULES) > 60
    for key in ("flops.py", "config.py", "data/builder.py", "ops/pallas/lstm.py",
                "train.py", "train_lm.py", "scripts/train_960.py",
                "scripts/convert.py", "scripts/evaluate_wer.py", "bench.py"):
        assert key in MODULES, key
    # these root scripts import no part of the JAX package
    for key in ("chip_smoke.py", "scripts/download_corpora.py",
                "scripts/multi_gpu_check.py"):
        assert key not in MODULES, key


@pytest.mark.parametrize("key", sorted(MODULES))
def test_every_public_name_has_a_counterpart(key):
    if key in LEFT_OUT:
        return
    jax_path, port_path = MODULES[key]
    names = _public(jax_path)
    port = _public(port_path) if os.path.exists(port_path) else set()
    missing = []
    for name in sorted(names):
        ref = f"{key}:{name}"
        if ref in LEFT_OUT:
            continue
        if ref in RENAMED:
            mod, new = RENAMED[ref].split(":")
            if new not in _public(os.path.join(PORT_PKG, mod)):
                missing.append(f"{name} (as {RENAMED[ref]})")
        elif name not in port:
            missing.append(name)
    if not os.path.exists(port_path) and any(
            f"{key}:{n}" not in RENAMED and f"{key}:{n}" not in LEFT_OUT
            for n in names):
        missing.insert(0, f"no module {os.path.relpath(port_path, ROOT)}")
    assert not missing, f"{key}: {missing}"


def test_the_lists_name_what_the_jax_package_has():
    for ref in list(RENAMED) + list(LEFT_OUT):
        key, _, name = ref.partition(":")
        assert key in MODULES, ref
        if name:
            assert name.split("#")[0] in _public(MODULES[key][0]), ref
    for ref in RENAMED.values():
        mod, name = ref.split(":")
        assert name in _public(os.path.join(PORT_PKG, mod)), ref
    assert all(LEFT_OUT.values())
