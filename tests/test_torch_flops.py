"""The port's FLOP accounting (libreasr_tpu_torch/flops.py) against the
JAX package's libreasr_tpu/flops.py, and against torch's own count.

Every counting function must equal JAX's exactly, as floats, on four
configs built from the same values on both sides: base.yaml's,
tests/test_flops.py's, a GRU (NBRC) encoder, and one with out_sz !=
hidden_sz. train_step_ceiling leaves out the JAX package's row cap of
the TPU's systolic array, so each compute component is JAX's times that
cap. The analytic forward count is held against
torch.utils.flop_counter.FlopCounterMode on the port's Transducer (the
analogue of JAX's check against XLA's cost analysis; FlopCounterMode
counts every step of a loop, which XLA's count of a scan body does not),
and the peaks: H100 SXM by its card name, a nominal CPU, and an error for
a card the table does not know."""

import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from libreasr_tpu import flops as JF
from libreasr_tpu.models.transducer import TransducerConfig as JaxCfg
from libreasr_tpu.ops.frontend import FrontendConfig as JaxFe
from libreasr_tpu_torch import flops as F
from libreasr_tpu_torch.config import parse_and_apply_config
from libreasr_tpu_torch.models.transducer import Transducer
from libreasr_tpu_torch.models.transducer import TransducerConfig as PortCfg
from libreasr_tpu_torch.ops.frontend import FrontendConfig as PortFe

SMALL = dict(feature_sz=96, embed_sz=64, vocab_sz=128, hidden_sz=128,
             out_sz=128, joint_sz=128, enc_num_layers=2, pred_num_layers=1,
             use_tmp_state_pcent=0.0)  # tests/test_flops.py's config


def _base_kw():
    m = parse_and_apply_config()["model"]
    return dict(feature_sz=m["feature_sz"], embed_sz=m["embed_sz"],
                vocab_sz=m["vocab_sz"], hidden_sz=m["hidden_sz"],
                out_sz=m["out_sz"], joint_sz=m["joint_sz"],
                enc_num_layers=m["encoder"]["num_layers"],
                enc_rnn_type=m["encoder"]["rnn_type"],
                pred_num_layers=m["predictor"]["num_layers"],
                pred_rnn_type=m["predictor"]["rnn_type"])


CONFIGS = {
    "base": (_base_kw, True),
    "test_flops": (lambda: SMALL, False),
    "gru_encoder": (lambda: {**SMALL, "enc_rnn_type": "NBRC", "enc_num_layers": 3}, False),
    "out_ne_hidden": (lambda: {**SMALL, "out_sz": 96, "embed_sz": 128,
                               "joint_sz": 80}, True),
}


@pytest.fixture(params=sorted(CONFIGS))
def cfgs(request):
    kw_fn, bf16 = CONFIGS[request.param]
    kw = kw_fn()
    return (JaxCfg(**kw, compute_dtype=jnp.bfloat16 if bf16 else None),
            PortCfg(**kw, compute_dtype=torch.bfloat16 if bf16 else None))


SHAPES = [(16, 49, 40), (4, 16, 8), (1, 1, 0), (64, 75, 60)]


def test_counts_equal_jax(cfgs):
    jc, pc = cfgs
    for name in ("encoder_step_flops", "predictor_step_flops", "joint_proj_flops",
                 "joint_out_flops", "joint_single_flops", "_transducer_params"):
        assert getattr(F, name)(pc) == getattr(JF, name)(jc), name
    assert F.compute_itemsize(pc) == JF.jnp_itemsize(jc)
    for n, t, u in SHAPES:
        assert F.train_step_flops(pc, n, t, u) == JF.train_step_flops(jc, n, t, u)
        assert F.loss_dp_flops(t, u + 1) == JF.loss_dp_flops(t, u + 1)
    for in_sz, h in ((1280, 1024), (96, 128), (7, 13)):
        assert F.lstm_layer_flops(in_sz, h) == JF.lstm_layer_flops(in_sz, h)
        assert F.gru_layer_flops(in_sz, h) == JF.gru_layer_flops(in_sz, h)
    for chunk, kw in ((1280, {}), (2560, {"n_fft": 512, "n_mels": 80})):
        pf, jf = PortFe(**kw), JaxFe(**kw)
        assert F.frontend_chunk_flops(pf, chunk) == JF.frontend_chunk_flops(jf, chunk)
        for n, nb, it in ((64, 1, 1.0), (512, 2, 1.37), (1, 1, 2.0)):
            assert (F.decode_step_flops(pc, pf, n, nb, chunk, iters_per_frame=it)
                    == JF.decode_step_flops(jc, jf, n, nb, chunk, iters_per_frame=it))


def test_ceiling_is_jax_without_the_systolic_cap(cfgs):
    """Traffic as JAX's; each compute component JAX's times the share
    JAX's _cap gave it (the cap divides the peak there), to float
    rounding (rel 1e-12: a/(p*c)*c against a/p); sol_s the max."""
    jc, pc = cfgs
    peak, bw = 989e12, 3.35e12
    for n, t, u in SHAPES:
        got = F.train_step_ceiling(pc, n, t, u, peak=peak, bw=bw)
        ref = JF.train_step_ceiling(jc, n, t, u, peak=peak, bw=bw)
        assert got["traffic_bytes"] == ref["traffic_bytes"]
        assert got["bandwidth_sol_s"] == ref["bandwidth_sol_s"]
        caps = {"enc_recurrent": JF._cap(n), "pred_recurrent": JF._cap(n),
                "joint_proj": JF._cap(n * min(t, u + 1)), "joint_head": 1.0}
        assert set(got["compute_breakdown_s"]) == set(caps)
        for k, cap in caps.items():
            assert got["compute_breakdown_s"][k] == pytest.approx(
                ref["compute_breakdown_s"][k] * cap, rel=1e-12), k
        assert got["compute_sol_s"] <= ref["compute_sol_s"] * (1 + 1e-12)
        assert got["sol_s"] == max(got["compute_sol_s"], got["bandwidth_sol_s"])
        assert (got["peak_flops"], got["hbm_bw"]) == (peak, bw)


def test_decode_step_linear_in_streams_and_grows_with_iters():
    cfg, fe = PortCfg(**SMALL), PortFe()
    lo = F.decode_step_flops(cfg, fe, 64, 1, 1280, iters_per_frame=1.0)
    hi = F.decode_step_flops(cfg, fe, 64, 1, 1280, iters_per_frame=3.0)
    assert hi > lo
    assert F.decode_step_flops(cfg, fe, 128, 1, 1280) == pytest.approx(
        2 * F.decode_step_flops(cfg, fe, 64, 1, 1280))
    assert F.train_step_flops(cfg, 8, 16, 8) == pytest.approx(
        2 * F.train_step_flops(cfg, 4, 16, 8))


def _counted(model, n, t, u, train: bool) -> float:
    g = torch.Generator().manual_seed(n * 100 + t)
    x = torch.randn(n, t, model.cfg.feature_sz, generator=g)
    y = torch.randint(1, model.cfg.vocab_sz, (n, u), generator=g)
    xl, yl = torch.full((n,), t), torch.full((n,), u)
    model.train(train)
    with FlopCounterMode(display=False) as fc:
        if train:
            logits, _ = model(x, y, xl, yl, generator=torch.Generator().manual_seed(1))
            logits.sum().backward()
        else:
            with torch.no_grad():
                model(x, y, xl, yl)
    return float(fc.get_total_flops())


@pytest.mark.parametrize("n,t,u", [(8, 1, 0), (8, 20, 5)])
def test_forward_count_against_flop_counter(n, t, u):
    """The analytic forward within [0.85, 1.0] of FlopCounterMode's count
    on the port's model (scan cells) at T 1, U 0 (JAX's band against XLA)
    and at T 20, U 5. Forward plus backward: train_step_flops counts the
    backward as twice the forward and adds the loss DP (6 flops a lattice
    cell, three times), which is no matmul and which FlopCounterMode does
    not see; this model's backward is exactly twice its forward in matmul
    FLOPs (the scan cell's product takes [x, h] together, so the first
    layer's input gradient is computed too), so the count less that DP
    term equals FlopCounterMode's exactly, and the ratio lies in
    [1, 1.001]."""
    cfg = PortCfg(**SMALL, enc_use_kernel=False, enc_use_train_kernel=False)
    model = Transducer(cfg, seed=0, device="cpu")
    want = n * (t * F.encoder_step_flops(cfg)
                + (u + 1) * F.predictor_step_flops(cfg)
                + (t + u + 1) * F.joint_proj_flops(cfg)
                + t * (u + 1) * F.joint_out_flops(cfg))
    got = _counted(model, n, t, u, train=False)
    assert 0.85 * got <= want <= got * 1.001, (want, got)
    step = F.train_step_flops(cfg, n, t, u)
    got_train = _counted(model, n, t, u, train=True)
    assert step - 3.0 * n * F.loss_dp_flops(t, u + 1) == got_train
    assert 1.0 <= step / got_train <= 1.001


def test_peaks_by_card_name(monkeypatch):
    assert F.device_peak_flops(torch.device("cpu")) == 1e12
    assert F.device_hbm_bw("cpu") == 100e9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert F.device_peak_flops() == 989e12
    assert F.device_peak_flops("cuda", "int8") == 1979e12
    assert F.device_peak_flops("cuda:0", "float32") == 67e12
    assert F.device_hbm_bw() == 3.35e12
    assert F.mfu(98.9e12, 1.0).mfu == pytest.approx(0.1)
    r = F.train_step_ceiling(PortCfg(**SMALL), 16, 49, 40)
    assert (r["peak_flops"], r["hbm_bw"]) == (989e12, 3.35e12)
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "Tesla T4"):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, s=name: s)
        with pytest.raises(ValueError, match=name):
            F.device_peak_flops()


def test_peaks_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        F.device_peak_flops()


def test_mfu_helper():
    m = F.MFU(flops=39.4e12, seconds=1.0, peak=394e12)
    assert m.mfu == pytest.approx(0.1)
    assert m.achieved == 39.4e12
    assert str(m) == str(JF.MFU(flops=39.4e12, seconds=1.0, peak=394e12))
    assert "MFU" in str(m)
