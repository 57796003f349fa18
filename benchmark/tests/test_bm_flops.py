"""The benchmark's frozen FLOP counts equal hand counts at small shapes,
and the program's own counts at the configured ones."""

import pytest

from benchmark import core
from benchmark import flops as FL


def _m():
    return {"feature_sz": 8, "embed_sz": 3, "hidden_sz": 4, "out_sz": 4,
            "joint_sz": 5, "vocab_sz": 6, "encoder": {"num_layers": 2},
            "predictor": {"num_layers": 2}}


def test_hand_counts():
    m = _m()
    # LSTM: 4 gates of [in + h] x h, 2 flops a multiply-add
    assert FL.encoder_frame(m) == 2 * 4 * 4 * (8 + 4) + 2 * 4 * 4 * (4 + 4)
    # ffn 3 -> 4, then two GRU layers of 3 gates
    assert FL.predictor_token(m) == 2 * 3 * 4 + 2 * (2 * 3 * 4 * (4 + 4))
    assert FL.joint_single(m) == 2 * (2 * 4 * 5) + 2 * 5 * 6
    lm = {"embed_sz": 3, "hidden_sz": 3, "num_layers": 2, "vocab_sz": 6}
    assert FL.lm_token(lm) == 2 * (2 * 4 * 3 * 6) + 2 * 3 * 6
    conf = {"sr": 16000, "hop_length": 0.01,
            "melkwargs": {"n_fft": 8, "n_mels": 2}}
    assert FL.frontend_chunk(conf, 320) == 2 * 2 * 8 * 5 * 2 + 2 * 2 * 5 * 2


def test_roofline_names_its_bound():
    t, bound = FL.roofline_s(3.35e12, 1.0, "NVIDIA H100 80GB HBM3")
    assert bound == "bytes" and t == pytest.approx(1.0)
    t, bound = FL.roofline_s(1.0, 989e12, "NVIDIA H100 80GB HBM3")
    assert bound == "operations" and t == pytest.approx(1.0)
    with pytest.raises(ValueError):
        FL.peaks("NVIDIA H100 PCIe")


def test_equal_to_the_programs_counts_at_the_configured_shapes():
    from libreasr_tpu_torch import flops as P
    from libreasr_tpu_torch.models.transducer import TransducerConfig
    from libreasr_tpu_torch.ops.frontend import FrontendConfig

    conf = core.load_json("configs", "rnnt-base-bf16")["conf"]
    cfg = TransducerConfig.from_config(conf)
    m = conf["model"]
    assert FL.encoder_frame(m) == P.encoder_step_flops(cfg)
    assert FL.predictor_token(m) == P.predictor_step_flops(cfg)
    assert FL.joint_single(m) == P.joint_single_flops(cfg)
    assert FL.frontend_chunk(conf, 1280) == P.frontend_chunk_flops(
        FrontendConfig.from_config(conf), 1280)
