"""The port's StreamingEngine under tests/test_soak.py's soak (hundreds
of chunks, slot churn, a silent slot, repeated utterances) on the CPU,
with the golden char bundle: the same invariants as the JAX engine's,
and the same transcript as the JAX engine's on every repetition (the
transcripts are compared exactly)."""

import os

import pytest

from helpers.soak import CHUNK, check_soak, golden_audio, run_soak
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.data.audio import read_wav
from libreasr_tpu_torch.models.streaming import StreamingEngine

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


@pytest.fixture(scope="module")
def audio():
    pcm, sr = read_wav(os.path.join(FIXTURES, "s-002.wav"))  # hello world
    assert sr == 16000
    return golden_audio(pcm[0])


def test_engine_soak_matches_jax(audio, tmp_path):
    from libreasr_tpu.api import ASRBundle as JaxBundle
    from libreasr_tpu.models.streaming import StreamingEngine as JaxEngine

    model = os.path.join(FIXTURES, "model.tar.gz")
    bundle = ASRBundle.from_bundle(model, extract_to=str(tmp_path / "port"),
                                   device="cpu")
    eng = StreamingEngine(bundle, n_streams=4)
    got = run_soak(eng, audio)
    jeng = JaxEngine(JaxBundle.from_bundle(model, extract_to=str(tmp_path / "jax")),
                     n_streams=4)
    want = run_soak(jeng, audio)
    assert got["transcripts"] == want["transcripts"]
    assert got["chunks"] == want["chunks"] == 8 * (2 * (len(audio) // CHUNK) + 5)
    assert eng.emitted[got["silence"]] == jeng.emitted[want["silence"]]
    check_soak(eng, got)
    check_soak(jeng, want)
    assert eng.steps > 0 and eng.replays == 0  # eager on the CPU
