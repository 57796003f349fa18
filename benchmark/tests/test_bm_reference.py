"""The plain reference against the program at a tiny size on the CPU,
driven by the same seeded inputs: in float32 the program's every
greedy decision is the reference's best, and every beam commit is the
reference beam's own."""

import numpy as np
import torch

from benchmark import core
from benchmark.reference.check import segments
from benchmark.reference.model import Frontend
from benchmark.tests.tiny import tiny_bench


def _run(bench, seconds=2.0):
    drv = bench.generator()
    drv.setup()
    drv.window(seconds)
    drv.release()
    return drv


def test_greedy_float32_program_matches_reference():
    drv = _run(tiny_bench("stream-greedy-backlog", 32, compute="float32",
                          bias=17.0, gain=16.0))
    nums, faults = drv.judge_numbers()
    assert not faults
    assert nums["tokens"] > 20
    assert nums["gap"] < 1e-4


def test_beam_float32_program_matches_reference():
    drv = _run(tiny_bench("stream-beam4lm-backlog", 43, compute="float32",
                          bias=14.0, gain=16.0))
    nums, faults = drv.judge_numbers()
    assert not faults
    assert nums["tokens"] > 20
    assert nums["mismatch"] == 0
    assert nums["gap"] == 0.0


def test_frontend_matches_the_programs_batch_features():
    from libreasr_tpu_torch.ops.frontend import log_mel_spectrogram, stack_downsample

    fe = dict(sr=16000, n_fft=1024, n_mels=128, win_length=0.025,
              hop_length=0.01, n_stack=10, downsample=8)
    pcm = torch.from_numpy(np.random.default_rng(0).standard_normal(16000)
                           .astype(np.float32) * 0.1)
    ours = Frontend(fe, "cpu")(pcm)
    mel = log_mel_spectrogram(pcm[None])
    theirs = stack_downsample(mel)[0]
    assert ours.shape == theirs.shape
    assert torch.allclose(ours, theirs, atol=2e-3, rtol=1e-4)


def test_segments_follow_the_silence_reset_and_the_eos_latch():
    empty = np.zeros(0, np.int64)
    steps = [empty, np.array([5]), empty, empty, np.array([7, 2, 9]), empty,
             np.array([4])] + [empty] * 50 + [np.array([6])]
    segs = segments(steps, eos=2, step_ms=80, thresh_ms=4000)
    assert [(s.s0, s.s1) for s in segs] == [(0, 53), (53, 58)]
    assert segs[0].delivered == [5, 7] and segs[0].latched
    assert segs[1].delivered == [6] and segs[1].closed


def test_manifest_loads():
    assert core.manifest()["paths"] == ["benchmark"]
