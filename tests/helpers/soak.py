"""The engine soak of tests/test_soak.py as a function, for any engine
with the StreamingEngine interface (open_slot, feed, close_slot,
transcript, emitted, outbox, sample_buf): the JAX package's, the port's
on the CPU (tests/test_torch_soak.py) and the port's on the card
(chip_smoke.py's soak phase).

Slot roles: one decodes the utterance over and over (closed and
reopened between repetitions), one hears silence for the whole soak,
and one churns: fed every third chunk and abandoned mid-utterance."""

import time

import numpy as np

CHUNK = 1280


def golden_audio(pcm: np.ndarray) -> np.ndarray:
    """The clip zero-padded to 1 s plus one chunk, as the soak feeds it."""
    audio = np.zeros(16000 + CHUNK, np.float32)
    audio[: pcm.shape[-1]] = pcm.reshape(-1)[: len(audio)]
    return audio


def run_soak(eng, audio: np.ndarray, reps: int = 8) -> dict:
    """-> {"transcripts", "silence" (the silent slot), "churn_cycles",
    "chunks" (fed, all slots), "seconds"}."""
    n_chunks = len(audio) // CHUNK
    silence = eng.open_slot()
    transcripts, churn_cycles, fed = [], 0, 0
    t0 = time.perf_counter()
    for _ in range(reps):
        s = eng.open_slot()
        churn = eng.open_slot()
        for c in range(n_chunks):
            eng.feed(s, audio[c * CHUNK: (c + 1) * CHUNK])
            eng.feed(silence, np.zeros(CHUNK, np.float32))
            fed += 2
            if c % 3 == 0:
                eng.feed(churn, audio[c * CHUNK: (c + 1) * CHUNK])
                fed += 1
            if c == n_chunks // 2:
                eng.close_slot(churn)  # abandoned mid-utterance
                churn = eng.open_slot()
                churn_cycles += 1
        transcripts.append(eng.transcript(s))
        eng.close_slot(s)
        eng.close_slot(churn)
    return {"transcripts": transcripts, "silence": silence,
            "churn_cycles": churn_cycles, "chunks": fed,
            "seconds": time.perf_counter() - t0}


def check_soak(eng, result: dict, reps: int = 8, n_slots: int = 4) -> None:
    """tests/test_soak.py's invariants: every repetition decodes "hello
    world", the silent slot emits at most 12 tokens, every slot's sample
    remainder stays under one chunk, and every slot is recyclable."""
    assert result["transcripts"] == ["hello world"] * reps, result["transcripts"]
    assert len(eng.emitted[result["silence"]]) <= 12
    for buf in eng.sample_buf:
        assert len(buf) < CHUNK
    assert result["churn_cycles"] == reps
    eng.close_slot(result["silence"])
    opened = [eng.open_slot() for _ in range(n_slots)]
    assert sorted(opened) == list(range(n_slots))
    for s in opened:
        assert eng.emitted[s] == [] and eng.outbox[s] == []
