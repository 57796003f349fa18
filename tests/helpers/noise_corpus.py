"""A corpus of seeded noise WAVs in LibriSpeech layout, with the JAX
package's dataset CSVs (create_dataset, then a train/valid split), as
tests/test_train_cli.py builds one."""

import wave

import numpy as np

TEXTS = ["yes", "no", "stop", "go", "up", "down", "left", "right"] * 2


def make_noise_corpus(root, samples: int = 24000, seed: int = 1) -> str:
    from libreasr_tpu.data.create_dataset import create_dataset
    from libreasr_tpu.data.split import split_dataset

    spk = root / "s"
    spk.mkdir()
    rng = np.random.default_rng(seed)
    with open(spk / "s.trans.txt", "w") as tf:
        for i, t in enumerate(TEXTS):
            utt = f"s-{i:03d}"
            pcm = (rng.standard_normal(samples) * 0.1).clip(-1, 1)
            with wave.open(str(spk / f"{utt}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((pcm * 32767).astype(np.int16).tobytes())
            tf.write(f"{utt} {t.upper()}\n")
    create_dataset(str(root), "librispeech", workers=1, pool="thread")
    split_dataset(str(root), valid=0.25, test=0.0)
    return str(root)


def tiny_conf(corpus: str, tok_file: str) -> dict:
    """A tiny float32 transducer over the corpus: 1.5 s clips in one
    2 s bucket (25 encoder frames, so the encoder trains on kernels D
    and E), the non-augmenting host stages, char labels."""
    return {
        "datasets": ["mini"],
        "dataset_paths": {"mini": corpus},
        "apply_limits": True, "almins": 0.5, "almaxs": 6.0,
        "y_min": 1, "y_max": 60, "y_max_words": 100,
        "pcent": {"train": 1.0, "valid": 1.0},
        "shuffle_builder": {"train": True, "valid": False},
        "sr": 16000,
        "melkwargs": {"n_fft": 1024, "n_mels": 128},
        "win_length": 0.025, "hop_length": 0.01, "deltas": 0,
        "transforms": {
            "x": [{"name": "OpenAudio"}, {"name": "ChannelCut"},
                  {"name": "Resample"}, {"name": "PadderCutter"}],
            "features": [{"name": "LogMelSpectrogram"},
                         {"name": "StackDownsample",
                          "args": {"downsample": 8, "n_stack": 10}}],
            "y": [{"name": "OpenLabel"}, {"name": "PadCutLabel"},
                  {"name": "Numericalize"}, {"name": "AddLen"}],
        },
        "buckets": [{"max_samples": 32000, "y_max": 12, "bs": 4}],
        "dtypes": {"param": "float32", "compute": "float32"},
        "model": {
            "name": "Transducer",
            "feature_sz": 1280, "embed_sz": 8, "hidden_sz": 12,
            "out_sz": 12, "joint_sz": 12, "vocab_sz": 40,
            "encoder": {"rnn_type": "LSTM", "num_layers": 1, "dropout": 0.0,
                        "reduction_factor": 1, "use_tmp_state_pcent": 0.5},
            "predictor": {"rnn_type": "NBRC", "num_layers": 1, "dropout": 0.0,
                          "use_tmp_state_pcent": 0.5},
            "joint": {"method": "concat", "dropout": 0.0},
            "use_tmp_bos": False, "use_tmp_bos_pcent": 0.2,
        },
        "training": {"optimizer": "adam", "lr": 1e-3, "wd": 0.0,
                     "epochs": 1, "warmup_pct": 0.1, "grad_clip": 10.0},
        "bs": 4, "accumulate_n_batches": 1, "seed": 3, "num_workers": 0,
        "tests_per_epoch": 1,
        "tokenizer": {"model_file": tok_file},
        "loss": {"type": "rnnt", "fused": True},
    }
