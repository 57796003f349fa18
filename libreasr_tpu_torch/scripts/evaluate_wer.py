"""WER/CER of a bundle on a dataset: decode it, greedy or with beam
search, and score it, overall and by utterance length (the JAX
package's scripts/evaluate_wer.py).

    python -m libreasr_tpu_torch.scripts.evaluate_wer --dataset tmp/tone_corpus/test-clean \\
        [--bundle model.tar.gz] [--beam 4] [--bs 16] [--max-utts N] [--device cuda]

`--dataset` is a directory with asr-dataset*.csv (WAV files). Without
`--bundle`, a seeded random model of `--config`. Runs on the card unless
`--device cpu` is given. A bundle's own corpus settings (a tone
recipe's `synth_tone` block) are dropped, so `--dataset` is what is
scored, and every row of it: a bundle's `drop_last` (the 960 recipe
trains with it) would drop the last partial batch, which the JAX
package's script does.
"""

from __future__ import annotations

import argparse
import time

USE_LM_MESSAGE = (
    "libreasr_tpu_torch: --use-lm is not implemented: the JAX package's "
    "scripts/evaluate_wer.py parses the flag and never applies it (its "
    "evaluation decodes with use_lm=False), so LM-fused scoring would be a "
    "feature the reference lacks")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", required=True, help="dir with asr-dataset*.csv")
    p.add_argument("--bundle", default="", help="release tar.gz (default: random init)")
    p.add_argument("--config", default="config/base.yaml")
    p.add_argument("--split", default="test")
    p.add_argument("--beam", type=int, default=0)
    p.add_argument("--use-lm", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--max-utts", type=int, default=0)
    p.add_argument("--max-secs", type=float, default=20.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.use_lm:
        raise NotImplementedError(USE_LM_MESSAGE)

    from ..api import ASRBundle
    from ..config import parse_and_apply_config
    from ..data.batching import ASRDataset
    from ..training.evaluate import evaluate_bundle

    if a.bundle:
        bundle = ASRBundle.from_bundle(a.bundle, device=a.device)
        conf = dict(bundle.conf)
    else:
        conf = parse_and_apply_config(inference=True, path=a.config)
        bundle = ASRBundle.from_config(conf, device=a.device)

    conf.update(
        synth_tone=None,
        datasets=["eval"],
        dataset_paths={"eval": a.dataset},
        apply_limits=False,
        drop_last=False,
        shuffle=False,
        shuffle_builder={a.split: False},
        pcent={a.split: 1.0},
        transforms={
            "x": [{"name": "OpenAudio"}, {"name": "ChannelCut"},
                  {"name": "Resample"}],
            "y": [{"name": "OpenLabel"}, {"name": "Numericalize"},
                  {"name": "AddLen"}],
        },
        buckets=[{"max_samples": int(a.max_secs * conf.get("sr", 16000)),
                  "y_max": 256, "bs": a.bs}],
    )
    ds = ASRDataset.from_config(conf, bundle.lang, a.split)
    if a.max_utts:
        ds.builder.rows = ds.builder.rows[: a.max_utts]
    stats = ds.builder.stats()
    print(f"[eval] {stats}")

    t0 = time.time()
    result = evaluate_bundle(bundle, iter(ds), beam_width=a.beam, keep_samples=5)
    dt = time.time() - t0
    hours = stats.get("hours", 0)
    print(
        f"[eval] n={result.n} WER={result.wer:.4f} CER={result.cer:.4f} "
        f"align={result.alignment_score:.2f} "
        f"({dt:.0f}s, {hours * 3600 / max(dt, 1e-9):.0f}x realtime)"
    )
    for label, rec in result.by_length.items():
        print(f"  WER[{label}] = {rec['wer']:.4f} (n={rec['n']})")
    for s in result.samples:
        print(f"  pred:   {s['pred']!r}\n  target: {s['target']!r}")
    return result


if __name__ == "__main__":
    main()
