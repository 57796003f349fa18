"""Training log: step and eval lines on stdout and in a JSON-lines file
(the JAX package's training/callbacks.py without tensorboardX or
wandb, which the port does not use).

Every `every` steps: the loss, its smoothed value, the gradient norm,
frames, tokens and batch size. The smoothed loss is an EMA over the
logged losses with decay 0.98 per step (0.98**k for a gap of k steps),
the JAX package's and fastai's smooth_loss. Each eval: WER, CER and the
alignment score, and whether the best WER improved.
"""

from __future__ import annotations

import json
import os
from typing import Any


class TrainLogger:
    def __init__(self, logdir: str = "runs/libreasr", every: int = 4):
        self.every = every
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "train_log.jsonl")
        self._file = open(self.path, "a")
        self.best_wer = float("inf")
        self._ema_loss = None
        self._ema_step = None

    def _write(self, record: dict) -> None:
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log_step(self, step: int, metrics: dict[str, Any], batch=None,
                 prev_step: int | None = None) -> None:
        """Logs when `step` crosses a multiple of `every` (reads the device
        metrics only then: each read synchronises)."""
        prev = step - 1 if prev_step is None else prev_step
        if step // self.every <= prev // self.every:
            return
        loss = float(metrics["loss"])
        gap = step - self._ema_step if self._ema_step is not None else self.every
        decay = 0.98 ** max(gap, 1)
        self._ema_loss = (loss if self._ema_loss is None
                          else decay * self._ema_loss + (1.0 - decay) * loss)
        self._ema_step = step
        rec = {"kind": "train", "step": step, "loss": loss,
               "smooth_loss": self._ema_loss,
               "grad_norm": float(metrics.get("grad_norm", 0.0))}
        for k in ("frames", "tokens"):
            if k in metrics:
                rec[k] = int(metrics[k])
        if batch is not None:
            rec["batch_size"] = len(batch.audio)
        self._write(rec)
        print(f"[train] step={step} loss={loss:.3f} "
              f"smooth={self._ema_loss:.3f} grad_norm={rec['grad_norm']:.3f}",
              flush=True)

    def log_eval(self, step: int, result) -> bool:
        """Logs an EvalResult; True when it lowers the best WER."""
        improved = result.wer < self.best_wer
        if improved:
            self.best_wer = result.wer
        self._write({"kind": "eval", "step": step, "wer": result.wer,
                     "cer": result.cer, "alignment_score": result.alignment_score,
                     "n": result.n, "best": improved,
                     "samples": result.samples[:4]})
        return improved

    def close(self) -> None:
        self._file.close()
