"""PyTorch/CUDA port of libreasr_tpu for one NVIDIA H100.

The offline serving path (tar.gz bundle -> log-mel frontend -> LSTM
encoder -> NBRC predictor -> concat joint -> greedy decode -> text) in
plain PyTorch, with the encoder's recurrence in a hand-written CUDA
kernel (csrc/lstm_seq.cu). Parameter layouts match the JAX package, so
its bundles load unchanged.

Entry points run on the card unless the caller asks for the CPU: a
`device` of None means "cuda", and a missing card raises instead of
silently running on the host.

Matmul precision: float32 products run in full float32 on the card.
TF32 keeps about three decimal digits, too coarse for the DFT frontend
(the JAX package pins those matmuls to Precision.HIGHEST), so both TF32
switches are turned off here, when the package is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """None -> cuda. Raises when cuda is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "libreasr_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run on the host"
        )
    return dev
