"""Global configuration of hippyflow_tpu_torch: default dtype and device,
and the float32 matmul precision.

Precision policy.  The JAX package pins every float32 matmul of its solver
kernels to full precision (Precision.HIGHEST in
``hippyflow_tpu/ops/pallas_kernels.py``): lower precision stalled Newton
and cost two orders of magnitude in Jacobian accuracy.  The port keeps
float32 matmuls in full IEEE float32 on the card, so TF32 is switched off
for matmuls and for cuDNN, and the float32 matmul precision is "highest".
These are process-wide PyTorch settings, set when the package is imported.

There is no kernel-routing switch: a CUDA tensor goes through the
hand-written kernels (``ops/hopper_kernels.py``), a CPU tensor through
their plain PyTorch versions.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# The dtype used where a caller passes none: the main path runs in float32,
# the parity checks pass float64 explicitly.
DEFAULT_DTYPE = torch.float32


def default_device() -> torch.device:
    """The first CUDA card.  Entry points run on the card unless the caller
    asks for the CPU: where there is no card this raises rather than fall
    back to the CPU quietly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hippyflow_tpu_torch: no CUDA card is available; pass "
            'device="cpu" to run on the CPU')
    return torch.device("cuda", 0)


def resolve(dtype=None, device=None):
    """(dtype, device) with the defaults filled in."""
    dtype = dtype or DEFAULT_DTYPE
    device = torch.device(device) if device is not None else default_device()
    return dtype, device
