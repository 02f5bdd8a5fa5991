"""Global configuration of hippyflow_tpu_torch: default dtype and device,
and the float32 matmul precision.

Precision.  The JAX package pins every float32 matmul of its solver
kernels to full precision (Precision.HIGHEST in
``hippyflow_tpu/ops/pallas_kernels.py``): lower precision stalled Newton
and cost two orders of magnitude in Jacobian accuracy.  The port keeps
float32 matmuls in full IEEE float32 on the card: TF32 is switched off for
cuBLAS matmuls and for cuDNN when the package is imported, through
PyTorch's per-backend settings (``torch.backends.cuda.matmul.fp32_precision``
and ``torch.backends.cudnn.fp32_precision`` = "ieee"; the CPU's mkldnn
matmuls are pinned to "ieee" too).  These are process-wide PyTorch
settings.  The legacy flags (``allow_tf32``,
``torch.set_float32_matmul_precision``) are not used: PyTorch refuses to
read one API's state after the other's was set.

The JAX package's solver-precision policy (``set_solver_precision``:
lowered-precision products in the banded solver ops, and refinement
sweeps around the PDE problem's solves) is not ported.  On the card it
could reach only the library products of ``block_cyclic`` and
``block_tridiag`` (the kernels K1-K3 do their own IEEE arithmetic), and
TF32 there, refined back to the IEEE residual, made neither faster
(``python3 -m hippyflow_tpu_torch.ops.tf32_sweep``).

There is no kernel-routing switch: a CUDA tensor goes through the
hand-written kernels (``ops/hopper_kernels.py``), a CPU tensor through
their plain PyTorch versions.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.fp32_precision = "ieee"
torch.backends.cudnn.fp32_precision = "ieee"
torch.backends.mkldnn.matmul.fp32_precision = "ieee"

# The dtype used where a caller passes none: the main path runs in float32,
# the parity checks pass float64 explicitly.
DEFAULT_DTYPE = torch.float32


def default_dtype() -> torch.dtype:
    """The floating dtype where a caller passes none (``DEFAULT_DTYPE``)."""
    return DEFAULT_DTYPE


def default_int_dtype() -> torch.dtype:
    """The integer dtype the port indexes with: ``torch.int64``
    (``torch.long``, PyTorch's index type), in every dtype setting."""
    return torch.int64


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
