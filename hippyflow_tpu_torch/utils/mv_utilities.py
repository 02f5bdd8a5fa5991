"""MultiVector <-> dense conversions (the port's copy of
``hippyflow_tpu/utils/mv_utilities.py``).

The reference moves between hp.MultiVector (a list of distributed
dl.Vectors) and numpy (n, k) arrays (`hippyflow/utilities/
mv_utilities.py:18-54`).  Here a multivector is an (n, k) array, so these
are identity conversions kept so that ported user code keeps working; a
tensor on any device comes back as a numpy array.
"""

from __future__ import annotations

import numpy as np
import torch


def mv_to_dense(mv) -> np.ndarray:
    """(n, k) array or tensor -> (n, k) numpy array."""
    if isinstance(mv, torch.Tensor):
        return mv.detach().cpu().numpy()
    return np.asarray(mv)


def mv_to_dense_local(mv) -> np.ndarray:
    return mv_to_dense(mv)


def dense_to_mv_local(arr, like=None):
    """(n, k) numpy array -> (n, k) multivector (identity)."""
    return mv_to_dense(arr)
