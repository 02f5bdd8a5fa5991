"""band_launches: the hand-written kernels' launches per pass (K1's chain,
its row design's Schur steps, K3, K4, K2's panels and streamed design),
from the program's ``launches_by_shape`` counted while a profiler session
recorded: in a traced run, over the window alone.  A row-design call of
K1 counts its launches under the Schur step's and K3's keys, so its own
key is left out.  None in an untraced run, or where the program has no
such counter."""

import sys

WRAPPERS = ("banded_factorize", "schur_step_", "batched_inverse",
            "banded_solve")


def read(run):
    hk = sys.modules.get("hippyflow_tpu_torch.ops.hopper_kernels")
    tallies = [getattr(getattr(hk, name, None), "launches_by_shape", None)
               for name in WRAPPERS]
    if run.trace is None or not run.passes or None in tallies:
        return None
    launches = sum(n for tally in tallies for key, n in tally.traced.items()
                   if key[0] != "rows")
    return launches / len(run.passes)
