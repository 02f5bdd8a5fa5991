"""k3_resident: the share, in percent, of the K3/K4 launches (keys 'k3'
and 'k4' of the program's ``batched_inverse.launches_by_shape``) that ran
the resident design (its ``resident_by_shape``), both counted while a
profiler session recorded: in a traced run, over the window alone.  A
row-design call of K1 counts its nb K3 launches under 'k3'.  None in an
untraced run, where no K3/K4 launch was counted, or where the program has
no such counter."""

import sys


def read(run):
    hk = sys.modules.get("hippyflow_tpu_torch.ops.hopper_kernels")
    inverse = getattr(hk, "batched_inverse", None)
    launches = getattr(inverse, "launches_by_shape", None)
    resident = getattr(inverse, "resident_by_shape", None)
    if run.trace is None or launches is None or resident is None:
        return None
    total = sum(n for key, n in launches.traced.items() if key[0] in ("k3", "k4"))
    if not total:
        return None
    return 100.0 * sum(resident.traced.values()) / total
