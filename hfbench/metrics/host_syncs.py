"""host_syncs: the times per pass the program's host waited on the device,
all sites (``utils.profiling.host_syncs``: each Newton round's read of the
active lanes, each chunk's converged flags, each resampling sweep's reads,
each stage's closing synchronize), counted while a profiler session
recorded: in a traced run, over the window alone.  None in an untraced
run, or where the program has no such counter."""

import sys


def read(run):
    profiling = sys.modules.get("hippyflow_tpu_torch.utils.profiling")
    tally = getattr(profiling, "host_syncs", None)
    if run.trace is None or not run.passes or tally is None:
        return None
    return sum(tally.traced.values()) / len(run.passes)
