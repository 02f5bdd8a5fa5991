"""warm_start_s: the host seconds per pass of the program's ``warm_start``
spans (every coarse level of a chunk: restriction, Newton, prolongation),
which the program sums in ``utils.profiling.span_seconds`` while a
profiler session records: in a traced run, over the window alone.  The
coarse levels are paced by the host, so the span's length is what they
cost.  None in an untraced run, or where no warm start ran."""

import sys


def read(run):
    profiling = sys.modules.get("hippyflow_tpu_torch.utils.profiling")
    seconds = getattr(profiling, "span_seconds", {}).get("warm_start")
    if run.trace is None or not run.passes or not seconds:
        return None
    return seconds / len(run.passes)
