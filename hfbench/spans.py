"""The program's spans in one ``torch.profiler`` trace of the window: what
``trace.summarize`` does not reduce, kept in memory as it is.

The program marks its stages (``trace.STAGES``) and the layers below them
(``hippyflow_tpu_torch.utils.profiling.SPANS``) with ``record_function``
ranges, which the profiler records on the same clock as the device's
operations.  From the raw events:

* ``device_by_span``: the device seconds of each operation inside the
  window, put down to the innermost program span open on the launching
  thread when it was launched (``outside spans`` where none was).  The
  launch is the host operation the profiler links to the device
  operation (``linked_correlation_id``), else the runtime call of the same
  ``correlation_id``; an operation with neither takes the span of the
  operation before it on its stream (``by_stream_order_s``), and with no
  such operation goes to ``unattributed_s``.
* ``device_under``: the same seconds put down to every span name open at
  the launch, so that a layer's seconds include its children's.
* ``idle_by_span``: each idle gap of ``trace.summarize`` put down to the
  innermost program span open at its midpoint on the window's thread
  (``between stages`` where none was); ``idle_in_stage`` gives, for each
  stage, its idle seconds and the part of them under a span below it.
* ``span_host_s`` and ``span_n``: the host seconds and the count of each
  span name; ``kernel_n``: the device operations of each kernel name.

    python3 hfbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does, prints run.py's result line,
then one more JSON line: this reduction of the window, the program's
counters counted inside it (``host_syncs``, ``launches_by_shape``,
``span_seconds``), and each per pass.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from dataclasses import asdict, dataclass, field
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hfbench import trace  # noqa: E402

OUTSIDE, BETWEEN = "outside spans", "between stages"


def program_spans() -> tuple:
    """The program's span names below the stages (none where the program
    has no such tuple)."""
    try:
        from hippyflow_tpu_torch.utils import profiling
    except ImportError:
        return ()
    return tuple(getattr(profiling, "SPANS", ()))


@dataclass
class SpanSummary:
    device_s: float = 0.0
    device_by_span: dict = field(default_factory=dict)
    device_under: dict = field(default_factory=dict)
    by_stream_order_s: float = 0.0
    unattributed_s: float = 0.0
    idle_by_span: dict = field(default_factory=dict)
    idle_in_stage: dict = field(default_factory=dict)
    span_host_s: dict = field(default_factory=dict)
    span_n: dict = field(default_factory=dict)
    kernel_n: dict = field(default_factory=dict)
    launch_found: dict = field(default_factory=dict)  # by which link, ops


def _is_launch_call(e) -> bool:
    """A runtime or driver call (``cudaLaunchKernel``, ...), not a torch
    operation or a range."""
    try:
        kind = str(e.activity_type()).lower()
    except AttributeError:  # a torch without it: the calls by their names
        return e.name().startswith("cu")
    return "runtime" in kind or "driver" in kind


def _stacks_at(spans: list, queries: list) -> dict:
    """For (t, i) queries sorted by t, on one thread's spans (start, end,
    name) sorted by (start, -end): the names of the spans open at each t,
    outermost first, in query order i."""
    out = {}
    stack, j = [], 0
    for t, i in queries:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack if s[1] > t)
    return out


def reduce_events(events, names: tuple) -> SpanSummary | None:
    """The summary of a trace's raw events, or None where there is no
    window or no device operation inside it.  ``names``: the program's
    span names below the stages."""
    from torch.autograd import DeviceType

    names = set(names) | set(trace.STAGES)
    window, device = None, []
    torch_ops, launches = {}, {}
    spans = defaultdict(list)
    for e in events:
        start, end = trace._times(e)
        if e.device_type() == DeviceType.CPU:
            name, tid = e.name(), e.start_thread_id()
            if name == trace.WINDOW:
                window = (start, end, tid)
            elif name in names:
                spans[tid].append((start, end, name))
            if _is_launch_call(e):
                launches[e.correlation_id()] = (start, tid)
            else:
                torch_ops[e.correlation_id()] = (start, tid)
        elif end > start and not trace._is_annotation(e):
            device.append((start, end, e.name(), e.linked_correlation_id(),
                           e.correlation_id(), e.device_resource_id()))
    if window is None or not device:
        return None
    w0, w1, wtid = window
    device = sorted((max(a, w0), min(b, w1), *rest)
                    for a, b, *rest in device if b > w0 and a < w1)
    if not device:
        return None
    for tid in spans:
        spans[tid].sort(key=lambda s: (s[0], -s[1]))

    # the launch of each operation, and the spans open there
    queries = defaultdict(list)
    found = defaultdict(int)
    for i, (_, _, _, linked, corr, _) in enumerate(device):
        at = torch_ops.get(linked) if linked else None
        found["torch op" if at else "runtime call" if corr in launches
              else "none"] += 1
        at = at or launches.get(corr)
        if at is not None:
            queries[at[1]].append((at[0], i))
    paths = {}
    for tid, qs in queries.items():
        qs.sort()
        paths.update(_stacks_at(spans.get(tid, []), qs))

    out = SpanSummary()
    by_span, under = defaultdict(float), defaultdict(float)
    kernel_n = defaultdict(int)
    last_on_stream = {}
    for i, (a, b, name, _, _, stream) in enumerate(device):
        dt = (b - a) * 1e-9
        out.device_s += dt
        kernel_n[trace.kernel_base_name(name)] += 1
        path = paths.get(i)
        if path is None:
            path = last_on_stream.get(stream)
            if path is None:
                out.unattributed_s += dt
                continue
            out.by_stream_order_s += dt
        last_on_stream[stream] = path
        by_span[path[-1] if path else OUTSIDE] += dt
        for n in set(path):
            under[n] += dt

    # the idle gaps, as trace.summarize finds them
    gaps, cur1 = [], w0
    for a, b, *_ in device:
        if a > cur1:
            gaps.append((cur1, a))
        cur1 = max(cur1, b)
    if w1 > cur1:
        gaps.append((cur1, w1))
    mids = _stacks_at(spans.get(wtid, []),
                      [((g0 + g1) // 2, i) for i, (g0, g1) in enumerate(gaps)])
    idle = defaultdict(float)
    in_stage = defaultdict(lambda: [0.0, 0.0])
    for i, (g0, g1) in enumerate(gaps):
        dt, path = (g1 - g0) * 1e-9, mids[i]
        idle[path[-1] if path else BETWEEN] += dt
        stages = [n for n in path if n in trace.STAGES]
        if stages:
            in_stage[stages[-1]][0] += dt
            if path[-1] not in trace.STAGES:
                in_stage[stages[-1]][1] += dt

    host, count = defaultdict(float), defaultdict(int)
    for tid_spans in spans.values():
        for a, b, name in tid_spans:
            if b > w0 and a < w1:
                host[name] += (min(b, w1) - max(a, w0)) * 1e-9
                count[name] += 1
    out.device_by_span, out.device_under = dict(by_span), dict(under)
    out.idle_by_span, out.idle_in_stage = dict(idle), dict(in_stage)
    out.span_host_s, out.span_n = dict(host), dict(count)
    out.kernel_n, out.launch_found = dict(kernel_n), dict(found)
    return out


def summarize_spans(prof) -> SpanSummary | None:
    """``reduce_events`` of a finished profiler run."""
    return reduce_events(prof.profiler.kineto_results.events(),
                         program_spans())


def counters(passes: int) -> dict:
    """The program's counters counted inside profiler sessions, whole and
    per pass: host syncs by site, launches by design, span seconds."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.utils import profiling

    tally = getattr(profiling, "host_syncs", None)
    syncs = dict(tally.traced) if tally is not None else {}
    by_design = defaultdict(int)
    for fn in (hk.banded_factorize, hk.schur_step_, hk.batched_inverse,
               hk.banded_solve):
        tally = getattr(fn, "launches_by_shape", None)
        for key, n in (tally.traced.items() if tally is not None else ()):
            by_design[key[0]] += n
    seconds = dict(getattr(profiling, "span_seconds", {}))
    per = max(passes, 1)
    return {"host_syncs": syncs,
            "host_syncs_per_pass": sum(syncs.values()) / per,
            "launches_by_design": dict(by_design),
            "launches_per_pass": {k: v / per for k, v in by_design.items()},
            "span_seconds_per_pass": {k: v / per for k, v in seconds.items()}}


def main(argv=None) -> int:
    from hfbench import harness, run, spec

    argv = list(sys.argv[1:] if argv is None else argv)
    kept = {}
    summarize, run_cell = trace.summarize, harness.run_cell

    def summarize_both(prof):
        kept["spans"] = summarize_spans(prof)
        return summarize(prof)

    def run_cell_kept(*args, **kwargs):
        out = run_cell(*args, **kwargs)
        kept["run"] = out[0]
        return out

    trace.summarize, harness.run_cell = summarize_both, run_cell_kept
    rc = run.main(argv + ["--trace", "1"])
    if rc != 0 or "run" not in kept:
        return rc
    result, summary = kept["run"], kept.get("spans")
    n = len(result.passes)
    line = {"passes": n, "window_s": result.window_s,
            "subspace_s_traced": result.window_s / n if n else None,
            "counters": counters(n)}
    if summary is not None:
        line["spans"] = asdict(summary)
        band = spec.band_kernel_names()
        ops = sum(v for k, v in summary.kernel_n.items() if k in band)
        line["band_ops_per_pass"] = ops / n if n else None
        line["device_by_span_per_pass"] = {
            k: v / n for k, v in summary.device_by_span.items()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
