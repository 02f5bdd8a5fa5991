"""The reduction of one ``torch.profiler`` trace of the window, kept in
memory and never written out.

From the profiler's raw events: the traced window (the host range
``WINDOW`` that the harness opens around it), the union of the device's
operation intervals inside it (``busy_s``), the device seconds of each
kernel by its plain name, and the idle gaps between device operations,
each put down to what the host was doing in its middle: the stage range
of the program (``forward``, ``jacobian``, ``ghep``, ...) and the
innermost host operation open at that moment on the harness's thread.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "hfbench.window"
STAGES = ("forward", "jacobian", "linearize", "fused", "ghep")


def kernel_base_name(name: str) -> str:
    """'void ns::foo_kernel<float, 4>(float const*, int)' -> 'foo_kernel'."""
    name = re.sub(r"^void\s+", "", name.strip())
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:  # drop template arguments and the parameter list
        if ch in "<(":
            if ch == "(" and depth == 0:
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    base = "".join(out).strip()
    return base.rsplit("::", 1)[-1].strip() or name


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)      # base name -> seconds
    idle_by_host: dict = field(default_factory=dict)  # host activity -> s
    n_device_ops: int = 0


def _times(e):
    try:
        return e.start_ns(), e.end_ns()
    except AttributeError:
        start = int(e.start_us() * 1000)
        return start, start + int(e.duration_us() * 1000)


def _is_annotation(e) -> bool:
    """A range that the profiler draws on the device's timeline for a host
    annotation (``record_function``): not an operation of the device."""
    try:
        if e.is_user_annotation():
            return True
    except AttributeError:
        pass
    try:
        return "annotation" in str(e.activity_type()).lower()
    except AttributeError:
        return e.name() == WINDOW or e.name() in STAGES


def summarize(prof) -> TraceSummary | None:
    """The summary of a finished profiler run, or None where the trace
    holds no device operation inside the window."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window, host, device = None, [], []
    for e in events:
        start, end = _times(e)
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            if name == WINDOW:
                window = (start, end, e.start_thread_id())
            host.append((start, end, name, e.start_thread_id()))
        elif end > start and not _is_annotation(e):
            device.append((start, end, e.name()))
    if window is None or not device:
        return None
    w0, w1, tid = window
    device = sorted((max(a, w0), min(b, w1), n) for a, b, n in device
                    if b > w0 and a < w1)
    if not device:
        return None
    kernel_s = defaultdict(float)
    busy, gaps = 0, []
    cur0, cur1 = w0, w0
    for a, b, name in device:
        kernel_s[kernel_base_name(name)] += (b - a) * 1e-9
        if a > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0 = a
        cur1 = max(cur1, b)
    busy += cur1 - cur0
    if w1 > cur1:
        gaps.append((cur1, w1))
    # what the harness's thread was doing in the middle of each gap: the
    # host ranges on one thread nest, so a sweep with a stack finds the
    # innermost one open at each (sorted) midpoint
    host = sorted((h for h in host if h[3] == tid and h[2] != WINDOW),
                  key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    stack, i = [], 0
    for g0, g1 in gaps:
        t = (g0 + g1) // 2
        j = bisect.bisect_right(starts, t)
        while i < j:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        stage = next((h[2] for h in reversed(stack) if h[2] in STAGES),
                     "between stages")
        inner = stack[-1][2] if stack and stack[-1][2] not in STAGES else "python"
        idle[f"{stage}: {inner}"] += (g1 - g0) * 1e-9
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                        kernel_s=dict(kernel_s), idle_by_host=dict(idle),
                        n_device_ops=len(device))


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
