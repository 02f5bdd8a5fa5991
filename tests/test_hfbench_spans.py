"""The benchmark's span reduction (``hfbench/spans.py``) on a synthetic
event list, beside ``hfbench/trace.py``'s ``summarize`` on the same list;
and the readers of ``warm_start_s``, ``coarse_newton_iters``,
``host_syncs``, ``band_launches`` and ``k3_resident``, which give None
where there is no trace or no coarse level and read the program's
counters counted inside a profiler session."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hfbench import spans, spec, trace  # noqa: E402
from hippyflow_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from hippyflow_tpu_torch.utils import profiling  # noqa: E402


class Ev:
    """The part of a profiler's raw event that the reductions read."""

    def __init__(self, name, start, end, kind="cpu_op", tid=1, corr=0,
                 linked=0, stream=7):
        self._name, self._start, self._end = name, start, end
        self.kind, self.tid = kind, tid
        self.corr, self.linked, self.stream = corr, linked, stream

    def name(self):
        return self._name

    def device_type(self):
        return (DeviceType.CUDA if self.kind in ("kernel", "gpu_user_annotation")
                else DeviceType.CPU)

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def start_thread_id(self):
        return self.tid

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def activity_type(self):
        return self.kind

    def is_user_annotation(self):
        return self.kind in ("user_annotation", "gpu_user_annotation")

    def device_resource_id(self):
        return self.stream


def _ann(name, a, b, corr):
    return Ev(name, a, b, kind="user_annotation", corr=corr)


def _kernel(name, a, b, linked=0, corr=0, stream=7):
    return Ev(name, a, b, kind="kernel", linked=linked, corr=corr, stream=stream)


EVENTS = [
    _ann(trace.WINDOW, 0, 1000, 1),
    _ann("forward", 10, 600, 2),
    _ann("newton.solve", 20, 400, 3),
    _ann("band.factorize", 50, 150, 4),
    Ev("aten::mul", 60, 70, corr=101),
    Ev("cudaLaunchKernel", 80, 85, kind="cuda_runtime", corr=5001, linked=4),
    _ann("newton.sync", 300, 350, 5),
    _ann("warm_start", 420, 550, 6),
    Ev("aten::add", 430, 440, corr=102),
    _ann("jacobian", 600, 900, 7),
    _ann("fem.assemble", 610, 700, 8),
    Ev("aten::mm", 620, 630, corr=103),
    Ev("aten::copy_", 950, 960, corr=104),  # the harness's, between stages
    _kernel("void ns::elementwise_kernel<float>(int)", 100, 200, linked=101),
    _kernel("banded_chain_kernel", 200, 260, corr=5001),  # by its runtime call
    _kernel("elementwise_kernel", 450, 500, linked=102),
    _kernel("gemm", 640, 700, linked=103),
    _kernel("gemm", 710, 720, corr=9999),  # no launch: its stream's last
    _kernel("reduce_kernel", 730, 740, corr=9998, stream=9),  # unattributed
    _kernel("copy_kernel", 955, 980, linked=104),
    _kernel("gemm", -50, 5, stream=11),  # clipped to the window, unattributed
    _kernel("gemm", 1100, 1200, linked=104),  # after the window
    Ev("forward", 10, 600, kind="gpu_user_annotation"),  # not an operation
]


class _Prof:
    def __init__(self, events):
        results = SimpleNamespace(events=lambda: events)
        self.profiler = SimpleNamespace(kineto_results=results)


def test_reduction_on_a_synthetic_trace():
    got = spans.reduce_events(EVENTS, profiling.SPANS)
    old = trace.summarize(_Prof(EVENTS))
    ns = 1e-9
    # the existing summary, unchanged on the same list
    assert old.window_s == pytest.approx(1000 * ns)
    assert old.busy_s == pytest.approx((5 + 160 + 50 + 60 + 10 + 10 + 25) * ns)
    assert old.n_device_ops == 8
    assert old.kernel_s == pytest.approx({
        "elementwise_kernel": 150 * ns, "banded_chain_kernel": 60 * ns,
        "gemm": 75 * ns, "reduce_kernel": 10 * ns, "copy_kernel": 25 * ns})
    # every device second is put down to a span or left unattributed
    assert got.device_s == pytest.approx(sum(old.kernel_s.values()))
    assert (sum(got.device_by_span.values()) + got.unattributed_s
            == pytest.approx(sum(old.kernel_s.values())))
    assert got.device_by_span == pytest.approx({
        "band.factorize": 160 * ns, "warm_start": 50 * ns,
        "fem.assemble": 70 * ns, spans.OUTSIDE: 25 * ns})
    assert got.by_stream_order_s == pytest.approx(10 * ns)
    assert got.unattributed_s == pytest.approx(15 * ns)
    assert got.device_under["newton.solve"] == pytest.approx(160 * ns)
    assert got.device_under["forward"] == pytest.approx(210 * ns)
    assert got.device_under["jacobian"] == pytest.approx(70 * ns)
    # every idle second is put down to the span open at its gap's middle
    assert (sum(got.idle_by_span.values())
            == pytest.approx(sum(old.idle_by_host.values())))
    assert got.idle_by_span == pytest.approx({
        "band.factorize": 95 * ns, "newton.solve": 190 * ns,
        "forward": 140 * ns, "jacobian": 235 * ns, spans.BETWEEN: 20 * ns})
    assert got.idle_in_stage["forward"] == pytest.approx([425 * ns, 285 * ns])
    assert got.idle_in_stage["jacobian"] == pytest.approx([235 * ns, 0.0])
    assert got.kernel_n == {"elementwise_kernel": 2, "banded_chain_kernel": 1,
                            "gemm": 3, "reduce_kernel": 1, "copy_kernel": 1}
    assert got.launch_found == {"torch op": 4, "runtime call": 1, "none": 3}
    assert got.span_host_s["newton.solve"] == pytest.approx(380 * ns)
    assert got.span_n == {"forward": 1, "newton.solve": 1, "band.factorize": 1,
                          "newton.sync": 1, "warm_start": 1, "jacobian": 1,
                          "fem.assemble": 1}


@pytest.mark.parametrize("name,launch", [("cudaLaunchKernel", True),
                                         ("cuLaunchKernel", True),
                                         ("aten::mm", False),
                                         ("band.solve", False)])
def test_launch_calls_by_name_where_events_have_no_activity_type(name, launch):
    assert spans._is_launch_call(SimpleNamespace(name=lambda: name)) is launch


def test_reduction_without_a_window_or_device_operations():
    assert spans.reduce_events(EVENTS[1:], profiling.SPANS) is None
    host_only = [e for e in EVENTS if e.kind != "kernel"]
    assert spans.reduce_events(host_only, profiling.SPANS) is None


def _run(traced=True, n_passes=2, coarse=(5, 3)):
    passes = [SimpleNamespace(error=None, n_samples=4,
                              coarse_iterations=list(coarse))
              for _ in range(n_passes)]
    return SimpleNamespace(trace=object() if traced else None, passes=passes)


@pytest.fixture
def counters():
    profiling.reset_counters()
    hk.reset_launch_counts()
    yield
    profiling.reset_counters()
    hk.reset_launch_counts()


@pytest.mark.parametrize("name", ["warm_start_s", "host_syncs",
                                  "band_launches", "coarse_newton_iters",
                                  "k3_resident"])
def test_readers_find_nothing_to_read(name, counters):
    read = spec.metric_reader(name)
    if name == "coarse_newton_iters":
        assert read(_run(coarse=())) is None
        assert read(_run(n_passes=0)) is None
    else:
        assert read(_run(traced=False)) is None
    if name == "warm_start_s":  # no warm start ran
        assert read(_run()) is None


def test_readers_read_the_window_per_pass(counters):
    profiling.host_syncs.add("newton.sync", 100)  # outside the session
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.host_syncs.add("newton.sync", 6)
        profiling.host_syncs.add("stage", 2)
        with profiling.annotate("warm_start", fine=True):
            pass
        key = ("rows", 16, 193, 193, 0, "float32")
        hk.banded_factorize.launches_by_shape.add(key)
        hk.schur_step_.launches_by_shape.add(("schur",) + key[1:], 193)
        hk.batched_inverse.launches_by_shape.add(("k3",) + key[1:], 193)
        hk.banded_solve.launches_by_shape.add(
            ("streamed", 16, 193, 193, 1, "float32"), 2)
    run = _run()
    assert spec.metric_reader("host_syncs")(run) == 4.0
    assert spec.metric_reader("band_launches")(run) == (193 + 193 + 2) / 2
    warm = spec.metric_reader("warm_start_s")(run)
    assert warm == pytest.approx(profiling.span_seconds["warm_start"] / 2)
    assert warm > 0
    assert spec.metric_reader("coarse_newton_iters")(run) == 8 / 4


def test_k3_resident_reads_the_traced_share(counters):
    """The share of the traced K3/K4 launches that ran resident; None where
    none was traced, or where the program has no resident tally (a
    checkout before the resident design)."""
    read = spec.metric_reader("k3_resident")
    key = ("k3", 16, 193, 193, 0, "float32")
    hk.batched_inverse.launches_by_shape.add(key, 50)  # outside the session
    hk.batched_inverse.resident_by_shape.add(key, 50)
    assert read(_run()) is None
    with profile(activities=[ProfilerActivity.CPU]):
        hk.batched_inverse.launches_by_shape.add(key, 193)
        hk.batched_inverse.resident_by_shape.add(key, 193)
        hk.batched_inverse.launches_by_shape.add(("k3", 16, 516, 52, 0, "float32"), 52)
        hk.batched_inverse.launches_by_shape.add(("k4", 96, 193, 1, 0, "float32"))
        hk.schur_step_.launches_by_shape.add(("schur",) + key[1:], 193)
    assert read(_run()) == pytest.approx(100.0 * 193 / (193 + 52 + 1))
    assert read(_run(traced=False)) is None
    tally = hk.batched_inverse.resident_by_shape
    try:
        del hk.batched_inverse.resident_by_shape
        assert read(_run()) is None
    finally:
        hk.batched_inverse.resident_by_shape = tally
