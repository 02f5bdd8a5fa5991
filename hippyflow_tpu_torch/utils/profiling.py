"""Phase timing, profiler traces, utilization and the kernels' bounds.

Port of ``hippyflow_tpu/utils/profiling.py``.  ``PhaseTimer`` keeps the
per-phase wall-clock dict the drivers pickle; ``trace`` and ``annotate``
are ``torch.profiler`` traces and ranges (the JAX package's TensorBoard
traces); ``mfu_report`` measures a callable's rate against the card's
peaks.  Two differences from the JAX module: ``trace`` raises where the
profiler fails (the JAX one swallows it), and the peaks of a CUDA card
that the table does not know raise ``ValueError`` instead of giving a
made-up number.

Below the stages the program marks its layers with fine spans
(``annotate(name, fine=True)``, one of ``SPANS``): ``record_function``
ranges entered only while a ``torch.profiler`` session records, so that
with no profiler a span costs one check of the profiler's flag.  Each
fine span adds its host seconds to ``span_seconds``.  ``host_syncs``
counts, by site, the places where the main path's host waits on the
device; ``reset_counters`` zeroes both.  A ``Tally`` keeps apart, in
``traced``, what it counted while a profiler session recorded: the part
that lies inside that session's trace.

The bounds (``bound``, ``k1_bound``, ``k2_bound``, ``k3_bound``,
``schur_bound``) are the least time one H100 SXM could take for a kernel's
work: its operations at the peak rate of their type or its bytes at the
memory rate, whichever is larger.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import config

# Peak rates by card name (NVIDIA's data sheets), as (TFLOP/s, GB/s).  The
# H100 SXM at 700 W: float32 outside the tensor cores (a float32 mma would
# be TF32, which the port never uses), float64 through the FP64 tensor
# cores (IEEE double), HBM3.
_PEAKS = {
    "H100 80GB HBM3": (67.0, 3350.0),
    "H100 SXM": (67.0, 3350.0),
}
# what the JAX module returns off its accelerators: ratios stay defined
_CPU_PEAKS = (1.0, 50.0)
_H100_SXM = _PEAKS["H100 SXM"]

# the peaks the kernels' bounds are taken at (one H100 SXM)
PEAK_FLOPS = {torch.float32: _H100_SXM[0] * 1e12,
              torch.float64: _H100_SXM[0] * 1e12}
HBM_BYTES_PER_S = _H100_SXM[1] * 1e9


# The fine spans below the stages (the stages are ``PhaseTimer`` phases
# with an ``annotate`` range of their name: forward, jacobian, ghep, ...).
SPANS = (
    "newton.solve",     # one batched forward solve (any level)
    "newton.sync",      # the host's wait for the active lanes, each round
    "fem.residual",     # residual evaluations
    "fem.assemble",     # the Jacobian's band, bc-symmetrized
    "fem.apply_c",      # C and C^T products, the observation's B^T
    "band.factorize",   # K1 (both designs), cyclic reduction, block-Thomas
    "band.solve",       # K2 (both designs), the other factors' solves
    "prior.sample",     # prior samples (the warm start's recomputation too)
    "prior.solve",      # R, R^-1, K^-1 and M^-1 products
    "warm_start",       # every coarse level of one chunk
    "sample.resample",  # re-solves of failed lanes
)


class Tally(collections.Counter):
    """A ``Counter`` whose ``traced`` part holds what ``add`` counted while
    a ``torch.profiler`` session recorded; ``clear`` zeroes both."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.traced = collections.Counter()

    def add(self, key, n: int = 1) -> None:
        self[key] += n
        if _autograd_profiler._is_profiler_enabled:
            self.traced[key] += n

    def clear(self) -> None:
        super().clear()
        self.traced.clear()


# host waits on the device by site: newton.sync, sample.converged,
# sample.resample, stage (PhaseTimer's synchronize)
host_syncs = Tally()
# host seconds of each fine span, summed over the spans recorded
span_seconds = collections.Counter()


def reset_counters() -> None:
    """Zero ``host_syncs`` and ``span_seconds``."""
    host_syncs.clear()
    span_seconds.clear()


class PhaseTimer:
    """Accumulates named phase durations and prints them like the
    reference when verbose.  ``timings`` is the metadata dict the drivers
    pickle; ``counts`` how often each phase ran."""

    def __init__(self, verbose: bool = False):
        self.timings: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.verbose = verbose

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time a phase.  Pass its output as ``block_on`` (or set it with
        ``holder["result"] = ...`` on the yielded dict, ``set_result``'s
        JAX form): the clock stops after the devices of its CUDA tensors
        have finished their queued work."""
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            out = holder.get("result", block_on)
            if out is not None:
                leaves = tree_flatten(out)[0]
                for dev in {t.device for t in leaves
                            if isinstance(t, torch.Tensor) and t.is_cuda}:
                    torch.cuda.synchronize(dev)
                    host_syncs.add("stage")
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if self.verbose:
                print(f"{name} took {dt:.3f}s")

    def report(self) -> str:
        lines = [
            f"{name:<40s} {t:>10.3f}s  (x{self.counts[name]})"
            for name, t in sorted(self.timings.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, CPU and (where there is a
    card) CUDA activities, written into ``log_dir`` as a Chrome trace
    (``*.pt.trace.json``, TensorBoard's layout) when the block ends.
    Yields the profiler, whose ``events()`` the caller may read.  A
    profiler that fails raises."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class _Range:
    """A ``record_function`` range; a stage's also takes an NVTX range where
    there is a card, a fine span adds its host seconds to
    ``span_seconds``."""

    __slots__ = ("name", "args", "fine", "rf", "nvtx", "t0")

    def __init__(self, name: str, args, fine: bool):
        self.name, self.args, self.fine = name, args, fine

    def __enter__(self):
        self.rf = _autograd_profiler.record_function(self.name, self.args)
        self.rf.__enter__()
        self.nvtx = not self.fine and torch.cuda.is_available()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        if self.fine:
            _open_spans().add(self.name)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.fine:
            span_seconds[self.name] += time.perf_counter() - self.t0
            _open_spans().discard(self.name)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        self.rf.__exit__(*exc)
        return False


_local = threading.local()
_OFF = contextlib.nullcontext()


def _open_spans() -> set:
    """The names of the fine spans open on this thread."""
    if not hasattr(_local, "open"):
        _local.open = set()
    return _local.open


def annotate(name: str, *, fine: bool = False, **shape):
    """A named range in the profiler's trace (``record_function``, its
    argument string ``shape`` as "k=v, ...") and, where there is a card,
    an NVTX range.  A ``fine`` span (one of ``SPANS``) is entered only
    while a ``torch.profiler`` session records (otherwise it costs one
    check of the profiler's flag), takes no NVTX range, adds its host
    seconds to ``span_seconds``, and is not entered inside an open span of
    its own name, so that its seconds count once."""
    if fine and (not _autograd_profiler._is_profiler_enabled
                 or name in _open_spans()):
        return _OFF
    args = ", ".join(f"{k}={v}" for k, v in shape.items()) if shape else None
    return _Range(name, args, fine)


@contextlib.contextmanager
def stage(timer: PhaseTimer, name: str, block_on=None):
    """A stage: an ``annotate`` range of its name, timed as a phase of
    ``timer`` up to the end of the device's work on ``block_on``'s
    devices.  Yields the phase's holder."""
    with annotate(name), timer.phase(name, block_on=block_on) as holder:
        yield holder


# -- utilization ------------------------------------------------------------


def _peaks(device) -> tuple[float, float]:
    device = config.default_device() if device is None else torch.device(device)
    if device.type == "cpu":
        return _CPU_PEAKS
    if device.type != "cuda":
        raise ValueError(f"no peak rates for a {device.type} device")
    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no peak rates for the card {name!r}: add its data "
                     "sheet's rates to utils/profiling.py")


def device_peak_tflops(device=None) -> float:
    """Peak TFLOP/s of the device (the first card when None): float32
    outside the tensor cores and float64 on the FP64 tensor cores of an
    H100 SXM, 67; 1.0 on the CPU.  An unknown card raises ValueError."""
    return _peaks(device)[0]


def device_peak_hbm_gbs(device=None) -> float:
    """Peak memory GB/s of the device (the first card when None): 3350 on
    an H100 SXM; 50.0 on the CPU.  An unknown card raises ValueError."""
    return _peaks(device)[1]


def flops_of(fn, *args) -> float:
    """Operations of fn(*args) as ``torch.utils.flop_counter`` counts them
    (matrix products and convolutions).  The hand-written kernels, which
    are launched through ctypes, are invisible to it, as Pallas calls are
    to XLA's cost analysis; the analytic models
    (``ops.structured.thomas_inv_flops``, the bounds below) count them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every ATen op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def bytes_of(fn, *args) -> float:
    """Bytes of fn(*args): each ATen op's tensor inputs and outputs, summed
    (the analogue of XLA's "bytes accessed").  It over-counts as XLA's
    does: a view or an operand that stays in cache counts at every use.
    The hand-written kernels, launched through ctypes, are invisible to
    it, as Pallas calls are to XLA, so the bandwidth utilization of the
    solves comes from ``ops.structured.thomas_inv_bytes``."""
    with _ByteCounter() as counter:
        fn(*args)
    return float(counter.bytes)


def _device_of(args):
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            return t.device
    return config.default_device()


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mfu_report(fn, *args, iters: int = 3, name: str = "fn") -> dict:
    """fn(*args)'s rate against the peaks of the device its first tensor
    argument lies on: one warm-up call, then the mean wall time of
    ``iters`` calls (the device synchronized after each), ``flops_of`` and
    ``bytes_of`` as numerators.  ``xla_bytes_ratio`` is the bytes' rate
    over the memory peak, a diagnostic that may exceed 1 (``bytes_of``
    over-counts), not a utilization.  Returns {name, flops, bytes,
    seconds, tflops, mfu, gbs, xla_bytes_ratio, device}."""
    device = _device_of(args)
    fn(*args)
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
        _synchronize(device)
    dt = (time.perf_counter() - t0) / iters
    fl, by = flops_of(fn, *args), bytes_of(fn, *args)
    peak, peak_bw = device_peak_tflops(device), device_peak_hbm_gbs(device)
    tflops = fl / dt / 1e12 if dt > 0 else 0.0
    gbs = by / dt / 1e9 if dt > 0 else 0.0
    return {
        "name": name,
        "flops": fl,
        "bytes": by,
        "seconds": dt,
        "tflops": tflops,
        "mfu": tflops / peak if peak else 0.0,
        "gbs": gbs,
        "xla_bytes_ratio": gbs / peak_bw if peak_bw else 0.0,
        "device": str(device),
    }


# -- the kernels' bounds on one H100 SXM -------------------------------------


def bound(flops: float, nbytes: float, dtype):
    """(ms, 'operations' or 'bytes'): the least time the card could take
    for ``flops`` operations in dtype and ``nbytes`` moved, the larger of
    the two at the peak rates."""
    ops = 1e3 * flops / PEAK_FLOPS[dtype]
    mem = 1e3 * nbytes / HBM_BYTES_PER_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def bound_keys(tag: str, ms: float, by: str) -> dict:
    """The JSON keys of a bound at the shape ``tag`` names."""
    return {f"bound_ms_{tag}": ms, f"bound_by_{tag}": by}


def _item(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def k1_bound(N, nb, s, dtype):
    """K1: per sample one s x s inverse (2 s^3) at row 0 and two products
    and an inverse (6 s^3) at each later row; the band read once, M and
    Dinv written once."""
    return bound(N * (6 * (nb - 1) + 2) * s**3, 5 * N * nb * s * s * _item(dtype),
                 dtype)


def k2_bound(N, nb, s, k, dtype):
    """K2: the 3 nb - 2 blocks of M, Dinv and B a sweep uses, each read
    once and applied to k columns (2 s^2 k); the rhs read and the solution
    written once."""
    blocks = N * (3 * nb - 2)
    return bound(2 * blocks * s * s * k,
                 (blocks * s * s + 2 * N * nb * s * k) * _item(dtype), dtype)


def k3_bound(N, s, dtype):
    """K3/K4: s^3 multiply-adds per matrix (in-place Gauss-Jordan), each
    matrix read and written once."""
    return bound(2 * N * s**3, 2 * N * s * s * _item(dtype), dtype)


def schur_bound(N: int, s: int, dtype):
    """(ms, 'operations' or 'bytes') of one Schur step of K1's rows: 4 N
    s^3 operations, and A_j, D_j, B_{j-1}, Dinv_{j-1} read and M_j, T_j
    written once."""
    return bound(4 * N * s**3, 6 * N * s * s * _item(dtype), dtype)
