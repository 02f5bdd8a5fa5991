"""One run of one cell: set-up, the measured window of whole passes, the
trace's reduction, and the check against the plain reference.

A pass is one input active subspace of the cell's configuration through
the program's own entry points, as the configuration's application builds
them (``applications/<application>.py``'s ``Program``), ending in a
device synchronize.  The pass's draws (the prior's white noise and the
GHEP's probe block) are made in set-up, on the device, from (seed, pass
index), and handed to the projector through its ``keychain`` and
``Omega_GN``, so no pass times noise generation, every pass solves new
samples, and the reference reads the same draws.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import torch

from . import check, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "hippyflow_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (the part before the first
    dot) is one of ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def mix(seed: int, *salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a salt."""
    x = int(seed) & ((1 << 64) - 1)
    for s in salt:
        x = (x * 6364136223846793005 + 1442695040888963407 + s * 0x9E3779B97F4A7C15)
        x = (x ^ (x >> 29)) & ((1 << 64) - 1)
    return x & ((1 << 63) - 1)


NOISE, OMEGA, SPARE, LANES, PICK = 1, 2, 3, 4, 5


@dataclass
class Draws:
    noise: torch.Tensor   # (n_samples, dM) the prior's white noise
    omega: torch.Tensor   # (dM, rank + oversampling) the GHEP's probes


DRAW_BUDGET = 2 << 30   # bytes of draws a run makes ahead
MAX_PASSES = 256


class DrawBank:
    """Every pass's draws, a pure function of (seed, pass index), made in
    set-up for ``capacity`` passes: as many as ``DRAW_BUDGET`` holds, at
    most ``MAX_PASSES``.  Pass p takes the draws of pass p mod capacity,
    so a window that outruns the bank repeats samples and never draws."""

    def __init__(self, seed, n_samples, dim, k, dtype, device):
        self.seed, self.shape = seed, ((n_samples, dim), (dim, k))
        self.dtype, self.device = dtype, device
        per = (n_samples + k) * dim * torch.empty((), dtype=dtype).element_size()
        self.capacity = max(1, min(MAX_PASSES, DRAW_BUDGET // per))
        self.made: dict[int, Draws] = {}

    def _make(self, p: int) -> Draws:
        out = []
        for salt, shape in zip((NOISE, OMEGA), self.shape):
            g = torch.Generator(device=self.device)
            g.manual_seed(mix(self.seed, salt, p + 2))
            out.append(torch.randn(shape, generator=g, dtype=self.dtype,
                                   device=self.device))
        return Draws(*out)

    def premake(self) -> None:
        for p in range(self.capacity):
            self.made[p] = self._make(p)

    def get(self, p: int) -> Draws:
        return self.made[p % self.capacity]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for d in self.made.values()
                   for t in (d.noise, d.omega))


def check_lanes(seed: int, p: int, n: int, count: int) -> torch.Tensor:
    """The ``count`` samples of pass ``p`` whose m, u and J the check
    compares, drawn from the seed, in order."""
    g = torch.Generator().manual_seed(mix(seed, LANES, p + 2))
    return torch.randperm(n, generator=g)[:count].sort().values


class PassNoise:
    """The pass's ``keychain``: ``normal`` hands out the pre-made noise
    rows in order; draws beyond them (resampled lanes) come from
    generators of their own, seeded from (seed, pass, draw)."""

    def __init__(self, noise, seed, p):
        self.noise, self.used = noise, 0
        self.seed, self.p = seed, p
        self.device = noise.device
        self.extra = 0

    def normal(self, shape, dtype=None, sigma: float = 1.0):
        b = shape[0]
        if len(shape) == 2 and shape[1] == self.noise.shape[1] and \
                self.used + b <= self.noise.shape[0]:
            x = self.noise[self.used:self.used + b]
            self.used += b
        else:
            g = torch.Generator(device=self.device)
            g.manual_seed(mix(self.seed, SPARE, self.p + 2, self.extra))
            x = torch.randn(shape, generator=g, dtype=self.noise.dtype,
                            device=self.device)
            self.extra += 1
        x = x if dtype is None else x.to(dtype)
        return x if sigma == 1.0 else sigma * x


@dataclass
class PassRecord:
    """What one pass left for the metrics and the check."""
    index: int
    stage_seconds: dict = field(default_factory=dict)
    n_samples: int = 0
    n_failures: int = 0
    error: str | None = None
    lanes: torch.Tensor | None = None
    seconds: float = 0.0  # wall seconds of the pass
    # device scalars, read after the window
    finite: torch.Tensor | None = None
    iterations: torch.Tensor | None = None
    coarse_iterations: list = field(default_factory=list)
    # host copies (pinned on a card), filled without a synchronize
    kept: dict = field(default_factory=dict)


class Keeper:
    """Host buffers for what the check reads of each pass: d, V and q of
    every sample, and m, u and J of the pass's check lanes.  Pinned and
    preallocated on a card, so each pass's copies queue on the stream
    without a synchronize."""

    def __init__(self, shapes: dict, capacity: int, pinned: bool):
        self.shapes, self.pinned = shapes, pinned
        self.free = [self._alloc() for _ in range(capacity)]

    def _alloc(self):
        return {k: torch.empty(s, dtype=torch.float32, pin_memory=self.pinned)
                for k, s in self.shapes.items()}

    def keep(self, tensors: dict) -> dict:
        bufs = self.free.pop() if self.free else self._alloc()
        for k, t in tensors.items():
            bufs[k].copy_(t.detach().to(torch.float32), non_blocking=self.pinned)
        return bufs


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class RunResult:
    """A finished run, as the metric readers and the check see it."""
    cell: spec.Cell
    seed: int
    passes: list
    window_s: float
    setup_s: float
    bands: list   # (nb, s) of each Newton level's band, fine first
    dq: int
    trace: trace.TraceSummary | None = None
    band_kernels: set = field(default_factory=set)
    peak_bytes: int = 0


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_process: float, log=None) -> tuple[RunResult, DrawBank, object]:
    """Set-up and the measured window.  Returns the run, the draws and
    the program (whose state the caller frees before the reference)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    on_card = device.type == "cuda"
    prog = cell.application.Program(cell, device)
    cfg, traffic = cell.config, cell.traffic
    n, dim, dq = cfg["samples_per_process"], prog.dim, prog.dq
    k = cfg["rank"] + cfg["oversampling"]
    bank = DrawBank(seed, n, dim, k, prog.dtype, device)
    L = min(n, traffic["check_lanes_per_pass"])

    # one warm pass of this cell's shapes, on draws of a pass index of
    # its own: it pays the first calls (the kernel library's load, lazy
    # imports); then the draws of the window's passes
    warm = bank._make(-1)
    t0 = time.perf_counter()
    prog.run_pass(warm, PassNoise(warm.noise, seed, -1))
    _sync(device)
    t_warm = time.perf_counter() - t0
    del warm
    bank.premake()
    keeper = Keeper({"d": (cfg["rank"],), "V": (dim, cfg["rank"]), "q": (n, dq),
                     "m": (L, dim), "u": (L, prog.state_dim),
                     "J": (L, dq, dim)},
                    bank.capacity, pinned=on_card)
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_process
    log(f"set-up {setup_s:.3f} s (warm pass {t_warm:.3f} s, draws for "
        f"{bank.capacity} passes)")

    passes: list[PassRecord] = []
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts, record_shapes=False, with_stack=False,
                       profile_memory=False)
        prof.__enter__()
        window_range = record_function(trace.WINDOW)
        window_range.__enter__()
    t_w0 = time.perf_counter()
    p = 0
    while True:
        t_pass = time.perf_counter()
        rec = PassRecord(index=p, lanes=check_lanes(seed, p, n, L))
        draws = bank.get(p)
        noise = PassNoise(draws.noise, seed, p)
        try:
            proj, d, V, E = prog.run_pass(draws, noise)
            s = proj.samples
            rec.stage_seconds = dict(proj.stage_seconds)
            rec.n_samples, rec.n_failures = s.ms.shape[0], s.n_failures
            rec.finite = (torch.isfinite(d).all() & torch.isfinite(V).all()
                          & torch.isfinite(E).all())
            rec.iterations = s.iterations.sum()
            rec.coarse_iterations = prog.coarse_iterations()
            lanes = torch.as_tensor(rec.lanes, device=device)
            rec.kept = keeper.keep({"d": d, "V": V, "q": s.qs, "m": s.ms[lanes],
                                    "u": s.us[lanes], "J": proj.Js[lanes]})
            del proj, s, d, V, E
        except Exception as exc:  # a pass that raises is a failed pass
            import traceback

            rec.error = "".join(traceback.format_exception_only(exc)).strip()
            log(f"pass {p} failed: {rec.error}")
            traceback.print_exc(file=sys.stderr)
            _sync(device)
        rec.seconds = time.perf_counter() - t_pass
        passes.append(rec)
        p += 1
        if time.perf_counter() - t_w0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t_w0
    log("pass seconds: " + " ".join(f"{r.seconds:.3f}" for r in passes))
    summary = None
    if traced:
        window_range.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        t1 = time.perf_counter()
        summary = trace.summarize(prof)
        del prof
        log(f"trace reduced in {time.perf_counter() - t1:.1f} s")
    peak = 0
    if on_card:
        peak = torch.cuda.max_memory_allocated(device) - bank.nbytes()
    if len(passes) > bank.capacity:
        log(f"{len(passes)} passes on the draws of {bank.capacity}: passes "
            f"from {bank.capacity} on repeat their samples")
    result = RunResult(cell=cell, seed=seed, passes=passes, window_s=window_s,
                       setup_s=setup_s, bands=prog.bands, dq=dq,
                       trace=summary, band_kernels=spec.band_kernel_names(),
                       peak_bytes=peak)
    return result, bank, prog


def finish_passes(result: RunResult) -> None:
    """Read the passes' device scalars (after the window)."""
    for rec in result.passes:
        if rec.error is None:
            rec.finite = bool(rec.finite)
            rec.iterations = int(rec.iterations)
            rec.coarse_iterations = [int(t) for t in rec.coarse_iterations]


def failed_passes(result: RunResult) -> list[int]:
    """The passes that raised or gave a non-finite d, V or encoder."""
    return [r.index for r in result.passes if r.error is not None or not r.finite]


def free_program(prog, device) -> None:
    prog.free()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def band_need_seconds(result: RunResult) -> float:
    """The least seconds of the band work of the window's passes, as the
    cell's application counts a pass's."""
    total = 0.0
    dtype = result.cell.config["dtype"]
    need = result.cell.application.band_need_seconds
    for rec in result.passes:
        if rec.error is not None:
            continue
        levels = [(result.bands[0], rec.iterations)] + list(
            zip(result.bands[1:], rec.coarse_iterations))
        total += need(levels, result.dq, rec.n_samples, dtype)
    return total


def pick_pass(result: RunResult) -> int | None:
    """The pass the reference follows whole, drawn from the seed among
    the window's passes that finished without resampling a lane (the
    reference follows each lane's first draw)."""
    done = [r.index for r in result.passes if r.error is None
            and not r.n_failures]
    if not done:
        return None
    g = torch.Generator().manual_seed(mix(result.seed, PICK))
    return done[int(torch.randint(len(done), (1,), generator=g))]


def reference_check(result: RunResult, bank: DrawBank, device, log=None):
    """Run the reference on the picked pass whole and on every pass's
    check lanes, and compare.  Returns check.Outcome."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t0 = time.perf_counter()
    k = pick_pass(result)
    outcome = check.compare_run(result, bank, k, device)
    resampled = [r.index for r in result.passes if r.n_failures]
    log(f"reference check of pass {k} and {outcome.n_lanes} lanes in "
        f"{time.perf_counter() - t0:.1f} s; passes that resampled lanes "
        f"(left out): {resampled}")
    return outcome
