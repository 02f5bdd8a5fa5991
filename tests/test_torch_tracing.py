"""The port's spans and counters below the stages, on the CPU: every span of
``utils.profiling.SPANS`` appears under its stage in a profiled
``construct_input_subspace()`` of a tiny grid-sequenced confusion problem;
no span enters ``record_function`` while no profiler records; the
host-sync counter counts one ``newton.sync`` per Newton round and resets;
a ``Tally`` keeps apart what it counted inside a profiler session; the
output subspace's and the data generator's stages are ``PhaseTimer``
phases with ranges of their names."""

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from hippyflow_tpu_torch.applications.confusion import (
    confusion_linear_observable,
    confusion_prior,
)
from hippyflow_tpu_torch.fem import coarse_newton_warm_start
from hippyflow_tpu_torch.models import (
    ActiveSubspaceParameterList,
    ActiveSubspaceProjector,
    DataGenerator,
)
from hippyflow_tpu_torch.utils import KeyChain
from hippyflow_tpu_torch.utils import profiling

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, N_SAMPLES = 8, 6
STAGES = ("forward", "jacobian", "ghep")
# the stage each span is expected under in this pass
UNDER = {
    "newton.solve": "forward", "newton.sync": "forward",
    "fem.residual": "forward", "fem.assemble": "jacobian",
    "fem.apply_c": "jacobian", "band.factorize": "jacobian",
    "band.solve": "jacobian", "prior.sample": "forward",
    "prior.solve": "ghep", "warm_start": "forward",
    "sample.resample": "forward",
}


def _projector(monkeypatch=None):
    """A projector of 6 samples at nx=8, Newton warm-started from nx=4;
    with ``monkeypatch``, the fine problem's first solve reports lane 0
    unconverged, so that one resampling sweep runs."""
    obs, Vh = confusion_linear_observable(nx=NX, sqrt_n_obs=3,
                                          velocity="analytic", **F64)
    prior = confusion_prior(Vh, **F64)
    obs_c, Vc = confusion_linear_observable(nx=NX // 2, sqrt_n_obs=3,
                                            velocity="analytic", **F64)
    p = ActiveSubspaceParameterList()
    p["samples_per_process"], p["rank"], p["oversampling"] = N_SAMPLES, 3, 2
    p["verbose"] = False
    p["coarse_warm_start"] = coarse_newton_warm_start(prior, obs_c.problem, Vh,
                                                      Vc)
    if monkeypatch is not None:
        problem, solve = obs.problem, obs.problem.solve_fwd
        calls = []

        def first_lane_fails(m, z=None, u0=None):
            u, info = solve(m, z=z, u0=u0)
            if not calls:
                ok = info.converged.clone()
                ok[0] = False
                info = info._replace(converged=ok)
            calls.append(m.shape[0])
            return u, info

        monkeypatch.setattr(problem, "solve_fwd", first_lane_fails)
    proj = ActiveSubspaceProjector(obs, prior, parameters=p)
    proj.keychain = KeyChain(3, "cpu")
    return proj


def _stages_above(event):
    names, e = [], event.cpu_parent
    while e is not None:
        names.append(e.name)
        e = e.cpu_parent
    return [n for n in names if n in STAGES]


def test_every_span_nests_under_its_stage(monkeypatch):
    proj = _projector(monkeypatch)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        proj.construct_input_subspace()
    found = {}
    for e in prof.events():
        if e.name in profiling.SPANS:
            found.setdefault(e.name, set()).update(_stages_above(e)[:1])
    assert set(found) == set(profiling.SPANS)
    for name, stages in found.items():
        assert UNDER[name] in stages, (name, stages)
    assert proj.samples.n_failures == 1
    # each span's host seconds, and the syncs of the pass inside the session
    assert set(profiling.span_seconds) == set(profiling.SPANS)
    assert all(t > 0 for t in profiling.span_seconds.values())
    syncs = profiling.host_syncs
    assert syncs.traced == syncs
    assert syncs["sample.converged"] == 1 and syncs["sample.resample"] == 2
    assert syncs["newton.sync"] >= 4  # two levels, and the resampled lanes
    profiling.reset_counters()
    assert not profiling.host_syncs and not profiling.host_syncs.traced
    assert not profiling.span_seconds


def test_no_span_enters_record_function_without_a_profiler(monkeypatch):
    proj = _projector()
    entered = []

    class Counting(autograd_profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", False)
    profiling.reset_counters()
    proj.construct_input_subspace()
    assert not set(entered) & set(profiling.SPANS)
    assert set(STAGES) <= set(entered)  # the stages keep their ranges
    assert not profiling.span_seconds
    assert profiling.host_syncs["newton.sync"] > 0
    assert not profiling.host_syncs.traced


@pytest.mark.parametrize("traced", [False, True])
def test_host_syncs_count_one_newton_sync_a_round(traced):
    obs, Vh = confusion_linear_observable(nx=NX, sqrt_n_obs=3,
                                          velocity="analytic", **F64)
    prior = confusion_prior(Vh, **F64)
    m = prior.sample(torch.randn(4, Vh.dim, generator=torch.Generator()
                                 .manual_seed(1), **F64))
    profiling.reset_counters()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            _, info = obs.problem.solve_fwd(m)
    else:
        _, info = obs.problem.solve_fwd(m)
    rounds = int(info.iterations.max()) + 1  # the last finds no lane active
    assert info.iterations.max() >= 2
    assert profiling.host_syncs == {"newton.sync": rounds}
    assert profiling.host_syncs.traced == ({"newton.sync": rounds} if traced
                                           else {})
    profiling.reset_counters()
    assert profiling.host_syncs == {}


def test_tally_keeps_what_a_profiler_session_saw_apart():
    tally = profiling.Tally()
    tally.add("a")
    with profile(activities=[ProfilerActivity.CPU]):
        tally.add("a", 2)
        tally.add(("k3", 4, 65, 1, 0, "float32"))
    tally.add("b")
    assert tally == {"a": 3, "b": 1, ("k3", 4, 65, 1, 0, "float32"): 1}
    assert tally.traced == {"a": 2, ("k3", 4, 65, 1, 0, "float32"): 1}
    tally.clear()
    assert tally == {} and tally.traced == {}


def test_a_fine_span_is_not_entered_inside_one_of_its_name():
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("prior.solve", fine=True, N=2):
            with profiling.annotate("prior.solve", fine=True):
                with profiling.annotate("band.solve", fine=True):
                    torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert names.count("prior.solve") == 1 and names.count("band.solve") == 1
    assert set(profiling.span_seconds) == {"prior.solve", "band.solve"}
    profiling.reset_counters()


def test_output_subspace_and_data_generator_stages_are_ranges(tmp_path):
    proj = _projector()
    gen = DataGenerator(proj.observable, proj.prior,
                        settings={"verbose": False, "chunk_size": 3, "rM": 2})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        proj.construct_output_subspace()
        gen.generate(N_SAMPLES, derivatives=(1, 0), data_dir=str(tmp_path))
    names = {e.name for e in prof.events()}
    assert {"forward", "jacobian", "hep", "write"} <= names
    assert proj._output_subspace_construction_time > 0
    assert set(gen.stage_seconds) == {"forward", "jacobian", "jacobian_z",
                                      "write"}
    assert gen.stage_seconds["jacobian_z"] == 0.0
    assert all(gen.stage_seconds[k] > 0 for k in ("forward", "jacobian",
                                                  "write"))
