"""The readings that the limits of the correctness check are set from.

    python3 hfbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--sides program tf32 float32] [--lanes 110]

For each seed, on the draws of the run's first pass (``harness.DrawBank``
at pass 0), each side answers one whole pass and ``lanes`` check lanes,
as many as a run of the cell compares, and the check that decides
``correct`` (``check.compare`` against the float64 reference) judges it:

* ``program``: the program, through the harness's own pass (the cell's
  application's ``Program``);
* ``tf32``, the control: the plain reference (the application's
  ``reference``) put in the program's place one precision below the
  configuration's float32 (float32 data, every product with TF32
  operands, ``reference.blocktri.Arith``);
* ``float32``: the reference in float32 with exact products, the rounding
  level of the configuration's own precision;
* ``half_batch``, a fault planted in the program (``FAULTS``): E[J^T J]
  over the first half of the pass's samples;
* ``stale``, a fault: the program's answers to the previous seed's pass
  (its samples, states, Jacobians and its d and V) given for this one, as
  a pass that hands on another pass's state or GHEP would.

The program is built once for all seeds.  Each (seed, side) prints one
JSON line.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _stale_state(setattr):
    """The sampling step hands every pass the state of the first pass it
    made: its samples, states and observations, unchanged."""
    from hippyflow_tpu_torch.models import active_subspace

    orig, first = active_subspace.sample_until_solved, []

    def stale(*args, **kwargs):
        first.append(orig(*args, **kwargs))
        return first[0]

    setattr(active_subspace, "sample_until_solved", stale)


def _half_batch(setattr):
    """E[J^T J] over the first half of the samples only."""
    from hippyflow_tpu_torch.models import ActiveSubspaceProjector

    def half(self, operation):
        n = self.Js.shape[0] // 2
        Jf = self.Js[:n].reshape(-1, self.Js.shape[-1])
        return lambda X: Jf.T @ (Jf @ X) / n

    setattr(ActiveSubspaceProjector, "_avg_gn_operator", half)


def _altered_answer(setattr):
    """The first observation of every chunk altered by a half where it is
    produced."""
    from hippyflow_tpu_torch.models import LinearStateObservable

    orig = LinearStateObservable.evalu

    def altered(self, u):
        q = orig(self, u).clone()
        q[0] *= 1.5
        return q

    setattr(LinearStateObservable, "evalu", altered)


# faults planted in the program, each through a ``setattr(obj, name,
# value)`` (a monkeypatch's, or ``planted``'s)
FAULTS = {"stale_state": _stale_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``FAULTS[name]`` in place for the ``with`` block."""
    saved = []

    def put(obj, attr, value):
        saved.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, value)

    FAULTS[name](put)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            if value is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, value)


def program_answers(prog, draws, seed: int, lanes):
    """The program's answers to one pass (``check.Answers``)."""
    from hfbench import check, harness

    proj, d, V, _ = prog.run_pass(draws, harness.PassNoise(draws.noise, seed, 0))
    s, idx = proj.samples, lanes.to(d.device)
    if s.n_failures:
        raise RuntimeError(f"seed {seed}: {s.n_failures} resampled lanes")
    return check.Answers(lanes=lanes, m=s.ms[idx], u=s.us[idx],
                         J=proj.Js[idx], q=s.qs, d=d, V=V)


def stand_in_answers(cell, draws, lanes, precision: str, device):
    """The reference's answers in float32, with TF32 products or exact."""
    import torch

    from hfbench import check
    from hfbench.reference import blocktri

    cfg = cell.config
    stand_in = cell.application.reference(
        cell, torch.float32, device, blocktri.Arith(tf32=precision == "tf32"))
    out = check.solve_samples(stand_in, draws.noise, strict=False)
    d, V = check.input_subspace(stand_in, out["J"], draws.omega, cfg["rank"])
    idx = lanes.to(device)
    return check.Answers(lanes=lanes, m=out["m"][idx], u=out["u"][idx],
                         J=out["J"][idx], q=out["q"], d=d, V=V)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["program", "tf32"],
                    choices=("program", "tf32", "float32", "half_batch", "stale"))
    ap.add_argument("--lanes", type=int, default=None,
                    help="check lanes a seed compares (default: the traffic's "
                         "lanes per pass)")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from hfbench import check, harness, spec

    cell = spec.load_cell(args.workload)
    cfg = cell.config
    n, rank = cfg["samples_per_process"], cfg["rank"]
    count = min(n, args.lanes or cell.traffic["check_lanes_per_pass"])
    truth = cell.application.reference(cell, torch.float64, args.device)
    on_program = {"program", "half_batch", "stale"} & set(args.sides)
    prog = cell.application.Program(cell, args.device) if on_program else None
    previous = None  # the program's answers to the previous seed's pass
    for seed in args.seeds:
        bank = harness.DrawBank(seed, n, truth.n, rank + cfg["oversampling"],
                                torch.float32, args.device)
        draws = bank._make(0)
        lanes = harness.check_lanes(seed, 0, n, count)
        t0 = time.perf_counter()
        ref = check.solve_reference(truth, {0: draws}, {0: lanes}, 0, rank)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "reference", "seconds":
                          round(time.perf_counter() - t0, 1)}), flush=True)
        current = None
        for side in args.sides:
            t0 = time.perf_counter()
            if side in ("program", "stale"):
                current = current or program_answers(prog, draws, seed, lanes)
                answers = current if side == "program" else previous
            elif side == "half_batch":
                with planted("half_batch"):
                    answers = program_answers(prog, draws, seed, lanes)
            else:
                answers = stand_in_answers(cell, draws, lanes, side, args.device)
            if answers is None:  # no previous pass to be stale from
                continue
            if side == "stale":
                answers = check.Answers(lanes=lanes, **{
                    k: getattr(answers, k) for k in ("m", "u", "J", "q", "d", "V")})
            values, n_lanes = check.judge(truth, ref, {0: answers}, 0)
            del answers
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "lanes": n_lanes, "values": values,
                              "seconds": round(time.perf_counter() - t0, 1)}),
                  flush=True)
        previous = current
    return 0


if __name__ == "__main__":
    sys.exit(main())
