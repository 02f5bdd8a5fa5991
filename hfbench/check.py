"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (float64; the cell's application builds it from ``reference/``)
takes the draws of one pass, picked from the seed among the window's
finished passes, and works out its whole pass again: every sample's prior
sample, state solve, observations and Jacobian, and the randomized GHEP
over them with the pass's probe block (``input_subspace``).
It also solves the check lanes (a few samples of every other pass, drawn
from the seed).  The numbers compared, each against its limit from the
cell's workload file:

* ``m_gap``: the prior samples of the lanes (the prior's solves): the
  largest |m - m_ref| / |m_ref|;
* ``u_gap``: the lanes' states (the state solves through K1 and K2), the
  same;
* ``q_gap``: the observations of every sample of the picked pass and of
  the lanes, the same;
* ``J_gap``: the lanes' Jacobians (the adjoint solves of K2's panels),
  the largest |J - J_ref|_F / |J_ref|_F;
* ``d_gap``: the picked pass's eigenvalues, max_k |d_k - d_ref,k| / d_ref,0;
* ``V_gap``: its decoder: each column v_k, normalized in the R norm,
  projected R-orthogonally off the reference's decoder; the residuals'
  squared R norms weighted by d_ref,k, over the sum of d_ref:
  sqrt(sum_k d_ref,k |(I - V_ref V_ref^T R) v_k|_R^2 / sum_k d_ref,k).

The reference sees only the cell's inputs; the program's outputs are
read only to be judged.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


NAMES = ("m_gap", "u_gap", "q_gap", "J_gap", "d_gap", "V_gap")


@dataclass
class Answers:
    """What one side produced for one pass: d, V and the observations of
    every sample (or None), and m, u, q, J of the lanes ``lanes``."""
    lanes: torch.Tensor
    m: torch.Tensor
    u: torch.Tensor
    J: torch.Tensor
    q: torch.Tensor | None = None         # (N, dq), all samples
    d: torch.Tensor | None = None
    V: torch.Tensor | None = None


@dataclass
class Outcome:
    values: dict
    limits: dict
    n_lanes: int = 0
    notes: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.notes and all(
            self.values.get(k, float("inf")) <= v for k, v in self.limits.items())


def _rel(a, b, dims):
    a, b = a.to(torch.float64), b.to(torch.float64)
    return (torch.linalg.vector_norm(a - b, dim=dims)
            / torch.linalg.vector_norm(b, dim=dims)).max().item()


def solve_samples(problem, noise, strict: bool = True):
    """(m, u, q, J) of the reference ``problem`` for white noise (N, n), in
    batches of its ``batch_size()``.  ``strict``: a state solve that does
    not converge raises (the float64 reference); a stand-in in a lower
    precision answers what it reached."""
    out = {"m": [], "u": [], "q": [], "J": []}
    b = problem.batch_size()
    for a in range(0, noise.shape[0], b):
        xi = noise[a:a + b].to(problem.dtype)
        m = problem.sample(xi)
        u, ok, _ = problem.solve(m)
        if strict and not bool(ok.all()):
            raise RuntimeError(f"the reference's state solve did not converge "
                               f"on {int((~ok).sum())} samples")
        out["m"].append(m)
        out["u"].append(u)
        out["q"].append(problem.observe(u))
        out["J"].append(problem.jacobians(u, m))
    return {k: torch.cat(v) for k, v in out.items()}


def input_subspace(problem, Js, Omega, rank: int):
    """(d (rank,), V (n, rank)) of the randomized GHEP H v = lambda R v,
    H = mean_i J_i^T J_i, from the probe block Omega (n, rank + p): Y =
    R^{-1} H Omega, an R-orthonormal basis Q of its span, and the Ritz
    pairs of Q^T H Q, every product through the problem's ``ar``."""
    mm = problem.ar.mm
    Jf = Js.reshape(-1, Js.shape[-1])                          # (N dq, n)
    N = Js.shape[0]
    H = lambda X: mm(Jf.T, mm(Jf, X)) / N
    Y = problem.Rinv(H(Omega))
    Q = torch.linalg.qr(Y).Q
    for _ in range(2):                                         # R-orthonormal
        G = mm(Q.T, problem.R(Q))
        L = torch.linalg.cholesky(0.5 * (G + G.T))
        Q = torch.linalg.solve_triangular(L, Q.T, upper=False).T
    T = mm(Q.T, H(Q))
    lam, W = torch.linalg.eigh(0.5 * (T + T.T))
    order = torch.argsort(lam, descending=True)[:rank]
    return lam[order], mm(Q, W[:, order])


def v_gap(problem, d_ref, V_ref, V):
    """The d_ref-weighted R-norm residual of V off span(V_ref)."""
    V = V.to(problem.dtype)
    RV = problem.R(V)
    V = V / torch.sqrt((V * RV).sum(0))
    res = V - V_ref @ (V_ref.T @ problem.R(V))
    r2 = (res * problem.R(res)).sum(0).clamp(min=0)
    w = d_ref.clamp(min=0)
    return torch.sqrt((w * r2).sum() / w.sum()).item()


def solve_reference(problem, draws: dict, lanes: dict, picked: int,
                    rank: int) -> dict:
    """The reference's answers: the pass ``picked`` whole (q of every
    sample, d and V of its GHEP on its probe block) and the lanes
    {pass: indices} of every pass, from the passes' ``draws`` {pass:
    harness.Draws}: {"q", "d", "V", "lanes": {pass: {m, u, q, J}}}."""
    dev = problem.device
    whole = solve_samples(problem, draws[picked].noise.to(dev))
    d, V = input_subspace(problem, whole["J"],
                          draws[picked].omega.to(dev, problem.dtype), rank)
    out = {"q": whole["q"], "d": d, "V": V, "lanes": {}}
    if picked in lanes:
        idx = lanes[picked].to(dev)
        out["lanes"][picked] = {k: v[idx] for k, v in whole.items()}
    del whole
    others = [p for p in sorted(lanes) if p != picked]
    if others:
        noise = torch.cat([draws[p].noise.to(dev)[lanes[p].to(dev)] for p in others])
        solved = solve_samples(problem, noise)
        a = 0
        for p in others:
            b = a + len(lanes[p])
            out["lanes"][p] = {k: v[a:b] for k, v in solved.items()}
            a = b
    return out


def judge(problem, ref: dict, answers: dict, picked: int) -> tuple[dict, int]:
    """The numbers compared (``NAMES``) for a side's ``answers`` {pass:
    Answers} against the reference's (``solve_reference``).  Returns
    (values, number of lanes compared)."""
    dev = problem.device
    ans = answers[picked]
    vals = {k: 0.0 for k in NAMES}
    vals["q_gap"] = _rel(ans.q.to(dev), ref["q"], 1)
    vals["d_gap"] = ((ans.d.to(dev, torch.float64) - ref["d"]).abs().max()
                     / ref["d"][0]).item()
    vals["V_gap"] = v_gap(problem, ref["d"], ref["V"], ans.V.to(dev))
    n_lanes = 0
    for p, r in ref["lanes"].items():
        ans = answers[p]
        lanes = ans.lanes.to(dev)
        vals["m_gap"] = max(vals["m_gap"], _rel(ans.m.to(dev), r["m"], 1))
        vals["u_gap"] = max(vals["u_gap"], _rel(ans.u.to(dev), r["u"], 1))
        vals["q_gap"] = max(vals["q_gap"], _rel(ans.q.to(dev)[lanes], r["q"], 1))
        vals["J_gap"] = max(vals["J_gap"], _rel(ans.J.to(dev), r["J"], (1, 2)))
        n_lanes += len(lanes)
    return vals, n_lanes


def compare(problem, answers: dict, draws: dict, picked: int,
            rank: int) -> tuple[dict, int]:
    """``judge`` of ``answers`` against ``solve_reference`` on the same
    draws and lanes."""
    ref = solve_reference(problem, draws, {p: a.lanes for p, a in answers.items()},
                          picked, rank)
    return judge(problem, ref, answers, picked)


def compare_run(result, bank, picked, device) -> Outcome:
    """The check of a harness run (``harness.RunResult``)."""
    cfg = result.cell.config
    limits = dict(result.cell.limits)
    notes = []
    from .harness import failed_passes

    failed = failed_passes(result)
    if failed:
        notes.append(f"passes that raised or gave non-finite output: {failed}")
    if picked is None:
        return Outcome({}, limits, 0, notes + ["no pass finished without "
                                               "resampling a lane"])
    # the reference follows each lane's first draw: a pass that resampled
    # lanes leaves its lanes out
    resampled = [r.index for r in result.passes if r.n_failures]
    answers = {}
    for r in result.passes:
        if r.error is not None or r.index in resampled:
            continue
        kept = r.kept
        answers[r.index] = Answers(
            lanes=r.lanes, m=kept["m"], u=kept["u"], J=kept["J"],
            q=kept["q"], d=kept["d"] if r.index == picked else None,
            V=kept["V"] if r.index == picked else None)
    problem = result.cell.application.reference(result.cell, torch.float64,
                                                device)
    draws = {p: bank.get(p) for p in answers}
    values, n_lanes = compare(problem, answers, draws, picked, cfg["rank"])
    return Outcome(values, limits, n_lanes, notes)
