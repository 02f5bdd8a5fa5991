"""The confusion problem, its BiLaplacian prior and the input active
subspace, worked out plainly from the cell's inputs.

The discrete problem (hIPPYflow's confusion application): P1 elements on
the unit square cut into nx x nx squares, each split along its rising
diagonal, vertices numbered row by row; homogeneous Dirichlet values on
the boundary; the residual of the form

    (h/|v|) (v . grad u)(v . grad p) + k grad u . grad p
  + (v . grad u) p + c e^m u^3 p - f p

integrated by the 6-point degree-4 Dunavant rule, with v and f the P1
interpolants of their vertex values, |v| = sqrt(v . v + 1e-6), h the
cell's longest edge and f = max(0.5, exp(-25 |x - (0.7, 0.7)|^2)).  The
observations are the P1 interpolant of u at a sqrt_n x sqrt_n grid of
points in [0.6, 0.8]^2.

The prior: M the P1 mass matrix, A the stiffness of the constant tensor
of hippylib's AnisTensor2D(theta0=2, theta1=0.5, alpha=pi/4),
K = gamma A + delta M, precision R = K M^{-1} K, and a sample from white
noise xi is K^{-1} L xi with M = L L^T (the Cholesky factor).

The input active subspace: H = mean_i J_i^T J_i over the samples'
Jacobians J_i = dq/dm = -B A_i^{-1} C_i, and the randomized GHEP
H v = lambda R v from one probe block Omega: Y = R^{-1} H Omega, an
R-orthonormal basis Q of its span, and the Ritz pairs of Q^T H Q.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import blocktri as bt

# Dunavant's 6-point rule of degree 4 on the reference triangle
# {x, y >= 0, x + y <= 1}; the weights sum to 1/2.
_A1, _B1 = 0.445948490915965, 0.108103018168070
_A2, _B2 = 0.091576213509771, 0.816847572980459
_W1, _W2 = 0.223381589678011 / 2.0, 0.109951743655322 / 2.0
QUAD_POINTS = np.array([[_A1, _A1], [_B1, _A1], [_A1, _B1],
                        [_A2, _A2], [_B2, _A2], [_A2, _B2]])
QUAD_WEIGHTS = np.array([_W1, _W1, _W1, _W2, _W2, _W2])


def unit_square(nx: int):
    """(vertices (n, 2), cells (nc, 3)) of the unit square: vertex
    (i, j) is number j (nx + 1) + i, and each square splits into
    (v00, v10, v11) and (v00, v11, v01)."""
    xs = np.linspace(0.0, 1.0, nx + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)
    i, j = np.meshgrid(np.arange(nx), np.arange(nx), indexing="xy")
    v00 = (j * (nx + 1) + i).ravel()
    v10, v01 = v00 + 1, v00 + nx + 1
    v11 = v01 + 1
    cells = np.stack([np.stack([v00, v10, v11], 1),
                      np.stack([v00, v11, v01], 1)], 1).reshape(-1, 3)
    return vertices, cells


def observation_matrix(nx: int, sqrt_n: int) -> np.ndarray:
    """B (sqrt_n^2, (nx + 1)^2): the P1 interpolant at the grid of
    targets in [0.6, 0.8]^2, listed as the source lists them: for each x,
    every y."""
    s = nx + 1
    pts = np.linspace(0.6, 0.8, sqrt_n)
    B = np.zeros((sqrt_n * sqrt_n, s * s))
    for t, (x, y) in enumerate((x, y) for x in pts for y in pts):
        i = min(int(math.floor(x * nx)), nx - 1)
        j = min(int(math.floor(y * nx)), nx - 1)
        xi, eta = x * nx - i, y * nx - j
        v00 = j * s + i
        v10, v01, v11 = v00 + 1, v00 + s, v00 + s + 1
        if xi >= eta:
            B[t, [v00, v10, v11]] = [1.0 - xi, xi - eta, eta]
        else:
            B[t, [v00, v11, v01]] = [1.0 - eta, xi, eta - xi]
    return B


def aniso_tensor(theta0=2.0, theta1=0.5, alpha=math.pi / 4.0) -> np.ndarray:
    sa, ca = math.sin(alpha), math.cos(alpha)
    return np.array([[theta0 * sa * sa + theta1 * ca * ca, (theta0 - theta1) * sa * ca],
                     [(theta0 - theta1) * sa * ca, theta0 * ca * ca + theta1 * sa * sa]])


class Confusion:
    """The cell's problem on one device in one dtype; products through
    ``arith`` (``blocktri.Arith``)."""

    def __init__(self, nx: int, velocity: np.ndarray, sqrt_n_obs: int = 10,
                 c: float = 1.0, k: float = 0.01, gamma: float = 0.1,
                 delta: float = 1.0, dtype=torch.float64, device="cpu",
                 arith: bt.Arith = bt.EXACT):
        self.nx, self.s = nx, nx + 1
        self.n = self.s * self.s
        self.dtype, self.device, self.ar = dtype, torch.device(device), arith
        self.c, self.k = c, k
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)
        verts, cells = unit_square(nx)
        x = verts[cells]                                        # (nc, 3, 2)
        J = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]], axis=2)
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        area = np.abs(det) / 2.0
        # physical gradients of the three P1 basis functions (nc, 3, 2)
        ref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        grads = np.einsum("cdk,id->cik", np.linalg.inv(J), ref)
        edges = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 1], x[:, 0] - x[:, 2]], 1)
        h = np.sqrt((edges ** 2).sum(-1)).max(axis=1)
        lam = np.stack([1.0 - QUAD_POINTS.sum(1), QUAD_POINTS[:, 0],
                        QUAD_POINTS[:, 1]], axis=1)             # (6, 3)
        wdet = 2.0 * QUAD_WEIGHTS[None, :] * area[:, None]      # (nc, 6)
        vel = np.asarray(velocity, dtype=np.float64)
        vq = np.einsum("qi,cid->cqd", lam, vel[cells])          # (nc, 6, 2)
        f = np.maximum(0.5, np.exp(-25.0 * ((verts[:, 0] - 0.7) ** 2
                                            + (verts[:, 1] - 0.7) ** 2)))
        fq = lam @ f[cells].T                                   # (6, nc)
        vG = np.einsum("cqd,cid->cqi", vq, grads)              # v . grad phi_i
        tau = h[:, None] / np.sqrt((vq * vq).sum(-1) + 1e-6)    # (nc, 6)
        # the u-independent part of the element Jacobian
        A0 = (np.einsum("cq,cq,cqi,cqj->cij", wdet, tau, vG, vG)
              + k * area[:, None, None] * np.einsum("cid,cjd->cij", grads, grads)
              + np.einsum("cq,cqj,qi->cij", wdet, vG, lam))
        self.cells = torch.as_tensor(cells, device=self.device)
        self._grads, self._lam, self._wdet = t(grads), t(lam), t(wdet)
        self._vq, self._vG, self._tau, self._fq = t(vq), t(vG), t(tau), t(fq.T)
        self._A0 = t(A0)
        boundary = ((verts[:, 0] < 1e-12) | (verts[:, 0] > 1 - 1e-12)
                    | (verts[:, 1] < 1e-12) | (verts[:, 1] > 1 - 1e-12))
        self._keep = t(~boundary)                               # (n,)
        # flat places of the element entries in (nb, 3, s, s) block storage
        s = self.s
        rows = np.repeat(cells, 3, axis=1).reshape(-1, 3, 3)
        cols = np.tile(cells, (1, 3)).reshape(-1, 3, 3)
        br = rows // s
        flat = ((br * 3 + cols // s - br + 1) * s + rows % s) * s + cols % s
        keep = (~boundary[rows]) & (~boundary[cols])
        self._flat = torch.as_tensor(flat.reshape(-1), device=self.device)
        self._flat_keep = t(keep.reshape(-1))
        bidx = np.flatnonzero(boundary)
        self._bc_diag = torch.as_tensor(((bidx // s * 3 + 1) * s + bidx % s) * s
                                        + bidx % s, device=self.device)
        self.B = t(observation_matrix(nx, sqrt_n_obs))
        self.dq = self.B.shape[0]
        # the prior's operators
        M_e = area[:, None, None] * (np.ones((3, 3)) + np.eye(3))[None] / 12.0
        A_e = np.einsum("cid,de,cje,c->cij", grads, aniso_tensor(), grads, area)
        self.M = self._blocks(t(M_e)[None], identity_bc=False)
        self.K = self._blocks(t(gamma * A_e + delta * M_e)[None],
                              identity_bc=False)
        self._L_M = bt.cholesky_lower(self.M)
        self._K_inv = bt.factor(self.K, self.ar)
        self._M_inv = bt.factor(self.M, self.ar)

    # -- assembly -------------------------------------------------------------
    def _blocks(self, elems, identity_bc=True):
        """Element matrices (N, nc, 3, 3) summed into block storage (N, nb,
        3, s, s); with ``identity_bc`` the Dirichlet rows and columns are
        replaced by the identity's."""
        N, s = elems.shape[0], self.s
        vals = elems.reshape(N, -1)
        if identity_bc:
            vals = vals * self._flat_keep
        out = vals.new_zeros((N, s * 3 * s * s))
        out.index_add_(1, self._flat, vals)
        if identity_bc:
            out[:, self._bc_diag] = 1.0
        return out.reshape(N, s, 3, s, s)

    def _at_quad(self, u, m):
        ue, me = u[:, self.cells], m[:, self.cells]            # (N, nc, 3)
        uq = ue @ self._lam.T                                  # (N, nc, 6)
        emq = torch.exp(me @ self._lam.T)
        return ue, uq, emq

    def residual(self, u, m):
        """r(u, m) (N, n), zero in the Dirichlet rows."""
        ue, uq, emq = self._at_quad(u, m)
        vgu = (self._vG * ue[:, :, None, :]).sum(-1)           # (N, nc, 6)
        gu = (ue[..., None] * self._grads).sum(-2)             # (N, nc, 2)
        S = vgu + self.c * emq * uq ** 3 - self._fq
        w = self._wdet
        re = ((w * self._tau * vgu)[..., None] * self._vG).sum(-2)
        re = re + self.k * (self._grads * gu[:, :, None, :]).sum(-1) * (w.sum(-1)[:, None])
        re = re + ((w * S)[..., None] * self._lam).sum(-2)
        r = u.new_zeros(u.shape).index_add_(1, self.cells.reshape(-1),
                                            re.reshape(u.shape[0], -1))
        return r * self._keep

    def jacobian_blocks(self, u, m):
        """dr/du with the Dirichlet rows and columns of the identity."""
        _, uq, emq = self._at_quad(u, m)
        react = self._wdet * 3.0 * self.c * emq * uq ** 2      # (N, nc, 6)
        Ae = self._A0 + torch.einsum("ncq,qi,qj->ncij", react, self._lam, self._lam)
        return self._blocks(Ae)

    def C_elements(self, u, m):
        """Element blocks of C = dr/dm (N, nc, 3, 3)."""
        _, uq, emq = self._at_quad(u, m)
        w = self._wdet * self.c * emq * uq ** 3
        return torch.einsum("ncq,qi,qj->ncij", w, self._lam, self._lam)

    # -- solves -----------------------------------------------------------------
    def newton(self, m, rtol=None, max_iter=40):
        """u(m) by damped Newton from 0 (N, n); (u, converged, iterations)."""
        eps = torch.finfo(self.dtype).eps
        rtol = rtol if rtol is not None else max(1e-12, 100 * eps)
        u = torch.zeros_like(m)
        r = self.residual(u, m)
        rn = torch.linalg.vector_norm(r, dim=1)
        tol = 10 * eps + rtol * rn
        its = torch.zeros(m.shape[0], dtype=torch.long, device=m.device)
        alphas = [1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125]
        for _ in range(max_iter):
            act = (rn > tol).nonzero()[:, 0]
            if act.numel() == 0:
                break
            ua, ma, ra, rna = u[act], m[act], r[act], rn[act]
            blocks = self.jacobian_blocks(ua, ma)
            du = -bt.solve(blocks, bt.factor(blocks, self.ar), ra[..., None],
                           ar=self.ar)[..., 0]
            best_u, best_r, best_n = ua, ra, rna
            done = torch.zeros_like(rna, dtype=torch.bool)
            for a in alphas:
                un = ua + a * du
                rnew = self.residual(un, ma)
                nn = torch.linalg.vector_norm(rnew, dim=1)
                take = (~done) & ((nn < (1 - 1e-4 * a) * rna) | (nn < best_n))
                best_u = torch.where(take[:, None], un, best_u)
                best_r = torch.where(take[:, None], rnew, best_r)
                best_n = torch.where(take, nn, best_n)
                done = done | (nn < (1 - 1e-4 * a) * rna)
            u, r = u.index_copy(0, act, best_u), r.index_copy(0, act, best_r)
            rn = rn.index_copy(0, act, best_n)
            its = its.index_add(0, act, torch.ones_like(act))
        return u, rn <= tol, its

    def jacobians(self, u, m):
        """J = dq/dm at converged (u, m): (N, dq, n)."""
        N = u.shape[0]
        blocks = self.jacobian_blocks(u, m)
        Bt = (self.B.T * self._keep[:, None]).expand(N, -1, -1)
        P = bt.solve(blocks, bt.factor(blocks, self.ar), Bt, trans=True,
                     ar=self.ar)                               # (N, n, dq)
        Ce = self.C_elements(u, m) * self._keep[self.cells][None, :, :, None]
        # J^T[:, cells[c, j]] += sum_i C_e[c, i, j] P[:, cells[c, i]]
        Jt = P.new_zeros((N, self.n, self.dq))
        for i in range(3):
            Pi = P[:, self.cells[:, i]]                        # (N, nc, dq)
            for j in range(3):
                Jt.index_add_(1, self.cells[:, j], Ce[:, :, i, j, None] * Pi)
        return -Jt.mT

    def observe(self, u):
        return u @ self.B.T

    # -- the prior --------------------------------------------------------------
    def sample(self, noise):
        """Prior samples K^{-1} L xi for white noise (N, n)."""
        L = bt.matmat(self._L_M, noise.T[None], self.ar)
        return bt.solve(self.K, self._K_inv, L, ar=self.ar)[0].T

    def R(self, X):
        """K M^{-1} K X for X (n, k)."""
        Y = bt.matmat(self.K, X[None], self.ar)
        Y = bt.solve(self.M, self._M_inv, Y, ar=self.ar)
        return bt.matmat(self.K, Y, self.ar)[0]

    def Rinv(self, X):
        """K^{-1} M K^{-1} X for X (n, k)."""
        Y = bt.solve(self.K, self._K_inv, X[None], ar=self.ar)
        Y = bt.matmat(self.M, Y, self.ar)
        return bt.solve(self.K, self._K_inv, Y, ar=self.ar)[0]


def input_subspace(problem: Confusion, Js, Omega, rank: int):
    """(d (rank,), V (n, rank)) of the randomized GHEP H v = lambda R v,
    H = mean_i J_i^T J_i, from the probe block Omega (n, rank + p)."""
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
