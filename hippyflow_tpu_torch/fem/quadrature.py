"""Quadrature rules on the reference triangle {(x,y): x,y>=0, x+y<=1}.

Weights sum to 1/2 (reference-triangle area).  Degrees 1-5 cover all forms in
the framework: P1 mass/stiffness are exact at degree 2, the cubic reaction
term of the confusion problem (`applications/confusion/
confusion_linear_observable.py:101` in the reference) integrates P1 u^3 * v
exactly at degree 4.
"""

from __future__ import annotations

import numpy as np

# (points (nq,2), weights (nq,)) per polynomial degree.
_RULES: dict[int, tuple[np.ndarray, np.ndarray]] = {}

_RULES[1] = (
    np.array([[1.0 / 3.0, 1.0 / 3.0]]),
    np.array([0.5]),
)

# 3-point midpoint rule, degree 2.
_RULES[2] = (
    np.array([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5]]),
    np.array([1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0]),
)

# 4-point rule, degree 3.
_RULES[3] = (
    np.array(
        [
            [1.0 / 3.0, 1.0 / 3.0],
            [0.2, 0.2],
            [0.6, 0.2],
            [0.2, 0.6],
        ]
    ),
    np.array([-27.0 / 96.0, 25.0 / 96.0, 25.0 / 96.0, 25.0 / 96.0]),
)

# 6-point Dunavant rule, degree 4.
_a1, _b1 = 0.445948490915965, 0.108103018168070
_a2, _b2 = 0.091576213509771, 0.816847572980459
_w1, _w2 = 0.223381589678011 / 2.0, 0.109951743655322 / 2.0
_RULES[4] = (
    np.array(
        [
            [_a1, _a1],
            [_b1, _a1],
            [_a1, _b1],
            [_a2, _a2],
            [_b2, _a2],
            [_a2, _b2],
        ]
    ),
    np.array([_w1, _w1, _w1, _w2, _w2, _w2]),
)

# 7-point Dunavant rule, degree 5.
_c1 = 0.470142064105115
_c2 = 0.101286507323456
_wc = 0.225 / 2.0
_w3 = 0.132394152788506 / 2.0
_w4 = 0.125939180544827 / 2.0
_RULES[5] = (
    np.array(
        [
            [1.0 / 3.0, 1.0 / 3.0],
            [_c1, _c1],
            [1.0 - 2.0 * _c1, _c1],
            [_c1, 1.0 - 2.0 * _c1],
            [_c2, _c2],
            [1.0 - 2.0 * _c2, _c2],
            [_c2, 1.0 - 2.0 * _c2],
        ]
    ),
    np.array([_wc, _w3, _w3, _w3, _w4, _w4, _w4]),
)


def triangle_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (points, weights) exact for polynomials up to ``degree``."""
    for d in sorted(_RULES):
        if d >= degree:
            return _RULES[d]
    raise ValueError(f"no quadrature rule of degree {degree}")


def interval_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre rule on [0,1]; weights sum to 1."""
    npts = max(1, (degree + 2) // 2)
    x, w = np.polynomial.legendre.leggauss(npts)
    return (x + 1.0) / 2.0, w / 2.0
