"""Implicit time steppers: Rosenbrock-W and backward Euler.

The reference integrates with PETSc TS type ROSW, whose default scheme
is Rang & Angermann's ROS34PW2 ('ra34pw2': 4 stages, order 3, embedded
order 2, W-method — tolerant of approximate Jacobians), under
'-ts_type rosw' in every options file.  We implement the same scheme
natively, with each stage solve done matrix-free (see linalg.py).

Stage form (transformed coefficients, Hairer & Wanner IV.7; what PETSc
rosw.c implements):

  W = (1/(h*gamma)) I - J,   J = df/du at (t0, u0), held for the step
  for i = 1..s:
      U_i = u0 + sum_{j<i} a_ij Y_j
      W Y_i = f(t0 + alpha_i h, U_i) + (1/h) sum_{j<i} c_ij Y_j
  u1    = u0 + sum_j m_j  Y_j       (order 3)
  u1hat = u0 + sum_j m2_j Y_j       (order 2, for the error estimate)

with a = A G^{-1}, C = diag(1/gamma) - G^{-1}, m = b G^{-1},
m2 = b2 G^{-1}, alpha_i = sum_j A_ij — computed numerically from the
published (A, Gamma, b, b2) tableau at import time.

Counterpart: ksfd_tpu/solvers/steppers.py.  The Rosenbrock tableaus
are numpy and copied unchanged; the ESDIRK (ARKIMEX) tableaus wait for
the DIRK path (ROADMAP Queue A item 7, A9).

Like PETSc TSROSW, f is evaluated at shifted stage times but no
explicit df/dt term enters the stage solves; the W-property absorbs
the approximation.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import all_reduce_sum

__all__ = [
    "Tableau", "ROS34PW2", "BEULER", "get_tableau", "wlte_norm_delta",
]


@dataclass(frozen=True)
class Tableau:
    name: str
    gamma: float          # diagonal gamma
    a: tuple              # strictly lower triangular, transformed
    c: tuple              # strictly lower triangular, transformed
    m: tuple              # solution weights, transformed
    m2: tuple             # embedded weights, transformed
    alpha: tuple          # stage time fractions
    order: int
    embedded_order: int

    @property
    def stages(self):
        return len(self.m)


def _transform(name, A, Gamma, b, b2, order, embedded_order):
    A = np.asarray(A, dtype=float)
    Gamma = np.asarray(Gamma, dtype=float)
    b = np.asarray(b, dtype=float)
    b2 = np.asarray(b2, dtype=float)
    s = len(b)
    Ginv = np.linalg.inv(Gamma)
    a = A @ Ginv
    C = np.diag(1.0 / np.diag(Gamma)) - Ginv
    m = b @ Ginv
    m2 = b2 @ Ginv
    alpha = A.sum(axis=1)
    gamma = float(Gamma[0, 0])
    # python floats: numpy f64 scalars would promote float32 tensors
    tt = lambda M: tuple(tuple(float(x) for x in row) for row in M)
    tv = lambda v: tuple(float(x) for x in v)
    return Tableau(
        name=name,
        gamma=gamma,
        a=tt(a),
        c=tt(C),
        m=tv(m),
        m2=tv(m2),
        alpha=tv(alpha),
        order=order,
        embedded_order=embedded_order,
    )


# Rang & Angermann (2005) ROS34PW2 — PETSc's TSROSWRA34PW2, the
# default TSROSW scheme used by every reference options file.
_g = 4.3586652150845900e-01
ROS34PW2 = _transform(
    "ros34pw2",
    A=[
        [0.0, 0.0, 0.0, 0.0],
        [8.7173304301691801e-01, 0.0, 0.0, 0.0],
        [8.4457060015369423e-01, -1.1299064236484185e-01, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ],
    Gamma=[
        [_g, 0.0, 0.0, 0.0],
        [-8.7173304301691801e-01, _g, 0.0, 0.0],
        [-9.0338057013044082e-01, 5.4180672388095326e-02, _g, 0.0],
        [2.4212380706095346e-01, -1.2232505839045147e+00, 5.4526025533510214e-01, _g],
    ],
    b=[
        2.4212380706095346e-01,
        -1.2232505839045147e+00,
        1.5452602553351020e+00,
        4.3586652150845900e-01,
    ],
    b2=[
        3.7810903145819369e-01,
        -9.6042292212423178e-02,
        5.0000000000000000e-01,
        2.1793326075422950e-01,
    ],
    order=3,
    embedded_order=2,
)

# Backward Euler as a 1-stage Rosenbrock (linearly implicit Euler).
# With an exact J this is one Newton step on the BE equation; PETSc's
# '-ts_type beuler' was only ever an alternative in the reference's
# options files.  Embedded estimate: b2 = [1/2] gives
# uhat = u0 + Y1/2, i.e. d = -Y1/2 — half the implicit increment
# (explicit Euler is not expressible in the Y1 basis).  Usable for
# adaptivity, crude like BE itself.
BEULER = _transform(
    "beuler",
    A=[[0.0]],
    Gamma=[[1.0]],
    b=[1.0],
    b2=[0.5],
    order=1,
    embedded_order=1,
)

_TABLEAUS = {
    "rosw": ROS34PW2,
    "ros34pw2": ROS34PW2,
    "beuler": BEULER,
}


def get_tableau(name):
    """Counterpart: ksfd_tpu/solvers/steppers.py:get_tableau."""
    if name in ("arkimex", "ark324", "ark436"):
        raise NotImplementedError(
            "ESDIRK tableau %r: the DIRK path is ROADMAP Queue A item 7 (A9)"
            % name
        )
    return _TABLEAUS[name]


def wlte_norm_delta(u1, d, atol, rtol, mesh=None):
    """wlte_norm with the embedded difference d = uhat - u1 supplied
    directly (uhat = u1 + d is never materialized).

    Accumulating d as sum_j (m2_j - m_j) Y_j — exact Python-float
    coefficient differences — avoids the ~|u|*eps64 rounding the
    (u + sum m2 Y) - (u + sum m Y) round trip injects into the
    cancelling sum, and saves a full-grid store/load of uhat.

    d=None means the tableau has no distinct embedded pair
    (bhat == b): the estimate is identically zero.

    Counterpart: ksfd_tpu/solvers/steppers.py:wlte_norm_delta.  The
    result is a 0-d tensor on the state's device (no host sync).  With
    a ``mesh`` (parallel/mesh.py) u1 and d are this rank's slabs and
    the norm is the global root mean square: the sum of ``e*e`` is
    reduced over the ranks, so every rank gets the same value.
    """
    if d is None:
        return torch.zeros((), dtype=u1.dtype, device=u1.device)
    w = atol + rtol * torch.maximum(torch.abs(u1), torch.abs(u1 + d))
    e = d / w
    if mesh is None:
        return torch.sqrt(torch.mean(e * e))
    total = all_reduce_sum(torch.sum(e * e), mesh)
    return torch.sqrt(total / (e.shape[0] * mesh.n_points))
