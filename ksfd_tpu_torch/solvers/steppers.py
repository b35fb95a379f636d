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
are numpy and copied unchanged, and so are the ESDIRK (ARKIMEX)
tableaus ARK324 and ARK436 (``DIRKTableau``: untransformed Butcher
arrays, stage-time fractions in ``c``), which the step runs by
modified Newton (solvers/solver.py, ``_combine_dirk``).

Like PETSc TSROSW, f is evaluated at shifted stage times but no
explicit df/dt term enters the stage solves; the W-property absorbs
the approximation.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import all_reduce_sum

__all__ = [
    "Tableau", "DIRKTableau", "ROS34PW2", "BEULER", "ARK324", "ARK436",
    "get_tableau", "wlte_norm_delta",
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


@dataclass(frozen=True)
class DIRKTableau:
    """Diagonally-implicit RK tableau (untransformed Butcher arrays).

    Used for the ARKIMEX-class ESDIRK methods: stage i solves the
    nonlinear equation U_i = u0 + h*sum_{j<=i} A[i][j] f(U_j) by
    modified Newton with the step-start Jacobian (the original KSFD
    runs always used '-snes_type ksponly', i.e. ONE Newton iteration
    per stage: the PETSc block of its options84; here the iteration
    count is NumericsOptions.snes_iters).

    Counterpart: ksfd_tpu/solvers/steppers.py:DIRKTableau.
    """

    name: str
    gamma: float          # the (repeated) diagonal entry
    A: tuple              # full lower-triangular incl. diagonal
    b: tuple              # solution weights (order `order`)
    bhat: tuple           # embedded weights (order `embedded_order`)
    c: tuple              # stage time fractions (row sums of A)
    order: int
    embedded_order: int

    @property
    def stages(self):
        return len(self.b)


def _dirk(name, A, b, bhat, order, embedded_order):
    A = [[float(x) for x in row] for row in A]
    # the consumer (solver.py's DIRK loop) hardcodes the ESDIRK
    # structure: stage 0 explicit (fs = [f0]), stages 1.. implicit
    # with the shared diagonal gamma
    assert len(A) >= 2, "ESDIRK tableaus need >= 2 stages"
    assert A[0][0] == 0.0, "stage 0 must be explicit (ESDIRK)"
    c = [sum(row) for row in A]
    diag = [A[i][i] for i in range(1, len(A))]
    gamma = diag[0]
    assert all(abs(d - gamma) < 1e-14 for d in diag), "not singly diagonal"
    tt = lambda M: tuple(tuple(float(x) for x in row) for row in M)
    tv = lambda v: tuple(float(x) for x in v)
    return DIRKTableau(
        name=name, gamma=float(gamma), A=tt(A), b=tv(b), bhat=tv(bhat),
        c=tv(c), order=order, embedded_order=embedded_order,
    )


# Kennedy & Carpenter (2003) ARK3(2)4L[2]SA — the ESDIRK implicit part
# of PETSc's TSARKIMEX3, the default '-ts_type arkimex' scheme: 4
# stages (first explicit), stiffly accurate (b = last row), L-stable,
# order 3 with an order-2 embedded pair.  Order conditions verified
# exactly in rationals (sum b = 1, b.c = 1/2, b.c^2 = 1/3, bAc = 1/6).
_ag = 1767732205903.0 / 4055673282236.0
ARK324 = _dirk(
    "ark324l2sa",
    A=[
        [0.0, 0.0, 0.0, 0.0],
        [_ag, _ag, 0.0, 0.0],
        [2746238789719.0 / 10658868560708.0,
         -640167445237.0 / 6845629431997.0, _ag, 0.0],
        [1471266399579.0 / 7840856788654.0,
         -4482444167858.0 / 7529755066697.0,
         11266239266428.0 / 11593286722821.0, _ag],
    ],
    b=[1471266399579.0 / 7840856788654.0,
       -4482444167858.0 / 7529755066697.0,
       11266239266428.0 / 11593286722821.0, _ag],
    bhat=[2756255671327.0 / 12835298489170.0,
          -10771552573575.0 / 22201958757719.0,
          9247589265047.0 / 10645013368117.0,
          2193209047091.0 / 5459859503100.0],
    order=3,
    embedded_order=2,
)

# Kennedy & Carpenter (2003) ARK4(3)6L[2]SA — the ESDIRK implicit
# part of PETSc's TSARKIMEX4, selected by '-ts_arkimex_type 4' (the
# leftover option in the reference's options84 PETSc block): 6 stages
# (first explicit), stiffly accurate, L-stable, order 4 with an
# order-3 embedded pair.  gamma = 1/4; c = [0, 1/2, 83/250, 31/50,
# 17/20, 1].  Order conditions (sum b = 1, b.c = 1/2, b.c^2 = 1/3,
# b.c^3 = 1/4, b.A.c = 1/6) pinned by tests/test_torch_arkimex.py.
ARK436 = _dirk(
    "ark436l2sa",
    A=[
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.25, 0.25, 0.0, 0.0, 0.0, 0.0],
        [8611.0 / 62500.0, -1743.0 / 31250.0, 0.25, 0.0, 0.0, 0.0],
        [5012029.0 / 34652500.0, -654441.0 / 2922500.0,
         174375.0 / 388108.0, 0.25, 0.0, 0.0],
        [15267082809.0 / 155376265600.0, -71443401.0 / 120774400.0,
         730878875.0 / 902184768.0, 2285395.0 / 8070912.0, 0.25, 0.0],
        [82889.0 / 524892.0, 0.0, 15625.0 / 83664.0,
         69875.0 / 102672.0, -2260.0 / 8211.0, 0.25],
    ],
    b=[82889.0 / 524892.0, 0.0, 15625.0 / 83664.0,
       69875.0 / 102672.0, -2260.0 / 8211.0, 0.25],
    bhat=[4586570599.0 / 29645900160.0, 0.0,
          178811875.0 / 945068544.0, 814220225.0 / 1159782912.0,
          -3700637.0 / 11593932.0, 61727.0 / 225920.0],
    order=4,
    embedded_order=3,
)

_TABLEAUS = {
    "rosw": ROS34PW2,
    "ros34pw2": ROS34PW2,
    "beuler": BEULER,
    "arkimex": ARK324,
    "ark324": ARK324,
    "ark436": ARK436,
}


def get_tableau(name):
    """Counterpart: ksfd_tpu/solvers/steppers.py:get_tableau."""
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
