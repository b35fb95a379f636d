"""The options93nx128dt1 convergence gate through the port's Solver.

Counterpart: tools/validate.py.  The workload: 1D n=128, two ligand
groups, fixed dt=1, 2080 implicit steps, with a closed-form rho source
that makes the exponentially growing eigenmode of the linearized PDEs
the exact solution of the continuum system (the source is derived
symbolically from that solution).  The final error against the exact
state measures the solver's spatial and temporal discretization; the
reference's figure is a relative error of 6.18e-5 (CLAUDE.md).  The
problem and its exact state are this module's own copy of the
reference's tests/manufactured.py.

    python -m ksfd_tpu_torch.tools.validate                # on the card
    python -m ksfd_tpu_torch.tools.validate --steps 100 --nx 64 --device cpu
    python -m ksfd_tpu_torch.tools.validate --ksp banded --block 8
"""

import argparse
import sys
import time

import numpy as np
import sympy as sy
import torch

from ..utils.device import resolve_device
from .problems import OPTIONS92_PARAMS, make_clargs

__all__ = ["MURHO", "exact_state", "rho_source_expr", "make_problem",
           "run_gate", "REFERENCE_REL_ERR"]

MURHO = 9000.0
ARHO = 1.0
AUA = 0.6846227279629311
AUR = 0.088562372925828
LAMDA = 0.003974930217658144
K0 = 4.0
#: the reference's relative error on this gate (CLAUDE.md:12-13)
REFERENCE_REL_ERR = 6.18e-5


def _exact_fields_sympy():
    """The exact rho, U1, U2 as sympy expressions of x and t."""
    x, t = sy.symbols("x t")
    phase = 2 * sy.pi * (sy.Rational(1, 4) + K0 * x)
    E = sy.exp(LAMDA * t)
    rho = MURHO + ARHO * E * sy.sin(phase)
    U1 = MURHO + ARHO * AUA * E * sy.sin(phase)
    U2 = MURHO + ARHO * AUR * E * sy.sin(phase)
    return x, t, rho, U1, U2


def rho_source_expr(ps):
    """source_rho = d(rho_e)/dt - d/dx(rho_e d/dx G_e), the continuum
    residual of the exact fields (tests/manufactured.py)."""
    x, t, rho, U1, U2 = _exact_fields_sympy()
    vals = ps.values0
    s2 = vals["s2"]
    G = (
        -vals["beta_1"] * sy.log(vals["alpha_1"] + U1)
        - vals["beta_2"] * sy.log(vals["alpha_2"] + U2)
        + vals["maxscale"] * s2
        * (sy.tanh((rho - vals["rhomax"]) / vals["cushion"]) + 1)
        + s2 * sy.log(rho)
    )
    return (sy.diff(rho, t) - sy.diff(rho * sy.diff(G, x), x)).doit()


def exact_state(grid, t):
    """The exact (3, nx) state at time t, as numpy."""
    x = np.arange(grid.nx) * float(grid.spacing[0])
    phase = 2 * np.pi * (0.25 + K0 * x)
    E = np.exp(LAMDA * t)
    rho = MURHO + ARHO * E * np.sin(phase)
    U1 = MURHO + ARHO * AUA * E * np.sin(phase)
    U2 = MURHO + ARHO * AUR * E * np.sin(phase)
    return np.stack([rho, U1, U2])


def make_problem(nx=64, extra_params=(), device=None):
    """(ps, grid, ops) of the manufactured problem on ``device`` (the
    card unless given): the options92 parameters at ``nx``, with
    ``extra_params`` replacing any of the same name, and the rho
    source."""
    from ..interop import problem_from_clargs
    from ..ops import PDEOperators

    overrides = ["nelements=%d" % nx] + list(extra_params)
    okeys = {p.split("=", 1)[0] for p in overrides}
    params = [p for p in OPTIONS92_PARAMS
              if p.split("=", 1)[0] not in okeys] + overrides
    ps, grid, _ = problem_from_clargs(make_clargs(params=params), nx,
                                      device="cpu")
    ops = PDEOperators(ps, grid, sources=[rho_source_expr(ps), 0.0, 0.0],
                       device=resolve_device(device))
    return ps, grid, ops


def run_gate(nx=128, steps=2080, dt=1.0, ksp=None, iters=None, block=1,
             device=None):
    """The gate's run: returns a dict of the steps taken, t, the wall
    seconds of ``solve`` (synchronised on the card), the max abs error
    against the exact state, the deviation amplitude and their ratio."""
    from ..solvers import Solver
    from ..utils.cli import NumericsOptions

    ps, grid, ops = make_problem(nx=nx, device=device)
    kw = dict(adapt_type="none")
    if ksp:
        kw["ksp_type"] = ksp
    if iters:
        kw["ksp_iters"] = iters
    solver = Solver(ops, NumericsOptions(**kw), t0=0.0, dt=dt, tmax=1e18,
                    maxsteps=steps, rtol=1e-6, atol=0.01, block_steps=block)
    u0 = torch.from_numpy(exact_state(grid, 0.0)).to(ops.device)
    sync = (torch.cuda.synchronize if ops.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    u = solver.solve(u0)
    sync()
    wall = time.perf_counter() - t0
    uex = exact_state(grid, solver.t)
    err = float(np.abs(u.cpu().numpy() - uex).max())
    amp = float(np.abs(uex - MURHO).max())
    return dict(nx=nx, steps=solver.k, t=solver.t, wall_s=wall,
                max_abs_err=err, amplitude=amp, rel_err=err / amp,
                stats=solver.stats)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nx", type=int, default=128)
    parser.add_argument("--steps", type=int, default=2080)
    parser.add_argument("--dt", type=float, default=1.0)
    parser.add_argument("--ksp", default=None,
                        help="richardson|chebyshev|dense|banded|lu")
    parser.add_argument("--iters", type=int, default=None)
    parser.add_argument("--block", type=int, default=1,
                        help="fixed steps per make_multistep_fn call "
                             "(block_steps)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    r = run_gate(args.nx, args.steps, args.dt, args.ksp, args.iters,
                 args.block, args.device)
    print("nx=%d steps=%d dt=%g t=%g wall=%.2fs (%.1f steps/s)" % (
        r["nx"], r["steps"], args.dt, r["t"], r["wall_s"],
        r["steps"] / r["wall_s"]))
    print("max abs error=%.3e  deviation amplitude=%.3e  relative=%.3e "
          "(reference %.3g)" % (r["max_abs_err"], r["amplitude"],
                                r["rel_err"], REFERENCE_REL_ERR))
    return 0


if __name__ == "__main__":
    sys.exit(main())
