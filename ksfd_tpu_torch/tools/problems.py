"""Problem definitions shared by the probes and chip_smoke.py.

Counterpart: the parameters of __graft_entry__._make_problem and of
the reference's tests/helpers.py (OPTIONS92_PARAMS, make_clargs), kept
here as the port's own copy (the port imports nothing of the JAX
package or its tests).
"""

import shlex
from argparse import Namespace
from pathlib import Path

__all__ = ["OPTIONS92_PARAMS", "make_clargs", "bench_clargs",
           "example_params", "with_fields", "agg3d_clargs"]

#: the repository's example option files
EXAMPLES = Path(__file__).resolve().parents[2] / "examples"


def make_clargs(params=(), source=(), cappotential="tophat",
                seed=793817931, **kw):
    """A Namespace shaped like ksfdsolver.py's parsed command line (the
    port's copy of the reference's test helper of that name)."""
    ns = Namespace(
        cappotential=cappotential, save=None, check=None, resume=None,
        restart=None, series_retries=0, series_retry_interval=60,
        mpiok=False, showparams=False, noperiodic=False, onestep=False,
        solver="tpu", seed=seed, source=list(source), params=list(params),
        numerics=[], petsc=[],
    )
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


#: Parameters of the two-ligand-group problem of the reference's
#: convergence tests (options92 / options93nx128dt1), the base of the
#: 2D bench problem.
OPTIONS92_PARAMS = [
    "dt=1", "tmax=200000", "maxsteps=10000", "width=1", "nelements=128",
    "dim=1", "degree=3", "atol=0.01", "rtol=1e-6", "rhomin=1e-7",
    "rhomax=28000", "cushion=2000", "sigma=0.02357", "s2=sigma**2/2",
    "Nworms=0", "rho0=murho + arho*sin(2*pi*(0.25+k0*x))",
    "U0_1_1=murho + arho*aUa*sin(2*pi*(0.25+k0*x))",
    "U0_2_1=murho + arho*aUr*sin(2*pi*(0.25+k0*x))",
    "murho=9000.0", "arho=1.0", "aUa=0.6846227279629311",
    "aUr=0.088562372925828", "lamda=0.003974930217658144", "k0=4.0",
    "srho0=0", "ngroups=2", "nligands_1=1", "alpha_1=1500",
    "beta_1=5.56e-4", "s_1_1=0.01", "gamma_1_1=0.01", "D_1_1=1e-6",
    "nligands_2=1", "alpha_2=1500", "beta_2=-5.56e-4", "s_2_1=0.001",
    "gamma_2_1=0.001", "D_2_1=1e-5",
]


def bench_clargs(n, dof=3):
    """The options84-class bench problem on an n x n grid: the
    parameters of __graft_entry__._make_problem; ``dof`` as
    ``with_fields`` sets it."""
    params = [
        p for p in OPTIONS92_PARAMS
        if p.split("=", 1)[0]
        not in ("nelements", "dim", "rho0", "U0_1_1", "U0_2_1")
    ] + [
        "nelements=%d" % n, "nwidth=%d" % n, "nheight=%d" % n, "dim=2",
        "height=1", "rho0=murho + arho*sin(2*pi*(x+y))", "U0_1_1=",
        "U0_2_1=",
    ]
    return make_clargs(params=with_fields(params, dof))


def example_params(name):
    """The ``name=value`` parameter lines of examples/<name>, up to its
    numerics block, without ``nelements``; each line split by shell
    rules, as the reference's parser reads an options file (a quoted
    ``'rho0=...'`` loses its quotes)."""
    params = []
    with open(EXAMPLES / name) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(("--petsc", "--numerics")):
                break
            if line and not line.startswith(("#", "--", "nelements=")):
                params += shlex.split(line, comments=True)
    return params


def with_fields(params, dof):
    """aggregation3d's (or aggregation2d's, or the bench problem's)
    parameter lines with ``dof`` fields: 3 as they are, 4 with a second
    repellent ligand (s 0.002, gamma 0.005, D 3e-6), 5 also with a third
    (s 0.003, gamma 0.004, D 4e-6), 6 also with a fourth (s 0.004, gamma
    0.003, D 5e-6), 2 with the attractant group only, 1 with no ligand
    (rho alone: ngroups=0)."""
    if dof in (4, 5, 6):
        extra = ["s_2_2=0.002", "gamma_2_2=0.005", "D_2_2=3e-6"]
        if dof >= 5:
            extra += ["s_2_3=0.003", "gamma_2_3=0.004", "D_2_3=4e-6"]
        if dof == 6:
            extra += ["s_2_4=0.004", "gamma_2_4=0.003", "D_2_4=5e-6"]
        return [p for p in params if p != "nligands_2=1"] + [
            "nligands_2=%d" % (dof - 2)] + extra
    if dof in (1, 2):
        drop = ("nligands_2", "alpha_2", "beta_2", "s_2_", "gamma_2_",
                "D_2_")
        if dof == 1:
            drop += tuple(p.replace("2", "1", 1) for p in drop)
        return [p for p in params if p != "ngroups=2"
                and not p.startswith(drop)] + ["ngroups=%d" % (dof - 1)]
    if dof != 3:
        raise ValueError("with_fields: dof %r is not one of 1 to 6"
                         % (dof,))
    return list(params)


def agg3d_clargs(n, dof=3):
    """The parameters of examples/aggregation3d (rho plus an attractant
    and a repellent ligand group, degree 3, periodic unit cube) with
    nelements=n; ``dof`` as ``with_fields`` sets it."""
    return make_clargs(params=with_fields(
        example_params("aggregation3d"), dof) + ["nelements=%d" % n])
