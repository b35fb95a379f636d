"""The reference's arkimex gate through the port's driver.

tests/test_gates.py:80 (``test_options92_arkimex_gate``, marked slow in
the reference): examples/eigenmode1d (1D, 128 x 3) cut to tmax = 2e4,
with ``-ts_type arkimex`` at its PETSc block's ``-snes_type ksponly``
(one modified-Newton iteration per stage; its ``-ksp_type preonly
-pc_type lu`` stays on the iterative stack, the direct tier being
Rosenbrock-only), run by ``ksfdsolver.main`` in this process (what
``python -m ksfd_tpu_torch`` runs), on the card unless
``KSFD_PLATFORM=cpu``.  The example's ``--save``/``--check`` lines are
dropped (the card's machine has no h5py), so the state is read in
memory.  Its bounds: fewer than 150 failures, at most 400 steps, t >=
2e4, 4 peaks, 2e4 < max rho < 2.8e4.  Most of the run is the GMRES
fallback (its stage solves escalated to 4 Newton iterations), which is
launch-bound on the card's 1D problem: the whole gate takes minutes
there, so chip_smoke.py phase 32 runs only its first steps
(``maxsteps``) and this tool the whole of it.

    python -m ksfd_tpu_torch.tools.arkimex_gate          # on the card
    KSFD_PLATFORM=cpu python -m ksfd_tpu_torch.tools.arkimex_gate
"""

import argparse
import json
import shlex
import sys
import time

import numpy as np
import torch

from .problems import EXAMPLES

__all__ = ["count_peaks", "drive_main", "gate_argv", "run", "GATE_TMAX",
           "MAX_FAILURES", "MAX_STEPS"]

GATE_TMAX = 20000.0
MAX_FAILURES = 150
MAX_STEPS = 400


def count_peaks(rho):
    """The gate's peak count (tests/test_gates.py): rising edges of rho
    above its mean, periodic."""
    above = rho > rho.mean()
    return int((np.diff(np.r_[above, above[0]].astype(int)) == 1).sum())


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def drive_main(*argv):
    """``ksfdsolver.main`` in this process on argv, recording the Solver
    or EnsembleSolver it builds: (status, the solver, seconds from the
    call to the first monitor call (parsing, sympy, the problem and its
    kernels, the start), seconds of the rest).  The solver's
    ``records`` hold its monitor calls ``(perf_counter, k, t)``."""
    from .. import ksfdsolver

    seen = []
    bases = {name: getattr(ksfdsolver, name)
             for name in ("Solver", "EnsembleSolver")}

    def recording(base):
        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.records = []
                self.add_monitor(lambda s, k, t, u: s.records.append(
                    (time.perf_counter(), k, t)))
                seen.append(self)
        return Recorded

    for name, base in bases.items():
        setattr(ksfdsolver, name, recording(base))
    try:
        _sync()
        t0 = time.perf_counter()
        status = ksfdsolver.main("ksfd_tpu_torch", *argv)
        _sync()
        t1 = time.perf_counter()
    finally:
        for name, base in bases.items():
            setattr(ksfdsolver, name, base)
    s = seen[-1] if seen else None
    setup = s.records[0][0] - t0 if s is not None and s.records else None
    return status, s, setup, t1 - (t0 + setup) if setup is not None else None


def gate_argv(maxsteps=None):
    """The command line of the gate: examples/eigenmode1d's tokens
    without its --save/--check lines and with tmax=2e4 (and
    ``maxsteps``), then ``--numerics -ts_type arkimex --`` (a native
    token overrides the PETSc block's)."""
    drop = ("--save=", "--check=", "tmax=") + (
        ("maxsteps=",) if maxsteps is not None else ())
    argv = []
    with open(EXAMPLES / "eigenmode1d") as fh:
        for line in fh:
            argv += [tok for tok in shlex.split(line, comments=True)
                     if not tok.startswith(drop)]
    argv.append("tmax=%g" % GATE_TMAX)
    if maxsteps is not None:
        argv.append("maxsteps=%d" % maxsteps)
    return argv + ["--numerics", "-ts_type", "arkimex", "--"]


def run(maxsteps=None):
    """The gate (or its first ``maxsteps`` steps): a dict of its steps,
    failures, the fallback's steps, t, peaks, the rho range, seconds
    and whether the gate's bounds hold (``ok``; for a cut run, only
    that it ran and stayed finite)."""
    t0 = time.perf_counter()
    status, s, setup, _ = drive_main(*gate_argv(maxsteps))
    secs = time.perf_counter() - t0
    rho = s.u[0].cpu().numpy()
    t_last = s.records[-1][2]
    peaks = count_peaks(rho)
    res = dict(
        status=status, device=str(s.u.device), tableau=s.tableau.name,
        snes_iters=s.numerics.snes_iters, ksp_type=s.numerics.ksp_type,
        steps=s.k, failures=s.snes_failures,
        fallback_steps=s.stats.fallback_steps,
        host_retries=s.stats.host_retries, t=t_last, peaks=peaks,
        rho_min=float(rho.min()), rho_max=float(rho.max()),
        finite=bool(torch.isfinite(s.u).all()), seconds=secs,
        setup_s=setup)
    res["ok"] = (status == 0 and res["finite"] and res["tableau"]
                 == "ark324l2sa" and res["snes_iters"] == 1
                 and res["ksp_type"] == "richardson")
    if maxsteps is None:
        res["ok"] = (res["ok"] and res["failures"] < MAX_FAILURES
                     and res["steps"] <= MAX_STEPS and t_last >= GATE_TMAX
                     and peaks == 4 and 20000.0 < res["rho_max"] < 28000.0)
    else:
        res["ok"] = res["ok"] and res["steps"] == maxsteps
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--maxsteps", type=int, default=None,
                        help="run only the gate's first steps")
    args = parser.parse_args(argv)
    if torch.cuda.is_available():
        from ..utils.device import card_line
        print(card_line(), flush=True)
    res = run(args.maxsteps)
    print("arkimex gate on %s: %d steps (<= %d), %d failures (< %d), %d "
          "fallback steps, t=%.6g, %d peaks, rho [%.2f, %.2f], %.2f s "
          "(setup %.2f): %s" % (
              res["device"], res["steps"], MAX_STEPS, res["failures"],
              MAX_FAILURES, res["fallback_steps"], res["t"], res["peaks"],
              res["rho_min"], res["rho_max"], res["seconds"],
              res["setup_s"], "ok" if res["ok"] else "FAILED"), flush=True)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
