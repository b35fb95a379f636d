"""Numerics-configuration smoke matrix of the port.

Counterpart: tools/smoke_matrix.py.  Integrates 3 implicit steps of the
1D manufactured problem (tools/validate.py ``make_problem``) through the
port's host Solver under every supported combination of stepper, stage
solver, preconditioner, loop mode and precision, and prints per
combination OK, BAD (a non-finite state or a short run) or CRASH (an
exception).  The combinations the library rejects by design (the exact
host tiers with a DIRK tableau: ValueError) count as OK when they are
rejected.  ``--quick`` runs only the stepper x stage-solver grid.

    python -m ksfd_tpu_torch.tools.smoke_matrix [--quick] [--nx 32]
        [--device cpu]

On the card (the default) every combination that launches a kernel
builds it at first use; on the CPU the kernels' plain versions run.
The exit status is 1 if any combination failed.
"""

import argparse
import sys
import time
import traceback

import torch

from ..solvers import Solver
from ..utils.cli import NumericsOptions
from ..utils.device import resolve_device
from . import validate

__all__ = ["cases", "EXPECTED_REJECT", "run_case", "main"]

TS_TYPES = ("rosw", "arkimex", "ark436", "beuler")
KSP_TYPES = ("richardson", "chebyshev", "gmres", "gmres_scipy",
             "gmres_rolled", "gmres_restarted", "dense", "banded", "lu")

#: the combinations the library rejects by design, with a ValueError
EXPECTED_REJECT = [
    dict(ts_type="arkimex", ksp_type="banded"),
    dict(ts_type="ark436", ksp_type="banded"),
    dict(ts_type="arkimex", ksp_type="lu"),
    dict(ts_type="ark436", ksp_type="lu"),
]


def cases(quick=False):
    """The matrix's NumericsOptions keyword sets, in the reference's
    order."""
    out = [dict(ts_type=ts, ksp_type=ksp) for ts in TS_TYPES
           for ksp in KSP_TYPES]
    if quick:
        return out
    for ksp in ("richardson", "chebyshev", "gmres_rolled", "gmres"):
        out.append(dict(ksp_type=ksp, device_loop=True))
    out.append(dict(device_loop=True, esc_cheb=False))
    out.append(dict(device_loop=True, ksp_iters_max2=0))
    for pc in ("block", "spectral", "none"):
        out.append(dict(pc_type=pc))
        out.append(dict(pc_type=pc, ksp_type="gmres_scipy"))
    out += [
        dict(precision="float32"),
        dict(precision="float32", device_loop=True),
        dict(adapt_type="none"),
        dict(adapt_type="none", ts_type="arkimex"),
        dict(sweep_dtype="float64"),
        dict(stage_delta=False),
        dict(pc_fft="on"),
        dict(pc_fft="on", ksp_type="gmres_scipy"),
        dict(ts_type="arkimex", device_loop=True),
        dict(ts_type="beuler", device_loop=True),
        dict(ts_type="ark436", device_loop=True),
    ]
    return out


def run_case(ops, u0, kw):
    """One combination: ``(verdict, note)``, verdict OK, BAD or CRASH."""
    tag = ",".join("%s=%s" % kv for kv in sorted(kw.items()))
    reject = kw in EXPECTED_REJECT
    try:
        s = Solver(ops, NumericsOptions(**kw), t0=0.0, dt=1.0, tmax=1e9,
                   maxsteps=3, rtol=1e-6, atol=0.01)
        u = s.solve(u0)
    except ValueError as e:
        if reject:
            return "OK", "%s (rejected: %s)" % (tag, e)
        return "CRASH", "%s %s" % (tag, e)
    except Exception as e:  # noqa: BLE001 -- every crash is a finding
        traceback.print_exc()
        return "CRASH", "%s %s" % (tag, e)
    ok = bool(torch.isfinite(u).all()) and s.k == 3
    note = "%s k=%d fails=%d" % (tag, s.k, s.snes_failures)
    if reject:
        return "BAD", note + " (expected a rejection but ran)"
    return ("OK" if ok else "BAD"), note


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the ts_type x ksp_type grid only")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    _, grid, ops = validate.make_problem(nx=args.nx, device=device)
    u0 = torch.as_tensor(validate.exact_state(grid, 0.0), device=device)
    fails = []
    matrix = cases(args.quick)
    t0 = time.perf_counter()
    for kw in matrix:
        verdict, note = run_case(ops, u0, kw)
        print("%-5s %s" % (verdict, note), flush=True)
        if verdict != "OK":
            fails.append((verdict, note))
    print("\n%d/%d failed (%.1f s on %s)" % (
        len(fails), len(matrix), time.perf_counter() - t0, device))
    for verdict, note in fails:
        print("  %s %s" % (verdict, note[:160]))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
