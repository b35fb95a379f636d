"""Probe the h-gap: stage-solve strength against step size on a rough
state.

Counterpart: tools/probe_hgap.py.  On a rough aggregation2d state the
adaptive chunk's accepted h is limited by the stage solve, not by the
CFL bound: the ladder (rich3, rich16, cheb48) parks on its top tier.
This probe measures, on one state, the embedded error ``enorm(h)`` of
one step for each tier in ``--configs`` over the step sizes ``--hs``
(``enorm <= 1``: the controller would accept; the largest h where a
tier's curve is at most 1 is the h that tier sustains), and with
``--time`` each tier's slope-timed ms per step (a fixed-dt multistep of
2 and of 10 steps at h=2, ``(t10 - t2) / 8``).

The rough state: the flagship (tools/flagship.py: examples/aggregation2d
from ``ic.start_values``, its numerics, the device loop) run in memory
to ``--accepts`` accepted steps (150 by default, past the k ~ 100 where
its ladder parks on cheb48), at ``--nelements`` (the example's 1536 by
default, its spacing kept); or, with ``--prefix`` and h5py, the last
snapshot of a stored run.  Tiers are named ``rich<N>`` (Richardson) and
``cheb<N>`` (Chebyshev) with N sweeps, on the example's numerics.

    python -m ksfd_tpu_torch.tools.probe_hgap --time      # on the card
    python -m ksfd_tpu_torch.tools.probe_hgap --nelements 64 \\
        --accepts 20 --hs 1,4,16 --device cpu

It prints the state, one row of enorm per tier, the ms per step, then
one JSON line: ``curves`` (tier -> enorms over hs), ``sustained``
(tier -> the largest h with enorm <= 1, or null) and ``ms_per_step``.
"""

import argparse
import dataclasses
import json
import math
import sys
import time

import torch

__all__ = ["rough_state", "tier_numerics", "probe", "main"]

#: the gate tolerances of examples/aggregation2d
ATOL, RTOL = 0.01, 1e-6


def rough_state(nelements=None, accepts=150, prefix=None, device=None,
                out=print):
    """``(ops, u, t)``: the last snapshot of the run stored at
    ``prefix`` (h5py needed), else the flagship run in memory to
    ``accepts`` accepted steps."""
    if prefix is not None:
        from ..io.solution import Solution

        sol = Solution(prefix, device=device)
        ops = sol.derivatives
        u = torch.as_tensor(sol.images(sol.tmax), device=ops.device)
        t = float(sol.tmax)
        sol.close()
        return ops, u, t
    from . import flagship

    res = flagship.run(nelements=nelements, maxsteps=accepts, device=device,
                       every=math.inf, out=out, keep=True)
    return res["state"]


def tier_numerics(tag):
    """The example's numerics with the stage solve of ``tag``:
    ``rich<N>`` or ``cheb<N>``, N sweeps, no device loop."""
    from .flagship import example_numerics

    kind = "chebyshev" if tag.startswith("cheb") else "richardson"
    return example_numerics(ksp_type=kind, ksp_iters=int(tag[4:]),
                            device_loop=False)


def probe(ops, u, t, hs, configs, time_steps=False, out=print):
    """enorm(h) per tier (and, with ``time_steps``, ms per step);
    returns the JSON record."""
    from ..solvers import make_multistep_fn, make_step_fn

    dev = u.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    f64 = lambda x: torch.tensor(float(x), dtype=torch.float64, device=dev)
    curves, sustained, ms = {}, {}, {}
    out("enorm(h) per solver tier (<=1 accepts):")
    out(("  %-8s" + " %9.3g" * len(hs)) % tuple(["tier"] + list(hs)))
    for tag in configs:
        step, _ = make_step_fn(ops, tier_numerics(tag), atol=ATOL, rtol=RTOL)
        row = [float(step(u, f64(t), f64(h))[1]) for h in hs]
        curves[tag] = row
        ok = [h for h, e in zip(hs, row) if math.isfinite(e) and e <= 1.0]
        sustained[tag] = max(ok) if ok else None
        out(("  %-8s" + " %9.3g" * len(hs)) % tuple([tag] + row))
    if time_steps:
        out("slope-timed ms/step (chained multistep, h=2):")
        for tag in configs:
            multi, _ = make_multistep_fn(ops, dataclasses.replace(
                tier_numerics(tag), adapt_type="none"), atol=ATOL, rtol=RTOL)
            times = {}
            for nst, pert in ((2, 0.0), (10, 0.0), (2, 1e-9), (10, 2e-9)):
                up = u * (1.0 + pert)
                sync()
                tic = time.perf_counter()
                u1, _, e1 = multi(up, f64(t), f64(2.0), nst)
                float(e1)
                sync()
                times[nst] = time.perf_counter() - tic
            ms[tag] = (times[10] - times[2]) / 8 * 1e3
            out("  %-8s %8.2f ms/step" % (tag, ms[tag]))
    return dict(hs=list(hs), curves=curves, sustained=sustained,
                ms_per_step=ms or None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prefix", default=None,
                        help="a stored run's --save prefix (h5py)")
    ap.add_argument("--nelements", type=int, default=None)
    ap.add_argument("--accepts", type=int, default=150)
    ap.add_argument("--hs", default="1,2,4,8,16,32,64")
    ap.add_argument("--configs", default="rich3,rich16,cheb16,cheb24,"
                    "cheb32,cheb48,rich48")
    ap.add_argument("--time", action="store_true",
                    help="also slope-time ms/step per tier")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.device is None or args.device.startswith("cuda"):
        from ..utils.device import card_line

        print(card_line(), flush=True)
    say = lambda s: print(s, flush=True)
    ops, u, t = rough_state(args.nelements, args.accepts, args.prefix,
                            args.device, out=say)
    say("state %s t=%.6g shape=%s rho=[%.4g, %.4g]" % (
        args.prefix or "flagship after %d accepts" % args.accepts, t,
        tuple(u.shape), float(u[0].min()), float(u[0].max())))
    res = probe(ops, u, t, [float(x) for x in args.hs.split(",")],
                [c.strip() for c in args.configs.split(",") if c.strip()],
                time_steps=args.time, out=say)
    res.update(t=t, shape=list(u.shape))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
