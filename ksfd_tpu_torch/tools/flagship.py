"""Run an example through the port's Solver and report its counts.

A measurement tool like the probes (no I/O, no entry point): it builds
examples/aggregation2d (the flagship; or ``--example hexagons2d``) at
its own size, starts from ``ic.start_values`` of the example's
parameters (seeded), and runs ``Solver`` with the example's numerics
block (-ts_type rosw, -ts_adapt_dt_max 10000, -ts_adapt_clip 0.1,5)
and ``device_loop=True``, as ``ksfdsolver.py @examples/aggregation2d
--numerics -device_loop 1 --`` runs the reference.  ``--tmax`` and
``--maxsteps`` bound the run (default: the example's), ``--wall`` stops
it after the dispatch that crosses that many seconds.  It prints a
progress line every ``--every`` seconds and, at the end: accepted
steps, on-device rejections, host retries, fallback steps, exact
rescues, chunk tier calls, host reads, the stepping wall time and the
aggregate count of the final rho (tools/peakstats.py's rule), then one
JSON line of the same.

    python -m ksfd_tpu_torch.tools.flagship --tmax 2e5      # on the card
    python -m ksfd_tpu_torch.tools.flagship --nelements 48 --maxsteps 20 \\
        --device cpu
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..randomfield import DEFAULT_SEED, Generator
from .peakstats import count_peaks_nd
from .problems import example_params, make_clargs

__all__ = ["example_clargs", "example_numerics", "run"]


def example_clargs(example="aggregation2d", nelements=None,
                   seed=DEFAULT_SEED, extra=()):
    """The example's parameter lines as a parsed command line, at its
    own size or at ``nelements`` (then with the example's width and
    height scaled by nelements / the example's, which keeps its grid
    spacing); ``extra`` lines replace the file's of the same name."""
    params = example_params(example)
    own = _own_nelements(example)
    if nelements is not None and nelements != own:
        scale = float(nelements) / own
        params = [_scaled(p, scale) for p in params]
    names = {p.split("=", 1)[0] for p in extra}
    params = [p for p in params if p.split("=", 1)[0] not in names]
    n = own if nelements is None else int(nelements)
    return make_clargs(params=params + list(extra) + ["nelements=%d" % n],
                       seed=seed)


def _own_nelements(example):
    from .problems import EXAMPLES

    for line in open(EXAMPLES / example):
        if line.startswith("nelements="):
            return int(line.split("=", 1)[1])
    raise ValueError("examples/%s sets no nelements" % example)


def _scaled(param, scale):
    name, _, val = param.partition("=")
    if name in ("width", "height", "depth"):
        return "%s=%.17g" % (name, float(val) * scale)
    return param


def example_numerics(**kw):
    """aggregation2d's (and hexagons2d's) numerics block as
    NumericsOptions, with ``device_loop=True``, and ``kw`` on top."""
    from ..utils.cli import NumericsOptions

    base = NumericsOptions(ts_type="rosw", adapt_type="basic", dt_max=1e4,
                           clip_low=0.1, clip_high=5.0, device_loop=True)
    return dataclasses.replace(base, **kw)


def run(example="aggregation2d", nelements=None, seed=DEFAULT_SEED,
        tmax=None, maxsteps=None, wall=None, every=60.0, device=None,
        numerics=None, out=print, keep=False):
    """Build, start and run; returns a dict of the counts (with
    ``keep``, also ``state``: the operators, the final state tensor and
    its t, as tools/probe_hgap.py takes its rough state)."""
    from .. import ic
    from ..interop import problem_from_clargs
    from ..solvers import Solver

    clargs = example_clargs(example, nelements, seed)
    n = int(_own_nelements(example) if nelements is None else nelements)
    ps, grid, ops = problem_from_clargs(clargs, n, n, device=device)
    Generator(seed)
    u0, t0 = ic.start_values(clargs, grid, ps, device=ops.device)
    p0 = ps.params0
    solver = Solver(
        ops, numerics or example_numerics(), t0=t0, dt=float(p0["dt"]),
        tmax=float(p0["tmax"] if tmax is None else tmax),
        maxsteps=int(p0["maxsteps"] if maxsteps is None else maxsteps),
        rtol=float(p0["rtol"]), atol=float(p0["atol"]),
        rng_state=seed)
    sync = (torch.cuda.synchronize if ops.device.type == "cuda"
            else (lambda: None))
    clock = dict(start=None, last=None)

    def progress(s, k, t, u):
        now = time.perf_counter()
        if clock["start"] is None:
            clock["start"] = clock["last"] = now
            return
        if now - clock["last"] >= every:
            clock["last"] = now
            st = s.stats
            out("  %.0f s: k=%d t=%.6g h=%.4g rejections=%d retries=%d "
                "rescues=%d tier calls=%s" % (
                    now - clock["start"], k, t, s.h, st.chunk_rejections,
                    st.host_retries, st.exact_rescues, st.tier_calls))
        if wall is not None and now - clock["start"] >= wall:
            s.maxsteps = k   # ends the loop after this exit

    solver.add_monitor(progress)
    sync()
    t_start = time.perf_counter()
    u = solver.solve(u0)
    sync()
    secs = time.perf_counter() - t_start
    rho = u[0].cpu().numpy()
    st = solver.stats
    res = dict(
        example=example, shape=list(grid.Vshape), seed=seed,
        steps=solver.k, t=solver.t, h=solver.h, diverged=solver.diverged,
        on_device_rejections=st.chunk_rejections,
        snes_failures=solver.snes_failures, host_retries=st.host_retries,
        fallback_steps=st.fallback_steps, exact_rescues=st.exact_rescues,
        dispatches=st.dispatches, tier_calls=st.tier_calls,
        host_reads=st.chunk_attempts + st.step_attempts,
        wall_s=secs, ms_per_step=secs / max(solver.k, 1) * 1e3,
        aggregates=count_peaks_nd(rho),
        rho_min=float(np.min(rho)), rho_max=float(np.max(rho)),
        finite=bool(np.isfinite(rho).all()))
    out("%s %s: %d accepted steps to t=%.6g (h %.4g), %d on-device "
        "rejections, %d host retries (%d fallback steps), %d exact "
        "rescues, %d dispatches, tier calls %s, %d host reads, stepping "
        "%.2f s (%.3f ms/step), %d aggregates, rho in [%.4g, %.4g]" % (
            example, "x".join(map(str, grid.Vshape)), res["steps"],
            res["t"], res["h"], res["on_device_rejections"],
            res["host_retries"], res["fallback_steps"],
            res["exact_rescues"], res["dispatches"], res["tier_calls"],
            res["host_reads"], secs, res["ms_per_step"], res["aggregates"],
            res["rho_min"], res["rho_max"]))
    if keep:
        res["state"] = (ops, u, float(solver.t))
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--example", default="aggregation2d",
                        choices=["aggregation2d", "hexagons2d"])
    parser.add_argument("--nelements", type=int, default=None,
                        help="grid points per axis (default: the "
                             "example's; the spacing is kept)")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--tmax", type=float, default=None)
    parser.add_argument("--maxsteps", type=int, default=None)
    parser.add_argument("--wall", type=float, default=None,
                        help="stop after the exit that crosses this many "
                             "seconds of stepping")
    parser.add_argument("--every", type=float, default=60.0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    if args.device is None or args.device.startswith("cuda"):
        from ..utils.device import card_line
        print(card_line(), flush=True)
    res = run(args.example, args.nelements, args.seed, args.tmax,
              args.maxsteps, args.wall, args.every, args.device,
              out=lambda s: print(s, flush=True))
    print(json.dumps(res))
    return 0 if res["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
