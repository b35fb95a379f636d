"""The control of the correctness check: the program's own float32 fast
mode (``NumericsOptions(precision="float32")``, the precision below the
configuration's float64 state) in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 5

runs, for each seed, the cell's set-up and a short window at the cell's
own size and load, then runs every call the window copied again in the
fast mode from the same input (the same tier, t and h) and prints, as
one JSON line per seed, the check's numbers for the program and for the
control (bench_check.py; the control's decision faults count only its
disagreements with the reference).  The benchmark's runs never run it;
its readings set the upper end of each limit (PERF.md).
"""

import argparse
import dataclasses
import importlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def control_samples(drv, samples):
    """The same calls in the fast mode: a copy of each sample with its
    ``u1`` and ``e`` from the float32 path."""
    import torch
    from torch.func import vmap

    from ksfd_tpu_torch.solvers import make_multistep_fn, make_step_fn

    out = []
    for s in samples:
        nm = dataclasses.replace(drv.numerics, ksp_type=s["kind"],
                                 ksp_iters=s["iters"], precision="float32")
        u, t, h = s["u"], s["t"], s["h"]
        if s["steps"] > 1:
            multi, _ = make_multistep_fn(
                drv.ops, dataclasses.replace(nm, adapt_type="none"),
                atol=drv.atol, rtol=drv.rtol)
            u1, _, e = multi(u[0], t[0], h[0], s["steps"])
            u1, e = u1.unsqueeze(0), e.reshape(1)
        else:
            step, _ = make_step_fn(drv.ops, nm, atol=drv.atol,
                                   rtol=drv.rtol)
            u1, e = vmap(step)(u, t, h)
        out.append(dict(s, u1=u1.to(torch.float64),
                        e=e.to(torch.float64)))
    return out


def readings(name, seed, seconds, device="cuda", n=None, out=print):
    """``dict(program=compared, control=compared)`` of one seed."""
    from bench_cells import config_params, load_cell
    from bench_check import judge

    _, wl, cfg = load_cell(name)
    kind = importlib.import_module("runners." + wl["kind"])
    drv = kind.Runner(wl, cfg, seed, device, n=n)
    drv.setup()
    drv.window(float(seconds))
    samples, decisions = drv.samples(), drv.decisions()
    ctl = control_samples(drv, samples)
    drv.release()
    params = config_params(cfg, drv.n)
    _, prog = judge(samples, decisions, params, drv.n, wl["limits"], device,
                    out)
    _, con = judge(ctl, (0, 0), params, drv.n, wl["limits"], device, out)
    return dict(program={k: v["value"] for k, v in prog.items()},
                control={k: v["value"] for k, v in con.items()})


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = readings(args.workload, seed, args.seconds,
                       out=lambda s: print(s, file=sys.stderr, flush=True))
        print(json.dumps(dict(workload=args.workload, seed=seed, **res)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
