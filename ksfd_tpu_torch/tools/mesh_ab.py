"""Measurement probe: phase 36's mesh timings for several checkouts on
one card, so that two commits compare on the same card and host.

Each checkout runs in a process of its own, from its own directory,
through its own ``chip_smoke.py`` helpers (what phases 30 and 36 run):

- the flagship (examples/aggregation2d at 1536^2 x 3 from
  ``ic.start_values``, its numerics with the device loop) for
  FLAG_ACCEPTS accepts after an untimed 2 through the one-card
  ``Solver`` (phase 30 (b)) and through ``Solver(mesh=)`` on a one-rank
  NCCL mesh (phase 36 (a)): ms per accept each; on the mesh also the
  collectives it called (``all_reduce``, ``batch_isend_irecv``,
  ``all_gather``, counted over the warm and the timed run) and the
  host µs of one ``all_reduce_sum`` of a scalar and one
  ``exchange_halos`` of the flagship's state;
- two gloo ranks spawned on the card (phase 36 (b) and (c),
  ``chip_smoke._mesh_rank``): the flagship through ``Solver(mesh=)``,
  and ``main`` over the two processes (the flagship cut to 16 steps,
  then --ensemble=4 hexagons2d): ms per accept each, the ranks' wall.

Run on the card, the checkouts in turns (parent, change, change,
parent):

    python -m ksfd_tpu_torch.tools.mesh_ab DIR_A DIR_B DIR_B DIR_A

It prints one JSON line per run (its directory and figures) and, last,
one JSON line with the card's name and power limit and every run.
Timings are on the host's clock (``torch.cuda.synchronize`` around each
run).
"""

import json
import os
import subprocess
import sys

#: one checkout's run, executed by ``python -c`` in its directory
WORKER = r'''
import json, os, sys, tempfile, time
import multiprocessing as mp
sys.path.insert(0, os.getcwd())
import torch
import torch.distributed as dist
import chip_smoke as cs
from ksfd_tpu_torch.parallel import grid_mesh
from ksfd_tpu_torch.parallel.mesh import all_reduce_sum, exchange_halos
from ksfd_tpu_torch.solvers import Solver
from ksfd_tpu_torch.tools.flagship import example_numerics

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
out = {}
clargs = cs.agg2d_clargs(cs.N_AGG)
ps, grid, ops = cs.problem_from_clargs(clargs, cs.N_AGG, cs.N_AGG,
                                       device=dev)
kern = cs.make_fused_kernels(ops)
u0 = torch.as_tensor(cs.ic_starts(clargs, grid, ps, 1, clargs.seed)[0],
                     device=dev)
p0 = ps.params0
kw = dict(t0=0.0, dt=float(p0["dt"]), tmax=float(p0["tmax"]),
          rtol=float(p0["rtol"]), atol=float(p0["atol"]), kernels=kern)
nm = example_numerics()
Solver(ops, nm, maxsteps=2, **kw).solve(u0)
s = Solver(ops, nm, maxsteps=cs.FLAG_ACCEPTS, **kw)
_, secs = cs.solver_run(s, u0)
out["one_card"] = dict(k=s.k, t=s.t, ms_per_accept=secs / s.k * 1e3)
ops_sw = int(ops.sw)
del s, kern, ops, u0
torch.cuda.empty_cache()
calls = dict(all_reduce=0, batch_isend_irecv=0, all_gather=0)


def counted(name, fn):
    def call(*a, **k):
        calls[name] += 1
        return fn(*a, **k)
    return call


def per_call_us(fn, reps):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                        % cs.free_port(), world_size=1, rank=0)
try:
    saved = {name: getattr(dist, name) for name in calls}
    for name in calls:
        setattr(dist, name, counted(name, saved[name]))
    try:
        s, _, secs, launches, _, _ = cs.mesh_flagship(
            dev, lambda g: grid_mesh(g, device=dev), cs.FLAG_ACCEPTS)
    finally:
        for name in calls:
            setattr(dist, name, saved[name])
    mesh = grid_mesh(grid, device=dev)
    x = torch.ones((), dtype=torch.float64, device=dev)
    slab = torch.ones((3,) + tuple(int(n) for n in grid.nps),
                      dtype=torch.float32, device=dev)
    us = dict(all_reduce_sum=per_call_us(
                  lambda: all_reduce_sum(x, mesh), 2000),
              exchange_halos=per_call_us(
                  lambda: exchange_halos([slab], ops_sw, mesh), 200))
finally:
    dist.destroy_process_group()
out["one_rank_nccl"] = dict(k=s.k, t=s.t, ms_per_accept=secs / s.k * 1e3,
                            launches=launches, calls=calls,
                            calls_per_accept={n: c / (s.k + 2)
                                              for n, c in calls.items()},
                            us_per_call=us)
del s
torch.cuda.synchronize()
torch.cuda.empty_cache()
ctx = mp.get_context("spawn")
queue = ctx.Queue()
store = os.path.join(tempfile.mkdtemp(prefix="ksfd_ab_"), "store")
procs = [ctx.Process(target=cs._mesh_rank, args=(r, 2, store, queue))
         for r in range(2)]
t0 = time.perf_counter()
for p in procs:
    p.start()
res = {}
try:
    for _ in procs:
        rank, r, err = queue.get(timeout=600)
        if err is not None:
            raise RuntimeError("rank %d:\n%s" % (rank, err))
        res[rank] = r
finally:
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
wall = time.perf_counter() - t0
flag, cli, ens = (res[0][k] for k in ("flagship", "cli_flagship",
                                      "cli_ensemble"))
out["two_gloo_ranks"] = dict(
    wall_s=wall, flagship_k=flag["k"],
    flagship_ms_per_accept=[res[r]["flagship"]["ms_per_accept"]
                            for r in (0, 1)],
    cli_ms_per_accept=[res[r]["cli_flagship"]["rest_s"]
                       / res[r]["cli_flagship"]["k"] * 1e3 for r in (0, 1)],
    cli_ensemble_ms_per_accept=[
        res[r]["cli_ensemble"]["rest_s"] / cs.CLI_ENS_ACCEPTS * 1e3
        for r in (0, 1)])
print("MESH_AB " + json.dumps(out))
'''


def run_checkout(path, timeout=900):
    """One checkout's figures (a dict), run from ``path``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(path))
    r = subprocess.run([sys.executable, "-c", WORKER], cwd=path, env=env,
                       capture_output=True, text=True, timeout=timeout)
    for line in r.stdout.splitlines():
        if line.startswith("MESH_AB "):
            return json.loads(line[len("MESH_AB "):])
    raise RuntimeError("%s: exit %d\n%s\n%s" % (path, r.returncode,
                                                r.stdout[-4000:],
                                                r.stderr[-4000:]))


def main(argv=None):
    from ..utils.device import card_line

    dirs = list(sys.argv[1:] if argv is None else argv)
    if not dirs:
        print(__doc__)
        return 2
    runs = []
    for path in dirs:
        fig = run_checkout(path)
        runs.append(dict(dir=path, **fig))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps(dict(card=card_line(), runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
