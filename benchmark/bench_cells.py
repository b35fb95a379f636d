"""Cells, configurations and the program's problem, found by name.

A cell ``<name>`` is ``workloads/<name>.json``: its configuration, its
runner kind (``runners/<kind>.py``), its traffic parameters, the
limits of its correctness numbers and, optionally, numerics tokens of
its own.  A configuration ``<config>`` is ``configs/<config>.json``:
the parameter lines (their ``dim``, 2 or 3, is the grid's) and numerics
tokens of the deployment, its size per axis and its source.  Adding a
cell or a configuration adds files here and entries to
``BENCHMARK.json``.
"""

import itertools
import json
import math
from argparse import Namespace
from pathlib import Path

import torch

from reference.ks import eval_params

#: the benchmark's folder and the checkout that holds it
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

__all__ = ["BENCH", "ROOT", "load_benchmark", "load_cell", "cell_metrics",
           "build_program", "orient", "start_state", "cell_start"]


def load_benchmark():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_cell(name, overrides=None):
    """``(entry, workload, config)`` of cell ``name``: its BENCHMARK.json
    entry and its two data files, the workload's parameters updated by
    ``overrides`` (tests only).  A workload's ``numerics`` tokens follow
    its configuration's, so a later one wins."""
    bench = load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit("no cell %r in BENCHMARK.json" % name)
    with open(BENCH / "workloads" / (name + ".json")) as fh:
        wl = dict(json.load(fh), **(overrides or {}))
    if wl["config"] != entry["config"] or wl["traffic"] != entry["traffic"]:
        raise SystemExit("workloads/%s.json disagrees with BENCHMARK.json"
                         % name)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(ROOT / cfg_entry["file"]) as fh:
        cfg = json.load(fh)
    if "numerics" in wl:
        cfg["numerics"] = list(cfg.get("numerics", [])) + list(wl["numerics"])
    return entry, wl, cfg


def cell_metrics(name, trace):
    """The metric entries this cell reports: the end-to-end ones without
    tracing, the per-layer ones with it (a metric's ``workloads`` key
    names its cells; without it, every cell reporting the end-to-end
    metric it moves)."""
    bench = load_benchmark()
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def _clargs(params, seed):
    """A parsed command line as the program's entry point
    (``ksfdsolver.py``) makes it."""
    return Namespace(
        cappotential="tophat", save=None, check=None, resume=None,
        restart=None, series_retries=0, series_retry_interval=60,
        mpiok=False, showparams=False, noperiodic=False, onestep=False,
        solver="tpu", seed=int(seed), source=[], params=list(params),
        numerics=[], petsc=[])


def config_params(cfg, n=None):
    """The configuration's parameter lines at ``n`` points per axis (its
    own size when None; the spacing is kept, as each extent scales)."""
    own = int(cfg["nelements"])
    n = own if n is None else int(n)
    p = eval_params(cfg["params"])
    axes = ("width", "height", "depth")[:int(p["dim"])]
    out = [q for q in cfg["params"]
           if q.split("=", 1)[0] not in axes + ("nelements",)]
    scale = n / own
    return out + ["%s=%.17g" % (a, p.get(a, 1.0) * scale)
                  for a in axes] + ["nelements=%d" % n]


def build_program(cfg, n, seed, device):
    """The program's ``(ps, grid, ops, numerics)`` of a configuration at
    ``n`` points per axis on ``device``."""
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.utils.cli import decode_numerics

    params = config_params(cfg, n)
    nz = n if int(eval_params(params)["dim"]) == 3 else None
    ps, grid, ops = problem_from_clargs(_clargs(params, seed), n, n, nz,
                                        device=device)
    numerics = decode_numerics(list(cfg.get("numerics", [])),
                               petsc_tokens=list(cfg.get("petsc", [])))
    return ps, grid, ops, numerics


#: the six orders of a cube's axes
_ORDERS = list(itertools.permutations(range(3)))


def orient(u, key):
    """u (members, fields) + (n,) * dim under one of the grid's
    symmetries, by ``key``.  In 2D: one of the 8 rotations and
    reflections of the square (``key % 8``) after a periodic shift of
    ``(key // 8) % n`` points along x and ``(key // (8 n)) % n`` along
    y.  In 3D: one of the cube's 48, an order of the axes
    (``key % 6``) and a reflection of each (the bits of ``(key // 6) %
    8``), after a periodic shift of ``s % n``, ``(s // n) % n`` and
    ``(s // n^2) % n`` points along x, y and z, ``s = key // 48``.  The
    system is invariant under each (its extents are equal), so every
    key gives the same dynamics on other values at each point."""
    n = u.shape[-1]
    if u.dim() == 5:
        k, s = int(key) % 48, int(key) // 48
        u = torch.roll(u, shifts=(s % n, (s // n) % n, (s // n ** 2) % n),
                       dims=(-3, -2, -1))
        u = u.permute(0, 1, *(2 + a for a in _ORDERS[k % 6]))
        flips = [-3 + a for a in range(3) if (k // 6) >> a & 1]
        return (torch.flip(u, flips) if flips else u).contiguous()
    k, s = int(key) % 8, int(key) // 8
    u = torch.roll(u, shifts=(s % n, (s // n) % n), dims=(-2, -1))
    if k >= 4:
        u = u.transpose(-2, -1)
    return torch.rot90(u, k % 4, dims=(-2, -1)).contiguous()


def start_state(cfg, n, seeds, device):
    """The noisy uniform start of each seed, ``(len(seeds), fields) +
    (n,) * dim`` float64: rho = murho + srho0 * a smooth field of unit
    variance at the points of a coarse grid of n/4 per axis (a standard
    normal draw there, its trigonometric interpolant here), each ligand
    at its local steady state rho s / gamma.  Drawn on ``device`` from
    a ``torch.Generator`` seeded with each seed, one call per member."""
    p = eval_params(config_params(cfg, n))
    dim = int(p["dim"])
    nc = max(2, n // 4)
    kx = nc // 2
    # where the coarse spectrum's low and high modes go along each axis
    # but the last, which rfftn halves
    places = list(itertools.product(
        ((slice(None, kx), slice(None, kx)),
         (slice(n - (nc - kx), None), slice(kx, None))), repeat=dim - 1))
    gen = torch.Generator(device=device)
    rows = []
    for s in seeds:
        gen.manual_seed(int(s) % (2 ** 63))
        coarse = torch.randn((nc,) * dim, generator=gen, device=device,
                             dtype=torch.float64)
        spec = torch.fft.rfftn(coarse)
        full = torch.zeros((n,) * (dim - 1) + (n // 2 + 1,),
                           dtype=spec.dtype, device=device)
        last = slice(None, spec.shape[-1])
        for place in places:
            full[tuple(f for f, _ in place) + (last,)] = spec[
                tuple(c for _, c in place)]
        rows.append(torch.fft.irfftn(full, s=(n,) * dim)
                    * n ** dim / nc ** dim)
    field = torch.stack(rows)
    rho = p["murho"] + p["srho0"] * field
    fields = [rho]
    g = 1
    while "alpha_%d" % g in p and g <= int(p.get("ngroups", 1)):
        for l in range(1, int(p.get("nligands_%d" % g, 1)) + 1):
            key = "_%d_%d" % (g, l)
            fields.append(rho * (p["s" + key] / p["gamma" + key]))
        g += 1
    u = torch.stack(fields, dim=1)
    if not math.isfinite(float(u.abs().max())):
        raise RuntimeError("the start state is not finite")
    return u


def cell_start(cfg, wl, n, seed, device):
    """The start of a cell's run of ``seed``: the noise of the cell's
    ``noise_seed`` (member i of an ensemble: ``noise_seed * members +
    i``) under the grid symmetry the seed picks (``orient``), so every
    seed runs the same dynamics, and so the same work, on its own
    input."""
    members = int(wl.get("members", 1))
    base = int(wl["noise_seed"]) * members
    u = start_state(cfg, n, [base + i for i in range(members)], device)
    return orient(u, seed)
