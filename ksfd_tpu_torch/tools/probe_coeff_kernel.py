"""Measurement probe: the coefficient-field resid kernel (B11) against B1.

Counterpart: tools/probe_coeff_kernel.py (build_coeff_resid, main).
The held-J step evaluates G(u, t) and its field derivatives dG_i
inside every sweep's resid launch although (u, t) is fixed for the
step.  This probe precomputes them once as float32 coefficient fields

    C = [rho_g, G, dG_0*mask_0, ..., dG_{dof-1}*mask_{dof-1}, maskpack]

(``maskpack = sum_i 2^i (u_i > floor_i)``, exact in float32 for dof <=
24) and times B11, a resid kernel that reads C, v and b with no
pointwise transcendental (``ksfd_coeff_resid`` in csrc/stencil2d.cu,
through ops/fused_stencil.py ``coeff_resid``), against the production
resid kernel B1, which reads u, v and b and evaluates G/dG per launch.
The trade: C is dof + 3 planes where u is dof, against the pointwise
arithmetic.

Run on the card (the default) or, with ``--device cpu``, on the plain
versions:

    python -m ksfd_tpu_torch.tools.probe_coeff_kernel [--nx 1024]
        [--sweeps 64] [--repeats 3] [--device cpu]

It checks B11 against B1 (relative deviation < 1e-5, the reference's
assert), slope-times the chains ``x -> 0.1*resid(x)`` of 4 and 4 +
sweeps launches (min over repeats, perturbed inputs, a device
synchronisation as the fence) and prints, last, one JSON line with the
reference's keys (``nx``, ``production_us``, ``coeff_us``, ``speedup``,
``rel_dev``) and the card's name and power limit.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..interop import problem_from_clargs
from ..ops.fused_stencil import make_fused_kernels
from ..utils.device import card_line, resolve_device
from .problems import bench_clargs

__all__ = ["build_coeff_resid", "probe_state", "chain_slope_us", "run",
           "main"]


def build_coeff_resid(ops, kernels=None):
    """The coefficient-field resid kernel of a 2D problem.

    Counterpart: tools/probe_coeff_kernel.py:build_coeff_resid.
    Returns ``(prepare, resid)``: ``prepare(u, t) -> C`` builds the
    float32 coefficient fields ``(dof + 3, nx, ny)`` at (u, t) in plain
    PyTorch (the reference's jitted XLA ``prepare``, :183-205, not a
    Pallas kernel): one transcendental pass per step instead of per
    sweep.  ``resid(C, v, b, t, shift)`` is B11, the ``coeff_resid``
    entry of ``make_fused_kernels(ops)`` (or of ``kernels``).
    """
    if ops.grid.dim != 2:
        raise NotImplementedError(
            "the coefficient-field resid kernel is 2D, as the reference's "
            "is (a %dD problem has none)" % ops.grid.dim
        )
    kern = kernels if kernels is not None else make_fused_kernels(ops)
    dof = ops.nligands + 1
    rhomin, umin = ops.rhomin, ops.Umin

    def prepare(u, t):
        """Coefficient fields at (u, t), float32."""
        u32 = u.to(torch.float32)
        t32 = torch.as_tensor(t, dtype=torch.float32, device=u.device)
        masks = [u32[0] > rhomin] + [u32[1 + l] > umin
                                     for l in range(dof - 1)]
        rho_g = torch.where(masks[0], u32[0], rhomin)
        Us_g = [torch.where(masks[1 + l], u32[1 + l], umin)
                for l in range(dof - 1)]
        G = ops._G_fn(rho_g, *Us_g, t32)
        dGs = [fn(rho_g, *Us_g, t32) for fn in ops._dG_fns]
        maskpack = sum((1 << i) * masks[i].to(torch.float32)
                       for i in range(dof))
        fields = [rho_g, G] + [
            torch.where(masks[i], dGs[i], 0.0) for i in range(dof)
        ] + [maskpack]
        return torch.stack(fields)

    return prepare, kern.coeff_resid


def probe_state(grid, device, seed=0):
    """The probe's rough state (tools/probe_coeff_kernel.py:231-241):
    numpy seed 0, fields ``6000 + (3000, 1000, 500)|N(0,1)|`` in
    float64 (a fourth field as the third; 2 fields: the first two),
    then v and b N(0,1) in float32."""
    rng = np.random.default_rng(seed)
    shape = tuple(grid.Sshape)
    dof = int(grid.Vshape[0])
    u = np.stack([6000 + s * np.abs(rng.standard_normal(shape))
                  for s in ((3000, 1000) + (500,) * (dof - 2))])
    v = rng.standard_normal(tuple(grid.Vshape)).astype(np.float32)
    b = rng.standard_normal(tuple(grid.Vshape)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (u, v, b))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chain_slope_us(resid, x0, sweeps, repeats):
    """µs per launch of the chain ``x -> 0.1 * resid(x)``: the slope
    between chains of 4 and 4 + sweeps launches, each timed on the host
    clock to a device synchronisation, min over ``repeats`` perturbed
    starts (both lengths run once untimed first)."""
    n_s, n_b = 4, sweeps + 4

    def chain(x, n):
        for _ in range(n):
            x = 0.1 * resid(x)
        return x

    for n in (n_s, n_b):
        chain(x0, n)
    _sync(x0.device)
    ts = {n_s: [], n_b: []}
    for rep in range(repeats):
        for n in (n_s, n_b):
            xp = x0 * (1.0 + 1e-6 * (rep + 1)) + 1e-6
            _sync(x0.device)
            t0 = time.perf_counter()
            chain(xp, n)
            _sync(x0.device)
            ts[n].append(time.perf_counter() - t0)
    return (min(ts[n_b]) - min(ts[n_s])) / (n_b - n_s) * 1e6


def run(nx=1024, sweeps=64, repeats=3, device=None, ops=None, kern=None):
    """The probe at nx^2 x 3: (result dict, (C, u32, v, b), kernels).
    ``ops``/``kern`` reuse a built problem and its kernels."""
    device = resolve_device(device)
    if ops is None:
        _, _, ops = problem_from_clargs(bench_clargs(nx), nx, nx,
                                        device=device)
    kern = kern if kern is not None else make_fused_kernels(ops)
    prepare, cresid = build_coeff_resid(ops, kern)
    u, v0, b = probe_state(ops.grid, device)
    t, shift = 0.5, 37.0
    u32 = u.to(torch.float32)
    C = prepare(u, t)
    # correctness: the same math from the coefficient fields
    r_prod = kern.resid(u32, v0, b, t, shift)
    r_coef = cresid(C, v0, b, t, shift)
    rel_dev = float((r_prod - r_coef).abs().max() / r_prod.abs().max())
    if not rel_dev < 1e-5:
        raise AssertionError("coeff-vs-production resid rel dev %.3e"
                             % rel_dev)
    t32 = torch.full((), t, dtype=torch.float32, device=device)
    s32 = torch.full((), shift, dtype=torch.float32, device=device)
    us_prod = chain_slope_us(lambda x: kern.resid(u32, x, b, t32, s32), v0,
                             sweeps, repeats)
    us_coef = chain_slope_us(lambda x: cresid(C, x, b, t32, s32), v0,
                             sweeps, repeats)
    out = {
        "nx": nx, "production_us": us_prod, "coeff_us": us_coef,
        "speedup": us_prod / us_coef, "rel_dev": rel_dev,
    }
    return out, (C, u32, v0, b), kern


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nx", type=int, default=1024)
    parser.add_argument("--sweeps", type=int, default=64)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="cpu runs the plain versions (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    out, _, _ = run(args.nx, args.sweeps, args.repeats, device)
    print("coeff-vs-production resid rel dev: %.3e" % out["rel_dev"],
          file=sys.stderr)
    print("production resid (G/dG per sweep): %.3f us/sweep"
          % out["production_us"], file=sys.stderr)
    print("coeff-field resid (no transcendentals): %.3f us/sweep"
          % out["coeff_us"], file=sys.stderr)
    out["card"] = card_line() if device.type == "cuda" else "cpu"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
