"""Measurement probe: where the time of the 3D stencil kernels goes.

The four kernels of csrc/stencil3d.cu (B6b jvp, B6c resid, B6d delta,
B6a rhs) march along x: a block loads its operands plane by plane,
evaluates the pointwise functions (the groom, the tangent mask, G, dG.v
or G_delta) into a window in shared memory, then computes the
star-stencil rows from there.  This probe builds variants of the source
that drop one part at a time (each a text edit, built into
``ksfd_tpu_torch/_build/`` like the library itself) and times every
variant's four entries with CUDA events, in turns (in order, then
reversed), on the aggregation3d problem (examples/aggregation3d) at
n^3 x 3:

- ``full``: the library as it is (checked against the plain versions to
  1e-5 of max|plain| first);
- ``no_pointwise``: G, dG and G_delta replaced by loaded values (the
  groom, the tangent mask and the rows stay);
- ``loads_only``: the window filled (loads and evaluations), no stencil
  rows computed: each output is its centre values, read and written as
  before (delta and rhs still read their operand at the output point);
- ``rows_only``: the loads of the stencil operands replaced by
  constants of the data's size (fields 6000-7008, tangents and
  increments -100-87.5: the branches and ranges of the pointwise
  functions stay those of the timed state), so no global reads of them
  and no address arithmetic for them; the evaluations and the rows
  stay;
- with ``--geometry POLICY=MY,NT,MINB`` (repeatable; POLICY one of
  Jvp, Delta, Rhs): ``full`` with that policy's column tile MY x 32,
  threads per block and resident blocks per SM (the registers ptxas
  sizes for) in place of its own, a variant named e.g.
  ``delta_16x32_2b`` that computes what ``full`` computes and is
  checked like it.

The variants other than ``full`` and the geometries compute wrong
numbers by design; they only time.  The edits know this source only:
to probe an older copy, run that checkout's own probe from a ``git
archive`` of it.  Run on the card:

    python -m ksfd_tpu_torch.tools.probe_stencil3d [--n 256] [--reps 20]
        [--geometry Delta=16,512,2 ...]

It prints one line per variant (µs of jvp, resid, delta and rhs, each
turn, and ptxas's registers and spills of the four unsharded entries)
and, last, one JSON line with the card's name and power limit and the
mean µs per variant and kernel.
"""

import argparse
import json
import re
from concurrent.futures import ThreadPoolExecutor

import torch

from ..interop import problem_from_clargs
from ..ops.fused_stencil import BUILD_DIR, build_library, make_fused_kernels
from ..ops.fused_stencil3d import CSRC3D
from ..utils.device import card_line
from .probe_pc_ring import _event_us
from .problems import agg3d_clargs

__all__ = ["KERNELS", "variants", "geometry", "build_variants", "run",
           "main"]

#: the kernels timed, in the order of each line
KERNELS = ("jvp", "resid", "delta", "rhs")

#: this source's march: the policies' point and row functions and the
#: shared fetch
_MARCH = {
    "no_pointwise": [
        ("    ksfd_dG(f, s[0], dg);\n",
         "    for (int k = 0; k < DOF; ++k) dg[k] = f[k];\n"),
        ("    dst[1 * ds] = ksfd_G(f, s[0]);\n", "    dst[1 * ds] = f[0];\n"),
        ("    const float G0c = ksfd_G(f, s[0]) - s[2];\n",
         "    const float G0c = f[0] - s[2];\n"),
        ("    const float dG = ksfd_G_delta(f, dd, u1, s[0]);\n",
         "    const float dG = dd[0] + u1[1];\n"),
        ("    dst[1 * ds] = ksfd_G(f, s[0]) - s[1 + DOF];\n",
         "    dst[1 * ds] = f[0] - s[1 + DOF];\n"),
    ],
    "loads_only": [
        ("    float row = graddot(xvr, xG, c_vr, c_G) + "
         "graddot(xrho, xdG, c_rho, c_dG) +\n"
         "                vr * lap(xG, c_G) + c_rho[0] * lap(xdG, c_dG);\n",
         "    float row = c_G[0] + c_dG[0];\n"),
        ("      row = -ksfd_gamma(l, s[0]) * xvU[SW] + ksfd_s(l, s[0]) * vr +\n"
         "            ksfd_D(l, s[0]) * lap(xvU, at.centre(4 + l));\n",
         "      row = xvU[SW];\n"),
        ("    out[g] = graddot(xd0, xGs, c_d0, c_Gs) + "
         "graddot(xr0c, xdG, c_r0c, c_dG) +\n"
         "             drho * lap(xGs, c_Gs) + u0[g] * lap(xdG, c_dG);\n",
         "    out[g] = c_Gs[0] + u0[g] * c_dG[0];\n"),
        ("      out[(1 + l) * plane + g] = -ksfd_gamma(l, s[0]) * xdU[SW] +\n"
         "                                 ksfd_s(l, s[0]) * drho +\n"
         "                                 ksfd_D(l, s[0]) * lap(xdU, "
         "at.centre(4 + l));\n",
         "      out[(1 + l) * plane + g] = xdU[SW];\n"),
        ("    out[g] = graddot(xrc, xGc, c_rc, c_Gc) + rho * lap(xGc, c_Gc);\n",
         "    out[g] = c_Gc[0] + rho * c_rc[0];\n"),
        ("      out[(1 + l) * plane + g] = -ksfd_gamma(l, s[0]) * xUc[SW] +\n"
         "                                 ksfd_s(l, s[0]) * rc + "
         "s[2 + DOF + l] +\n"
         "                                 ksfd_D(l, s[0]) * lap(xUc, "
         "at.centre(2 + l));\n",
         "      out[(1 + l) * plane + g] = xUc[SW];\n"),
    ],
    "rows_only": [
        ("        copy_f32(to, &pl.p[i][k * fs + off]);\n",
         "        *to = i == 1 ? 12.5f * (float)(((j * 5 + q * 3) & 15) - 8)\n"
         "                     : 6000.0f + 16.0f * (float)((j + 7 * q) & 63);\n"),
    ],
}

#: a policy's geometry line: its column tile, threads, blocks per SM
_GEOMETRY = re.compile(r"(struct (Jvp|Delta|Rhs) \{\n  static constexpr int "
                       r"MY = )\d+(, NT = KSFD_THREADS\()\d+(\), MINB = )\d+;")


def variants(src):
    """The variants' sources by name, from the text of
    csrc/stencil3d.cu."""
    out = {"full": src}
    for name, edits in _MARCH.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(
                    "csrc/stencil3d.cu changed: the probe's anchor %r is "
                    "not found once" % old.strip()[:60])
            text = text.replace(old, new)
        out[name] = text
    return out


def geometry(src, spec):
    """(name, source): ``src`` with the launch geometry of ``spec``,
    "POLICY=MY,NT,MINB", in place of that policy's own."""
    policy, nums = spec.split("=")
    my, nt, minb = (int(n) for n in nums.split(","))
    text, n = _GEOMETRY.subn(
        lambda m: (m.group(1) + str(my) + m.group(3) + str(nt) + m.group(4)
                   + str(minb) + ";") if m.group(2) == policy else m.group(0),
        src)
    if text == src:
        raise RuntimeError("csrc/stencil3d.cu: no march policy %r to give "
                           "the geometry %r" % (policy, nums))
    return "%s_%dx32_%db" % (policy.lower(), my, minb), text


def build_variants(header, geometries=()):
    """The variants' (library, build info) by name, one nvcc each, all
    started together, for one problem's pointwise header; each of
    ``geometries`` (``geometry``'s specs) adds a geometry of ``full``."""
    text = CSRC3D.read_text()
    paths = {}
    out = variants(text)
    out.update(geometry(text, spec) for spec in geometries)
    for name, vtext in out.items():
        paths[name] = BUILD_DIR / ("probe_s3d_%s.cu" % name)
        paths[name].parent.mkdir(parents=True, exist_ok=True)
        paths[name].write_text(vtext)
    with ThreadPoolExecutor(len(paths)) as pool:
        built = pool.map(lambda path: build_library(header, path, ndim=3),
                         paths.values())
        return dict(zip(paths, built))


#: the unsharded entries' mangled names, as ptxas reports them
_PTXAS = (("jvp_kernelILb0", "jvp"), ("jvp_kernelILb1", "resid"),
          ("delta_kernel", "delta"), ("rhs_kernel", "rhs"))


def _ptxas(log):
    """Registers and spills of the four unsharded kernels from an
    ``nvcc -Xptxas -v`` log."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((n for m, n in _PTXAS if m in line), None)
        elif name and "spill stores" in line:
            out.append("%s %s" % (name, line.split(",", 1)[1].strip()))
        elif name and "Used" in line and "registers" in line:
            out[-1] += ", " + line.split(":", 1)[1].strip()
            name = None
    return "; ".join(out)


def cases(kern, gen):
    """Each kernel's prepared (scalar pack, operands) on a rough state
    of ``kern``'s problem: jvp and resid on the groomed f32 state with
    random tangents, delta with increments of scale 100, rhs on the raw
    state."""
    build = kern.build
    dev = torch.device("cuda")
    shape = build.Vshape
    scale = torch.tensor([3.0, 1.0, 0.5][:build.dof] + [0.5] * (
        build.dof - 3), device=dev).view(-1, *([1] * (len(shape) - 1)))
    randn = lambda: torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float64)
    raw = 6000.0 + 1000.0 * scale * randn().abs()
    u64 = build.ops.groom(raw)
    u = u64.float()
    v, b = randn().float(), randn().float()
    u1 = build.ops.groom(u64 + 100.0 * randn())
    t = torch.zeros((), dtype=torch.float64, device=dev)
    shift = torch.full((), 2.29, dtype=torch.float64, device=dev)
    args = dict(jvp=(u, v, t), resid=(u, v, b, t, shift),
                delta=(u64, u1 - u64, u1, t), rhs=(raw.float(), t.float()))
    return {name: kern.kernels[name].prepare(*args[name])
            for name in KERNELS}


def run(kern, libs, reps=20, exact=("full",), kernels=KERNELS):
    """Check the variants ``exact`` of ``libs`` (build_variants: ``full``
    and the geometries) against the plain versions and time every
    variant's ``kernels`` in turns on a rough state of ``kern``'s
    problem; returns {variant: [(µs per kernel), ...]}."""
    build = kern.build
    prepared = {name: prep for name, prep in cases(
        kern, torch.Generator(device="cuda").manual_seed(5)).items()
        if name in kernels}
    times = {name: [] for name in libs}
    try:
        for variant in exact:
            build._lib = libs[variant]
            for name, (sc, ops) in prepared.items():
                k = kern.kernels[name]
                got, want = k.launch(sc, ops), k.body(sc, ops)
                err = float((got - want).abs().max())
                if not err <= 1e-5 * float(want.abs().max()):
                    raise RuntimeError("%s %s %s against its plain version: "
                                       "%.3e" % (build.csrc.name, variant,
                                                 name, err))
                del got, want
        for variant in list(libs) + list(reversed(list(libs))):
            build._lib = libs[variant]
            times[variant].append(tuple(
                _event_us(lambda: kern.kernels[name].launch(sc, ops), reps)
                for name, (sc, ops) in prepared.items()))
    finally:
        build._lib = None
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--geometry", action="append", default=[],
                    metavar="POLICY=MY,NT,MINB",
                    help="also time full with this launch geometry of a "
                    "policy (Jvp, Delta, Rhs), e.g. Delta=16,512,2")
    args = ap.parse_args(argv)
    n = args.n
    _, _, ops = problem_from_clargs(agg3d_clargs(n), n, n, n, device="cuda")
    kern = make_fused_kernels(ops)
    built = build_variants(kern.build.header, args.geometry)
    libs = {name: lib for name, (lib, _) in built.items()}
    text = CSRC3D.read_text()
    exact = ["full"] + [geometry(text, g)[0] for g in args.geometry]
    times = run(kern, libs, args.reps, exact)
    for name, turns in times.items():
        print("%d^3x3 %-12s %s | %s" % (n, name, ", ".join(
            "%s %s us" % (k, " / ".join("%.1f" % t[i] for t in turns))
            for i, k in enumerate(KERNELS)),
            _ptxas(built[name][1]["ptxas"])))
    means = {name: {k: sum(t[i] for t in turns) / len(turns)
                    for i, k in enumerate(KERNELS)}
             for name, turns in times.items()}
    print(json.dumps({"card": card_line(), "n": n, "us": means}))


if __name__ == "__main__":
    main()
