"""Measurement probe: where the time of the 2D stencil kernels goes.

The four kernels of csrc/stencil2d.cu (B2 jvp, B1 resid, B3 delta, B7
rhs) march along x: a block loads its operands row by row, evaluates
the pointwise functions (the groom, the tangent mask, G, dG.v or
G_delta) into a ring of rows in shared memory and computes the
star-stencil rows from it; resid also reads b and v at each output.
This probe builds variants of the source that drop one part at a time
(each a text edit, built into ``ksfd_tpu_torch/_build/`` like the
library itself) and times the four kernels of every variant with CUDA
events, in turns (in order, then reversed), on the 2D bench problem
(tools/problems.py bench_clargs) at n^2 x 3 for each n given:

- ``full``: the library as it is (checked against the plain versions to
  1e-5 of max|plain| first);
- ``no_pointwise``: G, dG and G_delta replaced by loaded values (the
  groom, the tangent mask and the rows stay);
- ``loads_only``: the ring filled (loads and evaluations), no stencil
  rows computed: each output is its centre values, read and written as
  before;
- ``rows_only``: the loads of the stencil operands replaced by
  constants of the data's size (fields 6000-7008, tangents and
  increments -100-87.5), so no global reads of them and no address
  arithmetic for them; the evaluations and the rows stay;
- ``no_output_reads``: resid writes its rows without reading b and v at
  the outputs (jvp, delta and rhs unchanged, a control);
- ``centre_reads`` (computes what ``full`` computes, checked like it):
  delta and rhs read the uncentred rho of their rows (u0's; u's,
  groomed) at the output point from global memory, as the tile design
  before the march did, in place of from the ring (which still carries
  it: the variant times the read, not the ring's smaller size);
- with ``--geometry POLICY=TY,TX,LX,NT,MINB,RX`` (repeatable; POLICY one
  of Jvp, Delta, Rhs): ``full`` with that policy's TY output columns a
  block, steps of TX rows, chunks of LX rows, NT threads, MINB resident
  blocks per SM (the registers ptxas sizes for) and runs of RX rows a
  thread in place of its own, a variant named e.g.
  ``delta_64x16_lx32_256t_3b_r4`` that computes what ``full`` computes
  and is checked like it.

The variants that drop a part compute wrong numbers by design; they
only time.  The edits know this source only: to probe an older copy,
run that checkout's own probe from a ``git archive`` of it.  Run on the
card:

    python -m ksfd_tpu_torch.tools.probe_stencil2d [--n 1024 1536]
        [--reps 50] [--geometry Delta=64,16,32,256,3,4 ...]

It prints one line per size and variant (µs of jvp, resid, delta and
rhs, each turn, and ptxas's registers and spills of the unsharded
entries) and, last, one JSON line with the card's name and power limit
and the mean µs per size, variant and kernel.
"""

import argparse
import json
import re
from concurrent.futures import ThreadPoolExecutor

from ..interop import problem_from_clargs
from ..ops.fused_stencil import BUILD_DIR, CSRC, build_library, \
    make_fused_kernels
from ..utils.device import card_line
from .probe_stencil3d import _ptxas, run
from .problems import bench_clargs

__all__ = ["KERNELS", "SAME", "variants", "geometry", "build_variants",
           "main"]

#: the kernels timed, in the order of each line
KERNELS = ("jvp", "resid", "delta", "rhs")

#: the variants that drop a part: edits of the policies' point() and
#: row() and of the march's loads
_PARTS = {
    "no_pointwise": [
        ("    ksfd_dG(f, s[0], dg);\n",
         "    for (int k = 0; k < DOF; ++k) dg[k] = f[k];\n"),
        ("    val[1] = ksfd_G(f, s[0]);\n", "    val[1] = f[0];\n"),
        ("    const float G0c = ksfd_G(f, s[0]) - s[2];\n",
         "    const float G0c = f[0] - s[2];\n"),
        ("    const float dG = ksfd_G_delta(f, dd, u1, s[0]);\n",
         "    const float dG = dd[0] + u1[1];\n"),
        ("    val[1] = ksfd_G(f, s[0]) - s[1 + DOF];\n",
         "    val[1] = f[0] - s[1 + DOF];\n"),
    ],
    "loads_only": [
        ("    float row = graddot(xvr, xG, c_vr, c_G) + "
         "graddot(xrho, xdG, c_rho, c_dG) +\n"
         "                vr * lap(xG, c_G) + xrho[SW] * lap(xdG, c_dG);\n",
         "    float row = c_G[0] + c_dG[0];\n"),
        ("      row = -ksfd_gamma(l, s[0]) * xvU[SW] + ksfd_s(l, s[0]) * vr +\n"
         "            ksfd_D(l, s[0]) * lap(xvU, at.centre(4 + l));\n",
         "      row = xvU[SW];\n"),
        ("    out[g] = graddot(xd0, xGs, c_d0, c_Gs) + "
         "graddot(xr0c, xdG, c_r0c, c_dG) +\n"
         "             drho * lap(xGs, c_Gs) + rho0 * lap(xdG, c_dG);\n",
         "    out[g] = c_Gs[0] + rho0 * c_dG[0];\n"),
        ("      out[(1 + l) * plane + g] = -ksfd_gamma(l, s[0]) * xdU[SW] +\n"
         "                                 ksfd_s(l, s[0]) * drho +\n"
         "                                 ksfd_D(l, s[0]) * lap(xdU, "
         "at.centre(5 + l));\n",
         "      out[(1 + l) * plane + g] = xdU[SW];\n"),
        ("    out[g] = graddot(xrc, xGc, c_rc, c_Gc) + rho * lap(xGc, c_Gc);\n",
         "    out[g] = c_Gc[0] + rho * c_rc[0];\n"),
        ("      out[(1 + l) * plane + g] = -ksfd_gamma(l, s[0]) * xUc[SW] +\n"
         "                                 ksfd_s(l, s[0]) * rc + "
         "s[2 + DOF + l] +\n"
         "                                 ksfd_D(l, s[0]) * lap(xUc, "
         "at.centre(3 + l));\n",
         "      out[(1 + l) * plane + g] = xUc[SW];\n"),
    ],
    "rows_only": [
        ("          raw[op * DOF + q] = sm.rp[kk][op][col + q * fs];\n",
         "          raw[op * DOF + q] =\n"
         "              op == 1 ? 12.5f * (float)(((i * 5 + q * 3) & 15) - 8)\n"
         "                      : 6000.0f + 16.0f * (float)((i + 7 * q) & 63);\n"),
    ],
    "no_output_reads": [
        ("    out[g] = RESID ? b[g] - s[1] * v[g] + row : row;\n",
         "    out[g] = row;\n"),
        ("      out[gl] = RESID ? b[gl] - s[1] * v[gl] + row : row;\n",
         "      out[gl] = row;\n"),
    ],
}

#: the variants that compute what full computes: the tile's reads of
#: the uncentred rho at the output point
_SAME_EDITS = {
    "centre_reads": [
        ("    const float rho0 = at.centre(4)[0];\n",
         "    const float rho0 = o.p[0][g];\n"),
        ("    const float rho = at.centre(2)[0];\n",
         "    const float u0 = o.p[0][g];\n"
         "    const float rho = u0 >= KSFD_RHOMIN ? u0 : KSFD_RHOMIN;\n"),
    ],
}
SAME = ("full",) + tuple(_SAME_EDITS)

#: a policy's geometry line
_GEOMETRY = re.compile(r"(struct (Jvp|Delta|Rhs) \{\n  static constexpr int "
                       r"TY = )\d+(, TX = )\d+(, LX = )\d+"
                       r"(, NT = KSFD_THREADS\()\d+(\), MINB = )\d+"
                       r"(,\s+RX = )[^;]+;")


def variants(src):
    """The variants' sources by name, from the text of
    csrc/stencil2d.cu."""
    out = {"full": src}
    for name, edits in list(_PARTS.items()) + list(_SAME_EDITS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(
                    "csrc/stencil2d.cu changed: the probe's anchor %r is "
                    "not found once" % old.strip()[:60])
            text = text.replace(old, new)
        out[name] = text
    return out


def geometry(src, spec):
    """(name, source): ``src`` with the launch geometry of ``spec``,
    "POLICY=TY,TX,LX,NT,MINB,RX", in place of that policy's own."""
    policy, nums = spec.split("=")
    nums = [int(n) for n in nums.split(",")]
    if len(nums) != 6:
        raise ValueError("geometry %r: POLICY=TY,TX,LX,NT,MINB,RX" % spec)

    found = []

    def put(m):
        if m.group(2) != policy:
            return m.group(0)
        found.append(policy)
        return "".join(m.group(1 + i + (i > 0)) + str(nums[i])
                       for i in range(6)) + ";"

    text = _GEOMETRY.sub(put, src)
    if not found:
        raise RuntimeError("csrc/stencil2d.cu: no march policy %r to give "
                           "the geometry %r" % (policy, nums))
    return ("%s_%dx%d_lx%d_%dt_%db_r%d" % ((policy.lower(),) + tuple(nums)),
            text)


def build_variants(header, geometries=()):
    """The variants' (library, build info) by name, one nvcc each, all
    started together, for one problem's pointwise header; each of
    ``geometries`` (``geometry``'s specs) adds a geometry of ``full``."""
    text = CSRC.read_text()
    out = variants(text)
    out.update(geometry(text, spec) for spec in geometries)
    paths = {}
    for name, vtext in out.items():
        paths[name] = BUILD_DIR / ("probe_s2d_%s.cu" % name)
        paths[name].parent.mkdir(parents=True, exist_ok=True)
        paths[name].write_text(vtext)
    with ThreadPoolExecutor(len(paths)) as pool:
        built = pool.map(lambda path: build_library(header, path, ndim=2),
                         paths.values())
        return dict(zip(paths, built))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1024])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--geometry", action="append", default=[],
                    metavar="POLICY=TY,TX,LX,NT,MINB,RX",
                    help="also time full with this launch geometry of a "
                    "policy (Jvp, Delta, Rhs), e.g. Delta=64,16,32,256,3,4")
    args = ap.parse_args(argv)
    text = CSRC.read_text()
    exact = list(SAME) + [geometry(text, g)[0] for g in args.geometry]
    means = {}
    for n in args.n:
        _, _, ops = problem_from_clargs(bench_clargs(n), n, n, device="cuda")
        kern = make_fused_kernels(ops)
        # the header depends on the spacing: one build per size
        built = build_variants(kern.build.header, args.geometry)
        libs = {name: lib for name, (lib, _) in built.items()}
        times = run(kern, libs, args.reps, exact, KERNELS)
        for name, turns in times.items():
            print("%d^2x3 %-28s %s | %s" % (n, name, ", ".join(
                "%s %s us" % (k, " / ".join("%.2f" % t[i] for t in turns))
                for i, k in enumerate(KERNELS)),
                _ptxas(built[name][1]["ptxas"])))
        means[n] = {name: {k: sum(t[i] for t in turns) / len(turns)
                           for i, k in enumerate(KERNELS)}
                    for name, turns in times.items()}
    print(json.dumps({"card": card_line(), "us": means}))


if __name__ == "__main__":
    main()
