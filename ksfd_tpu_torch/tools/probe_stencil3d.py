"""Measurement probe: where the time of the 3D jvp and resid kernels goes.

B6b (jvp) and B6c (resid) of csrc/stencil3d.cu share one body,
``jvp_body<RESID, HALO>``.  It loads u and v around a tile, evaluates
the pointwise functions (the groom, the masked tangent, G and dG.v)
into shared memory, then computes the star-stencil rows from there.
This probe builds variants of the source that drop one part at a time
(each a text edit of ``jvp_body``, built into ``ksfd_tpu_torch/_build/``
like the library itself) and times every variant's jvp and resid
entries with CUDA events, in turns (in order, then reversed), on the
aggregation3d problem (examples/aggregation3d) at n^3 x 3:

- ``full``: the library as it is (checked against the plain versions to
  1e-5 of max|plain| first);
- ``no_pointwise``: G and dG replaced by one loaded value each (the
  groom, the tangent mask and the rows stay);
- ``loads_only``: the shared arrays filled (loads and evaluations), no
  stencil rows computed: each output is its centre values, read and
  written as before;
- ``rows_only``: the loads of u and v replaced by constants (no global
  reads of the stencil operands, no address arithmetic for them); the
  evaluations and the rows stay.

The variants other than ``full`` compute wrong numbers by design; they
only time.  The edits know both designs of the body: the march along x
(this source) and the box of PR 8 and before, so the probe also runs on
an older copy of the source (``--source``).  Run on the card:

    python -m ksfd_tpu_torch.tools.probe_stencil3d [--n 256] [--reps 20]
        [--source path/to/stencil3d.cu]

It prints one line per variant (µs of jvp and resid, each turn, and
ptxas's registers and spills of the two entries) and, last, one JSON
line with the card's name and power limit and the mean µs per variant.
"""

import argparse
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..interop import problem_from_clargs
from ..ops.fused_stencil import BUILD_DIR, build_library, make_fused_kernels
from ..ops.fused_stencil3d import CSRC3D
from ..utils.device import card_line
from .probe_pc_ring import _event_us
from .problems import agg3d_clargs

__all__ = ["design_of", "variants", "build_variants", "run", "main"]

#: the body's edits by design: (old, new) pairs per variant, each old
#: text found exactly once inside ``jvp_body``
_EDITS = {
    "box": {
        "no_pointwise": [
            ("    ksfd_dG(f, dg);\n",
             "    for (int k = 0; k < DOF; ++k) dg[k] = f[k];\n"),
            ("    s_G[i] = ksfd_G(f);\n", "    s_G[i] = f[0];\n"),
        ],
        "loads_only": [
            ("    float row = graddot(&s_vr[c], &s_G[c]) + "
             "graddot(&s_rho[c], &s_dG[c]) +\n"
             "                vr * lap(&s_G[c]) + s_rho[c] * "
             "lap(&s_dG[c]);\n",
             "    float row = s_G[c] + s_dG[c];\n"),
            ("      row = -ksfd_gamma(l) * vU[0] + ksfd_s(l) * vr + "
             "ksfd_D(l) * lap(vU);\n", "      row = vU[0];\n"),
        ],
        "rows_only": [
            ("      const float raw = up[k * w.plane + w.g];\n",
             "      const float raw = 6000.0f + (float)((i + 7 * k) & 63);\n"),
            ("      vm[k] = raw > lo ? vp[k * w.plane + w.g] : 0.0f;\n",
             "      vm[k] = raw > lo ? 1.0f - (float)(i & 3) : 0.0f;\n"),
        ],
    },
    "march": {
        "no_pointwise": [
            ("  ksfd_dG(f, dg);\n",
             "  for (int k = 0; k < DOF; ++k) dg[k] = f[k];\n"),
            ("  dst[1 * ds] = ksfd_G(f);\n", "  dst[1 * ds] = f[0];\n"),
        ],
        "loads_only": [
            ("    float row = graddot(xvr, xG, &c_vr[c], &c_G[c]) +\n"
             "                graddot(xrho, xdG, &c_rho[c], &c_dG[c]) +\n"
             "                vr * lap(xG, &c_G[c]) + "
             "c_rho[c] * lap(xdG, &c_dG[c]);\n",
             "    float row = c_G[c] + c_dG[c];\n"),
            ("      row = -ksfd_gamma(l) * xvU[SW] + ksfd_s(l) * vr +\n"
             "            ksfd_D(l) * lap(xvU, &c_vU[l * CN + c]);\n",
             "      row = xvU[SW];\n"),
        ],
        "rows_only": [
            ("      copy_f32(&dst[k * ds + j], &ub[k * fs + off]);\n"
             "      copy_f32(&dst[(DOF + k) * ds + j], &vb[k * fs + off]);\n",
             "      dst[k * ds + j] = 6000.0f + (float)((j + 7 * k) & 63);\n"
             "      dst[(DOF + k) * ds + j] = 1.0f - (float)(j & 3);\n"),
        ],
    },
}
#: where the text of each design's body (and its helpers) starts; it
#: ends at the kernels that wrap it
_STARTS = {"box": "void jvp_body(",
           "march": "// -- the march of jvp and resid"}
#: text found in that span of one design only
_MARKS = {
    "box": "const Rows w = box_rows<HALO>(",
    "march": "for (int x = xa - 2 * SW; x < xb; ++x)",
}


def _body_span(src, design):
    """(start, end) of the design's body text in ``src``."""
    a = src.index(_STARTS[design])
    return a, src.index("jvp_kernel(", a)


def design_of(src):
    """"march" or "box": the design of the source's jvp_body."""
    found = [d for d, mark in _MARKS.items()
             if _STARTS[d] in src and mark in src[slice(*_body_span(src, d))]]
    if len(found) != 1:
        raise RuntimeError("csrc/stencil3d.cu changed: jvp_body is neither "
                           "the box nor the march design the probe knows")
    return found[0]


def variants(src):
    """The variants' sources by name, from the text of a
    csrc/stencil3d.cu (either design)."""
    out = {"full": src}
    design = design_of(src)
    for name, edits in _EDITS[design].items():
        a, b = _body_span(src, design)
        body = src[a:b]
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(
                    "csrc/stencil3d.cu changed: the probe's anchor %r is "
                    "not found once in jvp_body" % old.strip()[:60])
            body = body.replace(old, new)
        out[name] = src[:a] + body + src[b:]
    return out


def build_variants(header, source=CSRC3D):
    """The variants' (library, build info) by name, one nvcc each, all
    started together, for one problem's pointwise header."""
    text = Path(source).read_text()
    tag = design_of(text)
    paths = {}
    for name, vtext in variants(text).items():
        paths[name] = BUILD_DIR / ("probe_s3d_%s_%s.cu" % (tag, name))
        paths[name].parent.mkdir(parents=True, exist_ok=True)
        paths[name].write_text(vtext)
    with ThreadPoolExecutor(len(paths)) as pool:
        built = pool.map(lambda path: build_library(header, path, ndim=3),
                         paths.values())
        return dict(zip(paths, built))


def _ptxas(log):
    """Registers and spills of the jvp and resid kernels (the unsharded
    entries) from an ``nvcc -Xptxas -v`` log."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((n for m, n in (("jvp_kernelILb0", "jvp"),
                                        ("jvp_kernelILb1", "resid"))
                         if m in line), None)
        elif name and "spill stores" in line:
            out.append("%s %s" % (name, line.split(",", 1)[1].strip()))
        elif name and "Used" in line and "registers" in line:
            out[-1] += ", " + line.split(":", 1)[1].strip()
            name = None
    return "; ".join(out)


def run(kern, libs, reps=20):
    """Check ``full`` of ``libs`` (build_variants) and time every
    variant's jvp and resid in turns on a rough state of ``kern``'s
    problem; returns {variant: [(jvp µs, resid µs), ...]}."""
    build = kern.build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = build.Vshape
    scale = torch.tensor([3.0, 1.0, 0.5][:build.dof] + [0.5] * (
        build.dof - 3), device=dev).view(-1, *([1] * (len(shape) - 1)))
    raw = 6000.0 + 1000.0 * scale * torch.randn(
        shape, generator=gen, device=dev).abs()
    u = build.ops.groom(raw.double()).float()
    v, b = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
    t = torch.zeros((), dtype=torch.float64, device=dev)
    shift = torch.full((), 2.29, dtype=torch.float64, device=dev)
    cases = dict(jvp=(kern.jvp, kern.jvp.prepare(u, v, t)),
                 resid=(kern.resid, kern.resid.prepare(u, v, b, t, shift)))
    times = {name: [] for name in libs}
    try:
        build._lib = libs["full"]
        for name, (k, (sc, ops)) in cases.items():
            got, want = k.launch(sc, ops), k.body(sc, ops)
            err = float((got - want).abs().max())
            if not err <= 1e-5 * float(want.abs().max()):
                raise RuntimeError("stencil3d.cu %s against its plain "
                                   "version: %.3e" % (name, err))
            del got, want
        for name in list(libs) + list(reversed(list(libs))):
            build._lib = libs[name]
            times[name].append(tuple(
                _event_us(lambda: k.launch(sc, ops), reps)
                for k, (sc, ops) in cases.values()))
    finally:
        build._lib = None
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--source", default=str(CSRC3D),
                    help="the csrc/stencil3d.cu to probe (default: this "
                    "checkout's)")
    args = ap.parse_args(argv)
    n = args.n
    _, _, ops = problem_from_clargs(agg3d_clargs(n), n, n, n, device="cuda")
    kern = make_fused_kernels(ops)
    built = build_variants(kern.build.header, args.source)
    libs = {name: lib for name, (lib, _) in built.items()}
    times = run(kern, libs, args.reps)
    for name, turns in times.items():
        print("%d^3x3 %-12s jvp %s us, resid %s us | %s" % (
            n, name, " / ".join("%.1f" % t[0] for t in turns),
            " / ".join("%.1f" % t[1] for t in turns),
            _ptxas(built[name][1]["ptxas"])))
    means = {name: [sum(t[i] for t in turns) / len(turns) for i in (0, 1)]
             for name, turns in times.items()}
    print(json.dumps({"card": card_line(), "n": n,
                      "design": design_of(Path(args.source).read_text()),
                      "source": args.source, "us": means}))


if __name__ == "__main__":
    main()
