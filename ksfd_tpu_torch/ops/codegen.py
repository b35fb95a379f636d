"""Print the pointwise free energy of a problem as CUDA device code.

Counterpart: the tracing of ``ops._G_fn``, ``ops._dG_fns`` and
``ops._G_delta_fn`` into the Pallas kernel bodies of
ksfd_tpu/ops/pallas_stencil.py:make_pallas_kernels and
ksfd_tpu/ops/pallas_stencil3d.py:make_pallas_kernels_3d.  Where Pallas
traces the sympy-lambdified JAX functions, the CUDA kernels of
csrc/stencil2d.cu and csrc/stencil3d.cu include a header generated here
that holds

- ``ksfd_G(f)``, ``ksfd_dG(f, out)`` and ``ksfd_G_delta(f, d, s)`` as
  ``__device__ __forceinline__`` functions of ``float`` arrays of
  length ``KSFD_DOF`` (fields, increments, shifted fields);
- the star stencils ``ksfd_d1x(p, stride)`` ... ``ksfd_d2y`` (and
  ``ksfd_d1z``/``ksfd_d2z`` in 3D): the first/second derivative at
  ``*p`` along an axis of that stride, a left-to-right sum of the
  nonzero coefficients (the order of the Pallas body's ``_d``);
- the problem constants: ``KSFD_DIM``, ``KSFD_DOF``, ``KSFD_SW``, the
  groom floors ``KSFD_RHOMIN``/``KSFD_UMIN`` and the ligand
  coefficients ``ksfd_gamma(l)``, ``ksfd_s(l)``, ``ksfd_D(l)``, all as
  ``F`` literals of their float32 values.

The printer is sympy's C99 printer with ``real`` aliased to float32, so
literals carry an ``F`` suffix and calls are the single-precision
``logf``/``tanhf``/``log1pf``/``powf``/``fmaxf``; without the alias the
literals would be ``double`` and the arithmetic would silently run in
float64.  ``where_`` prints as a C conditional, which keeps the
where-form semantics of the Pallas body.  No ``--use_fast_math``: the
delta form's accuracy rests on the exact ``log1pf``/``logf``/``tanhf``.
"""

import numpy as np
import sympy as sy
from sympy.codegen.ast import float32, real
from sympy.printing.c import C99CodePrinter

from .stencil import deriv_coeffs

__all__ = ["pointwise_header", "c_expr"]


class _F32Printer(C99CodePrinter):
    """C99 printer in single precision, plus the delta heads."""

    def __init__(self):
        super().__init__(settings={"type_aliases": {real: float32}})

    def _print_Function(self, expr):
        name = type(expr).__name__
        if name == "where_":
            c, a, b = (self._print(x) for x in expr.args)
            return "((%s) ? (%s) : (%s))" % (c, a, b)
        if name == "log1p":
            return "log1pf(%s)" % self._print(expr.args[0])
        if name == "expm1":
            return "expm1f(%s)" % self._print(expr.args[0])
        return super()._print_Function(expr)


def c_expr(expr, names):
    """Single-precision C text of a sympy expression; ``names`` maps
    each free symbol to the C expression that replaces it."""
    expr = sy.sympify(expr).xreplace(
        {s: sy.Symbol(n) for s, n in names.items()}
    )
    return _F32Printer().doprint(expr)


def _flit(x):
    """A float as a C single-precision literal: the exact decimal of
    its float32 rounding (what a Python float becomes in a float32
    tensor expression)."""
    text = "%.17g" % float(np.float32(x))
    if not any(ch in text for ch in ".e"):
        text += ".0"  # "2560F" is not a C literal
    return text + "F"


def _stencil_fn(name, cs):
    sw = (len(cs) - 1) // 2
    terms = [
        "%s * p[%d * st]" % (_flit(c), j)
        for j, c in zip(range(-sw, sw + 1), cs)
        if float(c) != 0.0
    ]
    return (
        "__device__ __forceinline__ float %s(const float* p, int st) {\n"
        "  return %s;\n}" % (name, " + ".join(terms))
    )


def _table_fn(name, values):
    cases = " ".join(
        "case %d: return %s;" % (i, _flit(v)) for i, v in enumerate(values)
    )
    return (
        "__device__ __forceinline__ float %s(int l) {\n"
        "  switch (l) { %s }\n  return 0.0F;\n}" % (name, cases)
    )


def pointwise_header(ops):
    """The generated header text for a 2D or 3D PDEOperators.

    Raises NotImplementedError for a problem with time-dependent
    coefficients (their values would have to come in at run time) or
    without an increment form of G.  G, dG and G_delta do not depend on
    the dimension; only the stencils do.
    """
    dim = ops.grid.dim
    if dim not in (2, 3):
        raise NotImplementedError(
            "CUDA kernels are 2D and 3D; a %dD problem has none" % dim
        )
    if ops._G_tdep or ops._lig_tdep:
        raise NotImplementedError(
            "time-dependent PDE coefficients are not printed into the "
            "CUDA kernels yet"
        )
    if ops.G_delta_expr is None:
        raise NotImplementedError("G has no increment form (ops/delta.py)")
    dof = ops.nligands + 1
    t = sy.Symbol("t")
    fmap = {s: "f[%d]" % i for i, s in enumerate(ops.field_symbols)}
    dmap = {s: "d[%d]" % i for i, s in enumerate(ops.delta_symbols)}
    smap = {s: "s[%d]" % i for i, s in enumerate(ops.shifted_symbols)}
    for m in (fmap, dmap, smap):
        m[t] = "0.0F"  # t is absent from a time-independent G
    lines = [
        "// Generated by ksfd_tpu_torch/ops/codegen.py; do not edit.",
        "#pragma once",
        "#define KSFD_DIM %d" % dim,
        "#define KSFD_DOF %d" % dof,
        "#define KSFD_SW %d" % ops.sw,
        "#define KSFD_RHOMIN (%s)" % _flit(ops.rhomin),
        "#define KSFD_UMIN (%s)" % _flit(ops.Umin),
    ]
    for d, axis in enumerate("xyz"[:dim]):
        for order in (1, 2):
            lines.append(_stencil_fn(
                "ksfd_d%d%s" % (order, axis),
                deriv_coeffs(order, ops.sw, ops.spacing[d]),
            ))
    for cname in ("gamma", "s", "D"):
        lines.append(_table_fn(
            "ksfd_%s" % cname, [c[cname] for c in ops.lig_constants]
        ))
    lines += [
        "",
        "__device__ __forceinline__ float ksfd_G(const float* f) {",
        "  return %s;" % c_expr(ops.G_expr, fmap),
        "}",
        "",
        "__device__ __forceinline__ void ksfd_dG(const float* f, "
        "float* out) {",
    ]
    for i, e in enumerate(ops.dG_exprs):
        lines.append("  out[%d] = %s;" % (i, c_expr(e, fmap)))
    lines += [
        "}",
        "",
        "__device__ __forceinline__ float ksfd_G_delta(const float* f, "
        "const float* d, const float* s) {",
        "  return %s;" % c_expr(ops.G_delta_expr, {**fmap, **dmap, **smap}),
        "}",
        "",
    ]
    return "\n".join(lines)
