"""Cancellation-free increment forms: expr(u+d) - expr(u), exactly.

The stage right-hand sides of a Rosenbrock/DIRK step differ from the
step-base RHS by an amount proportional to the stage increment.  A
float32 kernel cannot evaluate f(U_i) directly to useful accuracy on
O(1e4) states (state quantization alone is ~6e-4 absolute), but it CAN
evaluate the DIFFERENCE f(u0 + d) - f(u0) to ~1e-7 relative accuracy
of the difference — provided every subtraction of large, nearly-equal
quantities is rewritten into an algebraically equivalent form that
never forms the large intermediates.  This module performs that
rewrite on the sympy expression tree:

    log(a + da) - log(a)    ->  log1p(da / a), switching to a direct
                                   log difference for |da| >= a/2
    exp(a + da) - exp(a)    ->  exp(a) * expm1(da)
    tanh(a + da) - tanh(a)  ->  tanh(da)*(1 - tanh(a)*tanh(a + da))
    (A*B)(u+d) - (A*B)(u)   ->  dA*B + A*dB + dA*dB
    (a + da)^n - a^n        ->  binomial expansion (every term
                                   carries a factor of da)
    sqrt(a + da) - sqrt(a)  ->  da / (sqrt(a+da) + sqrt(a))
    1/(a + da) - 1/a        ->  -da / (a*(a + da))

All identities are EXACT; only their floating-point evaluation
differs from the naive difference.  This powers the delta kernel
(ops/fused_stencil.py, csrc/stencil2d.cu) that replaces 3 of the 4
float64 stage RHS evaluations per implicit step.

Counterpart: ksfd_tpu/ops/delta.py.  ``delta_expr`` is sympy and is
copied unchanged; ``torchify_delta`` replaces ``jaxify_delta``.  The
CUDA kernel gets the same expression through ops/codegen.py.
"""

import sympy as sy

from ..utils.exceptions import KSFDException

__all__ = ["delta_expr", "torchify_delta", "UnsupportedDelta"]


class UnsupportedDelta(KSFDException):
    """Raised when an expression has no known cancellation-free
    increment form; callers fall back to full-precision evaluation."""


#: sympy Function heads emitted by the rewrite.  utils/symbolic.py's
#: torch printer and ops/codegen.py's C printer each have a rule for
#: them (where_ -> torch.where / a C conditional).
log1p = sy.Function("log1p")
expm1 = sy.Function("expm1")
where_ = sy.Function("where_")


def delta_expr(expr, field_map, shifted_map=None):
    """The increment expr(.. f+df ..) - expr(.. f ..), rewritten.

    Parameters
    ----------
    expr : sympy expression over field symbols (+ anything field-free,
        e.g. time).
    field_map : dict {field_symbol: delta_symbol}.
    shifted_map : optional dict {field_symbol: shifted_symbol} naming
        the SHIFTED state f + df as its own input.  Low-precision
        evaluation needs it: when a clamp sends a field from O(1e4) to
        its floor, df/f rounds to exactly -1 in float32 and
        log1p(-1) = -inf; the rewrite then branches per point to a
        direct difference of the (far-apart, cancellation-free)
        shifted and base values.  Without it, shifted quantities are
        formed as f + df (adequate in float64).

    Returns a sympy expression over the field symbols, the delta
    symbols (and shifted symbols if given) in which every term
    carries at least one delta factor — i.e. it evaluates the
    increment without ever forming expr(u + d) or expr(u) themselves.
    Raises UnsupportedDelta for expression shapes without a known
    rewrite.
    """
    expr = sy.sympify(expr)
    fields = set(field_map)

    def is_const(e):
        return fields.isdisjoint(e.free_symbols)

    def shifted(e):
        """e at the shifted state (exact)."""
        if shifted_map is not None:
            return e.xreplace(shifted_map)
        return e.xreplace({f: f + d for f, d in field_map.items()})

    def rec(e):
        if is_const(e):
            return sy.S.Zero
        if e in field_map:
            return field_map[e]
        if isinstance(e, sy.Add):
            return sy.Add(*[rec(a) for a in e.args])
        if isinstance(e, sy.Mul):
            const = [a for a in e.args if is_const(a)]
            dep = [a for a in e.args if not is_const(a)]
            c = sy.Mul(*const) if const else sy.S.One
            # fold dependent factors pairwise:
            # d(AB) = dA*B + A*dB + dA*dB
            cur, dcur = dep[0], rec(dep[0])
            for nxt in dep[1:]:
                dnxt = rec(nxt)
                dcur = dcur * nxt + cur * dnxt + dcur * dnxt
                cur = cur * nxt
            return c * dcur
        if isinstance(e, sy.Pow):
            base, ex = e.args
            if is_const(base):
                raise UnsupportedDelta(
                    "field-dependent exponent in %s" % (e,)
                )
            db = rec(base)
            if ex.is_Integer and ex > 0:
                # every binomial term carries a db factor
                n = int(ex)
                return sy.Add(*[
                    sy.binomial(n, k) * base ** (n - k) * db ** k
                    for k in range(1, n + 1)
                ])
            if ex.is_Integer and ex < 0:
                # d(b^-n) = (b^n - (b+db)^n) / (b^n (b+db)^n); the
                # numerator is MINUS the positive-power delta
                n = int(-ex)
                num = sy.Add(*[
                    sy.binomial(n, k) * base ** (n - k) * db ** k
                    for k in range(1, n + 1)
                ])
                return -num / (base ** n * shifted(base) ** n)
            if ex == sy.Rational(1, 2):
                return db / (sy.sqrt(shifted(base)) + sy.sqrt(base))
            raise UnsupportedDelta("exponent %s in %s" % (ex, e))
        if isinstance(e, sy.log):
            (a,) = e.args
            da = rec(a)
            # The small branch is only SELECTED for |da| < a/2, where
            # da/a > -1/2, so clamping its argument at -1/2 is the
            # identity there — but it keeps the UNSELECTED lanes
            # finite (da/a <= -1 under a clamp-to-floor increment
            # would make log1p produce -inf/NaN in the discarded
            # branch).
            small = log1p(sy.Max(da / a, sy.Rational(-1, 2)))
            # Large relative increments (|da| >= a/2, e.g. a clamp to
            # the floor): da/a is within one ulp of -1 in low
            # precision, so difference the logs directly — the values
            # are far apart there, so no cancellation.
            big = sy.log(shifted(a)) - sy.log(a)
            return where_(sy.Abs(da) < a / 2, small, big)
        if isinstance(e, sy.exp):
            (a,) = e.args
            return sy.exp(a) * expm1(rec(a))
        if isinstance(e, sy.tanh):
            # tanh(b) - tanh(a) = tanh(b-a) * (1 - tanh(a)*tanh(b)):
            # exact, and — unlike the (1 - T^2)/(1 + T*Td) form — has
            # no denominator, so opposite saturations (T=1, Td=-1)
            # cannot produce 0/0.
            (a,) = e.args
            return sy.tanh(rec(a)) * (1 - sy.tanh(a) * sy.tanh(shifted(a)))
        raise UnsupportedDelta(
            "no increment form for %s node %s" % (type(e).__name__, e)
        )

    return rec(expr)


def torchify_delta(args, expr, name=None):
    """Compile a delta_expr result (may contain where_/log1p/expm1
    heads) to a torch function; counterpart of jaxify_delta."""
    from ..utils.symbolic import torchify

    return torchify(args, expr, name=name)
