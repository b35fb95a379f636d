"""Symbolic utilities: safe sympification and sympy->PyTorch compilation.

Counterpart of ksfd_tpu/utils/symbolic.py: ``safe_sympify`` is the same
function; ``torchify`` replaces ``jaxify`` and compiles a sympy
expression into a plain Python function of torch tensors.

sympy's own TorchPrinter cannot print the stage-delta expressions of
ops/delta.py: it has no rule for the ``where_``/``log1p``/``expm1``
heads (it raises even when a module dict supplies them) and prints
``Max(-1/2, x)`` as ``torch.max(-1/2, x)``, which fails on a float and
a tensor.  ``_TorchPrinter`` adds those rules: ``Max``/``Min`` become
``torch.clamp`` against the numeric arguments and ``torch.maximum``/
``torch.minimum`` between tensors; a constant power prints as a float.
"""

import keyword
import re

import sympy as sy
from sympy.printing.pytorch import TorchPrinter

from .exceptions import KSFDException

__all__ = ["safe_sympify", "torchify", "free_parameter_names"]


#: Strings with non-expression meanings in the parameter language.
_LITERALS = {"": None, "True": True, "False": False}

_WORD_RE = re.compile(r"[A-Za-z_]\w*")


def safe_sympify(exp):
    """sympify() with a clear error on Python reserved keywords.

    Counterpart: ksfd_tpu/utils/symbolic.py:safe_sympify.
    '' -> None, 'False'/'True' -> bool, any string containing a Python
    keyword raises KSFDException.
    """
    if isinstance(exp, str):
        if exp in _LITERALS:
            return sy.sympify(_LITERALS[exp])
        reserved = sorted(
            {w for w in _WORD_RE.findall(exp) if keyword.iskeyword(w)}
        )
        if reserved:
            raise KSFDException(
                "expression contains Python keyword %r: %r"
                % (reserved[0], exp)
            )
    return sy.sympify(exp)


class _TorchPrinter(TorchPrinter):
    """TorchPrinter plus the heads the increment rewrite emits."""

    _HEADS = {"log1p": "torch.log1p", "expm1": "torch.expm1"}

    def _print_Function(self, expr):
        name = type(expr).__name__
        if name == "where_":
            c, a, b = (self._print(x) for x in expr.args)
            return "torch.where(%s, %s, %s)" % (c, a, b)
        if name in self._HEADS:
            (a,) = expr.args
            return "%s(%s)" % (self._HEADS[name], self._print(a))
        return super()._print_Function(expr)

    def _minmax(self, expr, pair, bound):
        nums = [float(a) for a in expr.args if a.is_number]
        terms = [self._print(a) for a in expr.args if not a.is_number]
        out = terms[0]
        for t in terms[1:]:
            out = "%s(%s, %s)" % (pair, out, t)
        if nums:
            lim = max(nums) if bound == "min" else min(nums)
            out = "torch.clamp(torch.as_tensor(%s), %s=%r)" % (
                out, bound, lim,
            )
        return out

    def _print_Pow(self, expr):
        # a constant power (pi**2 in a manufactured source) as a float,
        # a constant base by Python's power: torch.pow takes no pair of
        # numbers
        if expr.is_number and expr.is_real:
            return repr(float(expr))
        if expr.base.is_number:
            return "(%s)**(%s)" % (self._print(expr.base),
                                   self._print(expr.exp))
        return super()._print_Pow(expr)

    def _print_Max(self, expr):
        return self._minmax(expr, "torch.maximum", "min")

    def _print_Min(self, expr):
        return self._minmax(expr, "torch.minimum", "max")


def torchify(args, expr, name=None):
    """Compile a sympy expression to a function of torch tensors.

    Counterpart: ksfd_tpu/utils/symbolic.py:jaxify.  Python-float
    literals keep the dtype of the tensor arguments, so the same
    function serves float32 and float64 callers.
    """
    fn = sy.lambdify(tuple(args), expr, modules="torch",
                     printer=_TorchPrinter)
    if name:
        fn.__name__ = name
    return fn


def free_parameter_names(expr, exclude=("x", "y", "z", "t")):
    """Sorted names of free symbols in ``expr`` excluding coordinates."""
    expr = safe_sympify(expr)
    if expr is None or isinstance(expr, bool):
        return []
    try:
        syms = expr.free_symbols
    except AttributeError:
        return []
    return sorted(str(s) for s in syms if str(s) not in exclude)
