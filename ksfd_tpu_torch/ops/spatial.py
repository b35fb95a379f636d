"""SpatialExpression: evaluate a sympy expression of x,y,z,t on a grid.

Counterpart: ksfd_tpu/ops/spatial.py:SpatialExpression.  The
expression compiles to a function of torch tensors (utils/symbolic.py
torchify) over coordinate tensors held on the operators' device, so a
source is evaluated at a device time tensor without a host round trip.

All parameters are resolved at construction time: constants are folded
to numbers and time-dependent parameters are substituted with their
resolved expressions in ``t`` (SolutionParameters.resolved), leaving an
expression in the coordinates and ``t`` only.
"""

import numbers

import sympy as sy
import torch

from ..utils.device import resolve_device
from ..utils.exceptions import KSFDException
from ..utils.symbolic import safe_sympify, torchify

__all__ = ["SpatialExpression"]

_XYZT = sy.symbols("x y z t")


class SpatialExpression:
    """A function of space (and optionally time) on a Grid.

    Call with a time (python float or 0-d tensor) to get a float64
    tensor of shape ``grid.Sshape`` on ``device`` (the card unless
    given, utils/device.py).
    """

    def __init__(self, ps, grid, expr, name="spatial", device=None):
        self.ps = ps
        self.grid = grid
        self.name = name
        self.device = resolve_device(device)
        if isinstance(expr, SpatialExpression):
            expr = expr.expr
        self.source = expr
        sexpr = safe_sympify(expr)
        if sexpr is None:
            sexpr = sy.Float(0.0)
        if isinstance(sexpr, (bool, numbers.Number)):
            sexpr = sy.Float(float(sexpr))
        # Resolve every non-coordinate symbol through the parameter DAG.
        coords = set(_XYZT[: grid.dim]) | {_XYZT[3]}
        if ps is not None:
            resolved = getattr(ps, "resolved", {})
            for _ in range(3):  # resolved exprs are already leaf-only
                free = sexpr.free_symbols - coords
                if not free:
                    break
                subs = {}
                for s in free:
                    if str(s) in resolved:
                        subs[s] = resolved[str(s)]
                if not subs:
                    break
                sexpr = sexpr.subs(subs)
        extra = sexpr.free_symbols - coords
        if extra:
            raise KSFDException(
                "unknown symbols {syms} in spatial expression {expr!r}".format(
                    syms=sorted(map(str, extra)), expr=str(expr)
                )
            )
        self.expr = sexpr
        self.tdep = _XYZT[3] in sexpr.free_symbols
        args = list(_XYZT[: grid.dim]) + [_XYZT[3]]
        self._fn = torchify(args, sexpr, name=name)
        self._coords = [
            torch.as_tensor(grid.coords[d], device=self.device)
            for d in range(grid.dim)
        ]

    def __call__(self, t=0.0, out=None):
        val = torch.as_tensor(
            self._fn(*self._coords, t), dtype=torch.float64,
            device=self.device,
        )
        val = torch.broadcast_to(val, self.grid.Sshape)
        if out is not None:
            # the reference's out= protocol for host callers holding
            # numpy buffers
            arr = out[0] if isinstance(out, tuple) else out
            arr[...] = val.cpu().numpy()
        return val

    def is_zero(self):
        return bool(self.expr.is_zero)

    def __repr__(self):
        return "SpatialExpression({e!r})".format(e=str(self.expr))

    # pickling: reconstructible from (ps, grid, source)
    def __getstate__(self):
        return (self.ps, self.grid, str(self.source), self.name,
                str(self.device))

    def __setstate__(self, state):
        ps, grid, source, name, device = state
        self.__init__(ps, grid, source, name=name, device=device)
