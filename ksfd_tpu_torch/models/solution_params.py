"""SolutionParameters: the single source of truth for a problem.

Merges built-in defaults, ligand-group parameters, and user
``name=value`` command-line parameters; resolves the parameter
dependency DAG by topological sort; lambdifies every parameter into a
function of time; and provides the potential V(Us, rho).

Counterpart: ksfd_tpu/models/solution_params.py:SolutionParameters (a
copy: that package imports jax on import).  The reference's ``td_jax``
table has no user yet and is not ported.
"""

import collections
import copy
import re

import sympy as sy

from ..utils.exceptions import KSFDException
from ..utils.params import ParameterList, default_parameters
from ..utils.symbolic import safe_sympify
from .ligands import LigandGroups

__all__ = ["SolutionParameters", "topological_sort"]


def topological_sort(nodes, edges):
    """Kahn's algorithm. ``edges`` is a set of (u, v) meaning u before v."""
    nodes = list(nodes)
    succ = collections.defaultdict(set)
    indeg = {n: 0 for n in nodes}
    for u, v in edges:
        if u not in indeg or v not in indeg:
            continue
        if v not in succ[u]:
            succ[u].add(v)
            indeg[v] += 1
    ready = collections.deque(n for n in nodes if indeg[n] == 0)
    order = []
    while ready:
        n = ready.popleft()
        order.append(n)
        for m in sorted(succ[n]):
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
    if len(order) != len(nodes):
        cyc = sorted(n for n in nodes if indeg[n] > 0)
        raise KSFDException(
            "cyclic parameter dependencies involving: " + ", ".join(cyc)
        )
    return order


class SolutionParameters:
    """All parameters of a Keller-Segel problem.

    Key members:
    params0: ParameterList of initial (t0) parameter values; values may
        still be sympy expressions.
    values0: dict of all parameters evaluated at t0 (numbers, or
        space-dependent expressions for e.g. rho0).
    groups / Vgroups: LigandGroups (Vgroups is an independent deepcopy
        used when evaluating V with runtime parameter overrides).
    funcs / tdfuncs: name -> func(t) for all / time-dependent params.
    constants: dict of parameters that do not vary in time.
    V: V(Us, rho, params) — signal potential + density cap potential.
    """

    def __init__(self, clargs):
        self.clargs = clargs
        self.groups = LigandGroups(clargs)
        self.params0 = ParameterList(default_parameters)
        self.t0 = self.params0["t0"]
        self.params0["t"] = self.t0
        self.params0.add(self.groups.params())
        self.cparams = ParameterList()  # command-line params only
        self.cparams.decode(clargs.params, allow_new=True)
        self.params0.decode(clargs.params, allow_new=True)
        # nelements is a shortcut for the per-axis grid sizes
        # (ksfdsolver2.py docstring, 'nelements').
        if "nwidth" not in self.cparams:
            self.params0["nwidth"] = self.params0["nelements"]
        if "nheight" not in self.cparams:
            self.params0["nheight"] = self.params0["nelements"]
        if "ndepth" not in self.cparams:
            self.params0["ndepth"] = self.params0["nelements"]
        self.nwidth = int(self.params0["nwidth"])
        self.nheight = int(self.params0["nheight"])
        self.ndepth = int(self.params0["ndepth"])
        self.groups.fourier_series()
        self.params0.add(self.groups.params())  # Fourier may add ligands
        self.Vgroups = copy.deepcopy(self.groups)
        self.Vparams = ParameterList(default_parameters)
        self.Vparams.add(self.Vgroups.params())
        self.width = float(self.params0["width"])
        self.height = float(self.params0["height"])
        self.depth = float(self.params0["depth"])
        self.dim = int(self.params0["dim"])
        self.degree = int(self.params0["degree"])
        self.nligands = self.groups.nligands()
        self.rhomax = self.params0["rhomax"]
        self.cushion = self.params0["cushion"]
        self.t0 = self.params0["t0"]
        self.maxscale = self.params0["maxscale"]
        self.pfuncs()
        self.values0 = self.values()
        self.constants = collections.OrderedDict(
            (k, v) for k, v in self.values0.items() if k not in self.tdfuncs
        )
        self._make_V()

    # -- pickling: a SolutionParameters is reproducible from clargs ----
    def __getstate__(self):
        return self.clargs

    def __setstate__(self, clargs):
        self.__init__(clargs)

    # ------------------------------------------------------------------
    def _make_V(self):
        def Vfunc(Us, params={}):
            self.Vparams.update(params)
            return self.Vgroups.V(Us)

        def Vtophat(rho, params={}):
            tanh = sy.tanh((rho - params["rhomax"]) / params["cushion"])
            return params["maxscale"] * params["s2"] * (tanh + 1)

        def Vwitch(rho, params={}):
            tanh = sy.tanh((rho - params["rhomax"]) / params["cushion"])
            return (
                params["maxscale"]
                * params["s2"]
                * (tanh + 1)
                * (rho / params["rhomax"])
            )

        cappotential = getattr(self.clargs, "cappotential", "tophat")
        Vcap = Vwitch if cappotential == "witch" else Vtophat
        self.Vcap = Vcap

        def V2(Us, rho, params={}):
            return Vfunc(Us, params=params) + Vcap(rho, params=params)

        self.V = V2

    def values(self, t=None):
        """All parameter values at time t (default t0), as an OrderedDict."""
        if t is None:
            t = self.t0
        return collections.OrderedDict(
            (name, func(t)) for name, func in self.funcs.items()
        )

    #: Parameters never turned into symbols (problem-structure numbers
    #: and spatial initial-condition expressions).
    non_symbolic_params = [
        re.compile(nsp)
        for nsp in [
            "degree",
            "dim",
            "nelements",
            "nwidth",
            "nheight",
            "ndepth",
            "width",
            "Nworms",
            "ngroups",
            r"nligands_\d+",
            "maxsteps",
            "rtol",
            "atol",
            r"series_\d+_\d+",
            "rho0",
            r"U0_\d+_\d+",
        ]
    ]

    def _blocked(self, name):
        return any(re.fullmatch(nsp, name) for nsp in self.non_symbolic_params)

    def param_symbols(self):
        """name -> sympy Symbol (or numeric value for structural params)."""
        psyms = collections.OrderedDict()
        for name in self.funcs.keys():
            if self._blocked(name):
                psyms[name] = self.params0[name]
            else:
                psyms[name] = sy.Symbol(name)
        return psyms

    def time_dependent_symbols(self):
        """constants -> numbers, time-dependent params -> symbols."""
        tds = collections.OrderedDict(self.values0)
        for name in self.tdfuncs:
            tds[name] = sy.Symbol(name)
        return tds

    def td_value_array(self, t):
        """Values of the time-dependent params (sorted by name) at host time t."""
        return [self.tdfuncs[name](t) for name in sorted(self.tdfuncs)]

    def pfuncs(self):
        """Resolve the parameter DAG into per-parameter functions of t.

        Each parameter's expression is substituted with the resolved
        expressions of the parameters it depends on (in topological
        order), yielding per-parameter functions func(t).  Parameters
        whose resolved expression still contains x/y/z return sympy
        expressions (used by spatial initial conditions / sources);
        pure-t parameters are lambdified; constants return floats.
        """
        params0 = self.params0
        leaves = set(sy.symbols("t x y z")[: self.dim + 1])
        keys = set(params0.keys()).difference(map(str, leaves))
        edges = set()
        for p1, v1 in params0.items():
            if isinstance(v1, str):
                v1 = safe_sympify(v1)
            if v1 is None or isinstance(v1, (bool, int, float)):
                continue
            for p2 in v1.free_symbols.difference(leaves):
                edges.add((str(p2), p1))
        order = topological_sort(sorted(keys), edges)
        done = collections.OrderedDict()   # substitutable resolved values
        funcs = {}
        tdfuncs = {}
        tsym = sy.Symbol("t")
        for k in order:
            pt = params0[k]
            if isinstance(pt, str):
                pt = safe_sympify(pt)
            isnum = pt is None or pt == "" or isinstance(pt, (bool, int, float))
            if not isnum:
                pt = pt.subs(done)
            # None/bool values can't participate in substitutions
            if not (pt is None or isinstance(pt, bool)):
                done[k] = pt
            free = pt.free_symbols if not isnum else set()
            if not free:
                p0 = pt.evalf() if not isnum else pt
                if not isnum:
                    p0 = float(p0)

                def func(t, params={}, p0=p0):
                    return p0

                funcs[str(k)] = func
            elif free == {tsym}:
                lpt = sy.lambdify(tsym, pt, "numpy")

                def func(t, params={}, l0=lpt):
                    return float(l0(t))

                funcs[str(k)] = func
                tdfuncs[str(k)] = func
            else:

                def func(t, params={}, s0=pt):
                    return s0.subs({"t": t})

                funcs[str(k)] = func
                if tsym in pt.free_symbols:
                    tdfuncs[str(k)] = func

        def identity(t, params={}):
            return t

        funcs["t"] = identity
        tdfuncs["t"] = identity
        self.funcs = funcs
        self.tdfuncs = tdfuncs
        self.resolved = done
        return (funcs, tdfuncs)
