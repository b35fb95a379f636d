"""Parameter system: named, defaulted, sympy-valued parameters.

Counterpart: ksfd_tpu/utils/params.py (a copy: the module is free of
JAX, but ksfd_tpu/__init__.py imports jax, so it cannot be shared).

The user-facing parameter *language* is identical to the reference's
(KSFD/ksfdligand.py:14-254, KSFD/ksfdargparse.py:11-55): parameters are
``name=value`` strings where ``value`` is a sympy expression that may
reference other parameters and ``t`` (and, for spatially evaluated
parameters, ``x``/``y``/``z``); booleans and plain numbers are coerced
to Python bool/int/float at decode time.

The *implementation* is this project's own: a parameter is a ``Slot``
(a read/write accessor pair, so the value may live anywhere — a Ligand
field, a group attribute, or the list's private store), and a
``ParameterList`` is a single ordered registry of ``(slot, default,
help)`` records rather than parallel dictionaries.
"""

import collections
import dataclasses
import re
import typing

import sympy as sy

from .exceptions import KSFDException
from .symbolic import safe_sympify

__all__ = [
    "Parameter",
    "ParameterList",
    "find_duplicates",
    "default_parameters",
]


#: The canonical table of (name, default, help).  Values mirror the
#: reference defaults exactly (KSFD/ksfdargparse.py:11-55) — this table
#: IS the parity surface, so the constants are necessarily the same.
default_parameters = [
    ("degree", 3, "order of finite difference approximations"),
    ("dim", 1, "spatial dimensions"),
    ("nelements", 8, "number of grid points in each dimension"),
    ("nwidth", 8, "number of grid points in width"),
    ("nheight", 8, "number of grid points in height"),
    ("ndepth", 8, "number of grid points in depth"),
    ("randgridnw", 0, "random grid width"),
    ("randgridnh", 0, "random grid height"),
    ("randgridnd", 0, "random grid depth"),
    ("width", 1.0, "width of spatial domain"),
    ("height", 1.0, "height of spatial domain"),
    ("depth", 1.0, "depth of spatial domain"),
    ("CFL_safety_factor", 0.0, "CFL upper bound on timestep"),
    ("conserve_worms", False, "enforce conservation of worms"),
    ("variance_rate", 0.0, "rate of increase in random rho variance"),
    ("variance_interval", 100.0, "frequency of increase in random rho variance"),
    (
        "variance_timing_function",
        sy.sympify("t/variance_interval"),
        "when to inject noise",
    ),
    ("Umin", 1e-7, "minimum allowed value of U"),
    ("rhomin", 1e-7, "minimum allowed value of rho"),
    ("rhomax", 28000, "approximate max value of rho"),
    ("cushion", 2000, "cushion on rho"),
    ("maxscale", 2.0, "scale of cap potential"),
    ("s2", 5.56e-4, "random worm movement (sigma)"),
    ("Nworms", 0.0, "total number of worms"),
    ("srho0", 90.0, "standard deviation of rho(0)"),
    ("rho0", 9000.0, "function for rho0, added to random rho0"),
    ("U0_1_1", "", "function for U0_1_1"),
    ("ngroups", 1, "number of ligand groups"),
    ("nligands_1", 1, "number of ligands in group 1"),
    ("alpha_1", 1500.0, "alpha for ligand group 1"),
    ("beta_1", 5.56e-4, "beta for ligand group 1"),
    ("s_1_1", 0.01, "s for ligand group 1, ligand 1"),
    ("gamma_1_1", 0.01, "gamma for ligand group 1, ligand 1"),
    ("D_1_1", 1e-6, "D for ligand group 1, ligand 1"),
    ("maxsteps", 1000, "maximum number of time steps"),
    ("t0", 0.0, "initial time"),
    ("dt", 0.001, "first time step"),
    ("lastvart", 0.0, "last variance injection time"),
    ("tmax", 200000, "time to simulate"),
    ("rtol", 1e-5, "relative tolerance for step size adaptation"),
    ("atol", 1e-5, "absolute tolerance for step size adaptation"),
]


def find_duplicates(items):
    """Sorted list of entries appearing more than once in ``items``."""
    counts = collections.Counter(items)
    return sorted(item for item, n in counts.items() if n > 1)


_PARAM_RE = re.compile(r"(?s)(?P<key>[^=]*)=(?P<value>.*)")


def _concretize(value):
    """Collapse a sympified value to a native bool/int/float if it is one.

    Symbolic expressions (and anything else) pass through unchanged.
    """
    if value is None:
        return False
    if isinstance(value, bool):
        return value
    for predicate, pytype in (
        ("is_Boolean", bool),
        ("is_Integer", int),
        ("is_Float", float),
    ):
        if getattr(value, predicate, False):
            return pytype(value)
    return value


class Parameter:
    """A read/write slot for one parameter value.

    The value may be stored anywhere; the slot is a pair of accessor
    callables.  Calling conventions (kept for reference-API parity,
    KSFD/ksfdligand.py:14-57): ``p()`` reads, ``p(v)`` writes then
    reads; ``.get()``/``.set(v)`` and the ``.val`` property are
    explicit spellings of the same.
    """

    __slots__ = ("_read", "_write")

    def __init__(self, getter, setter):
        self._read = getter
        self._write = setter

    @classmethod
    def boxed(cls, value=None):
        """A slot owning its own storage."""
        cell = [value]

        def read():
            return cell[0]

        def write(v):
            cell[0] = v

        return cls(read, write)

    @classmethod
    def of_attr(cls, obj, attr):
        """A slot backed by ``obj.<attr>``."""

        def read():
            return getattr(obj, attr)

        def write(v):
            setattr(obj, attr, v)

        return cls(read, write)

    def __call__(self, val=None):
        if val is not None:
            self._write(val)
        return self._read()

    def get(self):
        return self._read()

    def set(self, val):
        self._write(val)

    val = property(get, set)


@dataclasses.dataclass
class _Entry:
    """One registry record of a ParameterList."""

    slot: Parameter
    default: typing.Any = None
    help: typing.Optional[str] = None


class ParameterList:
    """Ordered registry of named parameters with defaults and help text.

    Construction/`add` accepts records shaped ``(key, default)``,
    ``(key, default, help)`` (list-owned storage) or ``(key, Parameter,
    default, help)`` (externally stored).  ``decode`` parses
    ``key=value`` command-line strings with sympy values.
    """

    def __init__(self, parameters=()):
        self._entries = collections.OrderedDict()
        self.add(parameters)

    # -- registration --------------------------------------------------
    def add(self, parameters):
        for record in parameters:
            record = tuple(record)
            if len(record) == 4:
                key, slot, default, helptext = record
            elif len(record) in (2, 3):
                key, default = record[:2]
                helptext = record[2] if len(record) == 3 else None
                existing = self._entries.get(key)
                if existing is not None:
                    slot = existing.slot  # keep storage, refresh metadata
                else:
                    slot = Parameter.boxed(default)
            else:
                raise ValueError(
                    "parameter record has length %d; 2, 3 or 4 required"
                    % len(record)
                )
            self._entries[key] = _Entry(slot, default, helptext)

    def update(self, parameters):
        """Set many values at once, registering unknown keys on the fly."""
        pairs = (
            parameters.items()
            if hasattr(parameters, "items")
            else parameters
        )
        for key, value in pairs:
            self[key] = value

    # -- mapping protocol ----------------------------------------------
    def keys(self):
        return self._entries.keys()

    def items(self):
        for key, entry in self._entries.items():
            yield key, entry.slot.get()

    def __iter__(self):
        return self.items()

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def __getitem__(self, key):
        return self._entries[key].slot.get()

    def __setitem__(self, key, value):
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = _Entry(Parameter.boxed(value))
        else:
            entry.slot.set(value)

    def __delitem__(self, key):
        del self._entries[key]

    def get(self, key, default=None):
        entry = self._entries.get(key)
        return default if entry is None else entry.slot.get()

    # -- the command-line parameter language ----------------------------
    def decode(self, params, allow_new=False):
        """Decode ``key=value`` strings (sympy values).

        Duplicated keys raise KSFDException; unknown keys raise KeyError
        unless ``allow_new``.
        """
        parsed = []
        for arg in params:
            m = _PARAM_RE.fullmatch(arg)
            if m is None:
                raise KSFDException(
                    "parameter argument %r is not of form key=value" % (arg,)
                )
            parsed.append((m["key"], m["value"]))
        dups = find_duplicates(key for key, _ in parsed)
        if dups:
            raise KSFDException("duplicated parameters: " + ", ".join(dups))
        for key, text in parsed:
            if key not in self._entries and not allow_new:
                raise KeyError(key)
            self[key] = _concretize(safe_sympify(text))

    # -- introspection ---------------------------------------------------
    def params(self):
        """(key, Parameter, default, help) tuples for all parameters."""
        return [
            (key, e.slot, e.default, e.help)
            for key, e in self._entries.items()
        ]

    def __str__(self):
        return "".join(
            "%s=%s\n" % (key, value) for key, value in self.items()
        )
