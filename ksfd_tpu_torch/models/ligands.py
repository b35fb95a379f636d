"""Ligand groups: the chemical-signal model of the Keller-Segel system.

Counterpart: ksfd_tpu/models/ligands.py (a copy: that package imports
jax on import).

Model semantics (reference: KSFD/ksfdligand.py:256-747):

Ligands are organized into groups.  Group ``g`` contributes

    V_g = -beta_g * log(alpha_g + sum_l weight_{g,l} * U_{g,l})

to the potential; the total signal potential is the sum over groups.
Separating ligands into groups lets a repellent be expressed with a
negative ``beta`` without risking a negative log argument.

Each ligand also carries a secretion rate ``s``, a decay rate
``gamma``, and a diffusion constant ``D``; its PDE is

    dU/dt = -gamma*U + s*rho + D*laplacian(U).

A ligand with ``series=n > 1`` is expanded into ``n`` Fourier
components in the depth direction (diffusion of the ligand into the
agar substrate): component i gets gamma += D*(pi*i/depth)**2 and s/n
secretion, with an optional steady-state total-concentration
adjustment.  (Model per KSFD/ksfdligand.py:315-388; independent
implementation.)

The implementation here is dataclass-based: a ``Ligand`` is a plain
record whose fields are the per-ligand parameters; group size is
always derived from the ligand list (``nligands`` is a property), so
the count can never disagree with the ligands themselves.
"""

import dataclasses
import itertools
import typing

import sympy as sy

from ..utils.exceptions import KSFDException
from ..utils.params import Parameter, ParameterList

__all__ = ["Ligand", "LigandGroup", "LigandGroups"]


#: (name, default, help-template) for per-group parameters.
GROUP_PARAMS = [
    ("alpha", 1.0, "V = -beta*log(w.U + alpha) for group {group}"),
    ("beta", 1.0, "V = -beta*log(w.U + alpha) for group {group}"),
    ("nligands", 1, "number of ligands in group {group}"),
]

#: (name, default, help-template) for per-ligand parameters.
LIGAND_PARAMS = [
    ("weight", 1.0, "weight of ligand {ligand} in group {group}"),
    ("s", 1.0, "secretion rate of ligand {ligand} in group {group}"),
    ("gamma", 1.0, "decay rate of ligand {ligand} in group {group}"),
    ("D", 1.0, "diffusion of ligand {ligand} in group {group}"),
    ("series", 1, "Fourier series component of ligand {ligand} in group {group}"),
    ("depth", 0.4, "depth for ligand {ligand} in group {group}"),
]


@dataclasses.dataclass
class Ligand:
    """One ligand field U_<group>_<ligand> and its parameters.

    Field values may be numbers or sympy expressions (the parameter
    language allows either).
    """

    groupnum: int = 1
    ligandnum: int = 1
    nligands: int = 1
    # group-level coefficients mirrored onto each member so per-ligand
    # parameter listings are self-contained
    alpha: typing.Any = 1.0
    beta: typing.Any = 1.0
    # per-ligand parameters (defaults duplicate LIGAND_PARAMS)
    weight: typing.Any = 1.0
    s: typing.Any = 1.0
    gamma: typing.Any = 1.0
    D: typing.Any = 1.0
    series: typing.Any = 1
    depth: typing.Any = 0.4
    # set on depth-Fourier components
    fourier_term: typing.Optional[int] = None
    omega: typing.Any = 0

    def name(self):
        """The ligand's field name, always ``U_<group>_<ligand>``."""
        return "U_%d_%d" % (self.groupnum, self.ligandnum)

    def params(self):
        """[(key, Parameter, default, help)] records for this ligand.

        Keys have the form ``<name>_<group>_<ligand>`` and the
        Parameter slots write through to this object's fields.
        """
        return [
            (
                "%s_%d_%d" % (pname, self.groupnum, self.ligandnum),
                Parameter.of_attr(self, pname),
                default,
                helptmpl.format(group=self.groupnum, ligand=self.ligandnum),
            )
            for pname, default, helptmpl in LIGAND_PARAMS
        ]

    def fourier_series(self, adjust=True):
        """Expand this ligand into its depth-Fourier components.

        Returns ``round(self.series)`` new Ligands.  Component i models
        the cos(i*pi*z/depth) depth mode: it decays faster by
        D*(pi*i/depth)**2 and is secreted at rate s/series.  With
        ``adjust``, component secretion rates are rescaled so the
        local-steady-state total sum(s_i/gamma_i) matches the
        unexpanded ligand's s/gamma.
        """
        n = round(self.series)
        components = []
        for i in range(n):
            omega = sy.pi * i / self.depth
            components.append(
                dataclasses.replace(
                    self,
                    fourier_term=i,
                    omega=omega,
                    s=self.s / n,
                    weight=self.weight / n,
                    gamma=self.gamma + self.D * omega**2,
                )
            )
        if adjust and components:
            rescale = (self.s / self.gamma) / sum(
                c.s / c.gamma for c in components
            )
            for c in components:
                c.s = c.s * rescale
        return components


class LigandGroup:
    """One group of ligands sharing a log-potential.

    The member list is authoritative: ``nligands`` is derived from it
    (assigning ``nligands`` resizes the list with default ligands).
    """

    def __init__(self, groupnum=1, nligands=0):
        defaults = {name: d for name, d, _ in GROUP_PARAMS}
        self.groupnum = groupnum
        self._alpha = defaults["alpha"]
        self._beta = defaults["beta"]
        self.ligands = []
        self.blank = True
        if nligands:
            self._resize(nligands)

    def _new_ligand(self, ligandnum):
        return Ligand(
            groupnum=self.groupnum,
            ligandnum=ligandnum,
            alpha=self.alpha,
            beta=self.beta,
        )

    def _resize(self, n):
        """Grow/shrink the member list to n ligands; renumber."""
        del self.ligands[n:]
        while len(self.ligands) < n:
            self.ligands.append(self._new_ligand(len(self.ligands) + 1))
        self._renumber()

    def _renumber(self):
        for i, lig in enumerate(self.ligands, start=1):
            lig.ligandnum = i
            lig.nligands = len(self.ligands)

    @property
    def nligands(self):
        return len(self.ligands)

    @nligands.setter
    def nligands(self, n):
        self._resize(int(n))

    # alpha/beta writes propagate to the member ligands so per-ligand
    # parameter listings stay consistent.
    @property
    def alpha(self):
        return self._alpha

    @alpha.setter
    def alpha(self, alpha):
        self._alpha = alpha
        for lig in self.ligands:
            lig.alpha = alpha

    @property
    def beta(self):
        return self._beta

    @beta.setter
    def beta(self, beta):
        self._beta = beta
        for lig in self.ligands:
            lig.beta = beta

    def params(self):
        """[(key, Parameter, default, help)] for the group + members."""
        records = [
            (
                "%s_%d" % (pname, self.groupnum),
                Parameter.of_attr(self, pname),
                default,
                helptmpl.format(group=self.groupnum),
            )
            for pname, default, helptmpl in GROUP_PARAMS
        ]
        for lig in self.ligands:
            records.extend(lig.params())
        return records

    def collect(self, gvals, name, groupnum=None):
        """Fill per-ligand parameter ``name`` from [(group, value)] pairs.

        On first use (a blank group) the member list is sized to the
        number of matching values.  Values beyond the member count are
        ignored; members beyond the value count keep their defaults.
        """
        if groupnum is not None and groupnum != self.groupnum:
            if not self.blank:
                raise KSFDException(
                    "inconsistent group numbers %d and %d"
                    % (self.groupnum, groupnum)
                )
            self.groupnum = groupnum
            for lig in self.ligands:
                lig.groupnum = groupnum
        mine = [value for g, value in gvals if int(g) == self.groupnum]
        if self.blank:
            self._resize(len(mine))
            self.blank = False
        for lig, value in zip(self.ligands, mine):
            setattr(lig, name, value)

    def fourier_series(self):
        """Expand every member in place into its depth-Fourier components."""
        self.ligands = [
            comp for lig in self.ligands for comp in lig.fourier_series()
        ]
        self._renumber()

    def names(self):
        return [lig.name() for lig in self.ligands]

    def V(self, Us):
        """Group potential -beta*log(alpha + sum_l w_l*U_l)."""
        Us = list(Us)
        if len(Us) != self.nligands:
            raise KSFDException(
                "wrong number of ligands %d, should be %d"
                % (len(Us), self.nligands)
            )
        if not Us:
            return 0.0
        weighted = sum(lig.weight * U for lig, U in zip(self.ligands, Us))
        return -self.beta * sy.log(self.alpha + weighted)


class LigandGroups:
    """All ligand groups of a problem.

    Constructed either from parsed command-line arguments (a Namespace
    with a ``params`` list, from which ``ngroups`` / ``nligands_<g>``
    are read) or programmatically with ``ngroups`` / ``nligands``
    keyword arguments.
    """

    def __init__(self, command_line_arguments=None, **kwargs):
        if command_line_arguments is not None:
            if kwargs:
                raise KSFDException(
                    "command_line_arguments and keyword parameters are "
                    "mutually exclusive"
                )
            kwargs = dict(command_line_arguments._get_kwargs())
        self.groups = []
        if not kwargs:
            return
        if kwargs.get("ngroups"):
            sizes = dict(kwargs.get("nligands") or {})
            counts = [
                (g, sizes.get(g, 1)) for g in range(1, kwargs["ngroups"] + 1)
            ]
        elif "params" in kwargs:
            # group/ligand counts are themselves parameters:
            # ngroups, nligands_<g>
            decoded = ParameterList()
            decoded.decode(kwargs["params"], allow_new=True)
            counts = [
                (g, int(decoded.get("nligands_%d" % g, 1)))
                for g in range(1, int(decoded.get("ngroups", 1)) + 1)
            ]
        else:
            raise KSFDException("cannot determine ligand groups from arguments")
        self.groups = [
            LigandGroup(groupnum=g, nligands=n) for g, n in counts
        ]

    def nligands(self):
        return sum(group.nligands for group in self.groups)

    def ligands(self):
        return itertools.chain.from_iterable(
            group.ligands for group in self.groups
        )

    def names(self):
        return itertools.chain.from_iterable(
            group.names() for group in self.groups
        )

    def params(self):
        records = []
        for group in self.groups:
            records.extend(group.params())
        return records

    def fourier_series(self):
        for group in self.groups:
            group.fourier_series()

    def V(self, Us):
        """Total signal potential: sum of group potentials.

        ``Us`` lists the concentrations of all ligands in group order;
        entries may be numbers or sympy expressions.
        """
        Us = list(Us)
        if len(Us) != self.nligands():
            raise KSFDException(
                "provided %d ligands, need %d" % (len(Us), self.nligands())
            )
        total = 0.0
        cursor = 0
        for group in self.groups:
            total = total + group.V(Us[cursor : cursor + group.nligands])
            cursor += group.nligands
        return total
