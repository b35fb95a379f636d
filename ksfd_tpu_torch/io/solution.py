"""Solution: the reader of a stored run.

Counterpart: ksfd_tpu/io/solution.py (the reference's KSFD/ksfdsoln.py
Solution): open by prefix, rebuild the problem (command line,
parameters, sources, operators) from the file's '/info', and return
snapshots interpolated in time with images(t).
"""

import collections
import os

from ..utils.exceptions import KSFDException
from .monitors import pickleunp
from .timeseries import TimeSeries

__all__ = ["Solution"]


class Solution:
    """Counterpart: ksfd_tpu/io/solution.py:Solution."""

    def __init__(self, prefix, device=None):
        """Open a stored solution.

        prefix: the --save prefix the run was stored under.  device:
        where ``derivatives`` builds its operators (the card unless
        given, as every entry point of the port).
        """
        prefix = os.path.expandvars(os.path.expanduser(prefix))
        self.prefix = prefix
        self.device = device
        self.timeSeries = TimeSeries(prefix, mode="r")
        self.grid = self.timeSeries.grid
        info = self.timeSeries.info

        def unpickled(key):
            return pickleunp(info[key][()]) if key in info else None

        self.commandlineArguments = unpickled("commandlineArguments")
        self.solutionParameters = unpickled("SolutionParameters")
        self.sources = unpickled("sources")
        self.tstimes = self.timeSeries.sorted_times()
        if len(self.tstimes) == 0:
            # a run that failed before its first monitor write leaves a
            # valid file with /info and no snapshot
            self.timeSeries.close()
            raise KSFDException(
                "series {p} contains no snapshots".format(p=prefix))
        self.tmin, self.tmax = self.tstimes[0], self.tstimes[-1]
        self._derivatives = None

    @property
    def ps(self):
        return self.solutionParameters

    @property
    def tseries(self):
        return self.timeSeries

    @property
    def clargs(self):
        return self.commandlineArguments

    @property
    def derivatives(self):
        """PDEOperators rebuilt from the stored problem (lazily);
        WithGOperators for a with-G run's stored state (its trailing G
        field), as ksfd_tpu/io/solution.py:74-76."""
        if self._derivatives is None and self.solutionParameters is not None:
            ps = self.solutionParameters
            from ..ops import PDEOperators, WithGOperators

            cls = (WithGOperators if self.grid.dof == ps.nligands + 2
                   else PDEOperators)
            self._derivatives = cls(ps, self.grid, sources=self.sources,
                                    device=self.device)
        return self._derivatives

    derivs = derivatives

    @property
    def ligands(self):
        return self.ps.Vgroups.ligands()

    def params(self, t):
        """All parameter values at time t."""
        return collections.OrderedDict(self.ps.values(t))

    def load(self, t):
        self.vec = self.tseries.retrieve_by_time(t)
        return self.vec

    def images(self, t=None):
        """The full field array at time t (linear interpolation)."""
        if t is None:
            t = self.tmax
        self.ims = self.load(t)
        if self.ims.shape != self.grid.Vshape:
            raise KSFDException("snapshot shape %r, grid %r"
                                % (self.ims.shape, self.grid.Vshape))
        return self.ims

    def close(self):
        self.timeSeries.close()
