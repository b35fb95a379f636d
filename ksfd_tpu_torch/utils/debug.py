"""Subsystem-gated debug logging.

Counterpart: ksfd_tpu/utils/debug.py (same ``KSFDDEBUG`` protocol: a
colon-separated list of subsystem names, or ``ALL``).  Lines carry the
torch.distributed rank, 0 outside a process group.
"""

import functools
import os
import sys

__all__ = ["log", "logger", "enabled"]


@functools.lru_cache(maxsize=None)
def _systems():
    val = os.environ.get("KSFDDEBUG", "")
    return frozenset(s.strip().upper() for s in val.split(":") if s.strip())


def enabled(system="MAIN"):
    systems = _systems()
    return "ALL" in systems or system.upper() in systems


def _rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def log(*args, system="MAIN", **kwargs):
    """Print ``args`` if tracing is enabled for ``system``."""
    if enabled(system):
        print(
            "[{sys}:{rank}]".format(sys=system.upper(), rank=_rank()),
            *args,
            file=sys.stderr,
            flush=True,
            **kwargs,
        )


def logger(system):
    """Return a ``log``-like callable bound to one subsystem."""

    def _log(*args, **kwargs):
        log(*args, system=system, **kwargs)

    return _log
