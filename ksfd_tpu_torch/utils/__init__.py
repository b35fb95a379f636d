from .exceptions import KSFDException
from .debug import log, logger, enabled
from .symbolic import safe_sympify, torchify, free_parameter_names
from .params import (
    Parameter,
    ParameterList,
    default_parameters,
    find_duplicates,
)
from .cli import NumericsOptions, Parser, decode_numerics
from .device import resolve_device

__all__ = [
    "KSFDException",
    "log",
    "logger",
    "enabled",
    "safe_sympify",
    "torchify",
    "free_parameter_names",
    "Parameter",
    "ParameterList",
    "default_parameters",
    "find_duplicates",
    "NumericsOptions",
    "Parser",
    "decode_numerics",
    "resolve_device",
]
