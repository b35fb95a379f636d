"""Framework exception type.

Counterpart: ksfd_tpu/utils/exceptions.py:KSFDException.
"""


class KSFDException(RuntimeError):
    """Error raised for user-facing problem-specification mistakes."""
