"""wait_ms_per_attempt.solver: host ms per whole attempt of the Solver
blocked in the attempt's one read of its error norms: the ``ksfd::read``
spans inside ``ksfd::attempt`` over the attempts, in the traced
stretch."""

from spans_read import per_attempt_ms


def read(ctx):
    return per_attempt_ms(ctx, "solver", "ksfd::read")
