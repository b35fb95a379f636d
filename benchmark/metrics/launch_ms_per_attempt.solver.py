"""launch_ms_per_attempt.solver: host ms per whole attempt of the Solver
spent enqueuing its tier steps: the ``ksfd::tier`` spans inside
``ksfd::attempt`` over the attempts, in the traced stretch."""

from spans_read import per_attempt_ms


def read(ctx):
    return per_attempt_ms(ctx, "solver", "ksfd::tier")
