"""control_ms_per_attempt.solver: host ms per whole attempt of the Solver
outside its tiers and its read (gathering the tiers, the ladders, the
commits): the self time of ``ksfd::attempt`` over the attempts, in the
traced stretch."""

from spans_read import per_attempt_ms


def read(ctx):
    return per_attempt_ms(ctx, "solver", "ksfd::attempt")
