"""control_ms_per_attempt.ensemble: host ms per whole batched attempt of
the ensemble outside its tiers and its read (the members' ladders, the
commits): the self time of ``ksfd::attempt`` over the attempts, in the
traced stretch."""

from spans_read import per_attempt_ms


def read(ctx):
    return per_attempt_ms(ctx, "ensemble", "ksfd::attempt")
