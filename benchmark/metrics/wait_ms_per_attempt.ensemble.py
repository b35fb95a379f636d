"""wait_ms_per_attempt.ensemble: host ms per whole batched attempt of the
ensemble blocked in the attempt's one read of every member's norms: the
``ksfd::read`` spans inside ``ksfd::attempt`` over the attempts, in the
traced stretch."""

from spans_read import per_attempt_ms


def read(ctx):
    return per_attempt_ms(ctx, "ensemble", "ksfd::read")
