"""launch_ms_per_attempt.ensemble: host ms per whole batched attempt of
the ensemble spent gathering its members and enqueuing the vmapped tier
steps: the ``ksfd::tier`` spans inside ``ksfd::attempt`` over the
attempts, in the traced stretch."""

from spans_read import per_attempt_ms


def read(ctx):
    return per_attempt_ms(ctx, "ensemble", "ksfd::tier")
