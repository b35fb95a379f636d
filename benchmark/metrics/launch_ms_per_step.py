"""launch_ms_per_step: host ms per fixed-dt step spent enqueuing it: the
``ksfd::step`` spans over their count, in the traced stretch."""

from spans_read import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "ksfd::step")
