"""pc_launch_ms_per_step: host ms per fixed-dt step spent enqueuing the
preconditioner's applications: the ``ksfd::pc`` spans inside
``ksfd::step`` over the steps, in the traced stretch."""

from spans_read import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "ksfd::pc")
