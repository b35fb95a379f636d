"""What the per-layer metrics of the program's own spans read
(``ksfd_tpu_torch/utils/spans.py``: kept only while the profiler
records, so here the traced stretch alone).

The stretch starts the profiler inside the tier-step call of index 1 and
stops it inside the call of index ``1 + trace_attempts`` (the adaptive
kinds) or wraps ``trace_calls`` whole calls (the fixed kind).  The
spans that straddle either end are dropped, so the adaptive readers
divide by the whole ``ksfd::attempt`` spans and sum only the spans
inside them.  Where the program has no spans (a checkout without
``utils/spans.py``) or kept none, every reader gives None.
"""

__all__ = ["per_attempt_ms", "per_step_ms"]


def _summary(within=None):
    try:
        from ksfd_tpu_torch.utils.spans import summary
    except ImportError:
        return None
    return summary(within)


def per_attempt_ms(ctx, kind, name):
    """Host ms per whole attempt of the ``kind`` cell: the total of span
    ``name`` inside the attempts, or for ``ksfd::attempt`` itself its
    self time (what the attempt spends outside its tiers and its
    read)."""
    if ctx["kind"] != kind or not ctx.get("trace"):
        return None
    every = _summary()
    if not every or not every.get("ksfd::attempt", {}).get("count"):
        return None
    att = every["ksfd::attempt"]
    if name == "ksfd::attempt":
        secs = att["self_s"]
    else:
        secs = _summary("ksfd::attempt").get(name, {}).get("total_s", 0.0)
    return secs * 1e3 / att["count"]


def per_step_ms(ctx, name):
    """Host ms per whole ``ksfd::step`` span of the fixed cell: the
    steps' own total, or the total of span ``name`` inside them."""
    if ctx["kind"] != "fixed" or not ctx.get("trace"):
        return None
    every = _summary()
    if not every or not every.get("ksfd::step", {}).get("count"):
        return None
    step = every["ksfd::step"]
    if name == "ksfd::step":
        secs = step["total_s"]
    else:
        secs = _summary("ksfd::step").get(name, {}).get("total_s", 0.0)
    return secs * 1e3 / step["count"]
