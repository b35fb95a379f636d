"""Named host spans inside the program, kept only while a
``torch.profiler`` session records.

``with span("attempt"):`` marks a stretch of the host's work as
``ksfd::attempt``.  With no profiler recording, ``span`` checks the
profiler's enabled flag and returns a shared no-op: no profiler range,
no allocation, no clock read.  While a session records (the
benchmark's traced stretch, ``ksfdsolver``'s ``--xprof``), the span opens
a profiler range named ``ksfd::<name>``, so it sits on the profiler's
timeline beside the device's kernels on the same clock, and is kept
here too: its name, its start and end on ``time.perf_counter_ns`` and
the span around it.

The range is ``torch._C._profiler._RecordFunctionFast``, an op on the
host's row, and not ``torch.profiler.record_function``: that one is a
user annotation, which the profiler mirrors on the card's row as a
``gpu_user_annotation`` covering the span's kernels and the gaps
between them, so a reader of the card's busy time would count the
host's gaps as busy.  The fast range is also the cheaper of the two
on the host.

A span counts only where the profiler recorded at both its ends: one
that straddles the start or the stop of a session is dropped (its
children that fall inside the session are kept, with no parent).

``summary()`` gives per name the count, the total seconds and the self
seconds (the total less what the span's kept children cover);
``summary(within=name)`` the same of the spans inside a kept span of
that name only.  ``records()`` lists the kept spans, ``clear()``
forgets them.
"""

import threading
import time

import torch

__all__ = ["span", "summary", "records", "clear", "PREFIX"]

#: the prefix of every span's name on the profiler's timeline
PREFIX = "ksfd::"

_enabled = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns
#: every span entered while the profiler recorded, in the order entered:
#: ``[name, start_ns, end_ns, parent]``, end None where dropped, parent
#: the enclosing span's entry or None; the process's, as the profiler's
#: session is
_spans = []
#: per thread, the entries of the spans open in it
_local = threading.local()


class _Off:
    """The shared no-op of a span entered with no profiler recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A span entered while the profiler records."""

    __slots__ = ("name", "range", "entry")

    def __init__(self, name):
        self.name = PREFIX + name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.entry = [self.name, None, None, stack[-1] if stack else None]
        stack.append(self.entry)
        _spans.append(self.entry)
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.entry[1] = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        self.range.__exit__(*exc)
        _local.stack.pop()
        if _enabled():
            self.entry[2] = end
        return False


def span(name):
    """A context manager marking ``ksfd::<name>`` (module docstring)."""
    if not _enabled():
        return _OFF
    return _On(name)


def records():
    """The kept spans as ``(name, start_ns, end_ns, parent)``, in the
    order entered; ``parent`` indexes this list, -1 where the span
    around it was not kept (or there is none)."""
    keep, out = {}, []
    for entry in list(_spans):
        name, s, e, parent = entry
        if e is None:
            continue
        keep[id(entry)] = len(out)
        out.append((name, s, e, -1 if parent is None
                    else keep.get(id(parent), -1)))
    return out


def summary(within=None):
    """``{name: dict(count, total_s, self_s)}`` over the kept spans; with
    ``within`` (a full name, ``ksfd::attempt``) only those inside a kept
    span of that name, the span itself left out."""
    recs = records()
    inside = [within is None] * len(recs)
    child_ns = [0] * len(recs)
    for i, (name, s, e, parent) in enumerate(recs):
        if parent >= 0:
            child_ns[parent] += e - s
            inside[i] = inside[parent] or recs[parent][0] == within
    out = {}
    for i, (name, s, e, _) in enumerate(recs):
        if not inside[i]:
            continue
        agg = out.setdefault(name, dict(count=0, total_s=0.0, self_s=0.0))
        agg["count"] += 1
        agg["total_s"] += (e - s) * 1e-9
        agg["self_s"] += (e - s - child_ns[i]) * 1e-9
    return out


def clear():
    """Forget every span kept so far (call it with no span open)."""
    del _spans[:]
