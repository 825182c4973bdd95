"""The port's tracer: timed spans and counters added into a metrics dict.

    with span(metrics, "table"):    # adds its seconds to metrics["table_s"]
        ...
    count(metrics, "engine_slot_iters", n)

metrics is the dict a caller passes as metrics= (run_pipeline, the
CLI's --metrics-json), or None.  Spans nest: a child's seconds lie
inside its parent's too.  A span closes and adds its seconds when its
body raises.

While torch.profiler records, a span also opens a profiler range
darwin.<name>, on the clock of the trace's device events, so a trace
shows each device idle stretch against the host stage under it.  Only
spans around host work, or around one copy, take a range: a range
around launched kernels gets a device-side annotation from the first of
them to the last, which covers the idle stretches between them, and a
reader that counts device events would read those as busy.  So spans
around device work pass ranged=False and stay timers.  With metrics
None and no profiler recording, span returns one shared null context.
"""

from __future__ import annotations

import contextlib
import time

import torch

PREFIX = "darwin."
NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("metrics", "key", "range", "t0")

    def __init__(self, metrics: dict | None, name: str, ranged: bool):
        self.metrics = metrics
        self.key = f"{name}_s"
        self.range = (torch.profiler.record_function(PREFIX + name)
                      if ranged else None)

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        count(self.metrics, self.key, dt)
        return False


def span(metrics: dict | None, name: str, *, ranged: bool = True):
    """A context that adds its seconds to metrics[name + "_s"] and,
    where ranged and the profiler records, opens the range darwin.name."""
    ranged = ranged and torch.autograd._profiler_enabled()
    if metrics is None and not ranged:
        return NULL
    return _Span(metrics, name, ranged)


def count(metrics: dict | None, name: str, n) -> None:
    """Add n (a count or seconds) to metrics[name]."""
    if metrics is not None:
        metrics[name] = metrics.get(name, 0) + n


def merge(metrics: dict | None, other: dict) -> None:
    """Add every entry of other into metrics."""
    for name, n in other.items():
        count(metrics, name, n)
