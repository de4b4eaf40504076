"""The card's idle time put down to the program's own spans.

The harness reduces its traced window with the job kind's ``RANGES``: its
own spans around the calls into the program, and ``fleet_train`` /
``member_summary``.  Inside those calls the program opens finer spans
(``lesionvae_tpu_torch/utils/profiling.span``): ``PROGRAM``.  ``trace(ctx)``
reduces the same capture again with those names added, so the breakdown
labels each idle second by the innermost span open on the host then, the
program's or the harness's.  ``idle_pct(ctx, spans)`` is 100 x the idle
seconds labelled by one of ``spans``, over the window.

A reader's context carries the reduced trace and not the capture's events:
``trace`` takes them from ``ctx.events`` where the context has them, else
from the harness's capture (``cap``) in a frame that called the reader.
Against a program that opens none of ``spans`` in the window, and where the
events cannot be found, the metric is None.
"""

from __future__ import annotations

import importlib
import sys
from typing import Optional, Sequence

from .trace import Capture, Trace

#: the program's spans (``utils/profiling.span``) that the job kinds'
#: ``RANGES`` do not name
PROGRAM = ("fleet.init", "fleet.draws", "fleet.upload", "fleet.normalize", "fleet.state",
           "fetch.history", "fetch.members", "vae.init", "vae.upload", "vae_train",
           "program.load", "program.epoch", "program.capture", "program.history")


def _events(ctx):
    events = getattr(ctx, "events", None)
    frame = sys._getframe(1)
    while events is None and frame is not None:
        cap = frame.f_locals.get("cap")
        if isinstance(cap, Capture):
            events = getattr(cap, "events", None)
        frame = frame.f_back
    return events


def trace(ctx) -> Optional[Trace]:
    """The window's trace with the program's spans among its ranges (built
    once a context), or None where the events are not found."""
    if "program_trace" not in vars(ctx):
        events = _events(ctx)
        tr = None
        if events is not None:
            kind = importlib.import_module(f"{__package__}.jobs.{ctx.config['job']}")
            tr = Trace(events, tuple(kind.RANGES) + PROGRAM)
            if (tr.w0, tr.w1) != (ctx.trace.w0, ctx.trace.w1):
                tr = None
        ctx.program_trace = tr
    return ctx.program_trace


def idle_pct(ctx, spans: Sequence[str]) -> Optional[float]:
    """100 x the card's idle seconds in the window while the innermost open
    span is one of ``spans``, over the window; None where none of them
    opens in the window."""
    tr = trace(ctx)
    if tr is None or not any(h.name in spans and h.end > tr.w0 and h.start < tr.w1
                             for h in tr.host_ranges):
        return None
    idle = dict(tr.breakdown(top=len(tr.ranges) + 1)["idle_gaps"])
    return 100.0 * sum(idle.get(s, 0.0) for s in spans) / tr.window_s
