"""Lightweight stage tracer (observability the reference lacks).

The reference left its segment-trace hooks commented out
(``EbEncDecProcess.c:4583-4587``) and only reports whole-run fps in the
app.  Here every pipeline stage can be timed with near-zero overhead
when disabled: ``span("stage")`` is a no-op context manager unless
tracing was enabled via ``enable()`` or the ``TPU_VP9_TRACE`` env var.

Summaries are per-stage {count, total_s, mean_ms} dicts — printed by the
CLI with ``-trace`` or fetched via ``Vp9Encoder.get_trace_summary()``.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

_enabled = os.environ.get("TPU_VP9_TRACE", "") not in ("", "0")
_acc: dict[str, list] = {}
_notices: list[str] = []


def notice(msg: str) -> None:
    """Record a capability downgrade (RT→host, TPU→CPU ME, native→Python
    serializer, …).  Always printed to stderr once per process — the
    reference surfaces such conditions through its error-packet callback
    (EbEncHandle.c:437-452); silent fallbacks are forbidden here."""
    if msg not in _notices:
        _notices.append(msg)
        print(f"tpu_vp9_torch: WARNING: {msg}", file=sys.stderr, flush=True)


def notices() -> list[str]:
    return list(_notices)


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    _acc.clear()


@contextmanager
def span(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        ent = _acc.get(name)
        if ent is None:
            _acc[name] = [1, dt]
        else:
            ent[0] += 1
            ent[1] += dt


def summary() -> dict:
    out: dict = {
        name: {
            "count": c,
            "total_s": round(t, 4),
            "mean_ms": round(1000.0 * t / max(c, 1), 3),
        }
        for name, (c, t) in sorted(_acc.items(),
                                   key=lambda kv: -kv[1][1])
    }
    if _notices:
        out["notices"] = list(_notices)
    return out
