"""Profiling / tracing helpers.

The reference's only instrumentation is wall-clock brackets and progress
prints (BER_simulation_OpenCL.py:97,107-126). Here the per-SNR structured
results (sim.engine.PointResult) carry the throughput numbers, and this
module adds the device-level view: an optional ``jax.profiler`` trace
around any region, viewable in TensorBoard/XProf (per-kernel timings,
HBM traffic, fusion boundaries).
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Wrap a region in a jax.profiler trace when ``trace_dir`` is set."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield


def busy_ns(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in sorted(intervals):
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def device_op_times(trace_dir: str, top: int = 15) -> dict:
    """Reduce the newest ``jax.profiler`` trace under ``trace_dir`` to
    per-op device time.

    Reads the device planes (``/device:GPU:*``) of the ``.xplane.pb``; on
    each, the "XLA Ops" line when there is one, else every stream line.
    Returns the window (first op start to last op end), the busy time (union
    of op intervals), the idle share, the line names read, the ``top`` ops
    by summed duration, and time and launch count per fusion kind (the op
    name without its numeric suffix).
    """
    import glob
    import os
    import re

    from jax.profiler import ProfileData

    paths = glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    per_op: dict[str, float] = {}
    kinds: dict[str, dict] = {}
    intervals = []
    lines_read = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [l for l in lines if l.name == "XLA Ops"] or [
            l for l in lines if "Stream" in l.name
        ]
        for line in ops:
            lines_read.append(f"{plane.name}/{line.name}")
            for ev in line.events:
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
                kind = kinds.setdefault(
                    re.sub(r"[._]\d+$", "", ev.name), {"ns": 0.0, "launches": 0}
                )
                kind["ns"] += ev.duration_ns
                kind["launches"] += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        return {"lines_read": lines_read, "window_ns": 0.0}
    window = max(e0 for _, e0 in intervals) - min(s0 for s0, _ in intervals)
    busy = busy_ns(intervals)
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "lines_read": lines_read,
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window if window else None,
        "top_ops_ns": dict(ranked),
        "kinds": dict(sorted(kinds.items(), key=lambda kv: -kv[1]["ns"])),
    }


@contextlib.contextmanager
def wallclock(label: str, sink=print):
    """Wall-clock bracket, the reference's ``time.time()`` idiom."""
    t0 = time.time()
    yield
    sink(f"{label}: {time.time() - t0:.3f} s")
