"""The traced stretch of a run: torch.profiler's trace read back into plain
lists that the metric readers use.

The profiler writes a Chrome trace (Kineto's JSON).  From it:

* ``kernels``: every device kernel, (name, start us, duration us,
  correlation id), and ``device_ops`` the kernels with the device's copies
  and fills, which count as busy time too;
* ``launches``: the host side of each launch, correlation id -> (start
  us, thread), from the runtime or driver call that made it;
* ``ranges``: the ``record_function`` ranges, (name, start us, duration
  us, thread);
* ``waits``: the runtime calls in which the host waits for the device
  (a synchronise, or a copy to the host, which waits for the work queued
  before it), (name, start us, duration us, thread);
* ``host_ops``: the host's operator and range events, for what the host
  was doing in an idle gap of the device.

A range's device time is the time of the kernels launched while it was
open on its thread.  Its host time is its own duration less the waits
inside it: a copy to the host inside the solvers waits for the optics'
kernels still queued, and that time belongs to no host work of the
solvers.  The waits are counted apart.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import os
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
# Runtime calls that block the host until the device has done the work
# queued before them
WAIT_PREFIXES = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMemcpy")


class Trace(NamedTuple):
    kernels: list        # [(name, ts, dur, correlation)]
    device_ops: list     # [(name, ts, dur)] kernels, copies and fills
    launches: dict       # {correlation: (ts, tid, name)}
    ranges: list         # [(name, ts, dur, tid)]
    host_ops: list       # [(name, ts, dur, tid)]
    waits: list          # [(name, ts, dur, tid)]


def parse(events: list) -> Trace:
    """A Trace from the ``traceEvents`` of a Chrome trace."""
    kernels, device_ops, launches, ranges, host_ops, waits = (
        [], [], {}, [], [], [])
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device_ops.append((name, ts, dur))
            if cat == "kernel":
                kernels.append((name, ts, dur, args.get("correlation")))
        elif cat in LAUNCH_CATS:
            if "correlation" in args:
                launches[args["correlation"]] = (ts, e.get("tid"), name)
            if name.startswith(WAIT_PREFIXES):
                waits.append((name, ts, dur, e.get("tid")))
        elif cat in HOST_CATS:
            host_ops.append((name, ts, dur, e.get("tid")))
            if cat == "user_annotation":
                ranges.append((name, ts, dur, e.get("tid")))
    return Trace(kernels, device_ops, launches, ranges, host_ops, waits)


def load(path: str) -> Trace:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return parse(json.load(f)["traceEvents"])


def _intervals(trace: Trace, name: str) -> dict:
    """{tid: ([starts], [ends])} of the ranges called ``name``, sorted."""
    by_tid = collections.defaultdict(list)
    for n, ts, dur, tid in trace.ranges:
        if n == name:
            by_tid[tid].append((ts, ts + dur))
    return {tid: ([a for a, _ in sorted(v)], [b for _, b in sorted(v)])
            for tid, v in by_tid.items()}


def _inside(spans: dict, ts: float, tid) -> bool:
    if tid not in spans:
        return False
    starts, ends = spans[tid]
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= ends[i]


def kernels_in(trace: Trace, name: str) -> list:
    """The kernels launched while a range called ``name`` was open on the
    launching thread."""
    spans = _intervals(trace, name)
    out = []
    for k in trace.kernels:
        launch = trace.launches.get(k[3])
        if launch is not None and _inside(spans, launch[0], launch[1]):
            out.append(k)
    return out


def lost_kernels(trace: Trace) -> int:
    """Kernel launches on the host whose kernel the trace does not hold
    (the profiler dropped its record)."""
    found = {k[3] for k in trace.kernels}
    return sum(1 for c, launch in trace.launches.items()
               if "LaunchKernel" in launch[2] and c not in found)


def range_wait_us(trace: Trace, name: str) -> float:
    """The host's waits for the device that began while a range called
    ``name`` was open on the waiting thread."""
    spans = _intervals(trace, name)
    return sum(dur for _, ts, dur, tid in trace.waits
               if _inside(spans, ts, tid))


def range_host_us(trace: Trace, name: str) -> float:
    """The duration of the ranges called ``name``, less the waits inside
    them."""
    return (sum(dur for n, _, dur, _ in trace.ranges if n == name)
            - range_wait_us(trace, name))


def range_device_us(trace: Trace, name: str) -> float:
    return sum(k[2] for k in kernels_in(trace, name))


def window(trace: Trace, name: str):
    """(start, end) us of the ranges called ``name``, or None."""
    spans = [(ts, ts + dur) for n, ts, dur, _ in trace.ranges if n == name]
    if not spans:
        return None
    return min(a for a, _ in spans), max(b for _, b in spans)


def busy_intervals(trace: Trace, lo: float, hi: float) -> list:
    """The union of the device operations' intervals, clipped to
    [lo, hi], as sorted disjoint (start, end) pairs."""
    spans = sorted((max(ts, lo), min(ts + dur, hi))
                   for _, ts, dur in trace.device_ops
                   if ts + dur > lo and ts < hi)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def busy_us(trace: Trace, lo: float, hi: float) -> float:
    return sum(b - a for a, b in busy_intervals(trace, lo, hi))


def top_device_ops(trace: Trace, lo: float, hi: float, n: int = 10):
    """[[name, seconds]] of the ``n`` device operations that took most
    time in [lo, hi], summed by name."""
    total = collections.Counter()
    for name, ts, dur in trace.device_ops:
        if ts >= lo and ts < hi:
            total[name] += dur
    return [[name, us * 1e-6] for name, us in total.most_common(n)]


def thread_of(trace: Trace, name: str):
    """The thread of the first range called ``name``, or None."""
    return next((tid for n, _, _, tid in trace.ranges if n == name), None)


def idle_gaps(trace: Trace, lo: float, hi: float, tid=None, n: int = 10):
    """[[name, seconds]]: the device's idle time in [lo, hi], summed by
    the innermost host operation or range open on thread ``tid`` (every
    thread where None) at each gap's midpoint ("none" where the host was
    in none), the ``n`` largest."""
    busy = busy_intervals(trace, lo, hi)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    ops = sorted((o for o in trace.host_ops if tid is None or o[3] == tid),
                 key=lambda o: (o[1], -o[2]))
    total = collections.Counter()
    stack, i = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(ops) and ops[i][1] <= mid:
            op = ops[i]
            while stack and stack[-1][1] + stack[-1][2] <= op[1]:
                stack.pop()
            stack.append(op)
            i += 1
        while stack and stack[-1][1] + stack[-1][2] < mid:
            stack.pop()
        total[stack[-1][0] if stack else "none"] += b - a
    return [[name, us * 1e-6] for name, us in total.most_common(n)]


def record(fn, path: str):
    """Run ``fn()`` under torch.profiler (host and device activities) and
    write its Chrome trace to ``path``; returns fn's result."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        result = fn()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return result
