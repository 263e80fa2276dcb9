"""Dr-Hook-equivalent profiling, and the profiler spans of the step (port
of ``ecrad_tpu/profiling.py``).

The reference brackets every subroutine with
``if (lhook) call dr_hook('module:proc', 0/1, handle)`` and, when linked
against ECMWF fiat and activated by the env var ``DR_HOOK=1``, prints a
call-tree wall-clock profile at exit (drhook/yomhook_dummy.F90:14-39;
activation protocol test/ifs/Makefile:175-192).

Two layers:

* ``hook(name)``: a set-up or driver stage timed as Dr Hook times it,
  wall clock per name, total and self (the time of the hooks opened
  inside it taken off), and a ``torch.profiler.record_function`` range.
  Once CUDA is initialised in the process, the hook calls
  ``torch.cuda.synchronize()`` before it reads the clock at either end,
  so that its times are the card's and not the enqueue's.  Off by
  default, when it costs one flag test; on with the env var
  ``DR_HOOK=1`` (the reference's convention) or ``enable()``.  It
  synchronises, so it stays out of the step.
* ``scope(name)``: a span of the step.  While a torch.profiler records,
  a ``record_function`` range, on the profiler's clock with the device's
  kernels, copies and fills; otherwise nothing beyond one probe of the
  profiler's state.  It never synchronises.

``print_profile()`` renders the accumulated hooks like a Dr Hook profile
(sorted by total time).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Tuple

import torch

_enabled = os.environ.get("DR_HOOK", "0") not in ("", "0", "false",
                                                  "no", "off")
# name -> [ncalls, total_seconds, self_seconds]
_registry: Dict[str, list] = {}
# the time spent in hooks opened inside each open hook, innermost last
_children: list = []
_t_origin = time.time()
_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def enable(on: bool = True):
    global _enabled, _t_origin
    _enabled = on
    _t_origin = time.time()


def enabled() -> bool:
    return _enabled


def reset():
    global _t_origin
    _registry.clear()
    _t_origin = time.time()


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def hook(name: str):
    """Host-side profiling span (dr_hook equivalent)."""
    if not _enabled:
        yield
        return
    entry = _registry.setdefault(name, [0, 0.0, 0.0])
    _sync()
    t0 = time.perf_counter()
    _children.append(0.0)
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            _sync()
            elapsed = time.perf_counter() - t0
            inner = _children.pop()
            if _children:
                _children[-1] += elapsed
            entry[0] += 1
            entry[1] += elapsed
            entry[2] += elapsed - inner


def scope(name: str):
    """A span of the step: a ``record_function`` range called ``name``
    while a profiler records, else a context that does nothing."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def get_profile() -> Dict[str, Tuple[int, float, float]]:
    """{name: (calls, total seconds, self seconds)} of the hooks."""
    return {k: tuple(v) for k, v in _registry.items()}


def print_profile(file=None):
    """Dr-Hook-style profile table (sorted by total walltime)."""
    file = file or sys.stdout
    if not _registry:
        return
    wall = max(time.time() - _t_origin, 1e-9)
    rows = sorted(_registry.items(), key=lambda kv: -kv[1][1])
    print("", file=file)
    print("Profiling information (DR_HOOK=1):", file=file)
    print(f"  {'%time':>6} {'cumul(s)':>10} {'self(s)':>10} "
          f"{'#calls':>8} {'s/call':>10}  routine", file=file)
    for name, (ncalls, total, self_s) in rows:
        print(f"  {100.0 * total / wall:6.2f} {total:10.4f} "
              f"{self_s:10.4f} {ncalls:8d} {total / max(ncalls, 1):10.5f}"
              f"  {name}", file=file)
    print(f"  wall-clock since profile start: {wall:.4f} s", file=file)
