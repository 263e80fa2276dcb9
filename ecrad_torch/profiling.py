"""Dr-Hook-equivalent tracing and profiling (port of
``ecrad_tpu/profiling.py``).

The reference brackets every subroutine with
``if (lhook) call dr_hook('module:proc', 0/1, handle)`` and, when linked
against ECMWF fiat and activated by the env var ``DR_HOOK=1``, prints a
call-tree wall-clock profile at exit (drhook/yomhook_dummy.F90:14-39;
activation protocol test/ifs/Makefile:175-192).

Two layers, under the JAX package's names:

* ``hook(name)``: a host-side span, wall clock accumulated per name, and
  a ``torch.profiler.record_function`` so that the span appears on a
  torch.profiler trace.  Once CUDA is initialised in the process, the
  hook calls ``torch.cuda.synchronize()`` before it reads the clock at
  either end, so that its times are the card's and not the enqueue's.
  Off by default, when it costs one flag test; on with the env var
  ``DR_HOOK=1`` (the reference's convention) or ``enable()``.
* ``scope(name)`` / ``traced(name)``: a ``record_function`` range, which
  names the operators of a region on a torch.profiler trace.

``print_profile()`` renders the accumulated table like a Dr Hook profile
(sorted by total time).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from typing import Dict, Tuple

import torch

_enabled = os.environ.get("DR_HOOK", "0") not in ("", "0", "false",
                                                  "no", "off")
# name -> [ncalls, total_seconds]
_registry: Dict[str, list] = {}
_t_origin = time.time()


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
    entry = _registry.setdefault(name, [0, 0.0])
    _sync()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            _sync()
            entry[0] += 1
            entry[1] += time.perf_counter() - t0


def scope(name: str):
    """A torch.profiler range naming the operators of a region."""
    return torch.profiler.record_function(name)


def traced(name: str):
    """Decorator: run the function under ``scope(name)``, so that its
    operators carry the reference's module:proc label on a trace."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def get_profile() -> Dict[str, Tuple[int, float]]:
    return {k: (v[0], v[1]) for k, v in _registry.items()}


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
    for name, (ncalls, total) in rows:
        print(f"  {100.0 * total / wall:6.2f} {total:10.4f} "
              f"{total:10.4f} {ncalls:8d} {total / max(ncalls, 1):10.5f}"
              f"  {name}", file=file)
    print(f"  wall-clock since profile start: {wall:.4f} s", file=file)
