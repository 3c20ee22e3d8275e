"""Host-heap hygiene for long training runs.

The r4 health runs leaked ~65 MB of host RSS per optimizer step with FLAT
Python-visible ndarray bytes (runs/health_r4/SUMMARY.md, "Operational
incident" #2) — the classic signature of glibc malloc arena bloat: the
threaded loader's decode workers each get their own 64 MB arena, and
free()d decode buffers sit on per-arena free lists that glibc never
returns to the kernel.  The reference avoids the symptom only because
torch's DataLoader forks worker PROCESSES whose heaps die with them
(reference muvo/data/dataset.py:212-369 + train.py num_workers).

Two libc-level countermeasures, both no-ops if libc lacks the symbols
(musl, non-glibc):

- ``cap_malloc_arenas(n)``  — mallopt(M_ARENA_MAX, n) caps how many arenas
  glibc may create.  MALLOC_ARENA_MAX in the environment only works if set
  before the process starts; mallopt works at runtime, BEFORE the threads
  spawn.
- ``trim_host_heap()`` — malloc_trim(0) walks every arena and releases
  free-list pages back to the OS (MADV_DONTNEED).  Called at the logging
  interval it bounds RSS growth to the true live set.
"""

from __future__ import annotations

import ctypes

_M_ARENA_MAX = -8  # glibc malloc.h

_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        try:
            _libc = ctypes.CDLL("libc.so.6", use_errno=True)
        except OSError:
            _libc = False
    return _libc


def cap_malloc_arenas(n: int = 2) -> bool:
    """Cap glibc malloc arenas; call before spawning loader threads."""
    libc = _get_libc()
    if not libc or not hasattr(libc, "mallopt"):
        return False
    return bool(libc.mallopt(_M_ARENA_MAX, int(n)))


def trim_host_heap() -> bool:
    """Release glibc free-list pages back to the OS. Cheap (~µs-ms);
    safe to call every logging interval."""
    libc = _get_libc()
    if not libc or not hasattr(libc, "malloc_trim"):
        return False
    return bool(libc.malloc_trim(0))
