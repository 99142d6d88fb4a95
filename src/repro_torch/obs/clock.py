"""The package's sanctioned timing sources.

Every host timestamp taken inside ``repro_torch`` flows through these
aliases (or through an injected clock such as ``serving.faults.FakeClock``),
so timing stays fakeable in tests; ``tests/test_no_stray_timers.py`` bans
raw calls of ``time.perf_counter`` and ``time.time`` anywhere else in
``src/``. Device time is measured with ``torch.cuda.Event``, not here.

    from repro_torch.obs import clock
    t0 = clock.perf()      # high-resolution interval timing
    ts = clock.wall()      # epoch seconds
    tm = clock.monotonic() # deadlines / cadence
"""
from __future__ import annotations

import time

# Aliases, not wrappers: zero call overhead vs. the raw stdlib functions.
perf = time.perf_counter
wall = time.time
monotonic = time.monotonic
