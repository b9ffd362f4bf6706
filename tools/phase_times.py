#!/usr/bin/env python3
"""Seconds each phase of a checkout's chip_smoke.py takes.

    cd <checkout> && python3 <this repo>/tools/phase_times.py

Imports ``chip_smoke`` from the current directory, wraps every phase
function its ``main()`` calls (the names ending in ``_phase`` or
``card_vs_cpu``) and the kernel build with a timer, runs ``main()`` and
prints ``phase_seconds {...}`` (seconds by function name, the build as
``build``) after the script's own output. Works on a chip_smoke.py from
before ``PHASE_SECONDS`` was added to it, so two commits' runs can be set
side by side from one call on the card.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time


def _timed(fn, name, seconds):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        # every phase reads its results to the host before it returns
        t0 = time.perf_counter()  # lint: disable=DLT003
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
    return run


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from deeplearning4j_tpu_torch.perf.kernels import _build

    seconds: dict = {}
    for name, fn in list(vars(chip_smoke).items()):
        if callable(fn) and (name.endswith("_phase") or name.endswith("card_vs_cpu")):
            setattr(chip_smoke, name, _timed(fn, name, seconds))
    _build.build = _timed(_build.build, "build", seconds)
    t0 = time.perf_counter()  # lint: disable=DLT003 (main() ends on host reads)
    rc = chip_smoke.main()
    seconds["total"] = time.perf_counter() - t0
    print("phase_seconds " + json.dumps(seconds), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
