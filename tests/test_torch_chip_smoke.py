"""chip_smoke.py's dispatch check in phase_pipeline: a dispatch over half
its kernel's time passes as host noise only when the card was still busy
right after it and the same dispatch of the arm's other run stayed under
the bound."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _run(wall, kernel, busy, gc=None):
    gc = gc or [0.0] * len(wall)
    return {"dispatch_ms": wall, "dispatch_gc_ms": gc, "kernel_ms": kernel,
            "busy_after_dispatch": busy,
            "over_half_kernel": [w - g > 0.5 * k
                                 for w, g, k in zip(wall, gc, kernel)]}


QUIET = _run([0.8, 0.9], [9.4, 3.2], [True, True])


@pytest.mark.parametrize("run, other, slow, noise", [
    # one run alone over the bound, the card busy after it: host noise
    (_run([0.8, 2.175], [9.4, 3.379], [True, True]), QUIET,
     [], [(1, 2.175, 0.0, 3.379)]),
    # over the bound in both runs of the arm: a wait on the code path
    (_run([0.8, 2.175], [9.4, 3.379], [True, True]),
     _run([0.8, 2.0], [9.4, 3.2], [True, True]),
     [(1, 2.175, 0.0, 3.379)], []),
    # the card idle right after the dispatch: it waited for its kernel
    (_run([0.8, 2.175], [9.4, 3.379], [True, False]), QUIET,
     [(1, 2.175, 0.0, 3.379)], []),
    # no such dispatch in the other run: nothing to tell noise by
    (_run([0.8, 2.175], [9.4, 3.379], [True, True]),
     _run([0.8], [9.4], [True]), [(1, 2.175, 0.0, 3.379)], []),
    # the GC's pauses are taken out before the bound is applied
    (_run([0.8, 2.175], [9.4, 3.379], [True, True], gc=[0.0, 1.0]), QUIET,
     [], []),
    (QUIET, QUIET, [], []),
])
def test_split_slow_dispatches(run, other, slow, noise):
    assert chip_smoke.split_slow_dispatches(run, other) == (slow, noise)
