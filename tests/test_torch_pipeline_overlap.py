"""The pipeline schedules' bubble (paddle_tpu_torch.distributed.
meta_parallel.pipeline_schedules, ROADMAP item 26b) against the
reference's: tests/test_pipeline_overlap.py's two analytic cases, on the
port's unit lists (equal to the reference's) and the same cycle clock.

The reference file's third case, the executor's measured device
timeline, reads XLA's asynchronous dispatch through stamped
``io_callback`` computations on its virtual CPU devices; it has no port
form (the port's single controller runs one device's eager kernels in
order) and is a departure recorded in ROADMAP Queue C."""
import pytest

from paddle_tpu.distributed.meta_parallel import pipeline_schedules as jps
from paddle_tpu_torch.distributed.meta_parallel.pipeline_schedules import (
    build_schedule)


def _bubble_from_cycles(order, p):
    """The bubble fraction on the simulator's cycle clock: a cycle is one
    unit-time slot a stage; the busy slots are the units."""
    total_cycles = max(u.cycle for u in order) + 1
    return 1.0 - len(order) / (p * total_cycles)


@pytest.mark.parametrize("p,m", [(2, 4), (2, 8), (4, 8), (4, 16)])
def test_schedule_bubble_matches_analytic(p, m):
    """1F1B's bubble stays within (p-1)/(m+p-1) (the simulator has no
    p2p latency, so it may land tighter, never looser); FThenB's
    makespan is the same (its cost is memory); both equal the
    reference's."""
    order = build_schedule("1F1B", p, m)
    measured = _bubble_from_cycles(order, p)
    analytic = (p - 1) / (m + p - 1)
    assert measured <= analytic + 1e-9
    assert measured > 0 or p == 1
    ftb = _bubble_from_cycles(build_schedule("FThenB", p, m), p)
    assert ftb == pytest.approx(measured)
    assert measured == _bubble_from_cycles(jps.build_schedule("1F1B", p, m),
                                           p)
    assert ftb == _bubble_from_cycles(jps.build_schedule("FThenB", p, m), p)


def test_interleaved_beats_1f1b_bubble():
    p, m, v = 4, 8, 2
    b_1f1b = _bubble_from_cycles(build_schedule("1F1B", p, m), p)
    b_vpp = _bubble_from_cycles(build_schedule("Interleaved1F1B", p, m, v),
                                p)
    assert b_vpp < b_1f1b
    assert b_vpp == _bubble_from_cycles(
        jps.build_schedule("Interleaved1F1B", p, m, v), p)
