"""The long-tail, sequence and detection ops (ops/longtail.py,
ops/sequence_ops.py, ops/vision_ops.py, vision/ops.py) against the
reference's on the CPU: every case of tests/eager_op_cases.py's
``LONGTAIL_CASES`` runs on both packages from the same numpy inputs,
held by tests/test_torch_ops.py's rule (values within the case's `tol`,
rtol = atol, default 1e-6; dtypes and shapes exactly; the inputs' grads
through ``backward()`` within `grad_tol`, default 1e-5). Integer outputs
(NMS keeps and class ids, pooling indices, decode paths, gather_tree,
edit distances, the proposals' order) are held exactly by the same
rule: an integer array within a tolerance below 1 is equal.

The ops' own properties beyond the reference's cases (bounds checks,
margins of the NMS thresholds, the random ops' invariants) are in
tests/test_torch_detection.py."""
import numpy as np
import pytest

import eager_op_cases as C
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_ops import _close
from torch_port_helpers import cpu_place

CASES = [c for c in C.CASES if c[0] in set(C.LONGTAIL_CASES)]


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.mark.parametrize("name,fn,opts", CASES, ids=[c[0] for c in CASES])
def test_longtail_op_matches_reference(name, fn, opts):
    grad = opts.get("grad", True)
    got, got_g = C.run_case(ptt, fn, grad=grad)
    want, want_g = C.run_case(pt, fn, grad=grad)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, np.asarray(w), opts.get("tol", 1e-6), f"{name} out {i}")
    for i in set(got_g) | set(want_g):
        if i not in got_g:
            assert not np.asarray(want_g[i], np.float64).any(), \
                f"{name}: the reference has a nonzero grad of input {i}"
            continue
        assert i in want_g, f"{name}: the port has a grad of input {i}"
        _close(got_g[i], np.asarray(want_g[i]), opts.get("grad_tol", 1e-5),
               f"{name} grad {i}")
