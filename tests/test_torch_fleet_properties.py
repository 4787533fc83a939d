"""Port parity: the Hypothesis crash-schedule sweep of
``tests/test_fleet_properties.py`` over the port's fleet.

Under seeded mid-stream replica deaths and restarts, every admitted
request finishes with the JAX engine's uninterrupted token stream or is
refused with a typed rejection (never a mangled or cut stream), and the
fleet drain's leak gates are clean on every replica, restarted ones
included.  The draws are derandomized and no example database is kept,
so no stored draw replays between runs.  The in-process harness is
``tests/test_torch_fleet.py``'s.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property sweeps need hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st
from test_torch_fleet import (
    GEN,
    PROMPT_LEN,
    _fleet,
    _gen_tokens,
    _get_json,
    _post,
    _reference,
    _wait,
)
from torch_parity import fp_decoders

from repro.data import make_calibration as ref_calibration
from repro_torch.serve.faults import parse_fault_plan


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=0)


@pytest.fixture(scope="module")
def sweep(decoders):
    prompts = np.asarray(ref_calibration(256, n_segments=2,
                                         seg_len=PROMPT_LEN, seed=3).tokens,
                         np.int32)
    return prompts, [_reference(decoders[0], p) for p in prompts]


@settings(max_examples=3, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_random_kill_restart_schedules(decoders, sweep, data):
    prompts, refs = sweep
    n = data.draw(st.integers(2, 3), label="replicas")
    n_kills = data.draw(st.integers(0, 2), label="kills")
    schedule = [
        (data.draw(st.integers(0, n - 1), label=f"kill{j}_replica"),
         data.draw(st.integers(1, GEN - 1), label=f"kill{j}_tokens"))
        for j in range(n_kills)]
    restart_idx = data.draw(st.one_of(st.none(), st.integers(0, n - 1)),
                            label="restart")
    # each kill: the transport dies mid-stream on that replica's FIRST
    # incarnation (what the router sees of a kill -9: EOF before done)
    plans: dict[int, list] = {}
    for idx, k in schedule:
        plans.setdefault(idx, []).append(f"disconnect@tokens={k}")

    def fault_for(index, generation):
        if generation == 0 and index in plans:
            return parse_fault_plan(";".join(plans[index]))
        return None

    router = _fleet(decoders[1], n=n, fault_for=fault_for)
    try:
        for p, ref in zip(prompts, refs):
            assert _gen_tokens(router.port, p) == ref
        c, r = _post(router.port, {"prompt": [1, 2, 3], "max_new": 10_000})
        body = json.loads(r.read())
        c.close()
        assert r.status == 413 and body["retryable"] is False
        if restart_idx is not None:
            h = router.sup.handles[restart_idx]
            h.proc.drain_and_join("chaos-kill")
            assert _wait(lambda: h.state == "healthy" and h.restarts >= 1,
                         timeout=60)
            assert _gen_tokens(router.port, prompts[0]) == refs[0]
        _, fz = _get_json(router.port, "/fleetz")
        assert fz["journal"]["live"] == 0
    finally:
        report = router.drain_and_join()
    assert report.exit_code == 0
    assert all(r["exit_code"] in (0, None) for r in report.replicas)
    assert report.failed == 0
