"""Pipeline behavior under transfer-link weather.

A slow device link can suffer minutes-scale rate slumps. The pipeline's
prefetch ring decouples decode from transfer so a slump costs roughly its
own duration, and a slump is detected against a rolling median and
logged — these tests inject a synthetic slowdown into the device-put path
and assert both properties.
"""

import logging
import time

import numpy as np
import pytest

from .conftest import requires_fixtures


def _run(fixtures, monkeypatch, slow_batches=(), sleep_s=0.0):
    """One CG analysis run with an injected per-batch transfer delay on
    the given batch ordinals. Returns (wall seconds, results list)."""
    from gorder_tpu.input import Analysis, AnalysisType
    from gorder_tpu.parallel import context

    monkeypatch.setenv("GORDER_TPU_BATCH_SIZE", "8")
    monkeypatch.setenv("GORDER_TPU_WIRE", "f32")  # one big put per batch

    real_put = context.put_frames
    seen = {"batch": -1}

    def slow_put(x):
        arr = np.asarray(x) if not hasattr(x, "ndim") else x
        if getattr(arr, "ndim", 0) == 3:  # the coords payload: next batch
            seen["batch"] += 1
            if seen["batch"] in slow_batches:
                time.sleep(sleep_s)
        return real_put(x)

    monkeypatch.setattr(context, "put_frames", slow_put)

    analysis = Analysis(
        structure=str(fixtures / "cg.tpr"),
        trajectory=str(fixtures / "split" / "cg*.xtc"),
        analysis_type=AnalysisType.cgorder("@membrane"),
        silent=True,
    )
    t0 = time.perf_counter()
    results = analysis.run()
    wall = time.perf_counter() - t0
    values = [
        (bond.order.total.value, bond.order.total.error)
        for mol in results.molecules for bond in mol.bonds
    ]
    return wall, values


@requires_fixtures
def test_slump_costs_its_duration_not_a_product(fixtures, monkeypatch):
    """An injected transfer slump degrades the run by ~the slump duration:
    decode keeps running into the prefetch ring, so the loss is additive,
    not multiplicative (VERDICT round 2, item 3)."""
    sleep_s = 0.3
    slow = (5, 6, 7)
    injected = sleep_s * len(slow)
    # wall-clock bounds on a shared machine are noisy: retry the timing
    # comparison (correctness equality stays unconditional)
    for attempt in range(3):
        base_wall, base_values = _run(fixtures, monkeypatch)
        slump_wall, slump_values = _run(fixtures, monkeypatch,
                                        slow_batches=slow, sleep_s=sleep_s)
        assert slump_values == base_values  # weather never changes results

        overhead = slump_wall - base_wall
        # proportional: the overhead is the injected stall plus scheduling
        # noise, never a serialized decode x transfer product (which would
        # be >= 2x the injected time on this decode-heavy config)
        timing_ok = (overhead < injected * 1.5 + 1.0
                     and overhead > injected * 0.5 - 0.5)
        if timing_ok:
            return
    raise AssertionError(
        f"slump cost {overhead:.2f}s for {injected:.2f}s injected "
        f"(3 attempts)")


@requires_fixtures
def test_slump_detected_and_logged(fixtures, monkeypatch, caplog):
    """A batch 3x over the rolling median triggers the slump warning."""
    with caplog.at_level(logging.WARNING, logger="gorder"):
        _run(fixtures, monkeypatch, slow_batches=(8, 9), sleep_s=1.0)
    assert any("transfer slump" in r.getMessage() for r in caplog.records)


@requires_fixtures
def test_prefetch_depth_env(fixtures, monkeypatch):
    """GORDER_TPU_PREFETCH controls the ring depth without changing
    results."""
    _, base_values = _run(fixtures, monkeypatch)
    monkeypatch.setenv("GORDER_TPU_PREFETCH", "2")
    _, shallow = _run(fixtures, monkeypatch)
    monkeypatch.setenv("GORDER_TPU_PREFETCH", "8")
    _, deep = _run(fixtures, monkeypatch)
    assert base_values == shallow == deep
