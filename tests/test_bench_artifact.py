"""The benchmark harness's output validation.

A benchmark figure posts only when the run's output matches the pinned
golden (tools/bench_golden, generated on the CPU): `validate_output`
accepts byte-identical lines and one-print-quantum drift on a few values,
and fails loudly on anything larger or structural.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


def _write_golden(tmp_path, name, text, monkeypatch):
    gdir = tmp_path / "golden"
    gdir.mkdir(exist_ok=True)
    (gdir / name).write_text(text)
    monkeypatch.setattr(bench, "GOLDEN_DIR", str(gdir))
    return gdir


_GOLDEN_YAML = (
    "# Order parameters\n"
    "POPC:\n"
    "  average order:\n"
    "    total: 0.1234\n"
    "  order parameters:\n"
    "    C22 (32):\n"
    "      total: -0.0456\n"
)


def test_validate_output_exact(tmp_path, monkeypatch):
    _write_golden(tmp_path, "aa_100.yaml", _GOLDEN_YAML, monkeypatch)
    out = tmp_path / "run.yaml"
    out.write_text(_GOLDEN_YAML.replace("# Order parameters",
                                        "# different header comment"))
    assert bench.validate_output(str(out), "aa", 100) == "exact"


def test_validate_output_tolerates_one_print_quantum(tmp_path, monkeypatch):
    _write_golden(tmp_path, "aa_100.yaml", _GOLDEN_YAML, monkeypatch)
    out = tmp_path / "run.yaml"
    out.write_text(_GOLDEN_YAML.replace("0.1234", "0.1235"))
    status = bench.validate_output(str(out), "aa", 100)
    assert status.startswith("quantum(1/")


def test_validate_output_fails_on_corrupted_values(tmp_path, monkeypatch):
    """The corrupted-kernel injection: a value off by more than one print
    quantum must fail the benchmark loudly, never post a number."""
    _write_golden(tmp_path, "aa_100.yaml", _GOLDEN_YAML, monkeypatch)
    out = tmp_path / "run.yaml"
    out.write_text(_GOLDEN_YAML.replace("0.1234", "0.2234"))
    with pytest.raises(bench.BenchValidationError, match="differs from"):
        bench.validate_output(str(out), "aa", 100)
    # structural corruption (missing line) fails too
    out.write_text("\n".join(_GOLDEN_YAML.splitlines()[:-1]) + "\n")
    with pytest.raises(bench.BenchValidationError, match="lines"):
        bench.validate_output(str(out), "aa", 100)


def test_validate_output_none_without_golden(tmp_path, monkeypatch):
    _write_golden(tmp_path, "aa_100.yaml", _GOLDEN_YAML, monkeypatch)
    out = tmp_path / "run.yaml"
    out.write_text(_GOLDEN_YAML)
    assert bench.validate_output(str(out), "aa", 999) is None


def test_require_gpu_refuses_the_cpu():
    """A measurement never falls back to the CPU backend."""
    with pytest.raises(SystemExit, match="no GPU"):
        bench.require_gpu()


def test_drift_trajectory_matches_frame_by_frame_loop(tmp_path):
    """The chunked, threaded synthesizer writes the same bytes as the
    frame-at-a-time loop it replaces (the pinned goldens depend on it)."""
    from gorder_tpu.io import native

    rng = np.random.default_rng(3)
    positions = rng.uniform(0, 4, (50, 3)).astype(np.float32)
    mol_of_atom = np.repeat(np.arange(10), 5)
    box = np.array([4.0, 4.0, 4.0], np.float32)
    n_frames = 7
    fast = str(tmp_path / "fast.xtc")
    bench.write_drift_trajectory(fast, positions, mol_of_atom, box, n_frames,
                                 np.random.default_rng(11), chunk=3)

    rng = np.random.default_rng(11)
    drift = np.zeros((10, 3), np.float32)
    coords = np.empty((n_frames, 50, 3), np.float32)
    for i in range(n_frames):
        drift += rng.standard_normal((10, 3), dtype=np.float32) * 0.015
        drift *= 0.995
        jitter = rng.standard_normal((50, 3), dtype=np.float32) * 0.012
        coords[i] = (positions + drift[mol_of_atom] + jitter) % box
    slow = str(tmp_path / "slow.xtc")
    native.xtc_write(slow, coords,
                     np.tile(np.diag(box), (n_frames, 1, 1)),
                     (np.arange(n_frames) * 10.0).astype(np.float32),
                     (np.arange(n_frames) * 100).astype(np.int32),
                     precision=1000.0)
    with open(fast, "rb") as a, open(slow, "rb") as b:
        assert a.read() == b.read()
