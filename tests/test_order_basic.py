"""End-to-end golden tests: CG and AA order parameters vs the reference
outputs (tests/files/cg_order_basic.yaml, aa_order_basic.yaml and friends).

The cg.xtc / pcpepg.xtc fixtures are not shipped in the reference corpus;
their split variants (tests/files/split/) concatenate to the same
trajectories, which the reference's own concatenation tests confirm
(tests_cg.rs test_cg_order_basic_concatenated_yaml)."""

import numpy as np
import pytest

from gorder_tpu.input import Analysis, AnalysisType, LeafletClassification
from gorder_tpu.present import render_yaml, write_yaml

from .golden import assert_eq_order


@pytest.fixture()
def cg_traj(fixtures):
    return str(fixtures / "split" / "cg*.xtc")


@pytest.fixture()
def aa_traj(fixtures):
    return [str(fixtures / "split" / f"pcpepg{i}.xtc") for i in range(1, 6)]


def run_and_write(analysis, tmp_path):
    results = analysis.run()
    out = tmp_path / "order.yaml"
    write_yaml(results, str(out))
    return results, str(out)


def test_cg_order_basic(fixtures, cg_traj, tmp_path):
    analysis = Analysis(
        structure=str(fixtures / "cg.tpr"),
        trajectory=cg_traj,
        analysis_type=AnalysisType.cgorder("@membrane"),
        silent=True, overwrite=True,
    )
    results, out = run_and_write(analysis, tmp_path)
    assert results.n_analyzed_frames == 101
    assert results.molecule_names() == ["POPC", "POPE", "POPG"]
    assert_eq_order(out, str(fixtures / "cg_order_basic.yaml"))


def test_cg_order_basic_from_gro_bnd(fixtures, cg_traj, tmp_path):
    analysis = Analysis(
        structure=str(fixtures / "cg.gro"),
        bonds=str(fixtures / "cg.bnd"),
        trajectory=cg_traj,
        analysis_type=AnalysisType.cgorder("@membrane"),
        silent=True, overwrite=True,
    )
    _, out = run_and_write(analysis, tmp_path)
    assert_eq_order(out, str(fixtures / "cg_order_basic.yaml"))


def test_cg_order_basic_ndx_group(fixtures, cg_traj, tmp_path):
    analysis = Analysis(
        structure=str(fixtures / "cg.tpr"),
        trajectory=cg_traj,
        index=str(fixtures / "cg.ndx"),
        analysis_type=AnalysisType.cgorder("Membrane"),
        silent=True, overwrite=True,
    )
    _, out = run_and_write(analysis, tmp_path)
    assert_eq_order(out, str(fixtures / "cg_order_basic.yaml"))


def test_cg_order_begin_end_step(fixtures, cg_traj, tmp_path):
    analysis = Analysis(
        structure=str(fixtures / "cg.tpr"),
        trajectory=cg_traj,
        analysis_type=AnalysisType.cgorder("@membrane"),
        begin=352000.0, end=358000.0, step=5,
        leaflets=LeafletClassification.global_("@membrane", "name PO4"),
        silent=True, overwrite=True,
    )
    results, out = run_and_write(analysis, tmp_path)
    assert results.n_analyzed_frames == 13
    assert_eq_order(out, str(fixtures / "cg_order_begin_end_step.yaml"))


def test_cg_order_begin_end(fixtures, cg_traj, tmp_path):
    analysis = Analysis(
        structure=str(fixtures / "cg.tpr"),
        trajectory=cg_traj,
        analysis_type=AnalysisType.cgorder("@membrane"),
        begin=352000.0, end=358000.0,
        leaflets=LeafletClassification.global_("@membrane", "name PO4"),
        silent=True, overwrite=True,
    )
    results, out = run_and_write(analysis, tmp_path)
    assert results.n_analyzed_frames == 61
    assert_eq_order(out, str(fixtures / "cg_order_begin_end.yaml"))


def test_cg_order_leaflets_global(fixtures, cg_traj, tmp_path):
    analysis = Analysis(
        structure=str(fixtures / "cg.tpr"),
        trajectory=cg_traj,
        analysis_type=AnalysisType.cgorder("@membrane"),
        leaflets=LeafletClassification.global_("@membrane", "name PO4"),
        silent=True, overwrite=True,
    )
    _, out = run_and_write(analysis, tmp_path)
    assert_eq_order(out, str(fixtures / "cg_order_leaflets.yaml"))


def test_aa_order_basic(fixtures, aa_traj, tmp_path):
    analysis = Analysis(
        structure=str(fixtures / "pcpepg.tpr"),
        trajectory=aa_traj,
        analysis_type=AnalysisType.aaorder(
            "@membrane and element name carbon",
            "@membrane and element name hydrogen",
        ),
        silent=True, overwrite=True,
    )
    results, out = run_and_write(analysis, tmp_path)
    assert results.molecule_names() == ["POPE", "POPC", "POPG"]
    assert_eq_order(out, str(fixtures / "aa_order_basic.yaml"))


def test_aa_order_leaflets_global(fixtures, aa_traj, tmp_path):
    analysis = Analysis(
        structure=str(fixtures / "pcpepg.tpr"),
        trajectory=aa_traj,
        analysis_type=AnalysisType.aaorder(
            "@membrane and element name carbon",
            "@membrane and element name hydrogen",
        ),
        leaflets=LeafletClassification.global_("@membrane", "name P"),
        silent=True, overwrite=True,
    )
    _, out = run_and_write(analysis, tmp_path)
    assert_eq_order(out, str(fixtures / "aa_order_leaflets.yaml"))


def test_aa_order_selected(fixtures, tmp_path):
    analysis = Analysis(
        structure=str(fixtures / "pcpepg.tpr"),
        trajectory=str(fixtures / "pcpepg_selected.xtc"),
        analysis_type=AnalysisType.aaorder(
            "@membrane and element name carbon",
            "@membrane and element name hydrogen",
        ),
        leaflets=LeafletClassification.global_("@membrane", "name P"),
        silent=True, overwrite=True,
    )
    _, out = run_and_write(analysis, tmp_path)
    assert_eq_order(out, str(fixtures / "aa_order_selected.yaml"))


def test_batch_size_invariance(fixtures, cg_traj, tmp_path, monkeypatch):
    """Analogue of the reference's thread-count invariance: results are
    bit-identical across frame-batch sizes."""
    outputs = []
    for batch in (7, 32, 101):
        monkeypatch.setattr("gorder_tpu.analysis.DEFAULT_BATCH_SIZE", batch)
        analysis = Analysis(
            structure=str(fixtures / "cg.tpr"),
            trajectory=cg_traj,
            analysis_type=AnalysisType.cgorder("@membrane"),
            silent=True, overwrite=True,
        )
        results = analysis.run()
        outputs.append(render_yaml(results).split("\n", 1)[1])
    assert outputs[0] == outputs[1] == outputs[2]
