"""Membrane-normal runtime: dynamic PCA normals, manual normal tables,
static axis normals, and the geometry-restricted molecule-inside mask for
normal collection/export.

Split out of analysis.py (round 5); reference parity notes cite
src/analysis/normal.rs and src/errors.rs per function."""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..errors import AnalysisError, ConfigError
from ..input.config import Analysis
from ..select import select_mask
from ..system import System
from ..topology.classify import MoleculeKind
from .prepare import _AXIS_INDEX, _single_atom_per_molecule

log = logging.getLogger("gorder")

@dataclass
class NormalsRuntime:
    """Per-batch membrane normals (dynamic PCA or manual tables)."""

    mode: str                     # 'dynamic' | 'manual'
    compute = None                # device fn (dynamic)
    table: Optional[np.ndarray] = None    # (F, M, 3) manual normals
    collected: Optional[List[np.ndarray]] = None
    # geometry-restricted runs: (coords, box, geom_ref) → (B, M) bool,
    # True when ≥1 bond of the molecule lies inside the region. The
    # reference computes normals lazily per requesting bond
    # (normal.rs OnceCell), so molecules with no analyzed bond export NaN.
    molecule_inside = None

    def validate(self, n_analyzed: int) -> None:
        from ..errors import ManualNormalError

        if self.mode == "manual" and len(self.table) != n_analyzed:
            # wording: src/errors.rs:226-228
            # (ManualNormalError::UnexpectedNumberOfFrames)
            raise ManualNormalError(
                f"number of frames specified in the normals structure "
                f"('{len(self.table)}') is not consistent with the number "
                f"of analyzed frames ('{n_analyzed}')")

    def _collect(self, values: np.ndarray, coords_f32, box_dev, geom_ref):
        if self.molecule_inside is not None and geom_ref is not None:
            keep = np.asarray(
                self.molecule_inside(coords_f32, box_dev, geom_ref)
            )[:len(values)]
            values = values.copy()
            values[~keep] = np.nan
        self.collected.append(values)

    def fused_impl(self, ignore_collect: bool = False):
        """Traceable per-batch normal computation for fused programs, or
        None when the batch path must stay host-visible (manual tables,
        collection buffers). The dynamic PCA is a pure function of the
        batch; the ≥3-points validation moves to a device-computed
        min-count guard checked when results drain (same error, possibly
        a few batches later). With ignore_collect=True, collection does
        NOT disqualify — the fused program returns the in-program
        normals as an extra (B, M, 3) output for the collector — unless
        geometry-restricted collection (molecule_inside) needs full
        coordinates host-side."""
        impl = getattr(self.compute, "impl", None)
        if impl is None or self.mode != "dynamic":
            return None
        if self.collected is not None and not (
                ignore_collect and self.molecule_inside is None):
            return None
        return impl

    def normals_for_batch(self, coords_f32, box_dev,
                          analyzed_idx: np.ndarray, batch_size: int,
                          geom_ref=None):
        from ..errors import DynamicNormalError

        if self.mode == "manual":
            n_valid = len(analyzed_idx)
            out = np.zeros((batch_size,) + self.table.shape[1:], np.float32)
            out[:n_valid] = self.table[analyzed_idx]
            normals = out
            if self.collected is not None:
                self._collect(np.array(self.table[analyzed_idx]),
                              coords_f32, box_dev, geom_ref)
            return normals
        normals, counts = self.compute(coords_f32, box_dev)
        n_valid = len(analyzed_idx)
        counts_host = np.asarray(counts[:n_valid])
        if (counts_host < 3).any():
            # wording: src/errors.rs:173-176
            # (DynamicNormalError::NotEnoughPoints)
            got = int(counts_host[counts_host < 3].min())
            raise DynamicNormalError(
                f"not enough points for dynamic local membrane normal "
                f"calculation: got '{got}', need at least '3' points \n"
                f"(hint: try increasing the 'radius' in the "
                f"'membrane_normal' section of your input configuration "
                f"file)")
        if self.collected is not None:
            self._collect(np.asarray(normals[:n_valid]), coords_f32,
                          box_dev, geom_ref)
        return normals


def _make_molecule_inside(atom_a, atom_b, bond_mol, n_molecules: int,
                          geom_spec, handle_pbc: bool):
    """(coords, box_diag, geom_ref) → (B, M) bool: molecule has ≥1 bond
    midpoint inside the geometry region (same midpoint/reference math as
    the order kernel, core/order.py _order_step)."""
    import jax
    import jax.numpy as jnp

    from ..core.geometry import inside_mask
    from ..core.order import _geometry_reference
    from ..core.pbc import min_image

    aa_d = jax.device_put(np.asarray(atom_a, np.int32))
    ab_d = jax.device_put(np.asarray(atom_b, np.int32))
    mol_d = jax.device_put(np.asarray(bond_mol, np.int32))

    @jax.jit
    def fn(coords, box_diag, geom_ref):
        pa = jnp.take(coords, aa_d, axis=1)
        pb = jnp.take(coords, ab_d, axis=1)
        d = pb - pa
        if handle_pbc:
            d = min_image(d, box_diag[:, None, :])
        mid = pa + d * 0.5
        ref = _geometry_reference(coords, box_diag, geom_ref, handle_pbc)
        geo = inside_mask(mid, ref, box_diag, geom_spec,
                          handle_pbc).astype(jnp.float32)
        out = jnp.zeros((coords.shape[0], n_molecules), jnp.float32)
        out = out.at[:, mol_d].max(geo)
        return out > 0

    return fn


def _build_normals(system: System, analysis: Analysis,
                   kinds: List[MoleculeKind], n_molecules: int,
                   remap=None):
    """→ (leaflet_axis, static_vec or None, NormalsRuntime or None)."""
    from ..errors import ManualNormalError

    if remap is None:
        remap = lambda idx: idx  # noqa: E731 - identity for direct tests
    mn = analysis.membrane_normal
    if mn.kind == "static":
        axis = _AXIS_INDEX[mn.axis]
        normal_vec = np.zeros(3, np.float32)
        normal_vec[axis] = 1.0
        return axis, normal_vec, None

    # non-static normals: leaflet methods need their own axis
    axis = 2
    if analysis.leaflets is not None and analysis.leaflets.kind in (
            "global", "local", "individual"):
        if analysis.leaflets.membrane_normal is None:
            # wording: src/errors.rs:353-356
            # (ConfigError::MissingMembraneNormal)
            raise ConfigError(
                "static global membrane normal is not used but leaflet "
                "classification requires it\n(hint: add 'membrane_normal' "
                "to the 'leaflets' section of your input configuration "
                "file or, if analyzing a vesicle, \n assign the lipids into "
                "leaflets using the clustering method or manually)")
        axis = _AXIS_INDEX[analysis.leaflets.membrane_normal]

    runtime = NormalsRuntime(mode="dynamic" if mn.kind == "dynamic"
                             else "manual")
    if mn.collect.enabled:
        runtime.collected = []

    if mn.kind == "dynamic":
        from ..core.normals import make_dynamic_normals

        heads = _single_atom_per_molecule(system, kinds, mn.heads,
                                          "dynamic membrane normal heads")
        cloud_mask = select_mask(system, mn.heads)
        cloud = np.nonzero(cloud_mask)[0]
        runtime.compute = make_dynamic_normals(remap(heads), remap(cloud),
                                               mn.radius, analysis.handle_pbc)
        return axis, None, runtime

    # manual normals (from file or inline map)
    if mn.kind == "from_file":
        from ..input.config import yaml_module

        _yaml = yaml_module()
        try:
            with open(mn.file) as fh:
                mapping = _yaml.safe_load(fh)
        except OSError:
            # wording: src/errors.rs:201-202 (ManualNormalError::FileNotFound)
            raise ManualNormalError(
                f"could not open the normals file '{mn.file}'") from None
        except _yaml.YAMLError as e:
            # wording: src/errors.rs:204-205
            # (ManualNormalError::CouldNotParse)
            raise ManualNormalError(
                f"could not understand the contents of the normals file "
                f"'{mn.file}' ({e})") from None
    else:
        mapping = mn.normals_map
    runtime.table = _manual_normals_table(mapping, kinds)
    return axis, None, runtime


def _manual_normals_table(mapping, kinds: List[MoleculeKind]) -> np.ndarray:
    from ..errors import ManualNormalError

    if not isinstance(mapping, dict):
        raise ManualNormalError(
            "manual membrane normals must map molecule types to per-frame "
            "per-molecule vectors")
    known = {kind.name for kind in kinds}
    extra = [name for name in mapping if name not in known]
    if extra:
        # wording: src/errors.rs:222-224
        # (ManualNormalError::UnknownMoleculeType)
        detected = " ".join(kind.name for kind in kinds)
        raise ManualNormalError(
            f"molecule type '{extra[0]}' specified in the normals "
            f"structure not found in the system (detected molecule types "
            f"are: '{detected}')")
    n_frames = None
    per_kind = []
    for kind in kinds:
        if kind.name not in mapping:
            # wording: src/errors.rs:207-208
            # (ManualNormalError::MoleculeTypeNotFound)
            raise ManualNormalError(
                f"molecule type '{kind.name}' not found in the manual "
                f"normals structure")
        frames = mapping[kind.name]
        if not frames:  # `NAME:` with no value parses as None
            # wording: src/errors.rs:210-211 (ManualNormalError::NoNormals)
            raise ManualNormalError(
                f"no membrane normals provided for molecule type "
                f"'{kind.name}'")
        if n_frames is None:
            n_frames = len(frames)
        elif len(frames) != n_frames:
            raise ManualNormalError(
                "inconsistent frame counts between molecule types in the "
                "manual membrane normals")
        rows = []
        for fidx, frame in enumerate(frames):
            if len(frame) != kind.n_molecules:
                # wording: src/errors.rs:213-220
                # (ManualNormalError::InconsistentNumberOfMolecules)
                raise ManualNormalError(
                    f"inconsistent number of molecules specified in the "
                    f"normals structure: expected '{kind.n_molecules}' "
                    f"molecules of type '{kind.name}', got '{len(frame)}' "
                    f"molecules in frame '{fidx}'")
            rows.append(np.asarray(frame, np.float32))
        per_kind.append(np.stack(rows))
    if not n_frames:
        raise ManualNormalError("the manual membrane normals are empty")
    return np.concatenate(per_kind, axis=1)


def _static_normal(analysis: Analysis):
    if analysis.membrane_normal.kind != "static":
        raise AnalysisError(
            "only static membrane normals are supported in this build")
    axis = _AXIS_INDEX[analysis.membrane_normal.axis]
    normal_vec = np.zeros(3, np.float32)
    normal_vec[axis] = 1.0
    return axis, normal_vec
