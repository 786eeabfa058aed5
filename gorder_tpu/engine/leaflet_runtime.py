"""Leaflet assignment runtime: per-batch classification with frequency
gating, manual tables (file/map/ndx), clustering orientation, and the b7
decoder-channel eligibility logic.

Split out of analysis.py (round 5); reference parity notes cite
src/analysis/leaflets.rs and src/errors.rs per function."""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.leaflets import (
    make_global_classifier,
    make_individual_classifier,
    make_local_classifier,
)
from ..errors import AnalysisError, TopologyError
from ..input.config import Analysis, Frequency
from ..select import select_mask
from ..system import System
from ..topology.classify import MoleculeKind
from .prepare import (
    _AXIS_INDEX,
    _atoms_per_molecule,
    _empty_group_error,
    _single_atom_per_molecule,
)

log = logging.getLogger("gorder")

@dataclass
class LeafletRuntime:
    """Per-batch leaflet assignment with frequency gating."""

    classify = None                  # device fn or None (manual table)
    frequency: Frequency = None
    manual_table: Optional[np.ndarray] = None   # (n_assignment_frames, M)
    manual_source: str = "manual"               # 'manual' | 'ndx'
    carried: Optional[np.ndarray] = None        # (M,) last assignment
    n_molecules: int = 0
    collect_frames: Optional[List[np.ndarray]] = None  # per assignment frame
    kinds: Optional[List[MoleculeKind]] = None
    flip: bool = False
    orienter = None   # SpectralOrienter: raw cluster labels → leaflets
    # clustering methods classify every atom matching the heads query (the
    # reference's ClusterHeads group spans the whole system, not just the
    # analyzed molecules); this maps cloud positions → analyzed molecules
    cloud_to_mol: Optional[np.ndarray] = None
    _logged_stats: bool = False

    def _log_first_stats(self, classes: np.ndarray) -> None:
        """First-assignment-frame leaflet populations
        (reference: topology/mod.rs:178-225)."""
        if self._logged_stats or self.kinds is None:
            return
        self._logged_stats = True
        offset = 0
        for kind in self.kinds:
            chunk = classes[offset:offset + kind.n_molecules]
            log.info(
                "leaflet assignment (first frame): %s: %d upper, %d lower",
                kind.name, int((chunk == 0).sum()), int((chunk == 1).sum()))
            offset += kind.n_molecules

    def assignment_source(self, analyzed_idx: np.ndarray) -> np.ndarray:
        if self.frequency.kind == "once":
            return np.zeros_like(analyzed_idx)
        n = self.frequency.n
        return (analyzed_idx // n) * n

    def validate(self, n_analyzed: int) -> None:
        """Manual assignments must cover every assignment frame
        (reference: validate_run, topology/mod.rs:148-155)."""
        if self.manual_table is None:
            return
        if self.frequency.kind == "once":
            expected = 1
        else:
            expected = (n_analyzed + self.frequency.n - 1) // self.frequency.n
        if len(self.manual_table) != expected:
            from ..errors import ManualLeafletError, NdxLeafletError

            n = len(self.manual_table)
            freq = self.frequency.describe()
            if self.manual_source == "ndx":
                # wording: src/errors.rs:471-480
                # (NdxLeafletClassificationError::UnexpectedNumberOfNdxFiles)
                raise NdxLeafletError(
                    f"number of ndx files provided ('{n}') is not "
                    f"consistent with the number of analyzed frames "
                    f"('{n_analyzed}')\n(leaflet assignment was supposed to "
                    f"be performed {freq}, therefore there should be "
                    f"exactly '{expected}' ndx file(s) provided)")
            # wording: src/errors.rs:512-521
            # (ManualLeafletClassificationError::UnexpectedNumberOfFrames)
            raise ManualLeafletError(
                f"number of frames specified in the leaflet assignment "
                f"structure ('{n}') is not consistent with the number of "
                f"analyzed frames ('{n_analyzed}')\n(leaflet assignment was "
                f"supposed to be performed {freq}, therefore there should "
                f"be exactly '{expected}' frame(s) specified in the leaflet "
                f"assignment structure)")

    def fused_classify_impl(self, ignore_collect: bool = False):
        """Traceable per-batch classification for fused programs, or None
        when the batch path must stay host-visible: carried state
        (frequency > every-frame), manual lookup tables, sequential
        cluster matching (orienter), or collection buffers. Eligible
        methods (global / local / individual at every-frame frequency)
        are pure functions of the batch, so classes never leave the
        device. With ignore_collect=True, collection buffers do NOT
        disqualify — used by fused programs that return the in-program
        classes as an extra (B, M) output for the collector (export runs
        keep the compact wires; the drained classes are the same device
        values the kernel consumed)."""
        impl = getattr(self.classify, "impl", None)
        if (impl is None or self.manual_table is not None
                or self.orienter is not None
                or (self.collect_frames is not None and not ignore_collect)
                or self.frequency.kind != "every" or self.frequency.n != 1):
            return None
        if self.cloud_to_mol is None and not self.flip:
            return impl
        import jax.numpy as jnp

        from ..parallel.context import put_const

        cloud_d = (put_const(np.asarray(self.cloud_to_mol, np.int32))
                   if self.cloud_to_mol is not None else None)
        flip = self.flip

        def wrapped(coords, box_diag):
            classes = impl(coords, box_diag)
            if cloud_d is not None:
                classes = jnp.take(classes, cloud_d, axis=1)
            if flip:
                classes = 1 - classes
            return classes

        return wrapped

    def fused_channel_impl(self):
        """(traceable (heads, cog, box) -> classes, (membrane_slots,
        head_slots, axis)) when this classification can ride the b7
        wire's decoder side channels instead of reconstructed
        coordinates — global method, every-frame frequency, PBC on —
        else None. The channel classes match the coordinate path exactly
        except for the COG itself (host f64-accumulated vs the device's
        f32 sums — both within float noise of the reference's f64 Rust
        computation, and heads sit nm away from the center plane).
        Collection does not disqualify: the b7g fused program returns the
        in-program classes for the collector (engine/fused.py)."""
        if self.fused_classify_impl(ignore_collect=True) is None:
            return None
        ch = getattr(self.classify, "channel_impl", None)
        info = getattr(self.classify, "channel_info", None)
        if ch is None or info is None:
            return None
        membrane, heads, axis, handle_pbc = info
        if not handle_pbc or self.cloud_to_mol is not None:
            return None
        if self.flip:
            inner = ch

            def ch(heads_f, cog, box):          # noqa: F811
                return 1 - inner(heads_f, cog, box)

        return ch, (np.asarray(membrane, np.int32),
                    np.asarray(heads, np.int32), int(axis))

    def plane_eligible(self) -> bool:
        """True when this run's leaflet classes can ride the b7 wire as a
        host-computed (B, M) class plane: manual tables (classes are pure
        host data — reference src/analysis/leaflets.rs manual variants)
        or frequency-gated classification (`!once` / `!every N` — classes
        are computed on assignment frames only and carried between them,
        src/input/frequency.rs:13-55; the assignment frames' coordinates
        side-load sparsely while every frame ships bond vectors only)."""
        if self.manual_table is not None:
            return True
        return (self.classify is not None
                and (self.frequency.kind != "every"
                     or self.frequency.n != 1))

    def channel_coords_info(self):
        """(flip-wrapped traceable (coords, cog, box) -> classes,
        (membrane_slots, axis)) when this run's classification is in the
        decoder-COG channel class — global method, every-frame frequency,
        PBC on — else None. Unlike fused_channel_impl, collection does
        NOT disqualify: collect runs classify through classes_for_batch
        but must compare against the same per-frame COG, or an export run
        could differ from its non-export twin within float noise."""
        if (self.manual_table is not None or self.orienter is not None
                or self.cloud_to_mol is not None
                or self.frequency.kind != "every" or self.frequency.n != 1):
            return None
        ch = getattr(self.classify, "channel_coords_impl", None)
        info = getattr(self.classify, "channel_info", None)
        if ch is None or info is None:
            return None
        membrane, heads, axis, handle_pbc = info
        if not handle_pbc:
            return None
        if self.flip:
            inner = ch

            def ch(coords, cog, box):           # noqa: F811
                return 1 - inner(coords, cog, box)

        return ch, (np.asarray(membrane, np.int32), int(axis))

    def _channel_classify_host(self, coords_dev, cog, box_dev):
        """Raw (unflipped) channel classification for the host-visible
        path (classes_for_batch applies flip/collect itself)."""
        if getattr(self, "_channel_jit", None) is None:
            import jax

            self._channel_jit = jax.jit(self.classify.channel_coords_impl)
        # the (B,) cog goes in as numpy: jit commits it; pre-sharding it
        # with put_frames would reject short batches (frame-0 stats) on a
        # device mesh
        return np.asarray(self._channel_jit(
            coords_dev, np.asarray(cog, np.float32), box_dev))

    def classes_for_batch(self, coords_dev, box_dev, analyzed_idx: np.ndarray,
                          channel_cog: Optional[np.ndarray] = None
                          ) -> np.ndarray:
        """(B, M) leaflet classes for the analyzed frames of the batch.

        With channel_cog (decoder-COG channel class, see
        channel_coords_info), classification compares against the
        decoder's per-frame Bai-Breen center instead of a device-computed
        one — keeping host-visible paths (collection) bitwise consistent
        with the fused channel paths."""
        src = self.assignment_source(analyzed_idx)
        is_assign = src == analyzed_idx
        if self.manual_table is not None:
            if self.frequency.kind == "once":
                table_idx = np.zeros_like(src)
            else:
                table_idx = src // self.frequency.n
            classes = self.manual_table[table_idx]
        elif coords_dev is None and not is_assign.any() \
                and self.carried is not None:
            # b7 class-plane batches with no assignment frame (frequency
            # block longer than the batch): every row inherits the carried
            # assignment — no coordinates exist to classify, and none are
            # needed (the coordinate-wire path classifies such batches too,
            # but discards every row in the np.where below)
            classes = np.tile(self.carried[None, :], (len(analyzed_idx), 1))
        else:
            batch_start = analyzed_idx[0]
            if channel_cog is not None:
                assigned = self._channel_classify_host(coords_dev,
                                                       channel_cog, box_dev)
            else:
                assigned = np.asarray(self.classify(coords_dev, box_dev))
            if self.orienter is not None:
                # cluster identities are resolved sequentially per
                # assignment frame (clustering.rs classify_by_match)
                assigned = assigned.copy()
                for i in np.nonzero(is_assign)[0]:
                    assigned[i] = self.orienter.orient(assigned[i])
            in_batch = src >= batch_start
            local = np.clip(src - batch_start, 0, len(analyzed_idx) - 1)
            classes = np.where(
                in_batch[:, None], assigned[local],
                (self.carried if self.carried is not None
                 else assigned[0])[None, :],
            )
            # update carried state with the last assignment frame <= batch end
            if is_assign.any():
                last = np.nonzero(is_assign)[0][-1]
                self.carried = assigned[last]
        if self.cloud_to_mol is not None:
            classes = classes[:, self.cloud_to_mol]
        if self.flip:
            classes = 1 - classes
        if self.collect_frames is not None:
            for i in np.nonzero(is_assign)[0]:
                self.collect_frames.append(classes[i].copy())
        if not self._logged_stats and len(classes):
            self._log_first_stats(np.asarray(classes[0]))
        return classes.astype(np.int32)

def _require_cluster_atoms(n_atoms: int) -> None:
    """Clustering needs at least two head atoms
    (leaflets.rs:103-113 NotEnoughAtomsToCluster)."""
    if n_atoms < 2:
        raise TopologyError(
            f"clustering leaflet classification has been requested but "
            f"only '{n_atoms}' headgroup atom has been provided; need at "
            f"least '2' atoms")


def _cluster_head_cloud(system: System, kinds: List[MoleculeKind],
                        query: str):
    """Clustering operates on EVERY atom matching the heads query — the
    reference's ClusterHeads group spans the whole system (clustering.rs
    create_similarity_matrix iterates the raw group) — while each analyzed
    molecule is assigned the cluster of its own head. Returns
    (cloud_atom_indices, position_of_each_analyzed_molecule's_head)."""
    cloud = np.nonzero(select_mask(system, query))[0].astype(np.int64)
    heads = _single_atom_per_molecule(system, kinds, query, "cluster heads")
    mol_pos = np.searchsorted(cloud, heads)
    if not np.array_equal(cloud[mol_pos], heads):  # pragma: no cover
        raise TopologyError(
            "internal error: analyzed molecule heads missing from the "
            "cluster head cloud")
    return cloud, mol_pos
def build_leaflet_runtime(system: System, analysis: Analysis,
                          kinds: List[MoleculeKind], n_molecules: int,
                          normal_axis: int,
                          remap=None) -> Optional[LeafletRuntime]:
    params = analysis.leaflets
    if params is None:
        return None
    if remap is None:
        remap = lambda idx: idx  # noqa: E731 - identity for direct tests
    axis = normal_axis
    if params.membrane_normal is not None:
        axis = _AXIS_INDEX[params.membrane_normal]

    runtime = LeafletRuntime()
    runtime.frequency = params.frequency
    runtime.n_molecules = n_molecules
    runtime.kinds = kinds
    runtime.flip = params.flip
    if params.collect.enabled:
        runtime.collect_frames = []

    if params.kind in ("global", "local"):
        membrane_mask = select_mask(system, params.membrane)
        if not membrane_mask.any():
            raise _empty_group_error("Membrane")
        membrane_idx = np.nonzero(membrane_mask)[0]
        heads = _single_atom_per_molecule(system, kinds, params.heads,
                                          "leaflet heads")
        if params.kind == "global":
            runtime.classify = make_global_classifier(
                remap(membrane_idx), remap(heads), axis, analysis.handle_pbc)
        else:
            runtime.classify = make_local_classifier(
                remap(membrane_idx), remap(heads), axis, params.radius,
                analysis.handle_pbc)
    elif params.kind == "individual":
        heads = _single_atom_per_molecule(system, kinds, params.heads,
                                          "leaflet heads")
        methyls, methyl_mols = _atoms_per_molecule(system, kinds,
                                                   params.methyls, "methyls")
        runtime.classify = make_individual_classifier(
            remap(heads), remap(methyls), methyl_mols, n_molecules, axis,
            analysis.handle_pbc)
    elif params.kind == "clustering":
        from ..core.clustering import SpectralOrienter, make_spectral_labels

        cloud, mol_pos = _cluster_head_cloud(system, kinds, params.heads)
        _require_cluster_atoms(len(cloud))
        runtime.classify = make_spectral_labels(remap(cloud),
                                                analysis.handle_pbc)
        runtime.orienter = SpectralOrienter(cloud)
        runtime.cloud_to_mol = mol_pos
    elif params.kind == "spherical":
        from ..core.clustering import make_spherical_classifier

        cloud, mol_pos = _cluster_head_cloud(system, kinds, params.heads)
        _require_cluster_atoms(len(cloud))
        runtime.classify = make_spherical_classifier(remap(cloud),
                                                     analysis.handle_pbc)
        runtime.cloud_to_mol = mol_pos
    elif params.kind in ("from_file", "from_map"):
        if params.kind == "from_file":
            from ..errors import ManualLeafletError
            from ..input.config import yaml_module

            _yaml = yaml_module()

            try:
                with open(params.file) as fh:
                    assignment = _yaml.safe_load(fh)
            except OSError:
                # wording: src/errors.rs:486-487
                # (ManualLeafletClassificationError::FileNotFound)
                raise ManualLeafletError(
                    f"could not open the leaflet assignment file "
                    f"'{params.file}'") from None
            except _yaml.YAMLError as e:
                # wording: src/errors.rs:489-490
                # (ManualLeafletClassificationError::CouldNotParse)
                raise ManualLeafletError(
                    f"could not understand the contents of the leaflet "
                    f"assignment file '{params.file}' ({e})") from None
        else:
            assignment = params.assignment
        runtime.manual_table = _manual_leaflet_table(assignment, kinds)
    elif params.kind == "from_ndx":
        runtime.manual_table = _ndx_leaflet_table(system, kinds, params)
        runtime.manual_source = "ndx"
    else:
        raise AnalysisError(
            f"leaflet classification method '{params.kind}' is not yet "
            f"supported")
    return runtime


def _manual_leaflet_table(assignment, kinds: List[MoleculeKind]) -> np.ndarray:
    """{moltype: [per-assignment-frame [1/0 or Upper/Lower per molecule]]}
    → (n_assignment_frames, M) classes (0 = upper, 1 = lower)."""
    from ..errors import ManualLeafletError

    if not isinstance(assignment, dict):
        raise ManualLeafletError(
            "manual leaflet assignment must map molecule types to per-frame "
            "assignments")

    def to_class(value):
        if value in (1, "1", "Upper", "upper"):
            return 0
        if value in (0, "0", "Lower", "lower"):
            return 1
        raise ManualLeafletError(
            f"invalid leaflet value '{value}' in the manual assignment")

    known = {kind.name for kind in kinds}
    extra = [name for name in assignment if name not in known]
    if extra:
        # wording: src/errors.rs:523-525
        # (ManualLeafletClassificationError::UnknownMoleculeType)
        detected = " ".join(kind.name for kind in kinds)
        raise ManualLeafletError(
            f"molecule type '{extra[0]}' specified in the leaflet "
            f"assignment structure not found in the system (detected "
            f"molecule types are: '{detected}')")

    n_frames = None
    per_kind = []
    for kind in kinds:
        if kind.name not in assignment:
            # wording: src/errors.rs:492-493
            # (ManualLeafletClassificationError::MoleculeTypeNotFound)
            raise ManualLeafletError(
                f"molecule type '{kind.name}' not found in the leaflet "
                f"assignment structure")
        frames = assignment[kind.name]
        if not frames:  # `NAME:` with no value parses as None
            # wording: src/errors.rs:509-510
            # (ManualLeafletClassificationError::EmptyAssignment)
            raise ManualLeafletError(
                f"no leaflet assignment data provided for molecule type "
                f"'{kind.name}'")
        if n_frames is None:
            n_frames = len(frames)
        elif len(frames) != n_frames:
            raise ManualLeafletError(
                "inconsistent number of assignment frames between molecule "
                "types in the manual leaflet assignment")
        rows = []
        for fidx, frame in enumerate(frames):
            if len(frame) != kind.n_molecules:
                # wording: src/errors.rs:500-507
                # (ManualLeafletClassificationError::
                #  InconsistentNumberOfMolecules)
                raise ManualLeafletError(
                    f"inconsistent number of molecules specified in the "
                    f"leaflet assignment: expected '{kind.n_molecules}' "
                    f"molecules of type '{kind.name}', got '{len(frame)}' "
                    f"molecules in assignment frame '{fidx}'")
            rows.append([to_class(v) for v in frame])
        per_kind.append(np.asarray(rows, np.int32))
    if n_frames is None or n_frames == 0:
        raise ManualLeafletError("the manual leaflet assignment is empty")
    return np.concatenate(per_kind, axis=1)


def _ndx_leaflet_table(system: System, kinds: List[MoleculeKind],
                       params) -> np.ndarray:
    """One NDX file per assignment frame; heads in the upper/lower groups
    decide each molecule's leaflet (leaflets.rs FromNdx)."""
    from ..errors import NdxLeafletError
    from ..io.ndx import parse_ndx

    heads = _single_atom_per_molecule(system, kinds, params.heads,
                                      "leaflet heads")
    rows = []
    for path in params.ndx:
        from ..errors import NdxError

        try:
            with open(path) as fh:
                groups = parse_ndx(fh.read(), system.n_atoms, path,
                                   protected=(params.upper_leaflet,
                                              params.lower_leaflet))
        except OSError as e:
            raise NdxLeafletError(
                f"could not read leaflet ndx file '{path}': {e}") from None
        except NdxError as e:
            raise NdxLeafletError(str(e)) from None
        # wording: src/errors.rs:461-463
        # (NdxLeafletClassificationError::GroupNotFound)
        if params.upper_leaflet not in groups:
            raise NdxLeafletError(
                f"group '{params.upper_leaflet}' for selecting "
                f"upper-leaflet molecules was not found in the ndx file "
                f"'{path}'")
        if params.lower_leaflet not in groups:
            raise NdxLeafletError(
                f"group '{params.lower_leaflet}' for selecting "
                f"lower-leaflet molecules was not found in the ndx file "
                f"'{path}'")
        upper = set(groups[params.upper_leaflet].tolist())
        lower = set(groups[params.lower_leaflet].tolist())
        row = np.zeros(len(heads), np.int32)
        for m, head in enumerate(heads):
            # upper is checked first and wins on overlap
            # (leaflets.rs:1152-1170 assign_molecule)
            if int(head) in upper:
                row[m] = 0
            elif int(head) in lower:
                row[m] = 1
            else:
                # wording: src/errors.rs:465-469
                # (NdxLeafletClassificationError::AssignmentNotFound)
                raise NdxLeafletError(
                    f"could not find leaflet assignment for molecule index "
                    f"'{m}' (head index '{int(head)}')\n(hint: head "
                    f"identifier index '{int(head)}' is missing from both "
                    f"specified ndx groups)")
        rows.append(row)
    if not rows:
        raise NdxLeafletError("no ndx files given for leaflet assignment")
    return np.stack(rows)

