#!/usr/bin/env python3
"""CG and UA benchmark modes — the rest of the reference's published
benchmark table (performance/main_benchmarks.md §Coarse-grained and
§United-atom; BASELINE.md rows 4-8).

Synthesizes systems at the reference benchmark's scale and times the
complete end-to-end analysis the same way bench.py does for the AA
headline (best-of-N trials, each validated against its pinned golden):

- CG: 512-lipid Martini-like POPC (12 beads each) + single-bead water
  to 16.8k beads total, 10,000 XTC frames. Reference (8T): 1.912 s
  -> 5,230 frames/s.
- UA: 256-lipid Berger-like POPC (51 united atoms each) + 3-point
  water to 44.3k atoms total, 3,000 XTC frames. Reference (8T):
  1.749 s -> 1,715 frames/s.

Usage:
  python tools/bench_modes.py synth        # CPU-only: build the inputs
  python tools/bench_modes.py cg|ua        # run one mode on the GPU
Prints one JSON line per run (same shape as bench.py's, naming the
device). With no GPU it exits non-zero.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

import bench  # noqa: E402  (synthesizers, validation, device record)

CACHE = bench.CACHE

CG_LIPIDS = 512
CG_TOTAL_BEADS = 16800
CG_FRAMES = int(os.environ.get("GORDER_BENCH_CG_FRAMES", "10000"))
CG_BOX = np.array([12.8, 12.8, 10.0], np.float32)
CG_BASELINE_8T = 10000 / 1.912          # frames/s, BASELINE.md row 5

UA_LIPIDS = 256
UA_TOTAL_ATOMS = 44300
UA_FRAMES = int(os.environ.get("GORDER_BENCH_UA_FRAMES", "3000"))
UA_BOX = np.array([9.2, 9.2, 9.0], np.float32)
UA_BASELINE_8T = 3000 / 1.749           # frames/s, BASELINE.md row 7

# AA with global leaflets every frame: 9.86 s / 10k frames at 8 threads
# (performance/leaflets_benchmarks.md §Atomistic; BASELINE.md row 17)
AA_LEAFLETS_BASELINE_8T = 10000 / 9.86

# AA with LOCAL leaflets every frame: ~508 s / 10k frames at 8 threads —
# the reference's pathological case (per-lipid neighborhood scans on the
# CPU; leaflets_benchmarks.md §Atomistic; BASELINE.md row 17)
AA_LOCAL_LEAFLETS_BASELINE_8T = 10000 / 508.0

# AA with dynamic membrane normals: 6.68 s / 10k frames at 8 threads
# (performance/export_benchmarks.md §Normals; BASELINE.md row 19)
AA_DYNAMIC_BASELINE_8T = 10000 / 6.68

# The rest of the reference's leaflet-overhead table (AA, every frame,
# 8T — performance/leaflets_benchmarks.md §Atomistic; BASELINE.md row 17):
# individual 6.48 s, spherical-clustering 6.69 s, (spectral) clustering
# ~16 s, from-file 6.90 s
AA_INDIVIDUAL_BASELINE_8T = 10000 / 6.48
AA_SPHERICAL_BASELINE_8T = 10000 / 6.69
AA_CLUSTERING_BASELINE_8T = 10000 / 16.0
AA_FROMFILE_BASELINE_8T = 10000 / 6.90

# Export-overhead and frequency-gated rows
# (performance/export_benchmarks.md §Leaflets / §Normals, gorder 1.2 8T)
AA_LEAFLETS_EXPORT_BASELINE_8T = 10000 / 9.685     # global + export
AA_DYNAMIC_EXPORT_BASELINE_8T = 10000 / 8.168      # dyn normals + export
AA_LEAFLETS_E10_BASELINE_8T = 10000 / 7.314        # global, every 10th
AA_LEAFLETS_ONCE_BASELINE_8T = 10000 / 6.110       # global, once

# Palmitoyl-only rows (performance/main_benchmarks.md; BASELINE.md rows
# 3 and 8) — the reference publishes these at ONE thread (its direct
# `gmx order` comparison): AA 10.465 s / 10k frames, UA 4.036 s / 3k
AA_PALMITOYL_BASELINE_1T = 10000 / 10.465
UA_PALMITOYL_BASELINE_1T = 3000 / 4.036

# Geometry restriction has no published reference row; the comparison
# denominator is the reference's plain-AA 8T rate (5.86 s / 10k frames)
# so the row quantifies the repo's own geometry overhead
AA_GEOMETRY_BASELINE_8T = 10000 / 5.86

AA_MODES = ("aa-leaflets", "aa-local-leaflets", "aa-dynamic",
            "aa-individual-leaflets", "aa-spherical-leaflets",
            "aa-clustering-leaflets", "aa-fromfile-leaflets",
            "aa-palmitoyl", "aa-geometry",
            "aa-leaflets-export", "aa-dynamic-export",
            "aa-leaflets-every10", "aa-leaflets-once")


def _cg_template():
    """Martini-like POPC: NC3-PO4-GL1(-GL2)-C1A..C4A / C1B..C4B."""
    names = ["NC3", "PO4", "GL1", "GL2",
             "C1A", "C2A", "C3A", "C4A", "C1B", "C2B", "C3B", "C4B"]
    bonds = [(0, 1), (1, 2), (2, 3), (2, 4), (4, 5), (5, 6), (6, 7),
             (3, 8), (8, 9), (9, 10), (10, 11)]
    return names, bonds


def _ua_template():
    """Berger-like united-atom POPC: polar head + glycerol + 16-carbon
    saturated chain A + 18-carbon chain B with a CB9=CB10 double bond.
    Chain carbons carry no explicit hydrogens (that is the UA point)."""
    names, bonds = [], []

    def add(name, parent=None):
        names.append(name)
        if parent is not None:
            bonds.append((parent, len(names) - 1))
        return len(names) - 1

    n = add("N")
    c_prev = n
    for i in (1, 2, 3, 4):               # choline + linker carbons (CH2/CH3)
        c_prev = add(f"CN{i}", c_prev)
    p = add("P", c_prev)
    for i in (1, 2, 3):                  # phosphate oxygens
        add(f"O{i}", p)
    g1 = add("CG1", p)                   # glycerol backbone
    g2 = add("CG2", g1)
    g3 = add("CG3", g2)
    oa = add("OA", g2)                   # ester links
    ob = add("OB", g3)
    ca_prev = oa
    for i in range(2, 18):               # chain A: CA2..CA17 saturated
        ca_prev = add(f"CA{i}", ca_prev)
    cb_prev = ob
    for i in range(2, 20):               # chain B: CB2..CB19, CB9=CB10
        cb_prev = add(f"CB{i}", cb_prev)
    return names, bonds


def _synthesize(tag, template, n_mols, total_atoms, box, resname,
                water_names, frames, seed, z_offset=0.4,
                chains_inward=False):
    """bench.py's layout/motion model at this mode's scale: bonded
    random-walk lipids on a leaflet grid + water fill, then rigid
    per-molecule drift with per-atom jitter, written through our own
    XTC encoder. `z_offset`/`chains_inward` control the bilayer
    geometry: the clustering benchmark needs realistically separated
    leaflets (heads ~4 nm apart, tails inward) for spectral leaflet
    clustering to be well-posed."""
    from gorder_tpu.io import native
    from gorder_tpu.io.gro import write_gro
    from gorder_tpu.system import System, canonical_bonds

    gro = os.path.join(CACHE, f"{tag}_bench.gro")
    bnd = os.path.join(CACHE, f"{tag}_bench.bnd")
    xtc = os.path.join(CACHE, f"{tag}_bench_{frames}.xtc")

    lipid_names, lipid_bonds = template()
    per = len(lipid_names)
    n_lipid_atoms = per * n_mols
    n_water = (total_atoms - n_lipid_atoms) // len(water_names)

    need_struct = not (os.path.exists(gro) and os.path.exists(bnd))
    need_traj = True
    if os.path.exists(xtc):
        info = native.xtc_scan(xtc)
        need_traj = len(info["offsets"]) != frames
        if need_traj:
            os.remove(xtc)

    rng = np.random.default_rng(seed)
    names, resids, resnames = [], [], []
    bonds = []
    n_atoms = n_lipid_atoms + n_water * len(water_names)
    positions = np.zeros((n_atoms, 3), np.float32)
    grid = int(np.ceil(np.sqrt(n_mols / 2)))
    spacing = box[0] / grid
    idx = 0
    for m in range(n_mols):
        leaflet = m % 2
        cell = m // 2
        gx, gy = cell % grid, (cell // grid) % grid
        sign = 1.0 if leaflet == 0 else -1.0
        base = np.array([(gx + 0.5) * spacing, (gy + 0.5) * spacing,
                         box[2] / 2 + sign * z_offset], np.float32)
        z_dir = -sign if chains_inward else sign
        walk = base.copy()
        for name in lipid_names:
            names.append(name)
            resids.append(m + 1)
            resnames.append(resname)
            step = rng.normal(0, 1, 3).astype(np.float32)
            step[2] += z_dir * 1.2
            step /= max(np.linalg.norm(step), 1e-6)
            walk = walk + step * (0.3 if tag == "cg" else 0.14)
            positions[idx] = walk
            idx += 1
        off = m * per
        bonds += [(off + a, off + b) for a, b in lipid_bonds]
    for w in range(n_water):
        base = rng.random(3).astype(np.float32) * box
        for k, name in enumerate(water_names):
            names.append(name)
            resids.append(n_mols + w + 1)
            resnames.append("W" if tag == "cg" else "SOL")
            d = rng.normal(0, 1, 3).astype(np.float32)
            d /= max(np.linalg.norm(d), 1e-6)
            positions[idx] = base + (0.0957 * k) * d
            idx += 1
        if len(water_names) > 1:
            o = n_lipid_atoms + w * len(water_names)
            bonds += [(o, o + k) for k in range(1, len(water_names))]
    positions %= box

    system = System(
        name=f"gorder-tpu {tag} benchmark",
        atom_names=np.array(names, dtype="U8"),
        resids=np.array(resids, np.int64),
        resnames=np.array(resnames, dtype="U8"),
        serials=np.arange(1, n_atoms + 1, dtype=np.int64),
        positions=positions,
        box=np.diag(box).astype(np.float32),
    )
    system.bonds = canonical_bonds(np.asarray(bonds, np.int64))
    if need_struct:
        write_gro(gro, system)
        with open(bnd, "w") as fh:
            for a, b in system.bonds:
                fh.write(f"{a + 1} {b + 1}\n")

    if need_traj:
        t0 = time.perf_counter()
        bench.write_drift_trajectory(
            xtc, positions, np.asarray(system.resids, np.int64) - 1, box,
            frames, rng)
        sys.stderr.write(f"[bench-{tag}] synthesized {frames} frames in "
                         f"{time.perf_counter() - t0:.1f}s\n")
    return gro, bnd, xtc


def synth_cg():
    return _synthesize("cg", _cg_template, CG_LIPIDS, CG_TOTAL_BEADS,
                       CG_BOX, "POPC", ["W"], CG_FRAMES, seed=23)


def synth_ua():
    return _synthesize("ua", _ua_template, UA_LIPIDS, UA_TOTAL_ATOMS,
                       UA_BOX, "POPC", ["OW", "HW1", "HW2"], UA_FRAMES,
                       seed=29)


def synth_aa_bilayer(frames=None):
    """AA benchmark system with REALISTIC bilayer geometry (heads ~4 nm
    apart across the midplane, chains pointing inward) for the
    spectral-clustering leaflet mode: on the shared flat system the
    leaflet head planes sit closer than the in-plane head spacing, so
    leaflet clustering is ill-posed there (the reference tool would
    thrash the same way). Same scale as the headline system."""
    if frames is None:
        frames = bench.N_FRAMES
    return _synthesize("aab", bench.build_lipid_template, 256, 64500,
                       np.array([13.0, 13.0, 11.0], np.float32), "POPC",
                       ["OH2", "H1", "H2"], frames,
                       seed=31, z_offset=2.0, chains_inward=True)


def _make_analysis(mode):
    from gorder_tpu.input import Analysis, AnalysisType

    if mode == "cg":
        gro, bnd, xtc = synth_cg()
        atype = AnalysisType.cgorder("resname POPC")
        out = os.path.join(CACHE, "cg_bench_order.yaml")
    elif mode in AA_MODES:
        # AA-headline-system variants of the reference's other published
        # rows: the full leaflet-overhead table
        # (leaflets_benchmarks.md §Atomistic: global / local / individual
        # / spherical-clustering / clustering / from-file, every frame),
        # dynamic membrane normals (export_benchmarks.md §Normals), the
        # palmitoyl-only chain (main_benchmarks.md §Atomistic), and a
        # geometry-restriction row (repo-only; selection-COG cylinder)
        from gorder_tpu.input.config import (Geometry,
                                             LeafletClassification,
                                             MembraneNormal)

        gro = os.path.join(CACHE, "bench.gro")
        bnd = os.path.join(CACHE, "bench.bnd")
        xtc = os.path.join(CACHE, f"bench_{10000}.xtc")
        if not all(os.path.exists(p) for p in (gro, bnd, xtc)):
            raise SystemExit("run bench.py once first (synthesizes the AA "
                             "inputs this mode reuses)")
        kwargs = {}
        heavy = "resname POPC and name r'^C'"
        hydrogens = "resname POPC and name r'^H'"
        if mode == "aa-leaflets":
            kwargs["leaflets"] = LeafletClassification.global_(
                "resname POPC", "resname POPC and name P")
        elif mode == "aa-leaflets-export":
            # the reference's leaflet-export row: global classification
            # + per-frame assignment export (export_benchmarks.md
            # §Leaflets, frequency every)
            kwargs["leaflets"] = LeafletClassification.global_(
                "resname POPC", "resname POPC and name P").with_collect(
                    os.path.join(CACHE, "aa-leaflets-export_leaflets.yaml"))
        elif mode == "aa-leaflets-every10":
            # frequency-gated classification (export_benchmarks.md
            # §Leaflets, frequency every 10th): rides the b7 wire with
            # sparse assignment-frame coordinate side-reads
            from gorder_tpu.input.config import Frequency

            kwargs["leaflets"] = LeafletClassification.global_(
                "resname POPC", "resname POPC and name P").with_frequency(
                    Frequency.every(10))
        elif mode == "aa-leaflets-once":
            from gorder_tpu.input.config import Frequency

            kwargs["leaflets"] = LeafletClassification.global_(
                "resname POPC", "resname POPC and name P").with_frequency(
                    Frequency.once())
        elif mode == "aa-dynamic-export":
            # the reference's normals-export row (export_benchmarks.md
            # §Normals): collection forces the host-visible normals path
            kwargs["membrane_normal"] = MembraneNormal.dynamic(
                "resname POPC and name P",
                collect=os.path.join(CACHE, "aa-dynamic-export_normals.yaml"))
        elif mode == "aa-local-leaflets":
            # radius 2.5 nm — the reference manual's local-method example
            kwargs["leaflets"] = LeafletClassification.local(
                "resname POPC", "resname POPC and name P", 2.5)
        elif mode == "aa-individual-leaflets":
            # methyls: the two terminal chain carbons of the synthetic
            # CHARMM-like template (bench.py build_lipid_template)
            kwargs["leaflets"] = LeafletClassification.individual(
                "resname POPC and name P",
                "resname POPC and name C217 C317")
        elif mode == "aa-spherical-leaflets":
            kwargs["leaflets"] = LeafletClassification.spherical(
                "resname POPC and name P")
        elif mode == "aa-clustering-leaflets":
            # dedicated realistic-bilayer system (see synth_aa_bilayer)
            gro, bnd, xtc = synth_aa_bilayer()
            kwargs["leaflets"] = LeafletClassification.clustering(
                "resname POPC and name P")
        elif mode == "aa-fromfile-leaflets":
            # deterministic per-frame manual assignment for every frame:
            # the synthetic membrane puts even molecules in the upper
            # leaflet (bench.py synthesize_structure; manual value 1 =
            # upper, 0 = lower — the reference's serialization)
            row = [1 - (m % 2) for m in range(256)]
            kwargs["leaflets"] = LeafletClassification.from_map(
                {"POPC": [row] * 10000})
        elif mode == "aa-dynamic":
            kwargs["membrane_normal"] = MembraneNormal.dynamic(
                "resname POPC and name P")   # default radius 2.0 nm
        elif mode == "aa-geometry":
            # selection-COG cylinder: the reference point is recomputed
            # every frame from the full lipid selection
            # (src/analysis/geometry.rs init_reference)
            kwargs["geometry"] = Geometry(
                "cylinder", reference="resname POPC", radius=4.0,
                orientation="z")
        elif mode == "aa-palmitoyl":
            # sn-1 chain only — the reference's `gmx order` comparison row
            heavy = "resname POPC and name r'^C2\\d+$'"
            hydrogens = "resname POPC and name r'^H\\d+[RST]2$'"
        return Analysis(
            structure=gro, bonds=bnd, trajectory=xtc,
            analysis_type=AnalysisType.aaorder(heavy, hydrogens),
            output_yaml=os.path.join(CACHE, f"{mode}_order.yaml"),
            silent=True, overwrite=True, **kwargs)
    elif mode == "ua-palmitoyl":
        gro, bnd, xtc = synth_ua()
        atype = AnalysisType.uaorder(
            saturated="resname POPC and name r'^CA\\d+$'")
        out = os.path.join(CACHE, "ua-palmitoyl_order.yaml")
    else:
        gro, bnd, xtc = synth_ua()
        atype = AnalysisType.uaorder(
            saturated="resname POPC and name r'^CA\\d+$' or "
                      "(resname POPC and name r'^CB\\d+$' and "
                      "not name CB9 CB10)",
            unsaturated="resname POPC and name CB9 CB10",
        )
        out = os.path.join(CACHE, "ua_bench_order.yaml")
    return Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=atype, output_yaml=out,
                    silent=True, overwrite=True)


def run_mode(mode):
    """Best-of-N end-to-end trials of one mode, each validated against its
    pinned golden; prints one JSON line naming the device."""
    device = bench.require_gpu()
    analysis = _make_analysis(mode)
    baseline = {"cg": CG_BASELINE_8T, "ua": UA_BASELINE_8T,
                "aa-leaflets": AA_LEAFLETS_BASELINE_8T,
                "aa-local-leaflets": AA_LOCAL_LEAFLETS_BASELINE_8T,
                "aa-dynamic": AA_DYNAMIC_BASELINE_8T,
                "aa-individual-leaflets": AA_INDIVIDUAL_BASELINE_8T,
                "aa-spherical-leaflets": AA_SPHERICAL_BASELINE_8T,
                "aa-clustering-leaflets": AA_CLUSTERING_BASELINE_8T,
                "aa-fromfile-leaflets": AA_FROMFILE_BASELINE_8T,
                "aa-palmitoyl": AA_PALMITOYL_BASELINE_1T,
                "ua-palmitoyl": UA_PALMITOYL_BASELINE_1T,
                "aa-geometry": AA_GEOMETRY_BASELINE_8T,
                "aa-leaflets-export": AA_LEAFLETS_EXPORT_BASELINE_8T,
                "aa-dynamic-export": AA_DYNAMIC_EXPORT_BASELINE_8T,
                "aa-leaflets-every10": AA_LEAFLETS_E10_BASELINE_8T,
                "aa-leaflets-once": AA_LEAFLETS_ONCE_BASELINE_8T}[mode]

    # warm: compile excluded, like bench.py
    warm = _make_analysis(mode)
    warm.begin, warm.end = 0.0, 10_230.0
    if mode == "aa-fromfile-leaflets":
        # manual assignment tables must cover exactly the analyzed frame
        # count; the 10 ps spacing puts 1,024 frames in the warm window
        warm.leaflets.assignment = {
            name: rows[:1024]
            for name, rows in warm.leaflets.assignment.items()}
    warm.run()

    trials = int(os.environ.get("GORDER_BENCH_TRIALS", "3"))
    out_yaml = {"cg": os.path.join(CACHE, "cg_bench_order.yaml"),
                "ua": os.path.join(CACHE, "ua_bench_order.yaml")}.get(
        mode, os.path.join(CACHE, f"{mode}_order.yaml"))
    from gorder_tpu import analysis as _mod

    best_rate, best_kbf, best_wire = 0.0, 0.0, ""
    for trial in range(trials):
        t0 = time.perf_counter()
        r = analysis.run()
        r.write()
        dt = time.perf_counter() - t0
        # the figure only posts if this run's output matches the golden
        validated = bench.validate_output(out_yaml, mode,
                                          r.n_analyzed_frames)
        n_frames = r.n_analyzed_frames
        rate = n_frames / dt
        xbytes = getattr(_mod, "_LAST_XFER_BYTES", 0) or 0
        wire = getattr(_mod, "_LAST_WIRE", None)
        wire_fmt = wire[0] if wire else "?"
        kbf = xbytes / n_frames / 1024 if n_frames else 0.0
        print(f"# {mode} trial {trial}: {rate:.1f} frames/s on wire "
              f"{wire_fmt} ({kbf:.1f} KB/frame) | {dt:.1f}s",
              file=sys.stderr)
        if rate > best_rate:
            best_rate, best_kbf, best_wire = rate, kbf, wire_fmt

    desc = {"cg": f"CG 512-lipid Martini-like {CG_TOTAL_BEADS / 1000:.1f}k-"
                  f"bead order analysis, end-to-end ({n_frames} XTC frames)",
            "ua": f"UA 256-lipid Berger-like {UA_TOTAL_ATOMS / 1000:.1f}k-"
                  f"atom order analysis, end-to-end ({n_frames} XTC frames)",
            "aa-leaflets": "AA 256-lipid order analysis with global "
                           "leaflet classification every frame, "
                           f"end-to-end ({n_frames} XTC frames)",
            "aa-local-leaflets": "AA 256-lipid order analysis with LOCAL "
                                 "leaflet classification every frame, "
                                 f"end-to-end ({n_frames} XTC frames)",
            "aa-dynamic": "AA 256-lipid order analysis with dynamic "
                          "membrane normals, end-to-end "
                          f"({n_frames} XTC frames)",
            "aa-individual-leaflets": "AA 256-lipid order analysis with "
                                      "INDIVIDUAL leaflet classification "
                                      "every frame, end-to-end "
                                      f"({n_frames} XTC frames)",
            "aa-spherical-leaflets": "AA 256-lipid order analysis with "
                                     "spherical-clustering (GMM) leaflet "
                                     "classification every frame, "
                                     f"end-to-end ({n_frames} XTC frames)",
            "aa-clustering-leaflets": "AA 256-lipid order analysis with "
                                      "spectral-clustering leaflet "
                                      "classification every frame, "
                                      f"end-to-end ({n_frames} XTC frames)",
            "aa-fromfile-leaflets": "AA 256-lipid order analysis with "
                                    "manual (from-map) leaflet assignment "
                                    "every frame, end-to-end "
                                    f"({n_frames} XTC frames)",
            "aa-palmitoyl": "AA 256-lipid order analysis, palmitoyl chain "
                            f"only, end-to-end ({n_frames} XTC frames; "
                            "reference baseline is 1-thread)",
            "ua-palmitoyl": "UA 256-lipid order analysis, palmitoyl chain "
                            f"only, end-to-end ({n_frames} XTC frames; "
                            "reference baseline is 1-thread)",
            "aa-geometry": "AA 256-lipid order analysis restricted to a "
                           "selection-COG cylinder (recomputed every "
                           f"frame), end-to-end ({n_frames} XTC frames; "
                           "baseline is the reference's plain-AA 8T rate)",
            "aa-leaflets-export": "AA 256-lipid order analysis with "
                                  "global leaflet classification every "
                                  "frame + assignment export, end-to-end "
                                  f"({n_frames} XTC frames)",
            "aa-dynamic-export": "AA 256-lipid order analysis with "
                                 "dynamic membrane normals + normals "
                                 "export, end-to-end "
                                 f"({n_frames} XTC frames)",
            "aa-leaflets-every10": "AA 256-lipid order analysis with "
                                   "global leaflet classification every "
                                   "10th frame, end-to-end "
                                   f"({n_frames} XTC frames)",
            "aa-leaflets-once": "AA 256-lipid order analysis with global "
                                "leaflet classification once, end-to-end "
                                f"({n_frames} XTC frames)",
            }[mode]
    print(json.dumps({
        "metric": desc,
        "value": best_rate,
        "unit": "frames/s",
        "vs_baseline_8T": best_rate / baseline,
        "wire_format": best_wire,
        "wire_KB_frame": best_kbf,
        "output_validated": validated or "no-golden",
        "device": device,
    }))


def _measure_device_resident_ua(analysis, batch=512, iters=30):
    """UA analogue of bench.measure_device_resident: one real batch's s6
    wire payload staged on the device, then the production fused body
    (_s6_impl reconstruction -> make_ua_step impl: virtual-H prediction
    + P2 + exact limb reduction) timed over `iters` scan repetitions in
    ONE dispatch (see bench.py for the carry-perturbation argument)."""
    import jax

    from gorder_tpu.analysis import (_build_atom_space, _prepare_ua_kinds,
                                     _s6_impl, _wire_groups, load_structure)
    from gorder_tpu.core.ua import make_ua_step
    from gorder_tpu.io.native import s6_stride
    from gorder_tpu.io.traj import Trajectory

    system = load_structure(analysis)
    kinds, compiled = _prepare_ua_kinds(system, analysis)
    assert kinds and compiled is not None
    ua_atom_arrays = [d[k] for d in compiled.categories.values()
                      for k in ("target", "h1", "h2", "h3") if k in d]
    space, remap = _build_atom_space(system, analysis, ua_atom_arrays)
    categories = {
        cat: {k: (remap(v) if k in ("target", "h1", "h2", "h3") else v)
              for k, v in d.items()}
        for cat, d in compiled.categories.items()
    }
    step = make_ua_step(categories, compiled.bond_type, compiled.bond_mol,
                        compiled.n_types, handle_pbc=True,
                        with_leaflets=False, normal_mode="static")

    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    idx = traj.select_frames(None, None, 1)[:batch]
    group_of, n_groups, vgidx = _wire_groups(system, space)
    n, n_out = len(idx), space.n_out
    esc_cap = 4096
    pk = np.zeros((n, s6_stride(n_out)), np.uint8)
    eg = np.zeros((n, esc_cap), np.uint16)
    ev = np.zeros((n, esc_cap), np.int16)
    gm = np.zeros((n, (n_groups + 1) * 3), np.int16)
    res, _ = traj.read_frames_s6(idx, space, group_of, n_groups,
                                 pk, eg, ev, gm)
    staged = coords_dev = scale_dev = None
    if res is not None:
        base, inv_prec, boxes, _, _ = res
        staged = tuple(jax.device_put(a)
                       for a in (pk, eg, ev, base, gm,
                                 vgidx.astype(np.int32)))
        scale_dev = jax.device_put(np.asarray(inv_prec, np.float32))
    else:
        coords, boxes, _, _ = traj.read_frames(idx, space)
        coords_dev = jax.device_put(coords)
    box_dev = jax.device_put(boxes[:, [0, 1, 2], [0, 1, 2]].copy())
    normal_dev = jax.device_put(np.array([0, 0, 1], np.float32))
    mask_dev = jax.device_put(np.ones(n, bool))
    jax.block_until_ready([box_dev, normal_dev, mask_dev])

    frame_args = (box_dev, normal_dev, mask_dev)
    if staged is not None:
        def one(carry, a):
            w, scale, (box, normal, mask) = a
            c = _s6_impl(*bench.perturb_base(w, carry), scale + carry)
            return step.impl(c, box, normal, mask)

        args = (staged, scale_dev, frame_args)
    else:
        def one(carry, a):
            coords, (box, normal, mask) = a
            return step.impl(coords + carry, box, normal, mask)

        args = (coords_dev, frame_args)
    return bench.time_scan(one, args, n, iters=iters)


def _measure_device_resident_aa_leaflets(analysis, batch=256, iters=30):
    """AA + global-leaflets analogue of bench.measure_device_resident:
    one real batch's b7g wire payload (bond residuals + head-position and
    Bai-Breen COG side channels) staged on the device, then the
    production fused body (analysis.py _build_fused_steps 'b7g' branch:
    _b7_impl -> channel classification -> leaflet-wise order kernel)
    timed over `iters` scan repetitions in ONE dispatch."""
    import jax
    import jax.numpy as jnp

    from gorder_tpu.analysis import (_b7_impl, _build_atom_space,
                                     _prepare_bond_kinds,
                                     build_leaflet_runtime, load_structure)
    from gorder_tpu.core.order import make_order_step
    from gorder_tpu.io.native import b7_stride
    from gorder_tpu.io.traj import Trajectory

    system = load_structure(analysis)
    kinds, compiled = _prepare_bond_kinds(system, analysis)
    space, remap = _build_atom_space(system, analysis,
                                     [compiled.atom_a, compiled.atom_b])
    leaflets = build_leaflet_runtime(system, analysis, kinds,
                                     compiled.n_molecules, 2, remap)
    ch = leaflets.fused_channel_impl()
    assert ch is not None, "global every-frame leaflets should ride b7g"
    channel_classify, (ch_membrane, ch_heads, ch_axis) = ch
    step = make_order_step(
        remap(compiled.atom_a), remap(compiled.atom_b), compiled.bond_type,
        compiled.molecule, compiled.n_types, compiled.n_molecules,
        handle_pbc=True, with_leaflets=True, normal_mode="static")
    bond_slots = (remap(compiled.atom_a), remap(compiled.atom_b))

    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    idx = traj.select_frames(None, None, 1)[:batch]
    n = len(idx)
    esc_cap = 4096
    pk = np.zeros((n, b7_stride(len(bond_slots[0]))), np.uint8)
    eg = np.zeros((n, esc_cap), np.uint16)
    ev = np.zeros((n, esc_cap), np.int16)
    aux = np.zeros((n, len(ch_heads), 3), np.int32)
    cog = np.zeros(n, np.float32)
    res, _ = traj.read_frames_b7(idx, space, bond_slots[0], bond_slots[1],
                                 pk, eg, ev, aux_slots=ch_heads,
                                 aux_out=aux, cog_slots=ch_membrane,
                                 cog_axis=ch_axis, cog_out=cog)
    assert res is not None, "synthesized AA batch should fit the b7 wire"
    base, inv_prec, boxes, _, _ = res
    staged = tuple(jax.device_put(a) for a in (pk, eg, ev, base, aux, cog))
    scale_dev = jax.device_put(np.asarray(inv_prec, np.float32))
    box_dev = jax.device_put(boxes[:, [0, 1, 2], [0, 1, 2]].copy())
    normal_dev = jax.device_put(np.array([0, 0, 1], np.float32))
    mask_dev = jax.device_put(np.ones(n, bool))
    jax.block_until_ready([box_dev, normal_dev, mask_dev])

    def one(carry, a):
        w, scale, (box, normal, mask) = a
        pk_d, eg_d, ev_d, base_d, aux_d, cog_d = bench.perturb_base(w, carry)
        scale = scale + carry
        dq = _b7_impl(pk_d, eg_d, ev_d, base_d)
        heads = aux_d.astype(jnp.float32) * scale[:, None, None]
        classes = channel_classify(heads, cog_d, box)
        return step.impl(dq, box, normal, mask, leaflet_classes=classes,
                         inv_scale=scale, diff_input=True)

    args = (staged, scale_dev, (box_dev, normal_dev, mask_dev))
    return bench.time_scan(one, args, n, iters=iters)


def _measure_device_resident_aa_geometry(analysis, batch=256, iters=30):
    """Geometry analogue of bench.measure_device_resident: one real
    batch's wire payload staged, then the production fused body timed
    over `iters` scan repetitions in ONE dispatch. Since round 5 the
    production route is b7geo — b7 bond vectors + the decoder-evaluated
    inside-mask bitplane (native/xdr.cpp xtc_geo_mask), so the body is
    bond-vector reconstruction + bit-unpack + the masked kernel with no
    coordinate reconstruction or on-device COG at all; the pre-round-5
    s6 route (full coordinates + in-program selection COG + inside test)
    remains as the fallback when b7 staging fails."""
    import jax
    import jax.numpy as jnp

    from gorder_tpu.analysis import (_build_atom_space, _prepare_bond_kinds,
                                     _prepare_geometry, _b7_impl, _s6_impl,
                                     _wire_groups, load_structure)
    from gorder_tpu.core.order import make_order_step
    from gorder_tpu.io.native import b7_stride, geo_stride, s6_stride
    from gorder_tpu.io.traj import Trajectory

    system = load_structure(analysis)
    kinds, compiled = _prepare_bond_kinds(system, analysis)
    geom_spec, geom_mode, geom_payload = _prepare_geometry(system, analysis)
    assert geom_mode == "selection", geom_mode
    space, remap = _build_atom_space(system, analysis,
                                     [compiled.atom_a, compiled.atom_b])
    geom_dev = jax.device_put(remap(geom_payload))
    step = make_order_step(
        remap(compiled.atom_a), remap(compiled.atom_b), compiled.bond_type,
        compiled.molecule, compiled.n_types, compiled.n_molecules,
        handle_pbc=True, with_leaflets=False, normal_mode="static",
        geom_spec=geom_spec)

    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    idx = traj.select_frames(None, None, 1)[:batch]
    group_of, n_groups, vgidx = _wire_groups(system, space)
    n, n_out = len(idx), space.n_out
    esc_cap = 8192
    ba, bb = remap(compiled.atom_a), remap(compiled.atom_b)
    bpk = np.zeros((n, b7_stride(len(ba))), np.uint8)
    beg = np.zeros((n, esc_cap), np.uint16)
    bev = np.zeros((n, esc_cap), np.int16)
    bres, _ = traj.read_frames_b7(idx, space, ba, bb, bpk, beg, bev)
    staged_b7 = staged = coords_dev = scale_dev = None
    if bres is not None:
        base, inv_prec, boxes, _, _ = bres
        geo = np.zeros((n, geo_stride(len(ba))), np.uint8)
        ok = traj.read_geo_mask(idx, space, ba, bb, geom_spec, 2, None,
                                remap(geom_payload), geo)
        assert ok
        staged_b7 = tuple(jax.device_put(a)
                          for a in (bpk, beg, bev, base, geo))
        scale_dev = jax.device_put(np.asarray(inv_prec, np.float32))
        print("# aa-geometry device-resident wire: b7geo", file=sys.stderr)
    else:
        pk = np.zeros((n, s6_stride(n_out)), np.uint8)
        eg = np.zeros((n, esc_cap), np.uint16)
        ev = np.zeros((n, esc_cap), np.int16)
        gm = np.zeros((n, (n_groups + 1) * 3), np.int16)
        res, _ = traj.read_frames_s6(idx, space, group_of, n_groups,
                                     pk, eg, ev, gm)
        if res is not None:
            base, inv_prec, boxes, _, _ = res
            staged = tuple(jax.device_put(a)
                           for a in (pk, eg, ev, base, gm,
                                     vgidx.astype(np.int32)))
            scale_dev = jax.device_put(np.asarray(inv_prec, np.float32))
        else:
            coords, boxes, _, _ = traj.read_frames(idx, space)
            coords_dev = jax.device_put(coords)
    box_dev = jax.device_put(boxes[:, [0, 1, 2], [0, 1, 2]].copy())
    normal_dev = jax.device_put(np.array([0, 0, 1], np.float32))
    mask_dev = jax.device_put(np.ones(n, bool))
    jax.block_until_ready([box_dev, normal_dev, mask_dev])

    frame_args = (box_dev, normal_dev, mask_dev)
    if staged_b7 is not None:
        def one(carry, a):
            w, scale, (box, normal, mask) = a
            pk_d, eg_d, ev_d, base_d, geo_d = bench.perturb_base(w, carry)
            dq = _b7_impl(pk_d, eg_d, ev_d, base_d)
            shifts = jnp.arange(8, dtype=jnp.uint8)
            bits = ((geo_d[:, :, None] >> shifts[None, None, :])
                    & jnp.uint8(1)).reshape(n, -1)[:, :len(ba)] \
                .astype(jnp.float32)
            return step.impl(dq, box, normal, mask, inv_scale=scale + carry,
                             geom_plane=bits, diff_input=True)

        args = (staged_b7, scale_dev, frame_args)
    elif staged is not None:
        def one(carry, a):
            w, scale, (box, normal, mask) = a
            c = _s6_impl(*bench.perturb_base(w, carry), scale + carry)
            return step.impl(c, box, normal, mask, geom_ref=geom_dev)

        args = (staged, scale_dev, frame_args)
    else:
        def one(carry, a):
            coords, (box, normal, mask) = a
            return step.impl(coords + carry, box, normal, mask,
                             geom_ref=geom_dev)

        args = (coords_dev, frame_args)
    return bench.time_scan(one, args, n, iters=iters)


def run_device_resident(mode):
    """Device-resident compute throughput for the CG / UA / AA-leaflets /
    AA-geometry modes (bench.py measures the AA headline)."""
    device = bench.require_gpu()
    analysis = _make_analysis(mode)
    baseline = {"cg": CG_BASELINE_8T, "ua": UA_BASELINE_8T,
                "aa-leaflets": AA_LEAFLETS_BASELINE_8T,
                "aa-geometry": AA_GEOMETRY_BASELINE_8T}[mode]
    rates = {}
    for batch in (256, 512):
        if mode == "cg":
            probe = bench.measure_wire_bytes(analysis)
            r = bench.measure_device_resident(probe, batch=batch)
        elif mode == "aa-leaflets":
            r = _measure_device_resident_aa_leaflets(analysis, batch=batch)
        elif mode == "aa-geometry":
            r = _measure_device_resident_aa_geometry(analysis, batch=batch)
        else:
            r = _measure_device_resident_ua(analysis, batch=batch)
        print(f"# {mode} device-resident @ batch {batch}: {r:.0f} frames/s "
              "(wire payload staged, no decode/transfer)", file=sys.stderr)
        rates[str(batch)] = r
    best = max(rates.values())
    print(json.dumps({
        "metric": f"{mode.upper()} device-resident compute (wire payload "
                  "pre-staged, production per-batch program)",
        "value": best,
        "unit": "frames/s",
        "per_batch": rates,
        "vs_baseline_8T": best / baseline,
        "device": device,
    }))


def main():
    cmd = sys.argv[1] if len(sys.argv) > 1 else "synth"
    if cmd == "synth":
        synth_cg()
        synth_ua()
        print("synthesized CG + UA benchmark inputs")
    elif cmd in ("cg", "ua", "ua-palmitoyl") or cmd in AA_MODES:
        run_mode(cmd)
    elif cmd in ("cg-dr", "ua-dr", "aa-leaflets-dr", "aa-geometry-dr"):
        run_device_resident(cmd[:-3])
    else:
        raise SystemExit(
            f"unknown mode {cmd!r} (use synth|cg|ua|ua-palmitoyl|"
            + "|".join(AA_MODES)
            + "|cg-dr|ua-dr|aa-leaflets-dr|aa-geometry-dr)")


if __name__ == "__main__":
    main()
