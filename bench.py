#!/usr/bin/env python3
"""Headline benchmark: atomistic order parameters for a 256-lipid
CHARMM-like membrane (64.5k atoms), 10,000 XTC frames, both chains —
the reference's main published benchmark (BASELINE.md: gorder v1.4 does
this in 15.58 s on 1 thread / 5.78 s on 8 threads of an i7-11700;
extrapolated 32-thread rate ≈ 5,000 frames/s, which is the baseline here).

The validation trajectories are not shipped with the reference, so the
benchmark synthesizes an equivalent system (same atom counts, realistic
spatial layout so XTC compression behaves like production data), writes it
once through our own XTC encoder, and then times the complete end-to-end
analysis: compressed-trajectory decode → host-to-device transfer → device
kernels → results.

Needs a GPU: with none, it exits non-zero. Prints ONE JSON line:
{"metric", "value" (frames/s), "unit", "vs_baseline", "device", ...}.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

N_LIPIDS = 256
N_FRAMES = int(os.environ.get("GORDER_BENCH_FRAMES", "10000"))
TOTAL_ATOMS = 64500
BOX = np.array([13.0, 13.0, 11.0], np.float32)
BASELINE_FRAMES_PER_S = 5000.0  # ≈ 32-thread gorder (BASELINE.md)
CACHE = os.environ.get(
    "GORDER_BENCH_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache"))


def build_lipid_template():
    """CHARMM-like POPC: 10 head atoms, 2×16-carbon chains with hydrogens.
    42 C + 82 H + 10 head = 134 atoms per lipid."""
    names, elements = [], []
    bonds = []  # relative index pairs

    def add(name):
        names.append(name)
        return len(names) - 1

    # head group: N, C11..C15, P, O11..O13
    n = add("N")
    c_head = [add(f"C1{i}") for i in range(1, 6)]
    p = add("P")
    o_head = [add(f"O1{i}") for i in range(1, 4)]
    bonds += [(n, c_head[0]), (c_head[0], c_head[1]), (c_head[1], c_head[2]),
              (c_head[2], c_head[3]), (c_head[3], c_head[4]),
              (c_head[2], p), (p, o_head[0]), (p, o_head[1]), (p, o_head[2])]

    # two chains of 16 carbons: CH2 with 2 H, terminal CH3 with 3 H
    # also head carbons get hydrogens (2 each) to mimic CHARMM H counts
    for c in c_head:
        for k in ("A", "B"):
            h = add(f"H{names[c][1:]}{k}")
            bonds.append((c, h))
    for chain, tag in ((1, "2"), (2, "3")):
        prev = c_head[chain + 2]
        for i in range(2, 18):
            c = add(f"C{tag}{i}")
            bonds.append((prev, c))
            prev = c
            n_h = 3 if i == 17 else 2
            for k in ("R", "S", "T")[:n_h]:
                h = add(f"H{i}{k}{tag}")
                bonds.append((c, h))
    return names, bonds


def synthesize_structure(cache_dir):
    """Write bench.gro + bench.bnd (256 lipids first, then water)."""
    from gorder_tpu.io.gro import write_gro
    from gorder_tpu.system import System, canonical_bonds

    lipid_names, lipid_bonds = build_lipid_template()
    per_lipid = len(lipid_names)
    n_lipid_atoms = per_lipid * N_LIPIDS
    n_water = (TOTAL_ATOMS - n_lipid_atoms) // 3

    names, resids, resnames = [], [], []
    bonds = []
    rng = np.random.default_rng(7)
    positions = np.zeros((n_lipid_atoms + n_water * 3, 3), np.float32)

    # Intra-frame spatial adjacency of file-consecutive atoms drives XTC's
    # small-delta run compression (~75% of atoms ride runs in production
    # membrane trajectories) — lay each lipid out as a bonded random walk
    # with realistic ~0.11-0.15 nm steps so the synthetic data compresses
    # and decodes like real data.
    grid = int(np.ceil(np.sqrt(N_LIPIDS / 2)))
    spacing = BOX[0] / grid
    idx = 0
    for m in range(N_LIPIDS):
        leaflet = m % 2
        cell = m // 2
        gx, gy = cell % grid, (cell // grid) % grid
        base = np.array([
            (gx + 0.5) * spacing, (gy + 0.5) * spacing,
            BOX[2] / 2 + (1.0 if leaflet == 0 else -1.0) * 0.4,
        ], np.float32)
        z_dir = 1.0 if leaflet == 0 else -1.0
        walk = base.copy()
        for a, name in enumerate(lipid_names):
            names.append(name)
            resids.append(m + 1)
            resnames.append("POPC")
            step_dir = rng.normal(0, 1, 3).astype(np.float32)
            step_dir[2] += z_dir * 1.2  # bias chains outward along z
            step_dir /= max(np.linalg.norm(step_dir), 1e-6)
            walk = walk + step_dir * (0.125 + 0.03 * rng.random())
            positions[idx] = walk
            idx += 1
        offset = m * per_lipid
        for a, b in lipid_bonds:
            bonds.append((offset + a, offset + b))

    for w in range(n_water):
        base = rng.random(3).astype(np.float32) * BOX
        o_pos = base
        # rigid water geometry (104.5° HOH) so no two atoms nearly coincide
        # — the frame-wide minimum consecutive-atom delta sets the XTC
        # compressor's small-size window
        d1 = rng.normal(0, 1, 3).astype(np.float32)
        d1 /= max(np.linalg.norm(d1), 1e-6)
        helper = rng.normal(0, 1, 3).astype(np.float32)
        perp = np.cross(d1, helper)
        perp /= max(np.linalg.norm(perp), 1e-6)
        d2 = np.cos(np.radians(104.5)) * d1 + np.sin(np.radians(104.5)) * perp
        for name, pos in (("OH2", o_pos), ("H1", o_pos + 0.0957 * d1),
                          ("H2", o_pos + 0.0957 * d2)):
            names.append(name)
            resids.append(N_LIPIDS + w + 1)
            resnames.append("TIP3")
            positions[idx] = pos
            idx += 1
        o = n_lipid_atoms + w * 3
        bonds += [(o, o + 1), (o, o + 2)]

    positions %= BOX

    system = System(
        name="gorder-tpu benchmark membrane",
        atom_names=np.array(names, dtype="U8"),
        resids=np.array(resids, np.int64),
        resnames=np.array(resnames, dtype="U8"),
        serials=np.arange(1, len(names) + 1, dtype=np.int64),
        positions=positions,
        box=np.diag(BOX).astype(np.float32),
    )
    system.bonds = canonical_bonds(np.asarray(bonds, np.int64))

    gro_path = os.path.join(cache_dir, "bench.gro")
    bnd_path = os.path.join(cache_dir, "bench.bnd")
    write_gro(gro_path, system)
    with open(bnd_path, "w") as fh:
        for a, b in system.bonds:
            fh.write(f"{a + 1} {b + 1}\n")
    return gro_path, bnd_path, system


def write_drift_trajectory(path, positions, mol_of_atom, box, frames, rng,
                           chunk=100):
    """Write `frames` frames of gentle Brownian motion to a new XTC file:
    rigid per-molecule drift under weak confinement plus per-atom jitter,
    which diffuses without destroying the intra-molecule adjacency that
    XTC compresses.

    The random numbers are drawn in the order a frame-by-frame loop draws
    them (molecule drift, then atom jitter), so the file depends only on
    the generator's state. The per-frame coordinate arithmetic runs on
    worker threads, and each chunk is written while the next is drawn."""
    from concurrent.futures import ThreadPoolExecutor

    from gorder_tpu.io import native

    n_atoms = positions.shape[0]
    n_mols = int(mol_of_atom.max()) + 1
    m3 = 3 * n_mols
    drift = np.zeros((n_mols, 3), np.float32)
    boxes = np.tile(np.diag(box).astype(np.float32), (chunk, 1, 1))
    workers = max(1, min(8, os.cpu_count() or 1))
    pending = None
    with ThreadPoolExecutor(workers) as pool, \
            ThreadPoolExecutor(1) as writer:
        for first in range(0, frames, chunk):
            n = min(chunk, frames - first)
            z = rng.standard_normal((n, m3 + 3 * n_atoms), dtype=np.float32)
            drifts = np.empty((n, n_mols, 3), np.float32)
            for i in range(n):
                drift += z[i, :m3].reshape(n_mols, 3) * 0.015
                drift *= 0.995  # weak confinement
                drifts[i] = drift
            coords = np.empty((n, n_atoms, 3), np.float32)

            def frame(i, z=z, drifts=drifts, coords=coords):
                jitter = z[i, m3:].reshape(n_atoms, 3) * 0.012
                coords[i] = (positions + drifts[i][mol_of_atom]
                             + jitter) % box

            list(pool.map(frame, range(n)))
            if pending is not None:
                pending.result()
            times = (np.arange(first, first + n) * 10.0).astype(np.float32)
            steps = (np.arange(first, first + n) * 100).astype(np.int32)
            pending = writer.submit(native.xtc_write, path, coords,
                                    boxes[:n], times, steps,
                                    precision=1000.0, append=first > 0)
        if pending is not None:
            pending.result()


def synthesize_trajectory(cache_dir, system):
    """N_FRAMES frames of gentle Brownian motion, encoded with our XTC
    codec (seed 11)."""
    from gorder_tpu.io import native

    xtc_path = os.path.join(cache_dir, f"bench_{N_FRAMES}.xtc")
    if os.path.exists(xtc_path):
        info = native.xtc_scan(xtc_path)
        if len(info["offsets"]) == N_FRAMES:
            return xtc_path
        os.remove(xtc_path)

    t0 = time.perf_counter()
    write_drift_trajectory(xtc_path, system.positions.copy(),
                           np.asarray(system.resids, np.int64) - 1, BOX,
                           N_FRAMES, np.random.default_rng(11))
    sys.stderr.write(
        f"[bench] synthesized {N_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f}s\n")
    return xtc_path


def card_label():
    """The first GPU's name and power limit, as `nvidia-smi` reports them
    (a child process that does not import JAX)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def require_gpu():
    """The device record every result line carries. Raises SystemExit when
    JAX's default backend is not a GPU: a measurement never falls back to
    the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {devices[0].platform} "
            f"({devices[0].device_kind})")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
            "card": card_label()}


def measure_wire_bytes(analysis):
    """Bytes/frame the pipeline will put on the wire for this run (same
    probe the pipeline uses)."""
    from gorder_tpu.analysis import (_build_atom_space, _pick_wire_format,
                                     _prepare_bond_kinds,
                                     _effective_batch_size, _wire_groups,
                                     load_structure)
    from gorder_tpu.io.native import b7_stride, i12_stride, s6_stride
    from gorder_tpu.io.traj import Trajectory

    system = load_structure(analysis)
    kinds, compiled = _prepare_bond_kinds(system, analysis)
    space, remap = _build_atom_space(system, analysis,
                                     [compiled.atom_a, compiled.atom_b])
    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    frame_indices = traj.select_frames(None, None, 1)
    group_of, n_groups, vgidx = _wire_groups(system, space)
    batch = _effective_batch_size()
    bond_slots = (remap(compiled.atom_a), remap(compiled.atom_b))
    wire, cap = _pick_wire_format(traj, frame_indices, space, 1, group_of,
                                  n_groups, batch, bond_slots=bond_slots)
    n_out = space.n_out
    n_bonds = len(bond_slots[0])
    per_frame = {
        "b7": b7_stride(n_bonds) + cap * 4
              + n_bonds * 12 // max(batch, 1),
        "s6": s6_stride(n_out) + (n_groups + 1) * 6 + cap * 4
              + n_out * 12 // max(batch, 1),
        "d8": n_out * 3 + cap * 6,
        "i12": i12_stride(n_out),
        "i16": n_out * 6,
        "f32": n_out * 12,
    }[wire]
    return wire, per_frame, system, compiled, space, remap, group_of, \
        n_groups, vgidx, traj, frame_indices, bond_slots, cap


def time_scan(one, args, n, iters=30, reps=3):
    """Best frames/s of `iters + 1` repetitions of the traced batch body
    `one(carry, args) -> (result, _)` inside ONE compiled program: a
    lax.scan whose carry (eps = 0.0 at run time, opaque to the compiler)
    perturbs each iteration's input, creating a serial data dependency
    that defeats loop-invariant hoisting while adding one elementwise add
    per batch. The staged payload `args` enters as a jit argument, as the
    wire arrays do in production, so the compiler cannot fold it. One
    dispatch and one barrier per repetition keep host dispatch cost out
    of the device time."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def many(eps, args):
        def body(carry, _):
            result, _ = one(carry, args)
            return eps * result["total"][0, 0, 0], None

        carry, _ = lax.scan(body, jnp.float32(0.0), None, length=iters)
        result, _ = one(carry, args)
        return result

    eps0 = jnp.float32(0.0)
    jax.block_until_ready(many(eps0, args))  # warm: compile + first run
    best = 0.0
    for _rep in range(reps):
        t0 = time.perf_counter()
        result = many(eps0, args)
        jax.block_until_ready(result)
        dt = time.perf_counter() - t0
        best = max(best, (iters + 1) * n / dt)
    return best


def perturb_base(wire, carry):
    """The wire tuple with the scan carry (0 at run time) added to its
    integer base (element 3 of the b7 and s6 payloads), so the wire
    decode depends on the carry and cannot be hoisted out of the scan."""
    import jax.numpy as jnp

    return wire[:3] + (wire[3] + carry.astype(jnp.int32),) + wire[4:]


def measure_device_resident(probe, batch=512, iters=30):
    """Device-resident compute throughput: one real batch's wire payload
    staged on the device once, then the production per-batch device path —
    the fused program the pipeline dispatches (wire reconstruction traced
    inline into the P2 kernel, engine/fused.py _build_fused_steps) — timed
    over `iters` repetitions with no decode and no transfer inside the
    window."""
    import jax

    from gorder_tpu.analysis import _b7_impl, _s6_impl
    from gorder_tpu.core.order import make_order_step
    from gorder_tpu.io.native import b7_stride, s6_stride

    (wire, per_frame, system, compiled, space, remap, group_of, n_groups,
     vgidx, traj, frame_indices, bond_slots, wire_cap) = probe

    step = make_order_step(
        remap(compiled.atom_a), remap(compiled.atom_b), compiled.bond_type,
        compiled.molecule, compiled.n_types, compiled.n_molecules,
        handle_pbc=True, with_leaflets=False, normal_mode="static",
        map_spec=None, geom_spec=None)

    n_out = space.n_out
    chunk = frame_indices[:batch]
    n = len(chunk)
    staged_b7 = staged = coords_dev = scale_dev = None
    if wire == "b7":
        esc_cap = max(128, wire_cap)
        pk = np.zeros((n, b7_stride(len(bond_slots[0]))), np.uint8)
        eg = np.zeros((n, esc_cap), np.uint16)
        ev = np.zeros((n, esc_cap), np.int16)
        res, _ = traj.read_frames_b7(chunk, space, bond_slots[0],
                                     bond_slots[1], pk, eg, ev)
        if res is not None:
            base, inv_prec, boxes, _, _ = res
            staged_b7 = tuple(jax.device_put(a) for a in (pk, eg, ev, base))
            scale_dev = jax.device_put(np.asarray(inv_prec, np.float32))
    if staged_b7 is None:
        esc_cap = 4096
        pk = np.zeros((n, s6_stride(n_out)), np.uint8)
        eg = np.zeros((n, esc_cap), np.uint16)
        ev = np.zeros((n, esc_cap), np.int16)
        gm = np.zeros((n, (n_groups + 1) * 3), np.int16)
        res, _ = traj.read_frames_s6(chunk, space, group_of, n_groups,
                                     pk, eg, ev, gm)
        if res is None:  # f32 staging; kernel timing still valid
            coords, boxes, _, _ = traj.read_frames(chunk, space)
            coords_dev = jax.device_put(coords)
        else:
            base, inv_prec, boxes, _, _ = res
            staged = tuple(jax.device_put(a)
                           for a in (pk, eg, ev, base, gm,
                                     vgidx.astype(np.int32)))
            scale_dev = jax.device_put(np.asarray(inv_prec, np.float32))
    box_dev = jax.device_put(boxes[:, [0, 1, 2], [0, 1, 2]].copy())
    normal_dev = jax.device_put(np.array([0, 0, 1], np.float32))
    mask_dev = jax.device_put(np.ones(n, bool))
    jax.block_until_ready([box_dev, normal_dev, mask_dev])

    frame_args = (box_dev, normal_dev, mask_dev)
    if staged_b7 is not None:
        def one(carry, a):
            w, scale, (box, normal, mask) = a
            return step.impl(_b7_impl(*perturb_base(w, carry)), box, normal,
                             mask, inv_scale=scale + carry, diff_input=True)

        args = (staged_b7, scale_dev, frame_args)
    elif staged is not None:
        def one(carry, a):
            w, scale, (box, normal, mask) = a
            return step.impl(_s6_impl(*perturb_base(w, carry), scale + carry),
                             box, normal, mask)

        args = (staged, scale_dev, frame_args)
    else:
        def one(carry, a):
            coords, (box, normal, mask) = a
            return step.impl(coords + carry, box, normal, mask)

        args = (coords_dev, frame_args)
    return time_scan(one, args, n, iters=iters)


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tools", "bench_golden")


class BenchValidationError(AssertionError):
    """The benchmark run's output does not match the pinned golden."""


def validate_output(yaml_path, label, n_frames):
    """Assert the run's YAML against the pinned golden
    (tools/bench_golden/{label}_{n_frames}.yaml, generated once on the
    CPU backend by tools/gen_bench_golden.py — the synthesized inputs
    are seed-deterministic). A corrupted kernel fails the benchmark
    loudly instead of posting a healthy-looking frames/s figure.

    Tolerance: byte equality per line, except values may differ by ONE
    4-dp print quantum on at most a handful of lines — a backend whose
    compiler contracts the per-sample arithmetic differently (FMA) may
    move a sample by one 1e-6 quantum (|Δsum| ≤ n_samples·1e-6 per bond
    type), which can cross a print boundary on long aggregates.
    Structural differences or larger deviations
    raise BenchValidationError. Returns a status string, or None when
    no golden is pinned for this configuration (e.g. a non-default
    GORDER_BENCH_FRAMES)."""
    import re

    golden = os.path.join(GOLDEN_DIR, f"{label}_{n_frames}.yaml")
    if not os.path.exists(golden):
        print(f"# output NOT validated: no pinned golden at {golden}",
              file=sys.stderr)
        return None
    with open(yaml_path) as fh:
        got = [ln for ln in fh.read().splitlines()
               if not ln.startswith("#")]
    with open(golden) as fh:
        want = [ln for ln in fh.read().splitlines()
                if not ln.startswith("#")]
    if len(got) != len(want):
        raise BenchValidationError(
            f"{label}: output has {len(got)} lines, golden has "
            f"{len(want)} ({yaml_path} vs {golden})")
    num = re.compile(r"-?\d+\.\d+")
    n_vals = 0
    n_off = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            n_vals += len(num.findall(w))
            continue
        gv = num.findall(g)
        wv = num.findall(w)
        if len(gv) != len(wv) or num.sub("@", g) != num.sub("@", w):
            raise BenchValidationError(
                f"{label}: structural difference at line {i + 1}: "
                f"{g!r} vs golden {w!r}")
        for a, b in zip(gv, wv):
            n_vals += 1
            d = abs(float(a) - float(b))
            if d == 0.0:
                continue
            if d > 1.0001e-4:
                raise BenchValidationError(
                    f"{label}: value {a} differs from golden {b} by {d:g} "
                    f"at line {i + 1} (tolerance: one 4-dp print quantum)")
            n_off += 1
    # a per-sample contrast is BIASED (FMA contraction rounds one way),
    # so long-aggregate means shift by up to ~1e-6 in a consistent
    # direction: with 4-dp printing that flips up to ~1e-6/1e-4 = O(%)
    # of values by exactly one quantum. The corruption guard is the
    # one-quantum cap above; the count bound catches systematic drift
    # beyond that contrast.
    if n_off > max(8, int(0.10 * n_vals)):
        raise BenchValidationError(
            f"{label}: {n_off} of {n_vals} values off by one print "
            f"quantum — beyond a per-sample rounding contrast")
    status = "exact" if n_off == 0 else f"quantum({n_off}/{n_vals})"
    print(f"# output validated against pinned golden: {status} "
          f"({n_vals} values)", file=sys.stderr)
    return status


def main():
    device = require_gpu()
    os.makedirs(CACHE, exist_ok=True)
    from gorder_tpu.input import Analysis, AnalysisType

    gro_path, bnd_path, system = synthesize_structure(CACHE)
    xtc_path = synthesize_trajectory(CACHE, system)

    analysis = Analysis(
        structure=gro_path,
        bonds=bnd_path,
        trajectory=xtc_path,
        analysis_type=AnalysisType.aaorder(
            "resname POPC and name r'^C'",
            "resname POPC and name r'^H'",
        ),
        output_yaml=os.path.join(CACHE, "bench_order.yaml"),
        silent=True,
        overwrite=True,
    )

    # warm the compile cache on the first 1,024 frames so compilation is
    # not measured (the reference's hyperfine runs also exclude it)
    warm = Analysis(
        structure=gro_path, bonds=bnd_path, trajectory=xtc_path,
        analysis_type=analysis.analysis_type,
        begin=0.0, end=10_230.0, silent=True, overwrite=True,
    )
    warm.run()

    from gorder_tpu.utils.timers import timers
    import gorder_tpu.analysis as _mod

    probe = measure_wire_bytes(analysis)
    trials = int(os.environ.get("GORDER_BENCH_TRIALS", "3"))
    best = None
    for trial in range(trials):
        t0 = time.perf_counter()
        r = analysis.run()
        r.write()
        dt = time.perf_counter() - t0
        # the figure only posts if this run's output matches the golden
        validated = validate_output(
            os.path.join(CACHE, "bench_order.yaml"), "aa", N_FRAMES)
        nf = r.n_analyzed_frames
        wire, wire_bytes = _mod._LAST_WIRE
        xf = timers.get("transfer")
        dec_cpu = timers.get("decode_cpu")
        trial_out = {
            "value": nf / dt,
            "wire_format": wire,
            "wire_KB_frame": wire_bytes / 1024,
            "transfer_MBps": (_mod._LAST_XFER_BYTES / xf / (1 << 20)
                              if xf > 0 else None),
            "decode_cpu_frames_s": nf / dec_cpu if dec_cpu > 0 else None,
            "driver_cpu_s": timers.get("driver_cpu"),
            "output_validated": validated or "no-golden",
        }
        print(f"# trial {trial}: {nf / dt:.1f} frames/s on wire {wire} | "
              f"{timers.summary()}", file=sys.stderr)
        if best is None or trial_out["value"] > best["value"]:
            best = trial_out

    dr_sweep = {}
    for dr_batch in (256, 512):
        rate = measure_device_resident(probe, batch=dr_batch)
        print(f"# device-resident compute @ batch {dr_batch}: {rate:.0f} "
              f"frames/s (wire payload staged, no decode/transfer)",
              file=sys.stderr)
        dr_sweep[str(dr_batch)] = rate

    print(json.dumps({
        "metric": "AA 256-lipid 64.5k-atom order analysis, end-to-end "
                  f"({r.n_analyzed_frames} XTC frames: decode + device "
                  "compute + results)",
        "unit": "frames/s",
        **best,
        "vs_baseline": best["value"] / BASELINE_FRAMES_PER_S,
        "device_resident_frames_s": dr_sweep,
        "device": device,
    }))


if __name__ == "__main__":
    main()
