#!/usr/bin/env python3
"""GPU smoke test of the order-parameter pipeline.

Drives the main path through the user entry points
(`gorder_tpu.Analysis(...).run().write()`) on seeded synthetic membranes at
the reference benchmark's full size, checks every output against the pinned
goldens in tools/bench_golden, and compares the device numerics with the
CPU backend in the same process.

    python chip_smoke.py          # one GPU: phases device, aa, cg, ua, exact
    python chip_smoke.py --four   # four GPUs: the AA run on a 4-device
                                  # frames mesh against one device

Phases print their details on earlier lines; the last line is one JSON
object, {"ok": true, "device": {"platform", "kind", "count"}}. With no GPU,
or when any phase fails, the script exits non-zero and prints no result
line. Inputs are synthesized into .bench_cache/ (or GORDER_BENCH_CACHE).
"""

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager

HERE = os.path.dirname(os.path.abspath(__file__))
AA_FRAMES = 10000
EXACT_BATCH = 512
SPECTRAL_FRAMES = 64


def log(msg):
    print(msg, flush=True)


@contextmanager
def phase(name):
    log(f"== phase {name}")
    t0 = time.perf_counter()
    yield
    log(f"== phase {name}: passed in {time.perf_counter() - t0:.1f} s")


def device_phase(n_expected):
    """The device record; exits without a GPU (bench.require_gpu) or with
    fewer than `n_expected` of them."""
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import jax

    import bench
    import gorder_tpu  # noqa: F401  (sets the matmul precision)

    device = bench.require_gpu()
    if device["count"] < n_expected:
        raise SystemExit(f"need {n_expected} GPUs, JAX sees "
                         f"{device['count']}")
    log(f"device_kind: {device['kind']}; devices: {device['count']}; "
        f"jax {jax.__version__}; default matmul precision: "
        f"{jax.config.jax_default_matmul_precision}")
    log(f"card: {device['card']}")
    card = device.pop("card")
    return device, card


def aa_analysis(paths, out_yaml):
    from gorder_tpu.input import Analysis, AnalysisType

    gro, bnd, xtc = paths
    return Analysis(
        structure=gro, bonds=bnd, trajectory=xtc,
        analysis_type=AnalysisType.aaorder(
            "resname POPC and name r'^C'", "resname POPC and name r'^H'"),
        output_yaml=out_yaml, silent=True, overwrite=True)


def synth_aa():
    """The headline membrane of bench.py (256 lipids, 64.5k atoms,
    AA_FRAMES frames); returns (paths, seconds)."""
    import bench

    t0 = time.perf_counter()
    gro, bnd, system = bench.synthesize_structure(bench.CACHE)
    xtc = bench.synthesize_trajectory(bench.CACHE, system)
    return (gro, bnd, xtc), time.perf_counter() - t0


def differing_lines(path, label, n_frames):
    """Output lines (headers excluded) that are not byte-identical to the
    pinned golden."""
    import bench

    golden = os.path.join(bench.GOLDEN_DIR, f"{label}_{n_frames}.yaml")
    with open(path) as fh:
        got = [ln for ln in fh.read().splitlines() if not ln.startswith("#")]
    with open(golden) as fh:
        want = [ln for ln in fh.read().splitlines()
                if not ln.startswith("#")]
    return sum(g != w for g, w in zip(got, want)) + abs(len(got) - len(want))


def run_cell(label, make, out_yaml, card):
    """Warm run on the first 1,024 frames (compilation), then the timed
    full run of `make()`; validated against the pinned golden."""
    import bench
    from gorder_tpu import analysis as engine
    from gorder_tpu.utils.timers import timers

    t0 = time.perf_counter()
    warm = make()
    warm.begin, warm.end = 0.0, 10_230.0
    warm.run()
    warm_s = time.perf_counter() - t0
    analysis = make()
    t0 = time.perf_counter()
    results = analysis.run()
    results.write()
    dt = time.perf_counter() - t0
    n = results.n_analyzed_frames
    status = bench.validate_output(out_yaml, label, n)
    if status is None:
        raise SystemExit(f"{label}: no pinned golden for {n} frames")
    wire, wire_bytes = engine._LAST_WIRE
    log(f"{label}: {n} frames, golden check {status}, "
        f"{differing_lines(out_yaml, label, n)} lines not byte-identical")
    log(f"{label}: {n / dt:.1f} frames/s end to end ({dt:.2f} s), wire "
        f"{wire} ({wire_bytes / 1024:.1f} KB/frame), warm-up incl. compile "
        f"{warm_s:.1f} s [{card}]")
    log(f"{label}: timers {timers.summary()} [{card}]")


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def aa_phase(card):
    import bench
    from gorder_tpu.io import native

    t0 = time.perf_counter()
    native.get_lib()
    log(f"aa: native codec build/load {time.perf_counter() - t0:.1f} s "
        f"(set-up) [{card}]")
    os.makedirs(bench.CACHE, exist_ok=True)
    paths, synth_s = synth_aa()
    log(f"aa: synthesized inputs in {synth_s:.1f} s (set-up) [{card}]")
    out = os.path.join(bench.CACHE, "smoke_aa.yaml")
    run_cell("aa", lambda: aa_analysis(paths, out), out, card)
    probe = bench.measure_wire_bytes(aa_analysis(paths, out))
    rate = bench.measure_device_resident(probe, batch=EXACT_BATCH)
    log(f"aa: device-resident fused step at batch {EXACT_BATCH}: "
        f"{rate:.0f} frames/s [{card}]")
    log(f"aa: peak_bytes_in_use {peak_bytes()} [{card}]")
    return paths, probe


def cg_phase(card):
    import bench_modes

    bench_modes.synth_cg()
    out = os.path.join(bench_modes.CACHE, "cg_bench_order.yaml")
    run_cell("cg", lambda: bench_modes._make_analysis("cg"), out, card)


def ua_phase(card):
    import bench_modes

    bench_modes.synth_ua()
    out = os.path.join(bench_modes.CACHE, "ua_bench_order.yaml")
    run_cell("ua", lambda: bench_modes._make_analysis("ua"), out, card)
    rate = bench_modes._measure_device_resident_ua(
        bench_modes._make_analysis("ua"), batch=EXACT_BATCH)
    log(f"ua: device-resident fused step at batch {EXACT_BATCH}: "
        f"{rate:.0f} frames/s [{card}]")


def exact_phase(probe):
    import jax
    import numpy as np

    import bench_modes
    from gorder_tpu.core.clustering import make_spectral_labels
    from gorder_tpu.core.order import (MAX_EXACT_SAMPLES, limb_reduce,
                                       make_order_step, recombine_limbs)
    from gorder_tpu.io import native

    cpu = jax.devices("cpu")[0]
    reduce_jit = jax.jit(limb_reduce)

    # (a) limb reduction: exact integer sums, tolerance 0
    n = MAX_EXACT_SAMPLES
    top = np.full((1, n), 127.0, np.float32)
    got = np.asarray(reduce_jit(top, top, top, np.ones((1, n), np.float32),
                                np.ones((n, 1), np.float32)))
    want = np.array([[[127 * n], [127 * n], [127 * n], [n]]], np.float64)
    if not np.array_equal(got, want):
        raise SystemExit(f"exact(a): ceiling sums {got.ravel()} != "
                         f"{want.ravel()}")
    log(f"exact(a): {n} samples of limb 127 in one type: sums exact "
        f"({int(got[0, 0, 0])})")
    compiled = probe[3]
    types = np.asarray(compiled.bond_type)
    n_types = int(compiled.n_types)
    onehot = np.zeros((len(types), n_types), np.float32)
    onehot[np.arange(len(types)), types] = 1.0
    rng = np.random.default_rng(5)
    limbs = [rng.integers(-127, 128, (EXACT_BATCH, len(types)))
             .astype(np.float32) for _ in range(3)]
    mask = rng.integers(0, 2, (EXACT_BATCH, len(types))).astype(np.float32)
    got = np.asarray(reduce_jit(*limbs, mask, onehot))
    rows = [l * mask for l in limbs] + [mask]
    want = np.stack([r.astype(np.float64) @ onehot.astype(np.float64)
                     for r in rows], axis=1)
    if not np.array_equal(got.astype(np.float64), want):
        bad = int(np.sum(got != want))
        raise SystemExit(f"exact(a): {bad} batch sums differ from numpy")
    log(f"exact(a): batch {EXACT_BATCH} x {len(types)} bonds x {n_types} "
        f"types: all {got.size} sums equal numpy int64 sums")

    # (b) the order step on one AA batch, GPU against CPU
    (_, _, _, compiled, space, remap, _, _, _, traj, frames, _, _) = probe
    chunk = frames[:EXACT_BATCH]
    q, inv, boxes, _, _ = traj.read_frames_quantized(chunk, space)
    box = boxes[:, [0, 1, 2], [0, 1, 2]].copy()
    normal = np.array([0, 0, 1], np.float32)
    mask = np.ones(len(chunk), bool)
    scale = np.asarray(inv, np.float32)

    def order_sums():
        step = make_order_step(
            remap(compiled.atom_a), remap(compiled.atom_b),
            compiled.bond_type, compiled.molecule, compiled.n_types,
            compiled.n_molecules)
        out, _ = step(q, box, normal, mask, inv_scale=scale)
        sums, counts = recombine_limbs(np.asarray(out["total"]))
        return sums.sum(0), counts.sum(0)

    s_gpu, c_gpu = order_sums()
    with jax.default_device(cpu):
        s_cpu, c_cpu = order_sums()
    diff = np.abs(s_gpu - s_cpu)
    if not np.array_equal(c_gpu, c_cpu) or (diff > c_cpu).any():
        raise SystemExit(f"exact(b): GPU and CPU order sums differ beyond "
                         f"one quantum per sample (max {diff.max()})")
    log(f"exact(b): order step on {len(chunk)} frames: max |GPU-CPU| "
        f"{int(diff.max())} quanta per type, {int((diff > 0).sum())} of "
        f"{len(diff)} types differ")

    # (c) spectral-clustering labels, GPU against CPU
    gro, _, xtc = bench_modes.synth_aa_bilayer(frames=SPECTRAL_FRAMES)
    from gorder_tpu.io.gro import read_gro

    heads = np.flatnonzero(read_gro(gro).atom_names == "P")
    info = native.xtc_scan(xtc)
    coords, cboxes, _, _ = native.xtc_decode(xtc, info["offsets"],
                                             int(info["natoms"][0]))
    cbox = cboxes[:, [0, 1, 2], [0, 1, 2]].copy()
    lab_gpu = np.asarray(make_spectral_labels(heads)(coords, cbox))
    with jax.default_device(cpu):
        lab_cpu = np.asarray(make_spectral_labels(heads)(coords, cbox))
    if not np.array_equal(lab_gpu, lab_cpu):
        raise SystemExit(f"exact(c): spectral labels differ in "
                         f"{int((lab_gpu != lab_cpu).sum())} places")
    log(f"exact(c): spectral labels for {len(coords)} frames x "
        f"{len(heads)} heads identical on GPU and CPU")


def four_phase(card):
    """The AA run on a 4-GPU frames mesh and on one device
    (GORDER_TPU_MESH=0) in the same process: byte-identical outputs."""
    import bench

    os.makedirs(bench.CACHE, exist_ok=True)
    paths, synth_s = synth_aa()
    log(f"four: synthesized inputs in {synth_s:.1f} s (set-up)")
    from gorder_tpu.analysis import _effective_batch_size
    from gorder_tpu.parallel import context

    mesh = context.activate(_effective_batch_size())
    context.deactivate()
    size = mesh.devices.size if mesh is not None else 1
    if size != 4:
        raise SystemExit(f"four: the frames mesh would span {size} devices")
    log(f"four: frames mesh over {size} devices, batch "
        f"{_effective_batch_size()}")
    outputs = {}
    for label, mesh in (("mesh4", None), ("single", "0")):
        if mesh is None:
            os.environ.pop("GORDER_TPU_MESH", None)
        else:
            os.environ["GORDER_TPU_MESH"] = mesh
        out = os.path.join(bench.CACHE, f"smoke_four_{label}.yaml")
        run_cell("aa", lambda: aa_analysis(paths, out), out, card)
        with open(out, "rb") as fh:
            outputs[label] = fh.read()
    os.environ.pop("GORDER_TPU_MESH", None)
    if outputs["mesh4"] != outputs["single"]:
        raise SystemExit("four: the 4-GPU mesh output differs from the "
                         "single-GPU output")
    log(f"four: 4-GPU mesh and single-GPU outputs byte-identical "
        f"({len(outputs['single'])} bytes)")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-GPU frames-mesh comparison")
    args = parser.parse_args()
    os.environ.setdefault("GORDER_BENCH_FRAMES", str(AA_FRAMES))

    with phase("device"):
        device, card = device_phase(4 if args.four else 1)
    if args.four:
        with phase("four"):
            four_phase(card)
    else:
        with phase("aa"):
            _, probe = aa_phase(card)
        with phase("cg"):
            cg_phase(card)
        with phase("ua"):
            ua_phase(card)
        with phase("exact"):
            exact_phase(probe)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
