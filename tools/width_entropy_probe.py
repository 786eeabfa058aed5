#!/usr/bin/env python3
"""Measure the byte-savings potential of per-value width coding for the
bond-difference wire (vs the uniform 7-bit b7 format).

For each bond value (bond × axis) the residual vs the per-batch median
base has its own variance (rigid ring C-H vs chain-end methyl). A
per-value fixed width k_j chosen once per batch costs
    k_j bits × B frames  +  32 bits × (#frames where |r| escapes k_j)
and stays device-decodable because the bit offsets are a static prefix
sum. This probe reports the total bytes/frame of the optimal per-value
width assignment against uniform b7, on the synthesized benchmark
trajectory (same data bench.py ships).

Usage: python tools/width_entropy_probe.py [n_frames]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

from gorder_tpu.io.traj import AtomSubset, Trajectory


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    cache = os.environ.get(
        "GORDER_BENCH_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".bench_cache"))
    path = os.path.join(cache, "bench_10000.xtc")
    bnd = os.path.join(cache, "bench.bnd")
    if not (os.path.exists(path) and os.path.exists(bnd)):
        sys.exit("run bench.py first to synthesize the cache")

    # bond list: parse the .bnd (index pairs, 1-based)
    pairs = []
    with open(bnd) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln or ln.startswith(("#", "[")):
                continue
            a, b = ln.split()[:2]
            pairs.append((int(a) - 1, int(b) - 1))
    pairs = np.asarray(pairs, np.int32)
    first_n = int(pairs.max()) + 1

    traj = Trajectory(path)
    idx = traj.select_frames(None, None, 1)[:n_frames]
    sub = AtomSubset.prefix(first_n)
    q = traj.read_frames_quantized(idx, sub, n_threads=1)[0]  # (B,N,3) i16
    q = q.astype(np.int32)
    B = q.shape[0]

    # C-H bonds only (the b7 wire ships exactly the analyzed bonds); the
    # .bnd in the bench cache is already just the analyzed set
    d = q[:, pairs[:, 1], :] - q[:, pairs[:, 0], :]     # (B, nb, 3)
    d = d.reshape(B, -1)                                 # (B, nv)
    base = np.median(d, axis=0).astype(np.int32)
    r = d - base[None, :]

    nv = r.shape[1]
    print(f"{B} frames, {pairs.shape[0]} bonds, {nv} values/frame")
    absr = np.abs(r)
    print("|r| p50/p90/p99/max:",
          np.percentile(absr, [50, 90, 99]).round(1), absr.max())

    # uniform-k cost (bits/frame), escapes at 32 bits
    tot = B * nv
    for k in range(4, 9):
        esc = (absr >= (1 << (k - 1))).sum()
        bits = k * tot + 32 * esc
        print(f"uniform b{k}: esc {esc / tot:8.4%}  "
              f"{bits / B / 8 / 1024:7.2f} KB/frame")

    # per-value optimal k in {3..8}
    ks = np.arange(3, 9)
    # escapes per value per k: (nv, len(ks))
    esc_counts = np.stack([(absr >= (1 << (k - 1))).sum(axis=0)
                           for k in ks], axis=1)
    costs = ks[None, :] * B + 32 * esc_counts           # bits per value
    best = costs.argmin(axis=1)
    best_bits = costs[np.arange(nv), best].sum()
    width_hist = np.bincount(ks[best], minlength=9)
    print("per-value widths histogram (k: count):",
          {int(k): int(c) for k, c in enumerate(width_hist) if c})
    # width table ships once per batch: 4 bits/value (k in 3..8 fits), plus
    # the base (int32/value) exactly as b7 already ships it
    table_bits = 4 * nv
    print(f"per-value optimal: {best_bits / B / 8 / 1024:7.2f} KB/frame "
          f"(+ width table {table_bits / 8 / 1024:.2f} KB amortized over "
          f"the batch = {table_bits / B / 8 / 1024:.3f} KB/frame)")
    esc_rate = esc_counts[np.arange(nv), best].sum() / tot
    print(f"per-value optimal escape rate: {esc_rate:.4%}")
    # entropy floor for reference
    hist = np.bincount((r - r.min()).ravel())
    p = hist[hist > 0] / r.size
    H = float(-(p * np.log2(p)).sum())
    print(f"global residual entropy: {H:.2f} bits "
          f"-> floor {H * nv / 8 / 1024:.2f} KB/frame")


if __name__ == "__main__":
    main()
