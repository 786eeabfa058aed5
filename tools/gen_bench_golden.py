#!/usr/bin/env python3
"""Generate the pinned correctness goldens the benchmark harness asserts
against (bench.validate_output; tools/bench_golden/{label}_{frames}.yaml).

Run on the CPU backend so the golden is computed independently of the
accelerator being benchmarked:

    JAX_PLATFORMS=cpu python tools/gen_bench_golden.py [aa cg ua ...]

The synthesized benchmark inputs are seed-deterministic (bench.py seeds 7
and 11; bench_modes seeds 23 and 29), and results are bitwise invariant
to batch size, device count and wire format (docs/PERFORMANCE.md), so a
CPU-computed golden matches a healthy GPU capture up to the print-quantum
contrast that validate_output tolerates. Regenerate after any change to
the per-sample arithmetic, and commit the generated files.
"""

import os
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    modes = sys.argv[1:] or ["aa", "cg", "ua", "ua-palmitoyl",
                             "aa-leaflets", "aa-local-leaflets",
                             "aa-dynamic", "aa-individual-leaflets",
                             "aa-spherical-leaflets",
                             "aa-clustering-leaflets",
                             "aa-fromfile-leaflets", "aa-palmitoyl",
                             "aa-geometry",
                             "aa-leaflets-export", "aa-dynamic-export",
                             "aa-leaflets-every10", "aa-leaflets-once"]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    assert jax.default_backend() == "cpu", jax.default_backend()

    import bench
    import bench_modes

    os.makedirs(bench.GOLDEN_DIR, exist_ok=True)
    for mode in modes:
        t0 = time.perf_counter()
        if mode == "aa":
            from gorder_tpu.input import Analysis, AnalysisType

            os.makedirs(bench.CACHE, exist_ok=True)
            gro, bnd, system = bench.synthesize_structure(bench.CACHE)
            xtc = bench.synthesize_trajectory(bench.CACHE, system)
            out = os.path.join(bench.CACHE, "bench_order.yaml")
            r = Analysis(
                structure=gro, bonds=bnd, trajectory=xtc,
                analysis_type=AnalysisType.aaorder(
                    "resname POPC and name r'^C'",
                    "resname POPC and name r'^H'"),
                output_yaml=out, silent=True, overwrite=True).run()
            r.write()
            n = r.n_analyzed_frames
        else:
            analysis = bench_modes._make_analysis(mode)
            r = analysis.run()
            r.write()
            n = r.n_analyzed_frames
            out = {"cg": os.path.join(bench.CACHE, "cg_bench_order.yaml"),
                   "ua": os.path.join(bench.CACHE, "ua_bench_order.yaml")
                   }.get(mode,
                         os.path.join(bench.CACHE, f"{mode}_order.yaml"))
        dst = os.path.join(bench.GOLDEN_DIR, f"{mode}_{n}.yaml")
        shutil.copyfile(out, dst)
        print(f"[golden] {mode}: {n} frames -> {dst} "
              f"({time.perf_counter() - t0:.1f}s)")


if __name__ == "__main__":
    main()
