#!/bin/bash
# Sequential GPU capture of the full benchmark table (docs/BENCHMARKS.md).
# Each mode prints one JSON line; everything lands in $OUT (default
# .bench_cache/bench_captures.jsonl) with stderr in $OUT.log.
set -u
cd "$(dirname "$0")/.."
mkdir -p .bench_cache
OUT="${1:-.bench_cache/bench_captures.jsonl}"
: > "$OUT"
: > "$OUT.log"
export GORDER_BENCH_TRIALS="${GORDER_BENCH_TRIALS:-2}"
MODES="${MODES:-aa-leaflets aa-local-leaflets aa-dynamic \
aa-individual-leaflets aa-spherical-leaflets aa-clustering-leaflets \
aa-fromfile-leaflets aa-palmitoyl aa-geometry cg ua ua-palmitoyl \
cg-dr ua-dr aa-leaflets-dr}"
for m in $MODES; do
  echo "=== $m ($(date -u +%H:%M:%S)) ===" >> "$OUT.log"
  timeout 1500 python3 tools/bench_modes.py "$m" \
    >> "$OUT" 2>> "$OUT.log"
  echo "--- $m rc=$? ---" >> "$OUT.log"
done
echo "DONE $(date -u +%H:%M:%S)" >> "$OUT.log"
