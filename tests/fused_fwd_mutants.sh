#!/bin/bash
# Planted faults in the fused renderer's forward tail (TPU kernel 9,
# tinynerf_torch/csrc/render_common.cuh, which kernel 10's recompute shares):
# runs the fused card tests (tests/test_torch_kernel_gpu.py -k fused) on the
# tree, then on four copies of it, each with a one-line fault, which must
# fail them: a fine sample before a coarse one on a tie, warp_scan's last
# lane dropped, the white-background term of the merged color dropped, the
# resampler's clip of its bin dropped. Needs a CUDA card and nvcc. Usage:
# bash tests/fused_fwd_mutants.sh [log dir, default build/mutants]
# Exits 0 when the tree passes and every copy fails.
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd)
LOGS=$(mkdir -p "${1:-$ROOT/build/mutants}" && cd "${1:-$ROOT/build/mutants}" && pwd)
SRC=tinynerf_torch/csrc/render_common.cuh
TESTS=(python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q -s
       -p no:cacheprovider -k fused)
declare -A FAULT=(
  [fine_first_on_a_tie]='s/  return t_coarse <= t_fine;/  return t_coarse < t_fine;/'
  [scan_last_lane_dropped]='s/const int lo = min(lane \* c, n), hi = min(lo + c, n);/const int lo = min(lane * c, n), hi = lane == 31 ? lo : min(lo + c, n);/'
  [no_white_term]='s/    out\[ch\] = white ? __fadd_rn(c\[ch\], __fsub_rn(1.f, wsum)) : c\[ch\];/    out[ch] = c[ch];/'
  [no_bin_clip]='s/  f.idx = min(max(cnt - 1, 0), nc - 1);/  f.idx = cnt - 1;/'
)
cd "$ROOT" && "${TESTS[@]}" > "$LOGS/tree.log" 2>&1
rc=$?
echo "tree: rc $rc, $(tail -1 "$LOGS/tree.log")"
status=$(( rc != 0 ))
for name in fine_first_on_a_tie scan_last_lane_dropped no_white_term no_bin_clip; do
  copy=$(mktemp -d)
  cp -r "$ROOT/." "$copy"
  sed -i "${FAULT[$name]}" "$copy/$SRC"
  changed=$(diff "$ROOT/$SRC" "$copy/$SRC" | grep -c '^>')
  (cd "$copy" && "${TESTS[@]}" > "$LOGS/$name.log" 2>&1)
  rc=$?
  echo "$name: $changed line(s) changed, rc $rc, $(tail -1 "$LOGS/$name.log")"
  (( changed == 1 && rc != 0 )) || status=1
  rm -rf "$copy"
done
exit $status
