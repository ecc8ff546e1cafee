#!/bin/bash
# Planted faults in the fp32 form of the field's recompute backward
# (tinynerf_torch/csrc/field_bwd_common.cuh: kernel 2, and kernels 4 and 10,
# which run its device code): runs the fp32 card cases of kernels 2, 4 and
# 10 (tests/test_torch_kernel_gpu.py) on the tree, then on three copies of
# it, each with one fault, which must fail cases of all three kernels: the
# last K-slab of every weight-gradient tile dropped, the weight partial of
# row slice 1 left unwritten, and the ReLU mask dropped from G. Needs a CUDA
# card and nvcc.
# Usage: bash tests/fp32_bwd_mutants.sh [log dir, default build/mutants]
# Exits 0 when the tree passes and every copy fails each kernel's cases.
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd)
LOGS=$(mkdir -p "${1:-$ROOT/build/mutants}" && cd "${1:-$ROOT/build/mutants}" && pwd)
SRC=tinynerf_torch/csrc/field_bwd_common.cuh
TESTS=(python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q -s -rf -p no:cacheprovider
       -k "test_bwd_kernel_matches or fp32_bwd_tile_edges or (flat_bwd and fp32) or (fused and fp32)")
declare -A FAULT=(
  [drop_last_slab]='s/for (int slab = 0; slab < slabs; ++slab) {/for (int slab = 0; slab + 1 < slabs; ++slab) {/'
  [skip_split_1]='s/if (k >= k_in) continue;/if (k >= k_in || blockIdx.y == 1) continue;/'
  [no_relu_mask]='s/if (mask) {/if (false) {/'
)
# failed cases of kernel $2 in log $1
kernel_fails() {
  local pattern
  case $2 in
    2) pattern='::(test_bwd_kernel_matches_plain_on_card|test_fp32_bwd_tile_edges_on_card\[rays)' ;;
    4) pattern='::(test_flat_bwd_kernel_matches_plain_on_card\[[^]]*fp32|test_fp32_bwd_tile_edges_on_card\[flat)' ;;
    10) pattern='::test_fused_kernels_match_plain_on_card\[fp32' ;;
  esac
  grep -cE "^FAILED [^ ]*$pattern" "$1"
}
cd "$ROOT" && "${TESTS[@]}" > "$LOGS/fp32_bwd_tree.log" 2>&1
rc=$?
echo "tree: rc $rc, $(tail -1 "$LOGS/fp32_bwd_tree.log")"
status=$(( rc != 0 ))
for name in drop_last_slab skip_split_1 no_relu_mask; do
  copy=$(mktemp -d)
  cp -r "$ROOT/." "$copy"
  rm -rf "$copy/build"
  sed -i "${FAULT[$name]}" "$copy/$SRC"
  changed=$(diff "$ROOT/$SRC" "$copy/$SRC" | grep -c '^>')
  log="$LOGS/fp32_bwd_$name.log"
  (cd "$copy" && "${TESTS[@]}" > "$log" 2>&1)
  rc=$?
  k2=$(kernel_fails "$log" 2) k4=$(kernel_fails "$log" 4) k10=$(kernel_fails "$log" 10)
  echo "$name: $changed line(s) changed, rc $rc; failed cases: kernel 2 $k2, kernel 4 $k4," \
       "kernel 10 $k10; $(tail -1 "$log")"
  (( changed == 1 && rc != 0 && k2 > 0 && k4 > 0 && k10 > 0 )) || status=1
  rm -rf "$copy"
done
exit $status
