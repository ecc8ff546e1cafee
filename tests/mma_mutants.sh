#!/bin/bash
# Planted faults in the field kernels' tensor-core tiles (the bf16 forms of
# TPU kernels 1-4: tinynerf_torch/csrc/field_tc.cuh, shared by the forward
# kernels, and the backward's device code in field_bwd_common.cuh): runs
# the bf16 card tests of kernels 1-4 (tests/test_torch_kernel_gpu.py) on
# the tree, then on three copies of it, each with one fault, which must
# fail them: the second k16 step of every K-tile's products dropped, the
# two B-fragment registers of an mma swapped, and the ReLU mask dropped
# from the backward's gradient store. Needs a CUDA card and nvcc.
# Usage: bash tests/mma_mutants.sh [log dir, default build/mutants]
# Exits 0 when the tree passes and every copy fails.
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd)
LOGS=$(mkdir -p "${1:-$ROOT/build/mutants}" && cd "${1:-$ROOT/build/mutants}" && pwd)
TESTS=(python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q -s -p no:cacheprovider
       -k "bf16 and not grid and not prop and not fused")
declare -A SRC=(
  [drop_k16_step]=tinynerf_torch/csrc/mma_common.cuh
  [swap_b_fragment]=tinynerf_torch/csrc/field_tc.cuh
  [no_relu_mask]=tinynerf_torch/csrc/field_bwd_common.cuh
)
declare -A FAULT=(
  [drop_k16_step]='s/^  mma_bf16(t, a1, b10, b11);$//'
  [swap_b_fragment]='s/mma_bf16_k32(acc\[mi\]\[2 \* nj\], af\[0\]\[mi\], b\[0\]\[0\], b\[0\]\[1\],/mma_bf16_k32(acc[mi][2 * nj], af[0][mi], b[0][1], b[0][0],/'
  [no_relu_mask]='s/if (mask != nullptr) {/if (false) {/'
)
cd "$ROOT" && "${TESTS[@]}" > "$LOGS/mma_tree.log" 2>&1
rc=$?
echo "tree: rc $rc, $(tail -1 "$LOGS/mma_tree.log")"
status=$(( rc != 0 ))
for name in drop_k16_step swap_b_fragment no_relu_mask; do
  copy=$(mktemp -d)
  cp -r "$ROOT/." "$copy"
  rm -rf "$copy/build"
  src=${SRC[$name]}
  sed -i "${FAULT[$name]}" "$copy/$src"
  changed=$(diff "$ROOT/$src" "$copy/$src" | grep -c '^>')
  (cd "$copy" && "${TESTS[@]}" > "$LOGS/$name.log" 2>&1)
  rc=$?
  echo "$name: $changed line(s) changed in $src, rc $rc, $(tail -1 "$LOGS/$name.log")"
  grep -hE "^(FAILED|PASSED)|passed|failed" "$LOGS/$name.log" | grep -v "^=" | sed 's/^/  /' | head -20
  (( changed == 1 && rc != 0 )) || status=1
  rm -rf "$copy"
done
exit $status
