#!/bin/bash
# Planted faults in the CP grid field kernels (TPU kernels 5 and 6:
# tinynerf_torch/csrc/grid_common.cuh, shared by the forward and the
# recompute backward, and grid_rays_bwd.cu): runs the grid card tests
# (tests/test_torch_kernel_gpu.py, fp32 and bf16) on the tree, then on three
# copies of it, each with one fault, which must fail them: the last k16 step
# of every decoder product on the tensor cores dropped, the write of a
# finished run's lower row skipped in the table gradient's run merging, and
# the ReLU mask dropped from g_h. Needs a CUDA card and nvcc.
# Usage: bash tests/grid_mutants.sh [log dir, default build/mutants]
# Exits 0 when the tree passes and every copy fails.
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd)
LOGS=$(mkdir -p "${1:-$ROOT/build/mutants}" && cd "${1:-$ROOT/build/mutants}" && pwd)
TESTS=(python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q -s -p no:cacheprovider
       -k "grid_kernels_match")
declare -A SRC=(
  [drop_k16_step]=tinynerf_torch/csrc/grid_common.cuh
  [skip_run_flush]=tinynerf_torch/csrc/grid_rays_bwd.cu
  [no_relu_mask]=tinynerf_torch/csrc/grid_rays_bwd.cu
)
declare -A FAULT=(
  [drop_k16_step]='s/for (int ks = 0; ks < nk; ++ks) {/for (int ks = 0; ks + 1 < nk; ++ks) {/'
  [skip_run_flush]='s/^ *col\[(size_t)lo \* F\] = o_lo + a_lo;  \/\/ the finished lower row$//'
  [no_relu_mask]='s/from_f<Act>(T.hp\[r \* S.hp + j\] > 0.f ? rnd<BF16>(g) : 0.f)/from_f<Act>(rnd<BF16>(g))/'
)
cd "$ROOT" && "${TESTS[@]}" > "$LOGS/grid_tree.log" 2>&1
rc=$?
echo "tree: rc $rc, $(tail -1 "$LOGS/grid_tree.log")"
status=$(( rc != 0 ))
for name in drop_k16_step skip_run_flush no_relu_mask; do
  copy=$(mktemp -d)
  cp -r "$ROOT/." "$copy"
  rm -rf "$copy/build" "$copy/chiprun_out"
  src=${SRC[$name]}
  sed -i "${FAULT[$name]}" "$copy/$src"
  changed=$(diff "$ROOT/$src" "$copy/$src" | grep -c '^>')
  (cd "$copy" && "${TESTS[@]}" > "$LOGS/grid_$name.log" 2>&1)
  rc=$?
  echo "$name: $changed line(s) changed in $src, rc $rc, $(tail -1 "$LOGS/grid_$name.log")"
  grep -hE "^(FAILED|PASSED)|passed|failed" "$LOGS/grid_$name.log" | grep -v "^=" | sed 's/^/  /' | head -30
  (( changed == 1 && rc != 0 )) || status=1
  rm -rf "$copy"
done
exit $status
