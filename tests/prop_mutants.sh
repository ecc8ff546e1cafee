#!/bin/bash
# Planted faults in the proposal MLP's backward (TPU kernel 8:
# tinynerf_torch/csrc/prop_rays_bwd.cu): runs the proposal card tests
# (tests/test_torch_kernel_gpu.py -k prop) on the tree, then on six copies of
# it, each with one fault, which must fail them. In the bf16 form on the
# tensor cores: the second k16 step of every weight-gradient product
# dropped, the ReLU mask dropped from the trunk's pre-activation gradients,
# and d_ts left unwritten on the path that computes the rays' gradients (an
# address range anchors it to the bf16 kernel: the fp32 kernel has the same
# line). In the fp32 form: the last row of every tile dropped from the
# weight gradients (wgrad_f32), the ReLU mask dropped (put_grad_f32), and
# d_ts left unwritten (its kernel's address range). Needs a CUDA card and
# nvcc.
# Usage: bash tests/prop_mutants.sh [log dir, default build/mutants]
# Exits 0 when the tree passes and every copy fails.
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd)
LOGS=$(mkdir -p "${1:-$ROOT/build/mutants}" && cd "${1:-$ROOT/build/mutants}" && pwd)
SRC=tinynerf_torch/csrc/prop_rays_bwd.cu
TESTS=(python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q -s -p no:cacheprovider
       -k "prop and not grid")
declare -A FAULT=(
  [drop_wgrad_k16_step]='s/^\( *\)a\[1\], b\[1\]\[nj\]\[0\], b\[1\]\[nj\]\[1\]);$/\1a[0], 0u, 0u);/'
  [no_relu_mask]='s/const uint32_t m = \*at;/const uint32_t m = 0x3f803f80u;/'
  [no_d_ts]='/^prop_rays_bwd_tc_kernel(/,$ s/d_ts\[m\] = v;/(void)v;/'
  [fp32_wgrad_last_row]='s/^      for (int r = 0; r < M; ++r) {$/      for (int r = 0; r < M - 1; ++r) {/'
  [fp32_no_relu_mask]='s/h\[v\] = h\[v\] > 0.f ? acc\[i\]\[g \* V + v\] : 0.f;/h[v] = acc[i][g * V + v];/'
  [fp32_no_d_ts]='/^prop_rays_bwd_kernel(/,/^prop_rays_bwd_tc_kernel(/ s/d_ts\[m\] = v;/(void)v;/'
)
cd "$ROOT" && "${TESTS[@]}" > "$LOGS/prop_tree.log" 2>&1
rc=$?
echo "tree: rc $rc, $(tail -1 "$LOGS/prop_tree.log")"
status=$(( rc != 0 ))
for name in drop_wgrad_k16_step no_relu_mask no_d_ts fp32_wgrad_last_row fp32_no_relu_mask \
    fp32_no_d_ts; do
  copy=$(mktemp -d)
  cp -r "$ROOT/." "$copy"
  rm -rf "$copy/build"
  sed -i "${FAULT[$name]}" "$copy/$SRC"
  changed=$(diff "$ROOT/$SRC" "$copy/$SRC" | grep -c '^>')
  (cd "$copy" && "${TESTS[@]}" > "$LOGS/$name.log" 2>&1)
  rc=$?
  echo "$name: $changed line(s) changed, rc $rc, $(tail -1 "$LOGS/$name.log")"
  grep -hE "^(FAILED|PASSED)|passed|failed" "$LOGS/$name.log" | grep -v "^=" | sed 's/^/  /' | head -20
  (( changed == 1 && rc != 0 )) || status=1
  rm -rf "$copy"
done
exit $status
