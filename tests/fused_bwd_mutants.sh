#!/bin/bash
# Planted faults in the fused renderer's backward kernel (TPU kernel 10,
# tinynerf_torch/csrc/render_fused_bwd.cu): runs the fused card tests
# (tests/test_torch_kernel_gpu.py -k fused) on the tree, then on six copies
# of it, each with one fault in one line, which must fail them: three in the
# resampler's backward (resample_bwd_kernel), three in the merge's
# (merge_bwd_kernel: the suffix sum of -w g_w dropped from g_sd, a fine t's
# g_delta(k_m - 1) term dropped, the white term dropped). Needs a CUDA card
# and nvcc. Usage: bash tests/fused_bwd_mutants.sh [log dir, default
# build/mutants]. Exits 0 when the tree passes and every copy fails.
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd)
LOGS=$(mkdir -p "${1:-$ROOT/build/mutants}" && cd "${1:-$ROOT/build/mutants}" && pwd)
SRC=tinynerf_torch/csrc/render_fused_bwd.cu
TESTS=(python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q -s
       -p no:cacheprovider -k fused)
declare -A FAULT=(
  [no_d_ts]='s/const float g = __fadd_rn(h.gt_fi\[i\], d_ts\[i\]);/const float g = h.gt_fi[i];/'
  [no_slope_derivative]='s/gw = __fadd_rn(gw, -__fmul_rn(__fdiv_rn(dl, __fmul_rn(x, x)), gslope\[n - 1\]));/(void)x;/'
  [no_resampler_backward]='s/const float g = __fadd_rn(h.gt_fi\[i\], d_ts\[i\]);/const float g = 0.f;/'
  [no_suffix_sum]='s/__fmul_rn(__fmul_rn(em\[k\], expf(-sd)), gw\[k\]), rev)/__fmul_rn(__fmul_rn(em[k], expf(-sd)), gw[k]), 0.f)/'
  [no_previous_gdelta]='s/if (k > 0) gt = __fadd_rn(gt, gd\[k - 1\]);/(void)gd;/'
  [no_white_term]='s/const float gsum = white ? __fadd_rn(__fadd_rn(g\[0\], g\[1\]), g\[2\]) : 0.f;/const float gsum = 0.f;/'
)
cd "$ROOT" && "${TESTS[@]}" > "$LOGS/tree.log" 2>&1
rc=$?
echo "tree: rc $rc, $(tail -1 "$LOGS/tree.log")"
status=$(( rc != 0 ))
for name in no_d_ts no_slope_derivative no_resampler_backward no_suffix_sum \
            no_previous_gdelta no_white_term; do
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
