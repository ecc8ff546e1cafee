#!/bin/bash
# Planted faults in the flat field's backward kernel (TPU kernel 4,
# tinynerf_torch/csrc/field_flat_bwd.cu, whose device code is kernel 2's in
# tinynerf_torch/csrc/field_bwd_common.cuh read through RowCoord): runs the
# kernel-4 card tests (tests/test_torch_kernel_gpu.py -k flat_bwd) on the
# tree, then on three copies of it, each with one fault in that device code,
# which must fail them: d_dirs dropped (in the bf16 form's kernel),
# sign(sigma_pre) dropped from the sigma head's gradient (in the fp32
# form's), and the layer-4 skip's share of the point encoding's gradient
# dropped (fp32). The two forms repeat the first two lines, so a sed address
# range (before or from the bf16 kernel's definition) anchors each fault to
# one site. Needs a CUDA card and nvcc.
# Usage: bash tests/flat_bwd_mutants.sh [log dir, default build/mutants]
# Exits 0 when the tree passes and every copy fails.
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd)
LOGS=$(mkdir -p "${1:-$ROOT/build/mutants}" && cd "${1:-$ROOT/build/mutants}" && pwd)
SRC=tinynerf_torch/csrc/field_bwd_common.cuh
TESTS=(python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q -s
       -p no:cacheprovider -k flat_bwd)
declare -A FAULT=(
  [no_d_dirs]='/^field_bwd_tc_kernel(/,$ s/d_d\[3 \* (size_t)base + idx\] = (&s.ddir\[0\]\[0\])\[idx\];/d_d[3 * (size_t)base + idx] = 0.f;/'
  [no_sign]='1,/^field_bwd_tc_kernel(/ s/const float sgn = pre > 0.f ? 1.f : (pre < 0.f ? -1.f : 0.f);/const float sgn = 1.f;/'
  [no_skip_encoding_grad]='s/s.act\[r\]\[c\] = g4 + acc2\[i\]\[j\];/s.act[r][c] = acc2[i][j];/'
)
cd "$ROOT" && "${TESTS[@]}" > "$LOGS/flat_tree.log" 2>&1
rc=$?
echo "tree: rc $rc, $(tail -1 "$LOGS/flat_tree.log")"
status=$(( rc != 0 ))
for name in no_d_dirs no_sign no_skip_encoding_grad; do
  copy=$(mktemp -d)
  cp -r "$ROOT/." "$copy"
  rm -rf "$copy/build"
  sed -i "${FAULT[$name]}" "$copy/$SRC"
  changed=$(diff "$ROOT/$SRC" "$copy/$SRC" | grep -c '^>')
  (cd "$copy" && "${TESTS[@]}" > "$LOGS/$name.log" 2>&1)
  rc=$?
  echo "$name: $changed line(s) changed, rc $rc, $(tail -1 "$LOGS/$name.log")"
  grep -hoE "flat bwd (fp32|bf16) R=[0-9]+: .*" "$LOGS/$name.log" | sed 's/^/  /'
  (( changed == 1 && rc != 0 )) || status=1
  rm -rf "$copy"
done
exit $status
