// Flat NeRF field backward (recompute VJP) for Hopper (sm_90a), plain C
// interface.
//
// Replaces tinynerf/kernels/mlp_kernel.py::_fused_backward / _bwd_kernel
// (+ _bwd_core, _trunk_bwd), the TPU kernel behind the custom VJP of
// field_pallas: the backward of the flat forward (field_flat_fwd.cu) at R
// independent rows of (point, direction). Given the points and dirs (R, 3)
// and the four (R,) cotangents of (sigma, r, g, b), it recomputes the
// field forward and returns d_points and d_dirs (R, 3), each row's own, and
// the gradients of all 24 weights and biases summed over the rows, all
// float32. Under CONTRACT every fine sample of a training step goes through
// it: the contraction warps the points outside the kernel, so the renderer
// calls the point interface.
//
// Precision (field_common.cuh, the precision note): as the TPU kernel's
// _bwd_core, the bf16 form rounds every pre-activation gradient to bf16,
// the heads' too (sigma's g * sign(pre), color's g * c * (1 - c)); this is
// where it differs from kernel 2, whose heads' gradients stay float32. The
// encoding's gradients, d_points, d_dirs and the weight gradients are
// float32.
//
// What bounds it: FLOPs. A row costs 3x the forward's 1,182,976 FLOP
// (recompute, input gradients, weight gradients).
//
// Design: kernel 2's device code and launch sequence (field_bwd_common.cuh;
// its design note is in field_rays_bwd.cu) read through RowCoord with one
// sample a "ray": the weights' transpose (fp32) or bf16 packing, the
// recompute + input-gradient launch over 128-row (fp32) or 64-row (bf16)
// tiles, the weight-gradient launch over fixed row slices and the ordered
// reduce, per chunk of CHUNK_ROWS rows. Each row's d_points and d_dirs are
// written as they are; there is no d_ts and no per-ray sum. No atomics: a
// call is deterministic.

#include "field_bwd_common.cuh"

extern "C" {

// Bytes of dynamic shared memory one block of the recompute kernel takes.
int field_flat_bwd_smem_bytes() { return (int)sizeof(Smem); }

// Float32 elements of workspace field_flat_bwd needs for n_rows rows.
long long field_flat_bwd_workspace_floats(int n_rows) {
  return field_bwd_workspace_floats(n_rows, 1);
}

// points, dirs, d_points, d_dirs: (n_rows, 3); the cotangents g_*:
// (n_rows,); grads: the 593,924 gradients of the weights and biases in
// kernel 2's order (field_rays_bwd.cu); workspace:
// field_flat_bwd_workspace_floats(n_rows) floats. All float32, contiguous,
// 16-byte aligned, on the current device. params: as for field_rays_fwd.
// bf16: nonzero for the bf16 form. Launches on `stream` and returns the
// first launch error, or 0.
int field_flat_bwd(const float* points, const float* dirs, const float* g_sigma,
                   const float* g_r, const float* g_g, const float* g_b,
                   const void* const* params, float* d_points, float* d_dirs,
                   float* grads, float* workspace, int n_rows, int bf16,
                   void* stream) {
  return field_bwd_launch(RowCoord{points, dirs}, g_sigma, g_r, g_g, g_b,
                          unpack_params(params), d_points, d_dirs, nullptr, grads,
                          workspace, n_rows, 1, bf16 != 0, false,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
