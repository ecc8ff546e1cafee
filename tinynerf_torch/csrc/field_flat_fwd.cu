// Flat NeRF field forward for Hopper (sm_90a), plain C interface.
//
// Replaces tinynerf/kernels/mlp_kernel.py::_fused_forward / _fwd_kernel,
// the TPU kernel behind field_pallas: the field at R independent rows of
// (point, direction), as the occupancy grid's refresh probes it (one point
// per cell, direction +z). For each row it computes the float32 positional
// encoding of the point (60) and of the direction (24), the 8x256 skip MLP
// with its heads, and writes out[row] = [r, g, b, sigma], (R, 4) float32.
// It runs in float32 or in the TPU kernel's bf16 form (field_common.cuh,
// the precision note).
//
// What bounds it: FLOPs, as the ray-major forward (field_rays_fwd.cu): a
// row costs 1,182,976 FLOP and moves 40 bytes (point and direction in, four
// floats out).
//
// Design: the ray-major forward's tile machinery unchanged (64-row tiles,
// activations in shared memory, weights streamed from L2; float32 FMA in
// the fp32 form, field_common.cuh's network_fwd; the tensor cores in the
// bf16 form, field_tc.cuh's network_tc), with a row-major encode in place
// of the (ray, sample) expansion. The ragged end of R is masked; nothing is
// padded.

#include "field_tc.cuh"
#include "launch_cache.cuh"

namespace {

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
field_flat_fwd_kernel(const float* __restrict__ points,
                      const float* __restrict__ dirs, Params p,
                      float* __restrict__ out, int total) {
  extern __shared__ float4 smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int base = blockIdx.x * TILE_M;
  field_tile<BF16>(s, p, RowCoord{points, dirs}, base, total,
                   [&](int m, int ch, float v) { out[4 * (size_t)m + ch] = v; });
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes.
int field_flat_fwd_smem_bytes() { return (int)sizeof(FwdSmem); }

// bf16 elements of the `packed` buffer the bf16 form takes.
int field_packed_weights_elems() { return PK_ELEMS; }

// points, dirs: (n_rows, 3); out: (n_rows, 4) = [r, g, b, sigma]; all
// float32, contiguous, on the current device. params: as for
// field_rays_fwd. bf16, packed: as for field_rays_fwd. Launches on `stream`
// and returns the first launch error, or 0.
int field_flat_fwd(const float* points, const float* dirs,
                   const void* const* params, float* out, void* packed, int n_rows,
                   int bf16, void* stream) {
  Params p = unpack_params(params);
  if (n_rows <= 0) return 0;
  if (n_rows > 0x7fffffff - TILE_M) return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (packed == nullptr) return (int)cudaErrorInvalidValue;
    __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(packed);
    p.wb = wb;
    const int e = pack_weights(p, wb, static_cast<cudaStream_t>(stream), false);
    if (e != 0) return e;
  }
  auto kernel = bf16 ? &field_flat_fwd_kernel<true> : &field_flat_fwd_kernel<false>;
  cudaError_t err = launch_cache::allow_smem(kernel, sizeof(FwdSmem));
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + TILE_M - 1) / TILE_M;
  kernel<<<blocks, THREADS, sizeof(FwdSmem), static_cast<cudaStream_t>(stream)>>>(
      points, dirs, p, out, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
