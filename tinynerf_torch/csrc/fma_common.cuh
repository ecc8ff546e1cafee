// The float32 FMA tile of the fp32 forms that stream their weights with
// cp.async, for Hopper (sm_90a): gemm_f32, shared by the 8x256 field's
// recompute backward (field_bwd_common.cuh: kernels 2, 4 and 10) and the
// proposal MLP's kernels (prop_common.cuh: kernels 7 and 8). No tensor core
// and no TF32: every product is a float32 FMA.
//
// A block of NT threads takes 8 NT / CW rows in groups of CW threads (CW =
// 32, a warp, or 16): group t / CW owns rows 8 (t / CW) .. +7 (ROWS), and
// thread t % CW of it an 8-row x NC-column register tile of a product CW
// NC wide, its columns in groups of V adjacent ones (col_of), so that a
// group is one shared-memory read of a weight row (16 bytes at V = 4).

#pragma once

#include "field_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int BT_M = 128;            // rows a tile of the 512-thread fp32 kernels
constexpr int BT_THREADS = 512;      // their 16 warps, 8 rows (ROWS) each
constexpr int BWD_KT = 16;           // weight rows a gemm_f32 K-tile stage
constexpr int BWD_STAGES = 2;
static_assert(BWD_KT % 4 == 0 && BWD_STAGES >= 2, "16-byte K steps, a tile in flight");

// V, the adjacent columns of a thread's group: 4 where NC allows, else 2 or 1.
template <int NC>
__host__ __device__ constexpr int vec_of() {
  return NC % 4 == 0 ? 4 : NC % 2 == 0 ? 2 : 1;
}

// The thread's column j of a product CW NC wide: (j / V) CW V + V (t % CW)
// + j % V.
template <int NC, int CW = 32>
__device__ __forceinline__ int col_of(int j) {
  constexpr int V = vec_of<NC>();
  return (j / V) * (CW * V) + V * (threadIdx.x % CW) + j % V;
}

// x[0 .. V-1] = p[0 .. V-1] in one access (p aligned to 4 V bytes).
template <int V>
__device__ __forceinline__ void load_v(float* x, const float* p) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// p[0 .. V-1] = x[0 .. V-1] in one access (p aligned to 4 V bytes).
template <int V>
__device__ __forceinline__ void store_v(float* p, const float* x) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *p = x[0];
}

// acc[i][j] += sum_k src[row_i][k] w[k][col_j] over the K rows of w ((K, CW
// NC) row-major in global memory, 16-byte aligned; src rows 16-byte
// aligned), with NT threads in groups of CW. The weights stream through
// BWD_STAGES BWD_KT-row K-tile stages of wt by cp.async, the next tile in
// flight while this one is multiplied; rows of a last tile past K are
// zero-filled, and
// the src columns read with them (up to K rounded up to BWD_KT) must hold
// finite values, so that they add exact zeros. k ascends, one FMA a term.
// Groups whose rows all lie at or past `valid` skip the FMAs. Ends with a
// barrier, so the caller may overwrite src.
template <int NC, int NT = BT_THREADS, int CW = 32>
__device__ __forceinline__ void gemm_f32(float (&acc)[ROWS][NC], const float* src,
                                         int src_stride, int K, const float* __restrict__ w,
                                         float* wt, int valid) {
  constexpr int OUT = CW * NC, V = vec_of<NC>(), STAGE = BWD_KT * OUT;
  constexpr int CHUNKS = STAGE / 4, PER = (CHUNKS + NT - 1) / NT;
  const int lane = threadIdx.x % CW, row0 = (threadIdx.x / CW) * ROWS;
  const int tiles = (K + BWD_KT - 1) / BWD_KT;
  // K-tile t to stage t % BWD_STAGES, one commit group a tile (an empty
  // group past the last tile, so that the waits count alike)
  auto load = [&](int t) {
    if (t < tiles) {
      float* s = wt + (t % BWD_STAGES) * STAGE;
#pragma unroll
      for (int it = 0; it < PER; ++it) {
        const int i = threadIdx.x + it * NT;
        if (CHUNKS % NT == 0 || i < CHUNKS) {
          const int k = t * BWD_KT + i / (OUT / 4);
          cp_async16(s + 4 * i, w + (size_t)min(k, K - 1) * OUT + 4 * (i % (OUT / 4)), k < K);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t + 1 < BWD_STAGES; ++t) load(t);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<BWD_STAGES - 2>();
    __syncthreads();  // tile t is in, and every thread is done with tile t - 1
    load(t + BWD_STAGES - 1);
    if (row0 >= valid) continue;
    const float* s = wt + (t % BWD_STAGES) * STAGE + V * lane;
    const float* a_row = src + row0 * src_stride + t * BWD_KT;
#pragma unroll 1
    for (int kk = 0; kk < BWD_KT; kk += 4) {  // not unrolled: fewer live registers
      float a[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) load_v<4>(a[i], a_row + i * src_stride + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[NC];
#pragma unroll
        for (int g = 0; g < NC / V; ++g) load_v<V>(b + g * V, s + (kk + q) * OUT + g * CW * V);
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i][q], b[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
}

}  // namespace
