// The field's bf16 form on the tensor cores, shared by the field kernels'
// forwards (field_rays_fwd.cu, field_flat_fwd.cu, the fused renderer's
// render_common.cuh) and their backward (field_bwd_common.cuh).
//
// Every product of the 8x256 MLP (trunk 0-7 with the layer-4 skip,
// point_info, and dir_info over [enc_dir, point_info]; in the backward also
// the input gradients g W^T) is bf16 x bf16 with float32 accumulation on
// mma.sync.m16n8k16 (mma_common.cuh), as the TPU kernel's jnp.dot with
// preferred_element_type=float32. The heads (sigma 256 -> 1, color 128 ->
// 3) and the encoding stay on the float32 path of field_common.cuh, and the
// rounding points are the precision note's there: weights, encodings and
// activations are bf16 values, biases are added in float32 after the sum.
//
// Layout. A block of 4 M threads takes an M-row tile: M = TILE_M = 64 rows
// and 256 threads in the field kernels, M = 128 rows and 512 threads in the
// fused renderer's forward (render_common.cuh), which so streams the
// weights once per 128 rows. Its activations (M x 256) and encodings (M x
// 64 and M x 32, zero-padded so that K is a multiple of 16) live in shared
// memory as bf16, each row padded by 8 elements so that ldmatrix's eight
// row addresses fall in distinct banks. A product's output is split over
// the M / 8 warps as M / 32 (rows) x 4 (columns): warp w owns rows 32 (w %
// (M / 32)) .. +31 and columns (OUT / 4) (w / (M / 32)) .. of it, NT = OUT
// / 32 n8-tiles, so 2 x NT m16n8 accumulators of 4 floats a thread, at
// either M. The weights, packed once a call into
// bf16 (pack_weights), stream from L2 through a double-buffered shared
// K-tile with cp.async, one tile's copy overlapping the previous tile's
// products:
// - the forward (FWD) product act W reads WK = 32 rows of W a tile, and
//   ldmatrix.trans gives the col-major B fragments;
// - the backward's input-gradient product g W^T reads WK = 32 columns of W
//   a tile (all its rows); W's rows are then B^T, which ldmatrix reads
//   without .trans, so no transposed copy of W is made.
// Each K-tile's two k16 steps are summed on the tensor cores from zero and
// added to the accumulator in float32 (mma_bf16_k32), and each forward
// layer's outputs whose bf16 rounding is ambiguous are summed again in the
// plain version's order (the fix-up, below), so that the bf16 form rounds
// where its plain version rounds. That summation is one of two (KSum,
// a template parameter of its own, apart from M): the fused renderer's
// forward instead accumulates the whole K in the tensor core (mma_bf16
// into the accumulator, one barrier a K-tile), as its outputs need only
// meet the bf16 forward bound against the plain version and kernel 10
// recomputes them with the same code; the fix-up needs the k32 pairs.

#pragma once

#include "field_common.cuh"
#include "mma_common.cuh"

namespace {

// How a product sums over K: K32_PAIRS, each K-tile's two k16 steps summed
// on the tensor cores from zero and added to the accumulator in float32,
// two barriers a K-tile (the order the fix-up models); WHOLE_K, every k16
// step into the accumulator on the tensor core, one barrier a K-tile.
enum class KSum { K32_PAIRS, WHOLE_K };

constexpr int ENC_PT_PAD = 64;   // point encoding, 60 columns + 4 zeros
constexpr int ENC_DIR_PAD = 32;  // direction encoding, 24 columns + 8 zeros
constexpr int ACT_LD = WIDTH + 8;
constexpr int ENC_PT_LD = ENC_PT_PAD + 8;
constexpr int ENC_DIR_LD = ENC_DIR_PAD + 8;
constexpr int WK = 32;           // weight rows (FWD) or columns (g W^T) a K-tile
constexpr int FWD_STAGE = WK * (WIDTH + 8);   // bf16 elements of one FWD K-tile
constexpr int BWD_STAGE = WIDTH * (WK + 8);   // ... of one g W^T K-tile

// ---- the packed bf16 weights, each (padded fan_in, fan_out) row-major ----
constexpr int PK_W0 = 0;                                 // trunk_0: 64 x 256
constexpr int PK_HIDDEN = PK_W0 + ENC_PT_PAD * WIDTH;    // trunk i = 1..7, hidden rows
constexpr int PK_4E = PK_HIDDEN + 7 * WIDTH * WIDTH;     // trunk_4's encoding rows: 64 x 256
constexpr int PK_PI = PK_4E + ENC_PT_PAD * WIDTH;        // point_info: 256 x 256
constexpr int PK_DE = PK_PI + WIDTH * WIDTH;             // dir_info's encoding rows: 32 x 128
constexpr int PK_DP = PK_DE + ENC_DIR_PAD * (WIDTH / 2); // dir_info's point_info rows: 256 x 128
constexpr int PK_ELEMS = PK_DP + WIDTH * (WIDTH / 2);    // 593,920
constexpr int N_PACK = 12;
// then each matrix again, transposed ((fan_out, padded fan_in) row-major,
// at PK_ELEMS + its offset), for the fix-up's sums; then, as float32, each
// matrix's column norms (WIDTH a matrix, in pack order: trunk_0, trunk
// 1..7, trunk_4's encoding rows, point_info, dir_info's encoding rows, its
// point_info rows)
constexpr int PK_NORMS = 2 * PK_ELEMS;
constexpr int PK_SCRATCH = PK_NORMS + 2 * N_PACK * WIDTH;  // bf16 elements in all

__host__ __device__ constexpr int pk_hidden(int layer) {  // trunk 1..7
  return PK_HIDDEN + (layer - 1) * WIDTH * WIDTH;
}

// ---- workspace A: each layer's input, bf16 elements a row (the recompute
// backward's scratch, or the residual that kernel 1's saving form keeps)
constexpr int AB_ENC_PT = 0;                          // the point encoding, padded to 64
__host__ __device__ constexpr int ab_hidden(int i) {  // h_i, trunk layer i's output
  return ENC_PT_PAD + i * WIDTH;
}
constexpr int AB_ENC_DIR = ENC_PT_PAD + 8 * WIDTH;    // the direction encoding, padded to 32
constexpr int AB_PI = AB_ENC_DIR + ENC_DIR_PAD;
constexpr int AB_HD = AB_PI + WIDTH;
constexpr int AB_STRIDE = AB_HD + WIDTH / 2;          // 2528

struct Pack {
  const float* src[N_PACK];
  int rows[N_PACK];      // source rows (the fan-in slice)
  int cols[N_PACK];      // fan_out
  int dst[N_PACK];       // offset in the packed buffer
  int dst_rows[N_PACK];  // rows padded with zeros
  bf16* out;
  int transposed;        // also write the transposed copy
};

// out[dst + r * cols + c] = out[PK_ELEMS + dst + c * dst_rows + r] =
// bf16(src[r * cols + c]) (round to nearest even) for r < rows, 0 for rows
// <= r < dst_rows.
__global__ void pack_kernel(Pack pk) {
  const int job = blockIdx.y;
  const int cols = pk.cols[job], n = pk.dst_rows[job] * cols, valid = pk.rows[job] * cols;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const bf16 v = __float2bfloat16_rn(i < valid ? __ldg(pk.src[job] + i) : 0.f);
    pk.out[pk.dst[job] + i] = v;
    if (pk.transposed)
      pk.out[PK_ELEMS + pk.dst[job] + (i % cols) * pk.dst_rows[job] + i / cols] = v;
  }
}

// norms[job * WIDTH + c] = |column c of packed matrix job|, float32: one
// warp a column, read as a row of the transposed copy.
__global__ void wnorm_kernel(Pack pk, float* __restrict__ norms) {
  const int job = blockIdx.y, lane = threadIdx.x & 31;
  const int c = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (c >= pk.cols[job]) return;
  const bf16* col = pk.out + PK_ELEMS + pk.dst[job] + c * pk.dst_rows[job];
  float s = 0.f;
  for (int r = lane; r < pk.dst_rows[job]; r += 32) {
    const float w = __bfloat162float(col[r]);
    s = fmaf(w, w, s);
  }
  s = warp_sum(s);
  if (lane == 0) norms[job * WIDTH + c] = sqrtf(s);
}

// Pack p's weights into `out` (16-byte aligned) on `st`: PK_ELEMS bf16;
// with `fixup` (the forward with the fix-up, forward_fixup_tc),
// PK_SCRATCH: also the transposed copy and the column norms that the
// fix-up reads. Returns the first launch error, or 0.
inline int pack_weights(const Params& p, bf16* out, cudaStream_t st, bool fixup) {
  Pack pk;
  int n = 0;
  auto add = [&](const float* src, int rows, int cols, int dst, int dst_rows) {
    pk.src[n] = src; pk.rows[n] = rows; pk.cols[n] = cols;
    pk.dst[n] = dst; pk.dst_rows[n] = dst_rows; ++n;
  };
  add(p.w[0], PT_ENC, WIDTH, PK_W0, ENC_PT_PAD);
  for (int i = 1; i < 8; ++i) add(p.w[i], WIDTH, WIDTH, pk_hidden(i), WIDTH);
  add(p.w[4] + WIDTH * WIDTH, PT_ENC, WIDTH, PK_4E, ENC_PT_PAD);
  add(p.w[POINT_INFO], WIDTH, WIDTH, PK_PI, WIDTH);
  add(p.w[DIR_INFO], DIR_ENC, WIDTH / 2, PK_DE, ENC_DIR_PAD);
  add(p.w[DIR_INFO] + DIR_ENC * (WIDTH / 2), WIDTH, WIDTH / 2, PK_DP, WIDTH);
  pk.out = out;
  pk.transposed = fixup;
  pack_kernel<<<dim3(32, N_PACK), THREADS, 0, st>>>(pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !fixup) return (int)err;
  wnorm_kernel<<<dim3(WIDTH / (THREADS / 32), N_PACK), THREADS, 0, st>>>(
      pk, reinterpret_cast<float*>(out + PK_NORMS));
  return (int)cudaGetLastError();
}

// Encode rows base .. base+M-1 as encode_tile does (float32 sin/cos), each
// value rounded to bf16, into enc_pt (row stride ENC_PT_LD) and enc_dir
// (ENC_DIR_LD), their pad columns zero, with 4 M threads. Ends with a
// barrier.
template <int M = TILE_M, class Coord>
__device__ __forceinline__ void encode_tile_tc(Coord coord, const float* __restrict__ freqs,
                                               int base, int row_end, bf16* enc_pt,
                                               bf16* enc_dir) {
  for (int idx = threadIdx.x; idx < M * 3 * (L_PT + L_DIR); idx += 4 * M) {
    const int r = idx / (3 * (L_PT + L_DIR));
    const int rem = idx % (3 * (L_PT + L_DIR));
    const int m = base + r;
    const bool is_pt = rem < 3 * L_PT;
    const int L = is_pt ? L_PT : L_DIR;
    const int e = is_pt ? rem : rem - 3 * L_PT;
    const int c = e / L, l = e % L;
    const float x = m < row_end ? coord(m, c, is_pt) : 0.f;
    const float arg = __fmul_rn(x, freqs[is_pt ? l : L_PT + l]);
    bf16* out = is_pt ? enc_pt + r * ENC_PT_LD + c * 2 * L + 2 * l
                      : enc_dir + r * ENC_DIR_LD + c * 2 * L + 2 * l;
    out[0] = __float2bfloat16_rn(sinf(arg));
    out[1] = __float2bfloat16_rn(cosf(arg));
  }
  for (int idx = threadIdx.x; idx < M * (ENC_PT_PAD - PT_ENC); idx += 4 * M)
    enc_pt[(idx / 4) * ENC_PT_LD + PT_ENC + idx % 4] = __float2bfloat16_rn(0.f);
  for (int idx = threadIdx.x; idx < M * (ENC_DIR_PAD - DIR_ENC); idx += 4 * M)
    enc_dir[(idx / 8) * ENC_DIR_LD + DIR_ENC + idx % 8] = __float2bfloat16_rn(0.f);
  __syncthreads();
}

template <int NT>
__device__ __forceinline__ void zero_tc(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;
}

// This thread's accumulator (mi, j, q) of an M-row tile sits at row
// tc_row<M>(mi, q), column tc_col<NT, M>(j, q) of the product.
template <int M = TILE_M>
__device__ __forceinline__ int tc_row(int mi, int q) {
  return ((threadIdx.x >> 5) % (M / 32)) * 32 + mi * 16 + ((threadIdx.x & 31) >> 2) + 8 * (q >> 1);
}

template <int NT, int M = TILE_M>
__device__ __forceinline__ int tc_col(int j, int q) {
  return ((threadIdx.x >> 5) / (M / 32)) * 8 * NT + j * 8 + 2 * (threadIdx.x & 3) + (q & 1);
}

// Copy K-tile t of the weights w (row stride ldw) into wbuf as one cp.async
// group, with 4 M threads: FWD, rows t*WK .. +WK (32 NT wide; shared row
// stride 32 NT + 8); else, columns t*WK .. +WK of its 32 NT rows (shared row
// stride WK + 8).
template <int NT, bool FWD, int M = TILE_M>
__device__ __forceinline__ void load_wtile(bf16* wbuf, const bf16* __restrict__ w, int ldw,
                                           int t) {
  constexpr int OUT = 32 * NT;
  if constexpr (FWD) {
    constexpr int CH = OUT / 8;  // 16-byte chunks a row
    const bf16* src = w + (size_t)t * WK * ldw;
    for (int i = threadIdx.x; i < WK * CH; i += 4 * M)
      cp_async16(wbuf + (i / CH) * (OUT + 8) + (i % CH) * 8,
                 src + (size_t)(i / CH) * ldw + (i % CH) * 8);
  } else {
    constexpr int CH = WK / 8;
    for (int i = threadIdx.x; i < OUT * CH; i += 4 * M)
      cp_async16(wbuf + (i / CH) * (WK + 8) + (i % CH) * 8,
                 w + (size_t)(i / CH) * ldw + t * WK + (i % CH) * 8);
  }
  cp_async_commit();
}

// acc += a[:, k0 .. k0+WK] B_tile, the tile in wt (see load_wtile), its
// two k16 steps summed as KS says.
template <int NT, bool FWD, int M = TILE_M, KSum KS = KSum::K32_PAIRS>
__device__ __forceinline__ void mma_wtile(float (&acc)[2][NT][4], const bf16* a, int lda,
                                          int k0, const bf16* wt) {
  constexpr int OUT = 32 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp % (M / 32)) * 32, n0 = (warp / (M / 32)) * 8 * NT;
  uint32_t af[2][2][4];  // [k16 step][mi]
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(af[s][mi], a + (m0 + mi * 16 + (lane & 15)) * lda + k0 + 16 * s + (lane >> 4) * 8);
  if constexpr (NT == 1) {
    static_assert(!FWD && KS == KSum::K32_PAIRS, "a forward product is at least 64 wide");
    uint32_t b[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
      ldsm_x2(b[s], wt + (n0 + (lane & 7)) * (WK + 8) + 16 * s + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      mma_bf16_k32(acc[mi][0], af[0][mi], b[0][0], b[0][1], af[1][mi], b[1][0], b[1][1]);
  } else {
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      uint32_t b[2][4];  // [k16 step]: n8-tiles 2 nj and 2 nj + 1
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if constexpr (FWD)
          ldsm_x4_trans(b[s], wt + (16 * s + (lane & 7) + ((lane >> 3) & 1) * 8) * (OUT + 8) +
                                  n0 + nj * 16 + (lane >> 4) * 8);
        else
          ldsm_x4(b[s], wt + (n0 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * (WK + 8) +
                            16 * s + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if constexpr (KS == KSum::WHOLE_K) {
          mma_bf16(acc[mi][2 * nj], af[0][mi], b[0][0], b[0][1]);
          mma_bf16(acc[mi][2 * nj], af[1][mi], b[1][0], b[1][1]);
          mma_bf16(acc[mi][2 * nj + 1], af[0][mi], b[0][2], b[0][3]);
          mma_bf16(acc[mi][2 * nj + 1], af[1][mi], b[1][2], b[1][3]);
          continue;
        }
        mma_bf16_k32(acc[mi][2 * nj], af[0][mi], b[0][0], b[0][1], af[1][mi], b[1][0], b[1][1]);
        mma_bf16_k32(acc[mi][2 * nj + 1], af[0][mi], b[0][2], b[0][3], af[1][mi], b[1][2],
                     b[1][3]);
      }
    }
  }
}

// acc[M x 32 NT] += a[M x K] B over K (a multiple of WK), a in shared
// memory (row stride lda). FWD: B = w, (K x 32 NT) with row stride ldw;
// else B = w^T, w (32 NT x K) with row stride ldw. wbuf holds two K-tiles.
// Ends with a barrier, so the caller may overwrite a.
template <int NT, bool FWD, int M = TILE_M, KSum KS = KSum::K32_PAIRS>
__device__ __forceinline__ void gemm_tc(float (&acc)[2][NT][4], const bf16* a, int lda,
                                        int K, const bf16* __restrict__ w, int ldw,
                                        bf16* wbuf) {
  constexpr int STAGE = FWD ? WK * (32 * NT + 8) : 32 * NT * (WK + 8);
  const int n = K / WK;
  if constexpr (KS == KSum::WHOLE_K) {
    // one barrier a K-tile: each step waits for its tile, then starts the
    // copy of the next one into the other buffer, which every thread is
    // done with once past the step's barrier. The probe build
    // FIELD_TC_WEIGHT_PROBE copies only a product's first two K-tiles and
    // runs its later K-tiles' products on them (wrong sums, the same
    // instructions): 176,128 of the 593,920 packed values a pass instead of
    // all, so that its time beside this build's says how long the products
    // wait on the weights' L2 reads (chip_smoke.py; never a path)
    load_wtile<NT, FWD, M>(wbuf, w, ldw, 0);
    for (int t = 0; t < n; ++t) {
      cp_async_wait<0>();
      __syncthreads();  // tile t is in, for every thread, and tile t - 1 is done with
#ifdef FIELD_TC_WEIGHT_PROBE
      if (t + 1 < n && t + 1 < 2)
#else
      if (t + 1 < n)
#endif
        load_wtile<NT, FWD, M>(wbuf + ((t + 1) & 1) * STAGE, w, ldw, t + 1);
      mma_wtile<NT, FWD, M, KS>(acc, a, lda, t * WK, wbuf + (t & 1) * STAGE);
    }
    __syncthreads();  // every thread is done with the tiles and with a
    return;
  }
  load_wtile<NT, FWD, M>(wbuf, w, ldw, 0);
  for (int t = 0; t < n; ++t) {
    if (t + 1 < n) {
      load_wtile<NT, FWD, M>(wbuf + ((t + 1) & 1) * STAGE, w, ldw, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in, for every thread
    mma_wtile<NT, FWD, M>(acc, a, lda, t * WK, wbuf + (t & 1) * STAGE);
    __syncthreads();  // every thread is done with tile t (and, at the end, with a)
  }
}

// act[r][c] = bf16((relu)(acc + bias)), then a barrier.
template <int NT, bool RELU, int M = TILE_M>
__device__ __forceinline__ void store_tc(const float (&acc)[2][NT][4],
                                         const float* __restrict__ bias, bf16* act) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = tc_col<NT, M>(j, 0);
    const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[mi][j][2 * h] + b0, v1 = acc[mi][j][2 * h + 1] + b1;
        if (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(act + tc_row<M>(mi, 2 * h) * ACT_LD + c) =
            pack_bf16x2(v0, v1);
      }
  }
  __syncthreads();
}

__device__ __forceinline__ float bf(const bf16 x) { return __bfloat162float(x); }

// ---- the fix-up: agreeing with a float32 sum where bf16 rounding is close
//
// A product's output is rounded to bf16 (or cut by a ReLU). A float32 sum
// in another order than the plain version's (cuBLAS's, k ascending, one
// FMA a term) differs from it by a few float32 ulps, and where that
// straddles a bf16 rounding boundary (or zero, for a ReLU) the two round
// one bf16 ulp apart; downstream, that moves other pre-activations across
// their ReLU kinks, so that a row's gradient, amplified by the encoding's
// high frequencies, lands percents of max|plain| away (so does an exactly
// summed form of the plain version: chip_smoke.py prints it).
// So the forward that a backward follows (forward_fixup_tc: kernel 1's
// saving form, the recompute backward) lists each layer's outputs whose
// rounding is ambiguous, [v - e, v + e] straddling a boundary with e =
// FIX_TOL |x_r| |w_c| (Cauchy-Schwarz bounds sum_k |x_k w_k| by the row's
// and the column's norms); sums each again in the plain version's order on
// the float32 FMA path, one thread an output, its input row (from the A
// workspace) and weight column (from a transposed copy) staged with
// cp.async; and stores that sum's rounding instead. Outputs past FIX_CAP
// keep the tensor-core sum.
constexpr int FIX_CAP = 1024;
// 4 x 2^-24: a few times cuBLAS's own |float32 sum - exact sum| / (2^-24
// |x| |w|) over the trunk's outputs (chip_smoke.py prints the record)
constexpr float FIX_TOL = 0x1p-22f;

struct FixSmem {
  float xn[3][TILE_M];     // row norms of act, enc_pt, enc_dir
  int wsum[THREADS / 32];  // per-warp counts of ambiguous outputs
  int n;                   // ambiguous outputs of the current layer
  int rc[FIX_CAP];         // their row << 8 | column
};

// One input segment of a forward product: rows x in shared memory (stride
// ldx) times the packed weights at offset `at` (K rows). For the fix-up:
// the rows' norms fx.xn[xn], the weights' column norms (pack job `job`),
// the rows' column a_col in the A workspace.
struct Seg {
  const bf16* x;
  int ldx, at, K, xn, job, a_col;
};

// xn[r] = |row r of x[:, :cols]|, float32; warp w takes rows 8w .. 8w+7.
// No barrier.
__device__ __forceinline__ void row_norms(const bf16* x, int ld, int cols, float* xn) {
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * ROWS;
  for (int i = 0; i < ROWS; ++i) {
    float s = 0.f;
    for (int k = lane; k < cols; k += 32) {
      const float v = bf(x[(row0 + i) * ld + k]);
      s = fmaf(v, v, s);
    }
    s = warp_sum(s);
    if (lane == 0) xn[row0 + i] = sqrtf(s);
  }
}

// The encodings' row norms into fx.xn[1], fx.xn[2]. No barrier.
__device__ __forceinline__ void enc_norms(const bf16* enc_pt, const bf16* enc_dir,
                                          FixSmem& fx) {
  row_norms(enc_pt, ENC_PT_LD, ENC_PT_PAD, fx.xn[1]);
  row_norms(enc_dir, ENC_DIR_LD, ENC_DIR_PAD, fx.xn[2]);
}

// store_tc, also listing the outputs of rows below `valid` whose bf16
// rounding is ambiguous, in thread order (a block-wide scan: the list is
// the same every launch), into fx. Ends with a barrier.
template <int NT, bool RELU, int NSEG>
__device__ __forceinline__ void store_collect(const float (&acc)[2][NT][4],
                                              const float* __restrict__ bias, bf16* act,
                                              const Params& p, Seg s0, Seg s1, FixSmem& fx,
                                              int valid) {
  static_assert(NT <= 8, "a mask word holds 4 NT outputs");
  const float* wn0 = reinterpret_cast<const float*>(p.wb + PK_NORMS) + s0.job * WIDTH;
  const float* wn1 = reinterpret_cast<const float*>(p.wb + PK_NORMS) + s1.job * WIDTH;
  float x0[2][2], x1[2][2];  // FIX_TOL |x_r| of this thread's rows (mi, h), per segment
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x0[mi][h] = FIX_TOL * fx.xn[s0.xn][tc_row(mi, 2 * h)];
      x1[mi][h] = NSEG > 1 ? FIX_TOL * fx.xn[s1.xn][tc_row(mi, 2 * h)] : 0.f;
    }
  uint32_t mask[2] = {0u, 0u};  // bit 4 j + q of mi's word
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = tc_col<NT>(j, 0);
    const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
    const float w00 = __ldg(wn0 + c), w01 = __ldg(wn0 + c + 1);
    const float w10 = NSEG > 1 ? __ldg(wn1 + c) : 0.f, w11 = NSEG > 1 ? __ldg(wn1 + c + 1) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tc_row(mi, 2 * h);
        float v0 = acc[mi][j][2 * h] + b0, v1 = acc[mi][j][2 * h + 1] + b1;
        float e0 = x0[mi][h] * w00, e1 = x0[mi][h] * w01;
        if (NSEG > 1) {
          e0 = fmaf(x1[mi][h], w10, e0);
          e1 = fmaf(x1[mi][h], w11, e1);
        }
        const uint32_t d0 = pack_bf16x2(v0 - e0, v0 + e0), d1 = pack_bf16x2(v1 - e1, v1 + e1);
        // a ReLU output is ambiguous only if v + e > 0 (else both ends are 0)
        if (r < valid && (d0 & 0xffffu) != (d0 >> 16) && (!RELU || v0 + e0 > 0.f))
          mask[mi] |= 1u << (4 * j + 2 * h);
        if (r < valid && (d1 & 0xffffu) != (d1 >> 16) && (!RELU || v1 + e1 > 0.f))
          mask[mi] |= 1u << (4 * j + 2 * h + 1);
        if (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(act + r * ACT_LD + c) = pack_bf16x2(v0, v1);
      }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cnt = __popc(mask[0]) + __popc(mask[1]);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) fx.wsum[warp] = incl;
  __syncthreads();
  int at = incl - cnt;
  for (int w = 0; w < warp; ++w) at += fx.wsum[w];
  if (threadIdx.x == THREADS - 1) fx.n = at + cnt;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    for (uint32_t m = mask[mi]; m; m &= m - 1) {
      const int bit = __ffs(m) - 1;
      if (at < FIX_CAP) fx.rc[at] = tc_row(mi, bit & 3) << 8 | tc_col<NT>(bit >> 2, bit & 3);
      ++at;
    }
  __syncthreads();
}

// For each listed output (r, c): the sum over the segments in order of
// x[r] . w[:, c], k ascending, one float32 FMA a term (the plain version's
// order), plus the bias, (relu), rounded into act[r][c]. In batches: all
// threads copy each listed output's input row (from the tile's saved rows
// a_tile) and weight column (from the transposed weights) into wbuf
// (wbuf_elems bf16, free), then one thread an output sums them. Ends with
// a barrier.
template <bool RELU, int NSEG>
__device__ __forceinline__ void fix_apply(const Params& p, Seg s0, Seg s1,
                                          const float* __restrict__ bias, bf16* act,
                                          const FixSmem& fx, const bf16* a_tile, bf16* wbuf,
                                          int wbuf_elems) {
  const int n = min(fx.n, FIX_CAP);
  const int k0 = s0.K, kc = k0 + (NSEG > 1 ? s1.K : 0), ch = kc / 8;
  const int ld = 2 * kc + 8;  // a slot: input row, weight column; the pad spreads banks
  const int batch = wbuf_elems / ld;
  for (int e0 = 0; e0 < n; e0 += batch) {
    const int nb = min(batch, n - e0);
    for (int i = threadIdx.x; i < nb * 2 * ch; i += THREADS) {
      const int slot = i / (2 * ch), part = i % (2 * ch);
      const int r = fx.rc[e0 + slot] >> 8, c = fx.rc[e0 + slot] & 0xff;
      const bool is_w = part >= ch;
      const int k = (is_w ? part - ch : part) * 8;
      const bool first = k < k0;
      const int kk = first ? k : k - k0;
      const bf16* src =
          is_w ? p.wb + PK_ELEMS + (first ? s0.at + c * s0.K : s1.at + c * s1.K) + kk
               : a_tile + (size_t)r * AB_STRIDE + (first ? s0.a_col : s1.a_col) + kk;
      cp_async16(wbuf + slot * ld + (is_w ? kc : 0) + k, src);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int slot = threadIdx.x; slot < nb; slot += THREADS) {
      const uint4* x = reinterpret_cast<const uint4*>(wbuf + slot * ld);
      const uint4* w = reinterpret_cast<const uint4*>(wbuf + slot * ld + kc);
      float a = 0.f;
#pragma unroll 4
      for (int k8 = 0; k8 < ch; ++k8) {
        const uint4 xv = x[k8], wv = w[k8];
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w}, ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          a = fmaf(__uint_as_float(xw[h] << 16), __uint_as_float(ww[h] << 16), a);
          a = fmaf(__uint_as_float(xw[h] & 0xffff0000u), __uint_as_float(ww[h] & 0xffff0000u),
                   a);
        }
      }
      const int r = fx.rc[e0 + slot] >> 8, c = fx.rc[e0 + slot] & 0xff;
      float v = a + __ldg(bias + c);
      if (RELU) v = fmaxf(v, 0.f);
      act[r * ACT_LD + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
  }
}

// One forward layer into act: bf16((relu)(sum over the NSEG segments of x W
// + bias)) on the tensor cores (the K-tiles in wt, wt_elems bf16). With
// a_tile (forward_fixup_tc, whose layer inputs are saved there), its
// ambiguous outputs are summed again in the plain version's order (the
// fix-up above) and act's row norms are left in fx.xn[0] for the next
// layer. The segments may read act. The fix-up is the 64-row tile's, on
// k32 pairs: other tiles pass no a_tile.
template <int NT, bool RELU, int NSEG, int M = TILE_M, KSum KS = KSum::K32_PAIRS>
__device__ __forceinline__ void layer_tc(const Params& p, Seg s0, Seg s1,
                                         const float* __restrict__ bias, bf16* act, bf16* wt,
                                         int wt_elems, FixSmem& fx, const bf16* a_tile,
                                         int valid) {
  float acc[2][NT][4];
  zero_tc(acc);
  gemm_tc<NT, true, M, KS>(acc, s0.x, s0.ldx, s0.K, p.wb + s0.at, 32 * NT, wt);
  if (NSEG > 1) gemm_tc<NT, true, M, KS>(acc, s1.x, s1.ldx, s1.K, p.wb + s1.at, 32 * NT, wt);
  constexpr bool FIXUP = M == TILE_M && KS == KSum::K32_PAIRS;
  if (!FIXUP || a_tile == nullptr) {
    store_tc<NT, RELU, M>(acc, bias, act);
    return;
  }
  if constexpr (FIXUP) {
    store_collect<NT, RELU, NSEG>(acc, bias, act, p, s0, s1, fx, valid);
    if (fx.n > 0) fix_apply<RELU, NSEG>(p, s0, s1, bias, act, fx, a_tile, wt, wt_elems);
    row_norms(act, ACT_LD, WIDTH, fx.xn[0]);
  }
}

// The trunk over the tile whose encodings are in enc_pt: layers 0..7
// (input skip at layer 4) into act; after each layer, save(layer). With
// a_tile, the fix-up (the encodings' row norms in fx, each layer's input
// saved in a_tile before the layer runs).
template <int M = TILE_M, KSum KS = KSum::K32_PAIRS, class Save>
__device__ __forceinline__ void trunk_tc(const Params& p, bf16* act, const bf16* enc_pt,
                                         bf16* wt, int wt_elems, FixSmem& fx,
                                         const bf16* a_tile, int valid, Save save) {
  const Seg enc{enc_pt, ENC_PT_LD, PK_W0, ENC_PT_PAD, 1, 0, AB_ENC_PT};
  layer_tc<8, true, 1, M, KS>(p, enc, enc, p.b[0], act, wt, wt_elems, fx, a_tile, valid);
  save(0);
  for (int layer = 1; layer < 8; ++layer) {
    const Seg hidden{act, ACT_LD, pk_hidden(layer), WIDTH, 0, layer, ab_hidden(layer - 1)};
    if (layer == 4) {
      const Seg skip{enc_pt, ENC_PT_LD, PK_4E, ENC_PT_PAD, 1, 8, AB_ENC_PT};
      layer_tc<8, true, 2, M, KS>(p, hidden, skip, p.b[4], act, wt, wt_elems, fx, a_tile, valid);
    } else {
      layer_tc<8, true, 1, M, KS>(p, hidden, hidden, p.b[layer], act, wt, wt_elems, fx, a_tile,
                              valid);
    }
    save(layer);
  }
}

// After the sigma head has read h7 in act: point_info = h W + b (no
// activation) into act, save(POINT_INFO); then the view branch
// relu([enc_dir, point_info] W + b) into act[:, :128], save(DIR_INFO).
template <int M = TILE_M, KSum KS = KSum::K32_PAIRS, class Save>
__device__ __forceinline__ void view_tc(const Params& p, bf16* act, const bf16* enc_dir,
                                        bf16* wt, int wt_elems, FixSmem& fx, const bf16* a_tile,
                                        int valid, Save save) {
  const Seg pi{act, ACT_LD, PK_PI, WIDTH, 0, 9, ab_hidden(7)};
  layer_tc<8, false, 1, M, KS>(p, pi, pi, p.b[POINT_INFO], act, wt, wt_elems, fx, a_tile, valid);
  save(POINT_INFO);
  const Seg de{enc_dir, ENC_DIR_LD, PK_DE, ENC_DIR_PAD, 2, 10, AB_ENC_DIR};
  const Seg dp{act, ACT_LD, PK_DP, WIDTH, 0, 11, AB_PI};
  layer_tc<4, true, 2, M, KS>(p, de, dp, p.b[DIR_INFO], act, wt, wt_elems, fx, a_tile, valid);
  save(DIR_INFO);
}

// Row row0 + i's sigma pre-activation |.| not yet taken: h7 . w_sigma + b,
// h7 in act (bf16), w_sigma rounded. Lane 0 holds the sum.
__device__ __forceinline__ float sigma_pre_tc(const Params& p, const bf16* act, int r) {
  const int lane = threadIdx.x & 31;
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < WIDTH / 32; ++q)
    v = fmaf(bf(act[r * ACT_LD + lane + 32 * q]),
             rnd<true>(__ldg(p.w[SIGMA] + lane + 32 * q)), v);
  return warp_sum(v) + __ldg(p.b[SIGMA]);
}

// Row r's color pre-activations: h_dir W_color + b, h_dir in act[:, :128].
__device__ __forceinline__ void color_pre_tc(const Params& p, const bf16* act, int r,
                                             float (&x)[3]) {
  const int lane = threadIdx.x & 31;
  float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < WIDTH / 2 / 32; ++q) {
    const int k = lane + 32 * q;
    const float h = bf(act[r * ACT_LD + k]);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[c] = fmaf(h, rnd<true>(__ldg(p.w[COLOR] + 3 * k + c)), v[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = warp_sum(v[c]) + __ldg(p.b[COLOR] + c);
}

// Rows below `valid` of src[:, :cols] (bf16, row stride ld) to dst (row
// stride dst_ld), 16 bytes a thread. No barrier: it only reads src.
__device__ __forceinline__ void save_rows(const bf16* src, int ld, int cols, bf16* dst,
                                          int dst_ld, int valid) {
  const int ch = cols / 8;
  for (int i = threadIdx.x; i < valid * ch; i += THREADS)
    *reinterpret_cast<uint4*>(dst + (size_t)(i / ch) * dst_ld + (i % ch) * 8) =
        *reinterpret_cast<const uint4*>(src + (i / ch) * ld + (i % ch) * 8);
}

// The forward that a backward follows, on the 64-row tile at `base` (rows
// at or past row_end masked), with the fix-up: the encodings into enc_pt
// and enc_dir, then the trunk, point_info and the view branch, each
// layer's input saved to a_tile (rows below `valid`, row stride
// AB_STRIDE), where the fix-up reads it back; p.wb holds
// pack_weights(..., fixup = true). sigma(r, pre) takes row r's sigma
// pre-activation and color(r, x) its three color pre-activations, both
// valid in lane 0 of the row's warp. Kernel 1's saving form and kernel 2's
// recompute run this one sequence, so that the backward from kernel 1's
// residuals sees what its recompute would. Ends with a barrier.
template <class Coord, class Sigma, class Color>
__device__ __forceinline__ void forward_fixup_tc(Coord coord, const Params& p, int base,
                                                 int row_end, bf16* act, bf16* enc_pt,
                                                 bf16* enc_dir, bf16* wt, int wt_elems,
                                                 FixSmem& fx, bf16* a_tile, int valid,
                                                 Sigma sigma, Color color) {
  encode_tile_tc(coord, p.freqs, base, row_end, enc_pt, enc_dir);
  enc_norms(enc_pt, enc_dir, fx);
  save_rows(enc_pt, ENC_PT_LD, ENC_PT_PAD, a_tile + AB_ENC_PT, AB_STRIDE, valid);
  save_rows(enc_dir, ENC_DIR_LD, ENC_DIR_PAD, a_tile + AB_ENC_DIR, AB_STRIDE, valid);
  trunk_tc(p, act, enc_pt, wt, wt_elems, fx, a_tile, valid, [&](int layer) {
    save_rows(act, ACT_LD, WIDTH, a_tile + ab_hidden(layer), AB_STRIDE, valid);
  });
  const int row0 = (threadIdx.x >> 5) * ROWS;
  for (int i = 0; i < ROWS; ++i) sigma(row0 + i, sigma_pre_tc(p, act, row0 + i));
  view_tc(p, act, enc_dir, wt, wt_elems, fx, a_tile, valid, [&](int layer) {
    if (layer == POINT_INFO)
      save_rows(act, ACT_LD, WIDTH, a_tile + AB_PI, AB_STRIDE, valid);
    else
      save_rows(act, ACT_LD, WIDTH / 2, a_tile + AB_HD, AB_STRIDE, valid);
  });
  for (int i = 0; i < ROWS; ++i) {
    float x[3];
    color_pre_tc(p, act, row0 + i, x);
    color(row0 + i, x);
  }
  __syncthreads();
}

// Shared memory of the bf16 forward on an M-row tile: 85 KB at M = 64,
// inside the FwdSmem that the forward kernels allocate; 132 KB at M = 128
// (the fused renderer's forward, render_common.cuh).
template <int M>
struct TcSmemT {
  bf16 act[M * ACT_LD];
  bf16 enc_pt[M * ENC_PT_LD];
  bf16 enc_dir[M * ENC_DIR_LD];
  bf16 wt[2 * FWD_STAGE];
  FixSmem fx;
};
using TcSmem = TcSmemT<TILE_M>;
static_assert(sizeof(TcSmem) <= sizeof(FwdSmem), "the bf16 tile must fit in FwdSmem");

// network_fwd's function in its bf16 form on an M-row tile of 4 M threads,
// on the tensor cores, its products summed as KS says; the encodings are
// in s (encode_tile_tc).
template <int M = TILE_M, KSum KS = KSum::K32_PAIRS, class Out>
__device__ __forceinline__ void network_tc(TcSmemT<M>& s, const Params& p, int base, int total,
                                           Out out) {
  const auto none = [](int) {};
  trunk_tc<M, KS>(p, s.act, s.enc_pt, s.wt, 2 * FWD_STAGE, s.fx, nullptr, 0, none);
  const int row0 = (threadIdx.x >> 5) * ROWS;
  for (int i = 0; i < ROWS; ++i) {
    const float v = sigma_pre_tc(p, s.act, row0 + i);
    const int m = base + row0 + i;
    if ((threadIdx.x & 31) == 0 && m < total) out(m, 3, fabsf(v));
  }
  view_tc<M, KS>(p, s.act, s.enc_dir, s.wt, 2 * FWD_STAGE, s.fx, nullptr, 0, none);
  for (int i = 0; i < ROWS; ++i) {
    float x[3];
    color_pre_tc(p, s.act, row0 + i, x);
    const int m = base + row0 + i;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if ((threadIdx.x & 31) == 0 && m < total) out(m, c, 1.f / (1.f + expf(-x[c])));
  }
}

// The field at rows base .. base+TILE_M-1 of `coord` (rows at or past
// `total` masked), out(m, ch, value) as network_fwd's, in the block's
// FwdSmem: the fp32 form encodes and runs network_fwd; the bf16 form runs
// the tensor-core tile in the same shared memory, with p.wb packed.
template <bool BF16, class Coord, class Out>
__device__ __forceinline__ void field_tile(FwdSmem& s, const Params& p, Coord coord,
                                           int base, int total, Out out) {
  if constexpr (BF16) {
    TcSmem& t = *reinterpret_cast<TcSmem*>(&s);
    encode_tile_tc<TILE_M>(coord, p.freqs, base, total, t.enc_pt, t.enc_dir);
    network_tc<TILE_M>(t, p, base, total, out);
  } else {
    encode_tile(coord, p.freqs, base, total, s.enc_pt, s.enc_dir);
    network_fwd(s, p, base, total, out);
  }
}

}  // namespace
