// Flash attention for Hopper (sm_90a) at float32 inputs: forward, dK/dV and dQ kernels.
//
// Counterparts of the three Pallas kernels in mafed_tpu/kernels/attention.py
// (_flash_kernel :81, _flash_bwd_dkv_kernel :230, _flash_bwd_dq_kernel :294)
// when they are given float32 q, k, v (a `--compute_dtype float32` run). The
// Pallas bodies keep the matmul operands in the input dtype, so at float32
// every product is a float32 product: these kernels multiply float32 operands
// with float32 FMAs on the CUDA cores. Hopper's wgmma takes tf32, not f32, and
// rounding the operands to tf32 would keep ~3 decimal digits where the
// reference keeps ~7, so no tensor-core instruction is used here. Numerics as
// the Pallas bodies at f32: the scale applied to the f32 product, masked
// scores filled with finfo(float32).min and probabilities zeroed where a key
// is not kept, the online max / sum with alpha = exp(m_prev - m_new), lse =
// +inf on rows with no kept key (their o is 0), p and ds unrounded. expf and
// logf are the accurate library functions (the build has no --use_fast_math).
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous [batch*heads, seq, D]
// float32; lse and delta [batch*heads, q_len] float32; the key-padding mask
// [batch, kv_len] int32 (or null). Causal calls need kv_len == q_len.
//
// Bound on the H100: operations. The kept pairs' products at the 410M CE
// shape (48 x 16 heads, 336 tokens, head_dim 64, causal) are ~11 GFLOP for
// the forward, ~0.17 ms at the 67 TFLOP/s of the CUDA cores, against ~0.08
// ms to move its 264 MB at 3.35 TB/s; the backward kernels do 1.5x and 2x
// the forward's products. So what counts is that every SM keeps its FMA
// pipes busy: operands come from shared memory as 16-byte vectors, each
// thread holds a 4 x 4 score block and a 4 x 8 output block, and loads of
// the next stage are in flight (cp.async) while the current one is computed.
// Measured at that shape on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// phase kernels): 0.80 / 1.75 / 1.33 ms forward / dK-dV / dQ, 4.9-5.5x the
// bound; at head_dim 256 and up, where each slice recomputes the score tile,
// the dense plain version is faster.
//
// Design. One instantiation per kernel, head_dim D a runtime argument (any
// multiple of 32 from 64 on whose slices below are 64 columns or more: 64,
// 96, 128, 256 and every multiple of 128). The grid is (slices, tiles,
// batch x heads): a CTA of 256 threads owns one 64-row tile (of queries for
// the forward and dQ, of keys for dK/dV) and one slice of at most SLICE =
// 128 output columns, so neither the accumulators (32 floats a thread a
// product) nor shared memory grow with D. Each CTA computes the whole 64 x 64
// score tile over all of D itself, from 32-column panels of both operands
// staged in shared memory, then forms only its slice's products; the slices
// of one tile run the same instructions on the same data in the same order,
// so they agree on every score, m and l bit for bit, and slice 0 writes lse.
// The work is a sequence of stages, each one cp.async group in one of two
// shared buffers: per streamed tile, D / 32 score stages (a panel of each
// operand) and then one stage per slice product (the V, K, dO or Q rows of
// the slice). The next stage's copies start before the current stage
// is computed. P and dS pass to the slice products through shared memory.
//
// Thread mapping: thread (ty, tx) = (tid / 16, tid % 16) holds rows ty + 16 i
// (i < 4) of the CTA's tile; in a score block the streamed rows tx + 16 j
// (j < 4), so a row's 64 scores lie in the 16 lanes of one half-warp (row
// reductions are 4 shuffles); in an output block the columns 4 tx + 64 h ..
// + 3 (h < 2, the second group only where the slice is wider than 64).
//
// Nothing is allocated on the device here: the Python wrapper allocates the
// outputs, and every launch goes on the stream it is given.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;                  // rows of a query tile and of a key tile
constexpr int THREADS = 256;               // 16 x 16
constexpr int SLICE = 128;                 // most output columns of one CTA
constexpr int PANEL_COLS = 32;             // head_dim columns of a staged score panel
// Row stride of a panel: 36 floats, nine 16-byte chunks, so that rows tx + 16 j of 8 consecutive
// lanes start in 8 different 16-byte bank groups
constexpr int PANEL_LD = 36;
constexpr int PANEL = BLOCK * PANEL_LD;    // floats of one panel
constexpr int SLICE_TILE = BLOCK * SLICE;  // floats of one staged slice (rows of SLICE floats)
// Row stride of a P or dS tile: 80 floats, so the rows ty + 16 i of a warp's two ty lie 16 banks
// apart and a warp's scalar stores of one (i, j) hit 32 different banks
constexpr int TILE_LD = 80;
constexpr int PTILE = BLOCK * TILE_LD;
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

// Shared memory of each kernel, in floats: two stage buffers (each the larger of a score stage's
// panels and a slice), then the P / dS tiles.
template <int PANELS, int TILES> struct Smem {
  static constexpr int STAGE = PANELS * PANEL > SLICE_TILE ? PANELS * PANEL : SLICE_TILE;
  static constexpr int TILE0 = 2 * STAGE;
  static constexpr size_t BYTES = (size_t)(TILE0 + TILES * PTILE) * sizeof(float);
};
using FwdSmem = Smem<2, 1>;  // Q, K panels; P
using DkvSmem = Smem<4, 2>;  // K, Q, V, dO panels; P^T, dS^T
using DqSmem = Smem<4, 1>;   // Q, K, dO, V panels; dS

__device__ __forceinline__ int thread_row() { return threadIdx.x >> 4; }  // ty
__device__ __forceinline__ int thread_col() { return threadIdx.x & 15; }  // tx

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Columns col0 .. col0 + 31 of rows row0 .. row0 + 63 of a [len][d] matrix into a panel; rows at
// or past len are zero-filled.
__device__ __forceinline__ void load_panel(float* dst, const float* __restrict__ src, int row0, int len, int d,
                                           int col0) {
  for (int idx = threadIdx.x; idx < BLOCK * (PANEL_COLS / 4); idx += THREADS) {
    const int r = idx >> 3, c = (idx & 7) * 4, row = row0 + r;
    const bool valid = row < len;
    cp_async16(dst + r * PANEL_LD + c, valid ? src + (size_t)row * d + col0 + c : src, valid);
  }
}

// Columns c0 .. c0 + w - 1 of rows row0 .. row0 + 63 of a [len][d] matrix into a slice buffer
// (rows of SLICE floats); rows at or past len are zero-filled.
__device__ __forceinline__ void load_slice(float* dst, const float* __restrict__ src, int row0, int len, int d,
                                           int c0, int w) {
  const int chunks = w >> 2;
  for (int idx = threadIdx.x; idx < BLOCK * chunks; idx += THREADS) {
    const int r = idx / chunks, c = (idx - r * chunks) * 4, row = row0 + r;
    const bool valid = row < len;
    cp_async16(dst + r * SLICE + c, valid ? src + (size_t)row * d + c0 + c : src, valid);
  }
}

// s[i][j] += sum over the panels' 32 columns of A[ty + 16 i][k] B[tx + 16 j][k], in column order.
__device__ __forceinline__ void score_panel(float (&s)[4][4], const float* a, const float* b) {
  const int ty = thread_row(), tx = thread_col();
#pragma unroll
  for (int k = 0; k < PANEL_COLS; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * PANEL_LD + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * PANEL_LD + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][h][c] += sum over the 64 rows k of X[ty + 16 i][k] Y[k][4 tx + 64 h + c]: X a P or dS
// tile (TILE_LD), Y a staged slice w columns wide; the second column group only below w.
__device__ __forceinline__ void slice_product(float (&acc)[4][2][4], const float* x, const float* y, int w) {
  const int ty = thread_row(), tx = thread_col();
  const bool hi = 4 * tx + 64 < w;
#pragma unroll 2
  for (int k = 0; k < BLOCK; k += 4) {
    float xv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(xv[i]) = *reinterpret_cast<const float4*>(x + (ty + 16 * i) * TILE_LD + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 y0 = *reinterpret_cast<const float4*>(y + (k + kk) * SLICE + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0][0] = fmaf(xv[i][kk], y0.x, acc[i][0][0]);
        acc[i][0][1] = fmaf(xv[i][kk], y0.y, acc[i][0][1]);
        acc[i][0][2] = fmaf(xv[i][kk], y0.z, acc[i][0][2]);
        acc[i][0][3] = fmaf(xv[i][kk], y0.w, acc[i][0][3]);
      }
      if (hi) {
        const float4 y1 = *reinterpret_cast<const float4*>(y + (k + kk) * SLICE + 64 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][1][0] = fmaf(xv[i][kk], y1.x, acc[i][1][0]);
          acc[i][1][1] = fmaf(xv[i][kk], y1.y, acc[i][1][1]);
          acc[i][1][2] = fmaf(xv[i][kk], y1.z, acc[i][1][2]);
          acc[i][1][3] = fmaf(xv[i][kk], y1.w, acc[i][1][3]);
        }
      }
    }
  }
}

// Rows row0 + ty + 16 i below n_rows of an output block into columns c0 + 4 tx + 64 h of a [.][d]
// matrix, row i divided by f[i] (DIVIDE) or times f[i]; the second group only below w.
template <bool DIVIDE>
__device__ __forceinline__ void store_block(float* __restrict__ dst, const float (&acc)[4][2][4], int row0,
                                            int n_rows, int d, int c0, int w, const float (&f)[4]) {
  const int ty = thread_row(), tx = thread_col();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (4 * tx + 64 * h >= w) continue;
      float4 out;
      out.x = DIVIDE ? acc[i][h][0] / f[i] : acc[i][h][0] * f[i];
      out.y = DIVIDE ? acc[i][h][1] / f[i] : acc[i][h][1] * f[i];
      out.z = DIVIDE ? acc[i][h][2] / f[i] : acc[i][h][2] * f[i];
      out.w = DIVIDE ? acc[i][h][3] / f[i] : acc[i][h][3] * f[i];
      *reinterpret_cast<float4*>(dst + (size_t)row * d + c0 + 4 * tx + 64 * h) = out;
    }
  }
}

__device__ __forceinline__ bool key_kept(const int* __restrict__ mask_row, int key, int kv_len) {
  return key < kv_len && (mask_row == nullptr || mask_row[key] > 0);
}

template <int N> __device__ __forceinline__ void zero(float (&a)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) a[i][j] = 0.0f;
}

__device__ __forceinline__ void zero_acc(float (&a)[4][2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[i][h][c] = 0.0f;
}

// ---------------------------------------------------------------------------
// Forward. Replaces _flash_kernel (mafed_tpu/kernels/attention.py:81-153) at
// float32. Per key tile: D / 32 score stages (Q and K panels), the online
// softmax of the 64 x 64 tile into P, then one stage of O_s += P V_s.
// ---------------------------------------------------------------------------
template <int SW>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const int* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int heads,
                     int q_len, int kv_len, int d, int causal, float scale) {
  const int slice = blockIdx.x, qt = blockIdx.y, bh = blockIdx.z;
  const int c0 = slice * SW, w = min(SW, d - c0), q0 = qt * BLOCK;
  const int ty = thread_row(), tx = thread_col();
  q += (size_t)bh * q_len * d;
  k += (size_t)bh * kv_len * d;
  v += (size_t)bh * kv_len * d;
  o += (size_t)bh * q_len * d;
  lse += (size_t)bh * q_len;
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * kv_len;

  extern __shared__ __align__(16) float smem[];
  float* const ptile = smem + FwdSmem::TILE0;
  const int n_kt = (kv_len + BLOCK - 1) / BLOCK;
  const int upper = causal ? min(qt + 1, n_kt) : n_kt;
  const int np = d / PANEL_COLS, per_tile = np + 1, n_stages = upper * per_tile;

  auto load_stage = [&](int st) {
    const int kt = st / per_tile, p = st - kt * per_tile;
    float* buf = smem + (st & 1) * FwdSmem::STAGE;
    if (p < np) {
      load_panel(buf, q, q0, q_len, d, p * PANEL_COLS);
      load_panel(buf + PANEL, k, kt * BLOCK, kv_len, d, p * PANEL_COLS);
    } else {
      load_slice(buf, v, kt * BLOCK, kv_len, d, c0, w);
    }
    cp_async_commit();
  };

  float acc[4][2][4], s[4][4];
  float m[4], l[4];
  zero_acc(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.0f;

  if (n_stages > 0) load_stage(0);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed, and every thread is done with stage st - 1
    if (st + 1 < n_stages) load_stage(st + 1);
    const int kt = st / per_tile, p = st - kt * per_tile;
    const float* buf = smem + (st & 1) * FwdSmem::STAGE;
    if (p == np) {  // O_s += P V_s
      slice_product(acc, ptile, buf, w);
      continue;
    }
    if (p == 0) zero(s);
    score_panel(s, buf, buf + PANEL);
    if (p + 1 < np) continue;
    // the tile's online softmax, as _flash_kernel's body
    bool keep[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) keep[j] = key_kept(mask_row, kt * BLOCK + tx + 16 * j, kv_len);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool kp[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kp[j] = keep[j] && (!causal || kt * BLOCK + tx + 16 * j <= row);
        s[i][j] = kp[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kp[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][h][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ptile[(ty + 16 * i) * TILE_LD + tx + 16 * j] = s[i][j];
    }
  }

  float l_safe[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) l_safe[i] = l[i] == 0.0f ? 1.0f : l[i];
  store_block<true>(o, acc, q0, q_len, d, c0, w, l_safe);  // o = acc / l, as _flash_kernel
  if (slice == 0 && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < q_len) lse[row] = l[i] == 0.0f ? INFINITY : m[i] + logf(l_safe[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV. Replaces _flash_bwd_dkv_kernel (mafed_tpu/kernels/attention.py:230)
// at float32. The CTA owns a key tile; per query tile: D / 32 score stages
// (K, Q, V and dO panels: S^T = K Q^T and dP^T = V dO^T), P^T = exp(S^T scale
// - lse) where kept and dS^T = P^T (dP^T - delta) into shared memory, then
// dV_s += P^T dO_s and dK_s += dS^T Q_s, one stage each; dK scaled at the end.
// ---------------------------------------------------------------------------
template <int SW>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ mask, float* __restrict__ dk,
                         float* __restrict__ dv, int heads, int q_len, int kv_len, int d, int causal, float scale) {
  const int slice = blockIdx.x, kt = blockIdx.y, bh = blockIdx.z;
  const int c0 = slice * SW, w = min(SW, d - c0), k0 = kt * BLOCK;
  const int ty = thread_row(), tx = thread_col();
  q += (size_t)bh * q_len * d;
  dout += (size_t)bh * q_len * d;
  k += (size_t)bh * kv_len * d;
  v += (size_t)bh * kv_len * d;
  dk += (size_t)bh * kv_len * d;
  dv += (size_t)bh * kv_len * d;
  lse += (size_t)bh * q_len;
  delta += (size_t)bh * q_len;
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * kv_len;

  extern __shared__ __align__(16) float smem[];
  float* const pt = smem + DkvSmem::TILE0;
  float* const dst = pt + PTILE;
  const int n_qt = (q_len + BLOCK - 1) / BLOCK;
  const int first = causal ? kt : 0;  // causal: query tiles before the key tile see none of its keys
  const int np = d / PANEL_COLS, per_tile = np + 2, n_stages = (n_qt - first) * per_tile;

  auto load_stage = [&](int st) {
    const int t = st / per_tile, p = st - t * per_tile, q0 = (first + t) * BLOCK;
    float* buf = smem + (st & 1) * DkvSmem::STAGE;
    if (p < np) {
      const int col = p * PANEL_COLS;
      load_panel(buf, k, k0, kv_len, d, col);
      load_panel(buf + PANEL, q, q0, q_len, d, col);
      load_panel(buf + 2 * PANEL, v, k0, kv_len, d, col);
      load_panel(buf + 3 * PANEL, dout, q0, q_len, d, col);
    } else {
      load_slice(buf, p == np ? dout : q, q0, q_len, d, c0, w);
    }
    cp_async_commit();
  };

  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = key_kept(mask_row, k0 + ty + 16 * i, kv_len);
  float dk_acc[4][2][4], dv_acc[4][2][4], s[4][4], dp[4][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  if (n_stages > 0) load_stage(0);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < n_stages) load_stage(st + 1);
    const int t = st / per_tile, p = st - t * per_tile, q0 = (first + t) * BLOCK;
    const float* buf = smem + (st & 1) * DkvSmem::STAGE;
    if (p == np) {  // dV_s += P^T dO_s
      slice_product(dv_acc, pt, buf, w);
      continue;
    }
    if (p == np + 1) {  // dK_s += dS^T Q_s
      slice_product(dk_acc, dst, buf, w);
      continue;
    }
    if (p == 0) {
      zero(s);
      zero(dp);
    }
    score_panel(s, buf, buf + PANEL);
    score_panel(dp, buf + 2 * PANEL, buf + 3 * PANEL);
    if (p + 1 < np) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx + 16 * j;  // the query of column j
      const bool in = row < q_len;
      const float row_lse = in ? lse[row] : INFINITY, row_delta = in ? delta[row] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
        const bool kp = in && key_ok[i] && (!causal || key <= row);
        const float pij = kp ? expf(s[i][j] * scale - row_lse) : 0.0f;
        pt[(ty + 16 * i) * TILE_LD + tx + 16 * j] = pij;
        dst[(ty + 16 * i) * TILE_LD + tx + 16 * j] = pij * (dp[i][j] - row_delta);
      }
    }
  }

  const float scales[4] = {scale, scale, scale, scale}, ones[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_block<false>(dk, dk_acc, k0, kv_len, d, c0, w, scales);
  store_block<false>(dv, dv_acc, k0, kv_len, d, c0, w, ones);
}

// ---------------------------------------------------------------------------
// dQ. Replaces _flash_bwd_dq_kernel (mafed_tpu/kernels/attention.py:294) at
// float32. The CTA owns a query tile; per key tile: D / 32 score stages (Q, K,
// dO and V panels: S = Q K^T and dP = dO V^T), dS = P (dP - delta) into shared
// memory, then one stage of dQ_s += dS K_s; dQ scaled at the end.
// ---------------------------------------------------------------------------
template <int SW>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const int* __restrict__ mask, float* __restrict__ dq,
                        int heads, int q_len, int kv_len, int d, int causal, float scale) {
  const int slice = blockIdx.x, qt = blockIdx.y, bh = blockIdx.z;
  const int c0 = slice * SW, w = min(SW, d - c0), q0 = qt * BLOCK;
  const int ty = thread_row(), tx = thread_col();
  q += (size_t)bh * q_len * d;
  dout += (size_t)bh * q_len * d;
  dq += (size_t)bh * q_len * d;
  k += (size_t)bh * kv_len * d;
  v += (size_t)bh * kv_len * d;
  lse += (size_t)bh * q_len;
  delta += (size_t)bh * q_len;
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * kv_len;

  extern __shared__ __align__(16) float smem[];
  float* const dst = smem + DqSmem::TILE0;
  const int n_kt = (kv_len + BLOCK - 1) / BLOCK;
  const int upper = causal ? min(qt + 1, n_kt) : n_kt;
  const int np = d / PANEL_COLS, per_tile = np + 1, n_stages = upper * per_tile;

  auto load_stage = [&](int st) {
    const int kt = st / per_tile, p = st - kt * per_tile;
    float* buf = smem + (st & 1) * DqSmem::STAGE;
    if (p < np) {
      const int col = p * PANEL_COLS;
      load_panel(buf, q, q0, q_len, d, col);
      load_panel(buf + PANEL, k, kt * BLOCK, kv_len, d, col);
      load_panel(buf + 2 * PANEL, dout, q0, q_len, d, col);
      load_panel(buf + 3 * PANEL, v, kt * BLOCK, kv_len, d, col);
    } else {
      load_slice(buf, k, kt * BLOCK, kv_len, d, c0, w);
    }
    cp_async_commit();
  };

  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < q_len ? lse[row] : INFINITY;
    row_delta[i] = row < q_len ? delta[row] : 0.0f;
  }
  float dq_acc[4][2][4], s[4][4], dp[4][4];
  zero_acc(dq_acc);

  if (n_stages > 0) load_stage(0);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < n_stages) load_stage(st + 1);
    const int kt = st / per_tile, p = st - kt * per_tile;
    const float* buf = smem + (st & 1) * DqSmem::STAGE;
    if (p == np) {  // dQ_s += dS K_s
      slice_product(dq_acc, dst, buf, w);
      continue;
    }
    if (p == 0) {
      zero(s);
      zero(dp);
    }
    score_panel(s, buf, buf + PANEL);
    score_panel(dp, buf + 2 * PANEL, buf + 3 * PANEL);
    if (p + 1 < np) continue;
    bool keep[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) keep[j] = key_kept(mask_row, kt * BLOCK + tx + 16 * j, kv_len);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool kp = keep[j] && (!causal || kt * BLOCK + tx + 16 * j <= row);
        const float pij = kp ? expf(s[i][j] * scale - row_lse[i]) : 0.0f;
        dst[(ty + 16 * i) * TILE_LD + tx + 16 * j] = pij * (dp[i][j] - row_delta[i]);
      }
    }
  }

  const float scales[4] = {scale, scale, scale, scale};
  store_block<false>(dq, dq_acc, q0, q_len, d, c0, w, scales);
}

// head_dims the kernels take: whole 32-column panels, and slices of 64 columns or more
__host__ __forceinline__ bool takes_head_dim(int d) { return d >= 64 && d % 32 == 0 && (d <= SLICE || d % SLICE == 0); }

__host__ __forceinline__ dim3 f32_grid(int head_dim, int len, int batch_heads) {
  return dim3((head_dim + SLICE - 1) / SLICE, (len + BLOCK - 1) / BLOCK, batch_heads);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers (bound from Python with ctypes), with the arguments of the
// bfloat16 launchers in flash_attn.cu. A head_dim the kernels do not take
// returns cudaErrorInvalidValue.
// ---------------------------------------------------------------------------

extern "C" cudaError_t flash_attn_fwd_f32(const void* q, const void* k, const void* v, const void* mask, void* o,
                                          void* lse, int batch_heads, int heads, int q_len, int kv_len,
                                          int head_dim, int causal, float scale, void* stream) {
  if (!takes_head_dim(head_dim)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<SLICE>, FwdSmem::BYTES);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<SLICE><<<f32_grid(head_dim, q_len, batch_heads), THREADS, FwdSmem::BYTES, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)mask, (float*)o, (float*)lse, heads, q_len,
      kv_len, head_dim, causal, scale);
  return cudaGetLastError();
}

extern "C" cudaError_t flash_attn_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                                              const void* lse, const void* delta, const void* mask, void* dk,
                                              void* dv, int batch_heads, int heads, int q_len, int kv_len,
                                              int head_dim, int causal, float scale, void* stream) {
  if (!takes_head_dim(head_dim)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel<SLICE>, DkvSmem::BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_f32_kernel<SLICE><<<f32_grid(head_dim, kv_len, batch_heads), THREADS, DkvSmem::BYTES,
                                    (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (const int*)mask, (float*)dk, (float*)dv, heads, q_len, kv_len, head_dim, causal, scale);
  return cudaGetLastError();
}

extern "C" cudaError_t flash_attn_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                                             const void* lse, const void* delta, const void* mask, void* dq,
                                             int batch_heads, int heads, int q_len, int kv_len, int head_dim,
                                             int causal, float scale, void* stream) {
  if (!takes_head_dim(head_dim)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<SLICE>, DqSmem::BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<SLICE><<<f32_grid(head_dim, q_len, batch_heads), THREADS, DqSmem::BYTES,
                                   (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (const int*)mask, (float*)dq, heads, q_len, kv_len, head_dim, causal, scale);
  return cudaGetLastError();
}
