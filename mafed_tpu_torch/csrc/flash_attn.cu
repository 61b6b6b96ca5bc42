// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Counterparts of the three Pallas kernels in mafed_tpu/kernels/attention.py
// (_flash_kernel :81, _flash_bwd_dkv_kernel :230, _flash_bwd_dq_kernel :294).
// Same numerics: bf16 matmul operands with f32 accumulation, the softmax
// scale applied to the f32 product, masked scores filled with
// finfo(float32).min and probabilities multiplied by the keep mask (so a row
// with no valid key gets p = 0, never a uniform row), lse = +inf on empty
// rows, p and ds rounded to bf16 before their products.
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous [batch*heads, seq, D]
// bf16; lse and delta are [batch*heads, q_len] f32; the key-padding mask is
// [batch, kv_len] int32 (or null). Causal calls need kv_len == q_len.
//
// Design. Each CTA has 4 warps and owns one 64-row tile (of queries for the
// forward and dQ, of keys for dK/dV); the other operand streams through
// shared memory in 64-row tiles. The ragged end of a sequence is
// bounds-masked inside every loop: rows past the end load as zeros, their
// keys are dropped from `keep`, and their outputs are never stored.
//   * forward and dK/dV: the 4 warps are one warpgroup; tiles arrive by TMA
//     through a 2-stage ring, every product is wgmma, and scores, softmax
//     statistics and accumulators stay in registers (sm90.cuh holds the
//     TMA, mbarrier and wgmma wrappers).
//   * dQ: each warp owns 16 rows; products go through WMMA 16x16x16
//     fragments, with scores staged through shared memory whose rows are
//     padded by 16 bytes to spread the fragment loads over the banks.
// Nothing is allocated on the device here: the Python wrapper allocates the
// outputs, and every launch goes on the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "sm90.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BLOCK = 64;               // rows of a query tile and of a key tile
constexpr int WARPS = 4;                // each warp owns 16 rows of its CTA's tile
constexpr int THREADS = WARPS * 32;
constexpr int LDP = BLOCK + 8;          // bf16 [BLOCK][BLOCK] row stride in shared memory
constexpr int LDS = BLOCK + 4;          // f32 [BLOCK][BLOCK] row stride
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

template <int D> struct Tile {
  static constexpr int LD = D + 8;      // bf16 [BLOCK][D] row stride
  static constexpr size_t BF16_TILE = sizeof(bf16) * BLOCK * LD;
  static constexpr size_t P_TILE = sizeof(bf16) * BLOCK * LDP;
  static constexpr size_t S_TILE = sizeof(float) * BLOCK * LDS;
  static constexpr size_t ROWS = sizeof(float) * BLOCK;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;  // B = rows^T
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Bump allocator over the dynamic shared memory; every piece is 128-byte aligned.
struct Carve {
  unsigned char* p;
  template <typename T> __device__ T* take(size_t bytes) {
    T* out = reinterpret_cast<T*>(p);
    p += (bytes + 127) / 128 * 128;
    return out;
  }
};

// Rows [row0, row0 + BLOCK) of a contiguous [n_rows, D] bf16 matrix into a
// padded shared tile; rows past n_rows become zeros. 16-byte loads.
template <int D>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int row0, int n_rows) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < BLOCK * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * Tile<D>::LD + c) = val;
  }
}

// keep[c] = key k0 + c exists and is not padding (causality is applied per row).
__device__ void load_key_keep(int* keep, const int* __restrict__ mask_row, int k0, int kv_len) {
  for (int i = threadIdx.x; i < BLOCK; i += THREADS) {
    const int col = k0 + i;
    keep[i] = col < kv_len && (mask_row == nullptr || mask_row[col] > 0);
  }
}

// out[16 x 64] = A_w[16 x D] . B^T, where B is a [64][D] tile (rows = the 64 columns of out).
template <int D>
__device__ void rows_times_tile_t(float* out, const bf16* a_rows, const bf16* b_tile) {
  for (int n = 0; n < BLOCK / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBT bt;
      wmma::load_matrix_sync(a, a_rows + kk * 16, Tile<D>::LD);
      wmma::load_matrix_sync(bt, b_tile + n * 16 * Tile<D>::LD + kk * 16, Tile<D>::LD);
      wmma::mma_sync(acc, a, bt, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[n] += P_w[16 x 64] . B[64 x D] for the D/16 column blocks of acc.
template <int D>
__device__ void accumulate_p_times_tile(FragC* acc, const bf16* p_rows, const bf16* b_tile) {
  for (int n = 0; n < D / 16; ++n) {
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      FragA a;
      FragB bm;
      wmma::load_matrix_sync(a, p_rows + kk * 16, LDP);
      wmma::load_matrix_sync(bm, b_tile + kk * 16 * Tile<D>::LD + n * 16, Tile<D>::LD);
      wmma::mma_sync(acc[n], a, bm, acc[n]);
    }
  }
}

// Store a warp's 16 x D f32 accumulator, times `scale`, as bf16 rows
// [row0, row0 + 16) of a [n_rows, D] output, through a 16 x LDS staging area.
template <int D>
__device__ void store_rows(bf16* __restrict__ dst, const FragC* acc, float* stage, int row0, int n_rows,
                           float scale) {
  static_assert(D <= LDS, "the staging area holds D columns");
  const int lane = threadIdx.x % 32;
  for (int n = 0; n < D / 16; ++n) wmma::store_matrix_sync(stage + n * 16, acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    if (row0 + r < n_rows) dst[(size_t)(row0 + r) * D + c] = __float2bfloat16(stage[r * LDS + c] * scale);
  }
}

// Keep bits of key tile k0: bit c = key k0 + c exists and is not padding.
// Warps 0 and 1 each fetch 32 keys (`keep_key`), then ballot them into one
// half of the tile's 64-bit word (`store_keep_bits`).
__device__ __forceinline__ bool keep_key(const int* __restrict__ mask_row, int k0, int kv_len) {
  const int col = k0 + threadIdx.x;  // threadIdx.x < 64
  return col < kv_len && (mask_row == nullptr || mask_row[col] > 0);
}

__device__ __forceinline__ void store_keep_bits(uint64_t* slot, bool keep) {
  const uint32_t word = __ballot_sync(0xffffffffu, keep);
  if (threadIdx.x % 32 == 0) reinterpret_cast<uint32_t*>(slot)[threadIdx.x / 32] = word;
}

// Store the 64 x D wgmma accumulator of the tile at row0, times `scale`, as
// bf16 pairs; rows at or past n_rows are never stored.
template <int D>
__device__ __forceinline__ void store_acc_rows(bf16* __restrict__ dst, const float (&acc)[D / 64][32], int row0,
                                               int n_rows, float scale) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * i;
    if (row >= n_rows) continue;
    bf16* out = dst + (size_t)row * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + n * 64 + 8 * j) =
            sm90::pack_bf16(acc[n][4 * j + 2 * i] * scale, acc[n][4 * j + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Forward. Replaces _flash_kernel (mafed_tpu/kernels/attention.py:81-153).
//
// Bound on the H100: memory. At the 410M CE shape (48x16 heads, 336 tokens,
// head_dim 64) it moves ~132 MB (q, k, v read, o written) for ~11 GFLOP of
// causal work: ~40 us at 3.35 TB/s against ~11 us of tensor-core time. The
// k/v of one head (43 KB) stays in L2 across that head's 6 query tiles, so
// what counts is that every SM keeps loads in flight and never waits on its
// own arithmetic.
//
// Design. One CTA is one warpgroup (128 threads) and owns one 64-row query
// tile of one (batch, head). Thread 0 loads Q once and streams 64-key K/V
// tiles with TMA through a ring of STAGES stages, one mbarrier each, so
// tile j + 1 is in flight while tile j is computed. S = Q K^T is wgmma with
// both operands K-major in shared memory; the scores, the online-softmax
// statistics m and l, and the O accumulator stay in registers: a thread
// holds two rows of each warp's 16-row slice, so a row reduction is two
// shuffles within its quad. The softmax runs in the log2 domain (the scale
// folded into log2(e), exp2 on the special-function unit) and masks only
// the tiles that need it: the diagonal one, where the loop stops, and those
// with a dropped key. P, rounded to bf16, goes from the S accumulator
// straight into the A fragment of O += P V (V read MN-major). About 41 KB of
// shared memory and under 100 registers a thread: 5 CTAs per SM. (Issuing
// S of tile j + 1 while P V of tile j runs measured slower on the H100.)
// ---------------------------------------------------------------------------
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Online softmax of one 64-key tile for this thread's two rows r_i = 16 warp
// + lane / 4 + 8 i, in the log2 domain (x = s scale log2(e)): dropped scores
// take finfo(f32).min, and p is 0 for them and for every key of a row that
// has no kept key yet. A row's max and sum are reduced within its quad. On
// return sc holds p, and alpha[i] rescales row i of the O accumulator.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             uint64_t kbits, bool diag, float scale_log2) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint64_t keep = 0;  // bit 8 j + c: column 8 j + 2 (lane % 4) + c is kept
    if (MASKED) {
      const int row = warp * 16 + lane / 4 + 8 * i;
      keep = (diag ? kbits & ((2ull << row) - 1) : kbits) >> (2 * (lane % 4));  // causal: keys 0..row
    }
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = sc[4 * j + 2 * i + c];
        x *= scale_log2;
        if (MASKED) x = ((keep >> (8 * j + c)) & 1) ? x : NEG;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    alpha[i] = sm90::exp2_approx(m[i] - m_new);
    const float m_sub = m_new == NEG ? INFINITY : m_new;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = sc[4 * j + 2 * i + c];
        x = sm90::exp2_approx(x - m_sub);
        sum += x;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[i] = l[i] * alpha[i] + sum;
    m[i] = m_new;
  }
}

template <int D> struct FwdSmem {  // byte offsets from the 1024-aligned base
  static constexpr uint32_t TILE = 64 * D * 2;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + TILE;
  static constexpr uint32_t V = K + STAGES * TILE;
  static constexpr uint32_t KEEP = V + STAGES * TILE;   // STAGES x uint64 keep bits
  static constexpr uint32_t BAR = KEEP + STAGES * 8;    // Q, then one per stage
  static constexpr size_t ALLOC = BAR + (1 + STAGES) * 8 + 1024;  // + room to align the base
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (sm90::smem_addr(raw) & 1023)) & 1023);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ mask, bf16* __restrict__ o,
                 float* __restrict__ lse, int heads, int q_len, int kv_len, int causal, float scale) {
  static_assert(D % 64 == 0, "tiles are stored as 64-column panels");
  using L = FwdSmem<D>;
  constexpr int NP = D / 64;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BLOCK;
  o += (size_t)bh * q_len * D;
  lse += (size_t)bh * q_len;
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)b * kv_len;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem + L::Q;
  uint64_t* keep_bits = reinterpret_cast<uint64_t*>(smem + L::KEEP);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);

  const int n_kt = (kv_len + BLOCK - 1) / BLOCK;
  const int upper = causal ? min(qt + 1, n_kt) : n_kt;
  auto load_kv = [&](int kt, int s) {
    sm90::mbar_expect_tx(&bar[1 + s], 2 * L::TILE);
    sm90::tma_load_tile<D>(smem + L::K + s * L::TILE, &tm_k, &bar[1 + s], kt * BLOCK, bh);
    sm90::tma_load_tile<D>(smem + L::V + s * L::TILE, &tm_v, &bar[1 + s], kt * BLOCK, bh);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_mbar_init();
  }
  if (warp < 2 && upper > 0) store_keep_bits(&keep_bits[0], keep_key(mask_row, 0, kv_len));
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar[0], L::TILE);
    sm90::tma_load_tile<D>(sQ, &tm_q, &bar[0], q0, bh);
    for (int s = 0; s < STAGES && s < upper; ++s) load_kv(s, s);
  }

  float acc[NP][32];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[n][r] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // row max (log2 domain) and sum
  const float scale_log2 = scale * LOG2E;
  sm90::mbar_wait(&bar[0], 0);

  for (int kt = 0; kt < upper; ++kt) {
    const int s = kt % STAGES;
    // the next tile's keep bits: fetched now, stored after this tile's products
    const bool next_keep = warp < 2 && kt + 1 < upper && keep_key(mask_row, (kt + 1) * BLOCK, kv_len);
    sm90::mbar_wait(&bar[1 + s], (kt / STAGES) & 1);
    const unsigned char* sK = smem + L::K + s * L::TILE;
    const unsigned char* sV = smem + L::V + s * L::TILE;

    float sc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = 0.0f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss(sc, sm90::desc_k_major(sQ, kk), sm90::desc_k_major(sK, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // online softmax in registers; a tile needs masking on the diagonal or
    // when one of its keys is dropped
    const uint64_t kbits = keep_bits[s];
    const bool diag = causal && kt == qt;
    float alpha[2];
    if (diag || kbits != ~0ull)
      softmax_tile<true>(sc, m, l, alpha, kbits, diag, scale_log2);
    else
      softmax_tile<false>(sc, m, l, alpha, kbits, false, scale_log2);
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[n][4 * j + 2 * i] *= alpha[i];
          acc[n][4 * j + 2 * i + 1] *= alpha[i];
        }

    // O += P V, P (bf16) from registers
    uint32_t pa[4][4];
    sm90::acc_to_a(sc, pa);
#pragma unroll
    for (int n = 0; n < NP; ++n) sm90::fence_regs(acc[n]);
    sm90::wgmma_fence();
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs(acc[n], pa[kk], sm90::desc_mn_major(sV, n, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NP; ++n) sm90::fence_regs(acc[n]);

    if (warp < 2 && kt + 1 < upper) store_keep_bits(&keep_bits[(kt + 1) % STAGES], next_keep);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && kt + STAGES < upper) load_kv(kt + STAGES, s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool empty = l[i] == 0.0f;
    const float l_safe = empty ? 1.0f : l[i];
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[n][4 * j + 2 * i] /= l_safe;
        acc[n][4 * j + 2 * i + 1] /= l_safe;
      }
    const int row = q0 + warp * 16 + lane / 4 + 8 * i;
    if (lane % 4 == 0 && row < q_len) lse[row] = empty ? INFINITY : m[i] * LN2 + logf(l_safe);
  }
  store_acc_rows<D>(o, acc, q0, q_len, 1.0f);
}

// ---------------------------------------------------------------------------
// dK, dV. Replaces _flash_bwd_dkv_kernel (mafed_tpu/kernels/attention.py:230-291).
//
// Bound on the H100: memory at VQA lengths. Per head it reads q, k, v, do
// (4 x T x D bf16) plus lse and delta, and writes dk, dv; its ~4 products per
// kept (q, k) pair are ~22 GFLOP at the CE shape, ~22 us of tensor-core time
// against ~55 us for the bytes.
//
// Design. One CTA is one warpgroup and owns one 64-key tile of one (batch,
// head). Thread 0 loads K and V once with TMA and streams 64-query Q/dO
// tiles through a ring of STAGES stages, from the diagonal tile on when
// causal. Per tile: S^T = K Q^T and dP^T = V dO^T are wgmma with both
// operands K-major in shared memory, committed as two groups; P^T = keep ?
// exp(S^T scale - lse) : 0 is formed in registers (log2 domain) as soon as
// S^T lands, and dV += P^T dO is issued while dP^T still runs; then
// dS^T = P^T (dP^T - delta), and dK += dS^T Q. P^T and dS^T are rounded to
// bf16 into the A fragments of those products (dO and Q read MN-major). dK
// and dV stay in registers for the whole sweep. lse and delta come in with
// ordinary loads (their rows are T x 4 bytes, which TMA takes only when T is
// a multiple of 4); rows past q_len read lse = +inf, delta = 0, so their p is
// 0. About 50 KB of shared memory and ~165 registers a thread: 3 CTAs per SM.
// ---------------------------------------------------------------------------
template <int D> struct DkvSmem {  // byte offsets from the 1024-aligned base
  static constexpr uint32_t TILE = 64 * D * 2;
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + TILE;
  static constexpr uint32_t Q = V + TILE;
  static constexpr uint32_t DO = Q + STAGES * TILE;
  static constexpr uint32_t LSE = DO + STAGES * TILE;      // STAGES x 64 f32
  static constexpr uint32_t DELTA = LSE + STAGES * 256;    // STAGES x 64 f32
  static constexpr uint32_t BAR = DELTA + STAGES * 256;    // K/V, then one per stage
  static constexpr size_t ALLOC = BAR + (1 + STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ mask,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int q_len, int kv_len, int causal,
                     float scale) {
  static_assert(D % 64 == 0, "tiles are stored as 64-column panels");
  using L = DkvSmem<D>;
  constexpr int NP = D / 64;
  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = kt * BLOCK;
  dk += (size_t)bh * kv_len * D;
  dv += (size_t)bh * kv_len * D;
  lse += (size_t)bh * q_len;
  delta += (size_t)bh * q_len;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* s_lse = reinterpret_cast<float*>(smem + L::LSE);
  float* s_delta = reinterpret_cast<float*>(smem + L::DELTA);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);

  // this thread's keys k0 + r_i, r_i = 16 warp + lane / 4 + 8 i
  bool key_keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + lane / 4 + 8 * i;
    key_keep[i] = key < kv_len && (mask == nullptr || mask[(size_t)b * kv_len + key] > 0);
  }

  const int n_qt = (q_len + BLOCK - 1) / BLOCK;
  const int first = causal ? kt : 0;  // causal: queries before k0 contribute nothing
  const int n_it = max(n_qt - first, 0);
  auto load_qdo = [&](int qt, int s) {
    sm90::mbar_expect_tx(&bar[1 + s], 2 * L::TILE);
    sm90::tma_load_tile<D>(smem + L::Q + s * L::TILE, &tm_q, &bar[1 + s], qt * BLOCK, bh);
    sm90::tma_load_tile<D>(smem + L::DO + s * L::TILE, &tm_do, &bar[1 + s], qt * BLOCK, bh);
  };
  // lse (threads 0-63) or delta (64-127) of query q0 + tid % 64
  auto fetch_row_stat = [&](int q0) {
    const int qrow = q0 + tid % 64;
    if (tid < 64) return qrow < q_len ? lse[qrow] : INFINITY;
    return qrow < q_len ? delta[qrow] : 0.0f;
  };
  auto store_row_stat = [&](int s, float x) {
    if (tid < 64)
      s_lse[s * 64 + tid] = x * LOG2E;  // log2 domain, +inf stays +inf
    else
      s_delta[s * 64 + tid - 64] = x;
  };
  const float scale_log2 = scale * LOG2E;

  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_mbar_init();
  }
  if (n_it > 0) store_row_stat(0, fetch_row_stat(first * BLOCK));
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar[0], 2 * L::TILE);
    sm90::tma_load_tile<D>(smem + L::K, &tm_k, &bar[0], k0, bh);
    sm90::tma_load_tile<D>(smem + L::V, &tm_v, &bar[0], k0, bh);
    for (int s = 0; s < STAGES && s < n_it; ++s) load_qdo(first + s, s);
  }

  float dk_acc[NP][32], dv_acc[NP][32], st[32], dpt[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    st[r] = dpt[r] = 0.0f;
#pragma unroll
    for (int n = 0; n < NP; ++n) dk_acc[n][r] = dv_acc[n][r] = 0.0f;
  }
  sm90::mbar_wait(&bar[0], 0);
  const unsigned char* sK = smem + L::K;
  const unsigned char* sV = smem + L::V;

  for (int it = 0; it < n_it; ++it) {
    const int qt = first + it, s = it % STAGES;
    const float next_stat = it + 1 < n_it ? fetch_row_stat((qt + 1) * BLOCK) : 0.0f;
    sm90::mbar_wait(&bar[1 + s], (it / STAGES) & 1);
    const unsigned char* sQ = smem + L::Q + s * L::TILE;
    const unsigned char* sDO = smem + L::DO + s * L::TILE;

    // S^T and dP^T as two groups; P^T and dV += P^T dO go ahead while dP^T runs,
    // dS^T while dV's product runs
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss(st, sm90::desc_k_major(sK, kk), sm90::desc_k_major(sQ, kk), kk > 0);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss(dpt, sm90::desc_k_major(sV, kk), sm90::desc_k_major(sDO, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(st);

    // p^T in registers: rows are keys, columns are the tile's queries
    const bool diag = causal && qt == kt;
    const float* t_lse = s_lse + s * 64;
    const float* t_delta = s_delta + s * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col0 = 8 * j + 2 * (lane % 4);
      const float2 lse2 = *reinterpret_cast<const float2*>(t_lse + col0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp * 16 + lane / 4 + 8 * i;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 4 * j + 2 * i + c;
          const bool keep = key_keep[i] && (!diag || row <= col0 + c);
          st[r] = keep ? sm90::exp2_approx(fmaf(st[r], scale_log2, -(c ? lse2.y : lse2.x))) : 0.0f;
        }
      }
    }
    uint32_t pa[4][4];
    sm90::acc_to_a(st, pa);
#pragma unroll
    for (int n = 0; n < NP; ++n) sm90::fence_regs(dv_acc[n]);
    sm90::wgmma_fence();
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs(dv_acc[n], pa[kk], sm90::desc_mn_major(sDO, n, kk));
    sm90::wgmma_commit();

    // ds^T = p^T (dp^T - delta)
    sm90::wgmma_wait<1>();
    sm90::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 delta2 = *reinterpret_cast<const float2*>(t_delta + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 4 * j + 2 * i + c;
          dpt[r] = st[r] * (dpt[r] - (c ? delta2.y : delta2.x));
        }
    }
    uint32_t dsa[4][4];
    sm90::acc_to_a(dpt, dsa);
#pragma unroll
    for (int n = 0; n < NP; ++n) sm90::fence_regs(dk_acc[n]);
    sm90::wgmma_fence();
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs(dk_acc[n], dsa[kk], sm90::desc_mn_major(sQ, n, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      sm90::fence_regs(dv_acc[n]);
      sm90::fence_regs(dk_acc[n]);
    }

    if (it + 1 < n_it) store_row_stat((it + 1) % STAGES, next_stat);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && it + STAGES < n_it) load_qdo(qt + STAGES, s);
  }

  store_acc_rows<D>(dv, dv_acc, k0, kv_len, 1.0f);
  store_acc_rows<D>(dk, dk_acc, k0, kv_len, scale);
}

// ---------------------------------------------------------------------------
// dQ. Replaces _flash_bwd_dq_kernel (mafed_tpu/kernels/attention.py:294-347).
//
// Bound on the H100: memory at VQA lengths (reads q, k, v, do, lse, delta,
// writes dq; 3 products per kept pair, ~17 GFLOP at the CE shape). The CTA
// keeps its query tile's q, do, lse and delta in shared memory and dQ in
// register fragments, and streams k/v tiles up to the causal diagonal.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ mask, bf16* __restrict__ dq,
                    int heads, int q_len, int kv_len, int causal, float scale) {
  using T = Tile<D>;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * BLOCK, wr = warp * 16;
  q += (size_t)bh * q_len * D;
  dout += (size_t)bh * q_len * D;
  dq += (size_t)bh * q_len * D;
  k += (size_t)bh * kv_len * D;
  v += (size_t)bh * kv_len * D;
  lse += (size_t)bh * q_len;
  delta += (size_t)bh * q_len;
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)b * kv_len;

  extern __shared__ __align__(128) unsigned char smem[];
  Carve carve{smem};
  bf16* sQ = carve.take<bf16>(T::BF16_TILE);
  bf16* sDO = carve.take<bf16>(T::BF16_TILE);
  bf16* sK = carve.take<bf16>(T::BF16_TILE);
  bf16* sV = carve.take<bf16>(T::BF16_TILE);
  bf16* sDS = carve.take<bf16>(T::P_TILE);
  float* sS = carve.take<float>(T::S_TILE);
  float* sDP = carve.take<float>(T::S_TILE);
  float* sLse = carve.take<float>(T::ROWS);
  float* sDelta = carve.take<float>(T::ROWS);
  int* sKeep = carve.take<int>(T::ROWS);

  load_tile<D>(sQ, q, q0, q_len);
  load_tile<D>(sDO, dout, q0, q_len);
  for (int i = threadIdx.x; i < BLOCK; i += THREADS) {
    const bool in = q0 + i < q_len;
    sLse[i] = in ? lse[q0 + i] : INFINITY;
    sDelta[i] = in ? delta[q0 + i] : 0.0f;
  }

  FragC dq_acc[D / 16];
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.0f);
  const int n_kt = (kv_len + BLOCK - 1) / BLOCK;
  const int upper = causal ? min(qt + 1, n_kt) : n_kt;
  for (int kt = 0; kt < upper; ++kt) {
    const int k0 = kt * BLOCK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<D>(sK, k, k0, kv_len);
    load_tile<D>(sV, v, k0, kv_len);
    load_key_keep(sKeep, mask_row, k0, kv_len);
    __syncthreads();

    rows_times_tile_t<D>(sS + wr * LDS, sQ + wr * T::LD, sK);    // q k^T
    rows_times_tile_t<D>(sDP + wr * LDS, sDO + wr * T::LD, sV);  // do v^T
    __syncwarp();

    for (int i = lane; i < 16 * BLOCK; i += 32) {
      const int r = wr + i / BLOCK, c = i % BLOCK;  // r: query within tile, c: key within tile
      const bool keep = sKeep[c] && (!causal || k0 + c <= q0 + r);
      const float p = keep ? expf(sS[r * LDS + c] * scale - sLse[r]) : 0.0f;
      sDS[r * LDP + c] = __float2bfloat16(p * (sDP[r * LDS + c] - sDelta[r]));
    }
    __syncwarp();

    accumulate_p_times_tile<D>(dq_acc, sDS + wr * LDP, sK);  // dq += ds k
  }
  __syncwarp();
  store_rows<D>(dq, dq_acc, sS + wr * LDS, q0 + wr, q_len, scale);
}

template <int D> constexpr size_t bwd_dq_smem() {
  using T = Tile<D>;
  return 4 * T::BF16_TILE + T::P_TILE + 2 * T::S_TILE + 3 * T::ROWS;
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers (bound from Python with ctypes). head_dim 64 is instantiated;
// any other head_dim returns cudaErrorInvalidValue. The forward and dK/dV
// launchers encode one tensor map per bf16 input on the host, per launch.
// ---------------------------------------------------------------------------

extern "C" cudaError_t flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                                      void* lse, int batch_heads, int heads, int q_len, int kv_len,
                                      int head_dim, int causal, float scale, void* stream) {
  if (head_dim != 64) return cudaErrorInvalidValue;
  constexpr int D = 64;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err;
  if ((err = sm90_host::make_map_3d(&tm_q, q, batch_heads, q_len, D)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_k, k, batch_heads, kv_len, D)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_v, v, batch_heads, kv_len, D)) != cudaSuccess) return err;
  constexpr size_t smem = FwdSmem<D>::ALLOC;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + BLOCK - 1) / BLOCK, batch_heads);
  flash_fwd_kernel<D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, (const int*)mask, (bf16*)o, (float*)lse, heads, q_len, kv_len, causal, scale);
  return cudaGetLastError();
}

extern "C" cudaError_t flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                          const void* lse, const void* delta, const void* mask, void* dk,
                                          void* dv, int batch_heads, int heads, int q_len, int kv_len,
                                          int head_dim, int causal, float scale, void* stream) {
  if (head_dim != 64) return cudaErrorInvalidValue;
  constexpr int D = 64;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = sm90_host::make_map_3d(&tm_q, q, batch_heads, q_len, D)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_k, k, batch_heads, kv_len, D)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_v, v, batch_heads, kv_len, D)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_do, dout, batch_heads, q_len, D)) != cudaSuccess) return err;
  constexpr size_t smem = DkvSmem<D>::ALLOC;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((kv_len + BLOCK - 1) / BLOCK, batch_heads);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta, (const int*)mask, (bf16*)dk, (bf16*)dv,
      heads, q_len, kv_len, causal, scale);
  return cudaGetLastError();
}

extern "C" cudaError_t flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                         const void* lse, const void* delta, const void* mask, void* dq,
                                         int batch_heads, int heads, int q_len, int kv_len, int head_dim,
                                         int causal, float scale, void* stream) {
  if (head_dim != 64) return cudaErrorInvalidValue;
  constexpr int D = 64;
  constexpr size_t smem = bwd_dq_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + BLOCK - 1) / BLOCK, batch_heads);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)mask, (bf16*)dq, heads, q_len, kv_len, causal, scale);
  return cudaGetLastError();
}
