// Flash attention for Hopper (sm_90a) at float32 inputs: forward, dK/dV and dQ kernels.
//
// Counterparts of the three Pallas kernels in mafed_tpu/kernels/attention.py
// (_flash_kernel :81, _flash_bwd_dkv_kernel :230, _flash_bwd_dq_kernel :294)
// when they are given float32 q, k, v (a `--compute_dtype float32` run). The
// Pallas bodies keep the matmul operands in the input dtype, so at float32
// every product is a float32 product. Numerics as the Pallas bodies at f32:
// the scale applied to the f32 product, masked scores filled with
// finfo(float32).min and probabilities zeroed where a key is not kept, the
// online max / sum with alpha = exp(m_prev - m_new), lse = +inf on rows with
// no kept key (their o is 0, their p 0), p and ds unrounded, dK and dQ scaled
// at the end. expf and logf are the accurate library functions (the build has
// no --use_fast_math).
//
// Which unit multiplies. The forward multiplies with float32 FMAs on the CUDA
// cores. The two backward kernels multiply on the tensor cores, in 3xTF32
// (mma.sync.m16n8k8 .tf32, the Sm80 tensor-op instruction, which Hopper
// keeps): each f32 operand x is split into big = x rounded to TF32 (as
// cvt.rna rounds it: 10 mantissa bits, nearest, ties away from zero) and
// small = x - big, which the tensor core reads truncated to TF32, and a
// product is summed as A_small B_big + A_big B_small + A_big B_big in f32, the
// small terms first, as CUTLASS's OpMultiplyAddFastF32 (PyTorch's
// memory-efficient attention at float32) orders them. One TF32 product keeps
// ~3 decimal digits; the split keeps f32's: big + small carries all but 2^-22
// of x, a product of two TF32 values is exact in f32, and the dropped small x
// small term is ~2^-22 of the product, so a sum is off by what f32
// accumulation gives plus a few 2^-21 of each product's size
// (tests/test_torch_tf32_split.py emulates the split on the CPU and bounds it
// against float64, a single TF32 product and the JAX package's kernels). The
// tensor core accumulates with truncation, so each stage's products start a
// fresh accumulator that a rounding FADD adds to the sums (split below).
// wgmma is not used: its 32-bit operands must both be K-major in shared
// memory, and three of the five backward products (dV = P^T dO, dK = dS^T Q,
// dQ = dS K) read their B operand N-major from the row-major [seq][D]
// tensors; mma.sync fragments are gathered by each thread from any layout.
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous [batch*heads, seq, D]
// float32; lse and delta [batch*heads, q_len] float32; the key-padding mask
// [batch, kv_len] int32 (or null). Causal calls need kv_len == q_len.
//
// Grid, shared by the three kernels. One instantiation per kernel, head_dim D
// a runtime argument (any multiple of 32 from 64 on whose slices below are 64
// columns or more: 64, 96, 128, 256 and every multiple of 128). The grid is
// (slices, tiles, batch x heads): a CTA (256 threads in the forward, 512 in
// the backward kernels) owns one 64-row tile (of queries for the forward and
// dQ, of keys for dK/dV) and one slice of at most SLICE = 128 output columns,
// so neither the accumulators nor shared memory grow with D. Each CTA
// computes the whole 64 x 64 score tile over all of D itself, from panels of
// both operands staged in shared memory (32 columns in the forward, 64 in
// the backward kernels), then forms only its slice's products; the slices of
// one tile run the same instructions on the same data in the same order, so
// they agree on every score (and in the forward on m and l) bit for bit, and
// slice 0 writes lse. The work is a sequence of stages, each one cp.async
// group in one of two shared buffers: per streamed tile, a score stage per
// panel (a panel of each operand) and then a slice stage (the V, K, or dO and
// Q rows of the slice). The next stage's copies start before the current
// stage is computed. P and dS pass to the slice products through shared
// memory. No atomics: every output element is written once, by one thread, so
// two runs agree bit for bit.
//
// Bound on the H100, at the 410M CE shape (48 x 16 heads, 336 tokens,
// head_dim 64, causal): the kept pairs' products are ~11 GFLOP for the
// forward, ~0.17 ms at the 67 TFLOP/s of the CUDA cores; the backward kernels
// do 2x and 1.5x the forward's products, three times over in 3xTF32, at 495
// TFLOP/s: ~0.13 and ~0.10 ms, where moving their bytes takes ~0.12 and ~0.10
// ms. Each kernel's design note says what it does about its bound; PERF.md
// has their times (scripts/flash_variants.py --dtype float32 compares
// versions of this file on the card).
//
// Nothing is allocated on the device here: the Python wrapper allocates the
// outputs, and every launch goes on the stream it is given.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;                  // rows of a query tile and of a key tile
constexpr int THREADS = 256;               // the forward's: 16 x 16
constexpr int MMA_THREADS = 512;           // the backward kernels': 16 warps
constexpr int SLICE = 128;                 // most output columns of one CTA
constexpr int PANEL_COLS = 32;             // head_dim columns of a staged score panel (the forward)
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

// The forward's strides. A panel row: 36 floats, nine 16-byte chunks, so that rows tx + 16 j of 8
// consecutive lanes start in 8 different 16-byte bank groups
constexpr int PANEL_LD = 36;
constexpr int PANEL = BLOCK * PANEL_LD;    // floats of one panel
constexpr int SLICE_TILE = BLOCK * SLICE;  // floats of one staged slice (rows of SLICE floats)
// Row stride of the P tile: 80 floats, so the rows ty + 16 i of a warp's two ty lie 16 banks apart
// and a warp's scalar stores of one (i, j) hit 32 different banks
constexpr int TILE_LD = 80;
constexpr int PTILE = BLOCK * TILE_LD;

// The backward kernels' panels are 64 head_dim columns wide (half the stages, and the barriers, of
// 32-column panels). Strides, for the mma fragments of lane (g, t) = (lane / 4, lane % 4), whose
// k-slots t and t + 4 of an 8-column step are columns 2t and 2t + 1 (one 64-bit read): a panel row
// 72 floats (== 8 mod 32), so the 64-bit reads of rows g, columns 2t of a half-warp hit 32 banks
constexpr int MMA_PANEL_COLS = 64;
constexpr int MMA_PANEL_LD = MMA_PANEL_COLS + 8;
constexpr int MMA_PANEL = BLOCK * MMA_PANEL_LD;
// In the slice products, k-slots t and t + 4 are k-rows t and t + 4 of B (and columns of A). A staged
// slice row: 136 floats (== 8 mod 32, as a panel's), so the 128-bit B reads of rows t, columns 4g ..
// 4g + 3 of a quarter-warp hit 32 banks, from a slice or from a panel
constexpr int MMA_SLICE_LD = 136;
constexpr int MMA_SLICE_TILE = BLOCK * MMA_SLICE_LD;
// A P or dS tile row: 68 floats (== 4 mod 32), so the A reads of rows g, columns t of a warp hit 32
// banks (the float2 stores of the score shares, rows g, columns 2t, two to a bank)
constexpr int MMA_TILE_LD = 68;
constexpr int MMA_PTILE = BLOCK * MMA_TILE_LD;

// Shared memory of each kernel, in floats: two stage buffers (each the larger of a score stage's
// panels and its slices), then the score tiles, then VEC floats of per-row vectors.
template <int PANELS_FLOATS, int SLICE_FLOATS, int TILES, int TILE_FLOATS, int VEC> struct Smem {
  static constexpr int STAGE = PANELS_FLOATS > SLICE_FLOATS ? PANELS_FLOATS : SLICE_FLOATS;
  static constexpr int TILE0 = 2 * STAGE;
  static constexpr int VEC0 = TILE0 + TILES * TILE_FLOATS;
  static constexpr size_t BYTES = (size_t)(VEC0 + VEC) * sizeof(float);
};
using FwdSmem = Smem<2 * PANEL, SLICE_TILE, 1, PTILE, 0>;  // Q, K panels; P
// K, Q, V, dO panels or dO, Q slices; S^T then P^T, dP^T then dS^T; lse and delta of the query
// tile, by tile parity
using DkvSmem = Smem<4 * MMA_PANEL, 2 * MMA_SLICE_TILE, 2, MMA_PTILE, 4 * BLOCK>;
// Q, K, dO, V panels or a K slice; S, dP then dS; the key tile's mask, by tile parity
using DqSmem = Smem<4 * MMA_PANEL, MMA_SLICE_TILE, 2, MMA_PTILE, 2 * BLOCK>;

__device__ __forceinline__ int thread_row() { return threadIdx.x >> 4; }  // ty
__device__ __forceinline__ int thread_col() { return threadIdx.x & 15; }  // tx

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes; src_size 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Columns col0 .. col0 + COLS - 1 of rows row0 .. row0 + 63 of a [len][d] matrix into a panel of row
// stride LD, by the NTHREADS threads of the CTA; rows at or past len and columns at or past d are
// zero-filled.
template <int LD, int NTHREADS, int COLS = PANEL_COLS>
__device__ __forceinline__ void load_panel(float* dst, const float* __restrict__ src, int row0, int len, int d,
                                           int col0) {
  for (int idx = threadIdx.x; idx < BLOCK * (COLS / 4); idx += NTHREADS) {
    const int r = idx / (COLS / 4), c = (idx % (COLS / 4)) * 4, row = row0 + r;
    const bool valid = row < len && col0 + c < d;
    cp_async16(dst + r * LD + c, valid ? src + (size_t)row * d + col0 + c : src, valid);
  }
}

// Columns c0 .. c0 + w - 1 of rows row0 .. row0 + 63 of a [len][d] matrix into a slice buffer of
// row stride LD, by the NTHREADS threads of the CTA; rows at or past len are zero-filled.
template <int LD, int NTHREADS>
__device__ __forceinline__ void load_slice(float* dst, const float* __restrict__ src, int row0, int len, int d,
                                           int c0, int w) {
  const int chunks = w >> 2;
  for (int idx = threadIdx.x; idx < BLOCK * chunks; idx += NTHREADS) {
    const int r = idx / chunks, c = (idx - r * chunks) * 4, row = row0 + r;
    const bool valid = row < len;
    cp_async16(dst + r * LD + c, valid ? src + (size_t)row * d + c0 + c : src, valid);
  }
}

__device__ __forceinline__ bool key_kept(const int* __restrict__ mask_row, int key, int kv_len) {
  return key < kv_len && (mask_row == nullptr || mask_row[key] > 0);
}

// ---------------------------------------------------------------------------
// CUDA-core products of the forward
// ---------------------------------------------------------------------------

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

// acc[i][h][c] += sum over the 64 rows k of X[ty + 16 i][k] Y[k][4 tx + 64 h + c]: X the P tile
// (TILE_LD), Y a staged slice w columns wide; the second column group only below w.
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
// matrix, row i divided by f[i]; the second group only below w.
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
      out.x = acc[i][h][0] / f[i];
      out.y = acc[i][h][1] / f[i];
      out.z = acc[i][h][2] / f[i];
      out.w = acc[i][h][3] / f[i];
      *reinterpret_cast<float4*>(dst + (size_t)row * d + c0 + 4 * tx + 64 * h) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core products of the backward kernels
//
// A CTA of 16 warps. In a score stage, warps 0-7 form the first product (S
// or S^T) and warps 8-15 the second (dP or dP^T), each warp a 16 x 32 share
// of its 64 x 64 tile (rows 16 ((w / 2) % 4), columns 32 (w % 2)). In dK/dV's
// slice stage warps 0-7 form dV and warps 8-15 dK, each warp rows 16 ((w / 2)
// % 4) and the 32-column groups 2 h + w % 2 below w (pair_product_mma); in
// dQ's every warp forms a 16 x 32 share of the 64 x w output: rows 16 (w /
// 4), the 32-column group w % 4; at w = 64 the warps of groups 2 and 3 take
// groups 0 and 1 over the second half of the 64 k, and their sums are added
// in at the end; at w = 96 group 3 has none (slice_product_mma). Fragments
// follow the PTX layout of mma.m16n8k8 (lane (g, t): A rows g and g + 8, B
// column g, C columns 2t and 2t + 1); which column or row of shared memory a
// k-slot or an n-slot reads is the kernel's choice, made so that each
// thread's values are one 64- or 128-bit read where the strides allow.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }
__device__ __forceinline__ bool first_product() { return warp_id() < 8; }            // a score stage's S (S^T)
__device__ __forceinline__ int score_row() { return 16 * ((warp_id() >> 1) & 3); }  // the warp's score rows
__device__ __forceinline__ int score_col() { return 32 * (warp_id() & 1); }         // and columns

template <int N> __device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.0f;
}

// x as big + small, TF32 values for the tensor core: big is x rounded as cvt.rna.tf32.f32 rounds a
// finite x (half of the dropped unit added to the bits, the 13 low bits cleared: two integer
// instructions, where cvt.rna's SASS adds a test for inf and NaN); small = x - big is exact in f32 and
// goes in with its low bits, which the tensor core does not read (a truncation to TF32: as accurate
// here as rounding it, and 4-6 % faster; PERF.md).
struct Split {
  uint32_t big, small;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {big, __float_as_uint(x - __uint_as_float(big))};
}

// mma.sync sums its products and accumulator with truncation (toward zero), so an accumulator fed
// through a long chain of them drifts by up to an ulp of its size at each (measured: 7e-5 off the plain
// version at head_dim 512). So the products of each stage (at most 8 k-steps) form a chain of their
// own from zero, added to the float32 sums with a rounding FADD.

struct FragA {  // a0 .. a3 of one k-step: (row g, slot t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  uint32_t big[4], small[4];
};
struct FragB {  // b0, b1: (slot t, column g), (slot t + 4, column g)
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  const Split x = split(b0), y = split(b1);
  return {{x.big, y.big}, {x.small, y.small}};
}

// The A fragment of the 8 k-columns from k0 of rows g and g + 8 of xr's row (a row-major tile of row
// stride LD): slot t is column k0 + 2t, slot t + 4 column k0 + 2t + 1.
template <int LD>
__device__ __forceinline__ FragA frag_a(const float* xr, int k0) {
  const float2 lo = *reinterpret_cast<const float2*>(xr + k0);
  const float2 hi = *reinterpret_cast<const float2*>(xr + 8 * LD + k0);
  const Split x[4] = {split(lo.x), split(hi.x), split(lo.y), split(hi.y)};
  return {{x[0].big, x[1].big, x[2].big, x[3].big}, {x[0].small, x[1].small, x[2].small, x[3].small}};
}

// The A fragment of the slice products: the 8 k-columns from k0 of rows g and g + 8 of xr's row (a
// row-major tile of row stride LD), slot t column k0 + t, slot t + 4 column k0 + t + 4.
template <int LD>
__device__ __forceinline__ FragA frag_a_slice(const float* xr, int k0) {
  const Split x[4] = {split(xr[k0]), split(xr[8 * LD + k0]), split(xr[k0 + 4]), split(xr[8 * LD + k0 + 4])};
  return {{x[0].big, x[1].big, x[2].big, x[3].big}, {x[0].small, x[1].small, x[2].small, x[3].small}};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += A B[n] (n < N) in 3xTF32: A_small B_big, A_big B_small, then A_big B_big, each a pass over
// the N tiles, so that the HMMAs on one accumulator are N apart.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const FragA& a, const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.small, b[n].big);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.big, b[n].small);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.big, b[n].big);
}

template <int N> __device__ __forceinline__ void add_chain(float (&acc)[N][4], const float (&part)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
}

// acc[j] (j < 4) += the warp's 16 x 32 share of its product over one score stage's 64 columns: the
// stage holds panels A0, B0, A1, B1 and the product is A B^T of the first pair (warps 0-7) or of the
// second (warps 8-15). Rows score_row() + g (+ 8) of A; n-tile j's column g is row score_col() + 8 j + g
// of B, its k-slots the same columns as A's.
__device__ __forceinline__ void score_stage_mma(float (&acc)[4][4], const float* buf) {
  const int g = lane_g(), t = lane_t();
  const float* a = buf + (first_product() ? 0 : 2 * MMA_PANEL);
  const float* ar = a + (score_row() + g) * MMA_PANEL_LD + 2 * t;
  const float* br = a + MMA_PANEL + (score_col() + g) * MMA_PANEL_LD + 2 * t;
  float part[4][4];
  zero(part);
#pragma unroll
  for (int k = 0; k < MMA_PANEL_COLS; k += 8) {
    const FragA fa = frag_a<MMA_PANEL_LD>(ar, k);
    FragB fb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(br + 8 * j * MMA_PANEL_LD + k);
      fb[j] = frag_b(v.x, v.y);
    }
    mma3(part, fa, fb);
  }
  add_chain(acc, part);
}

// Where the warp's share of a w-wide output slice lies: its first column within the slice, and the
// first of the 32 (w = 64) or 64 k-rows it sums over; false where it has none (group 3 at w = 96).
__device__ __forceinline__ bool slice_share(int w, int& col, int& k_begin, int& k_end) {
  const int group = warp_id() & 3;
  if (w == 64) {
    col = 32 * (group & 1);
    k_begin = 32 * (group >> 1);
    k_end = k_begin + 32;
    return true;
  }
  col = 32 * group;
  k_begin = 0;
  k_end = BLOCK;
  return col < w;
}

// acc[jj] += the warp's share of X Y: X a P or dS tile (rows 16 (w / 4) + g (+ 8)), Y a staged slice
// or panel w columns wide of row stride LD, over the warp's k-rows. In the warp's 32-column group,
// n-tile jj's column g is column col + 4 g + jj of Y and k-slots t, t + 4 of the step from k are rows
// k + t, k + t + 4, so a thread's B values of one row are one 128-bit read, and its accumulators hold
// columns col + 8 t .. + 7 of rows g and g + 8 (c0, c2 of n-tile jj at + jj; c1, c3 at + 4 + jj).
template <int LD>
__device__ __forceinline__ void slice_product_mma(float (&acc)[4][4], const float* x, const float* y, int w) {
  int col, k_begin, k_end;
  if (!slice_share(w, col, k_begin, k_end)) return;
  const int g = lane_g(), t = lane_t();
  const float* xr = x + (16 * (warp_id() >> 2) + g) * MMA_TILE_LD + t;
  const float* yr = y + t * LD + col + 4 * g;
  float part[4][4];
  zero(part);
#pragma unroll 4
  for (int k = k_begin; k < k_end; k += 8) {
    const FragA fa = frag_a_slice<MMA_TILE_LD>(xr, k);
    const float4 v0 = *reinterpret_cast<const float4*>(yr + k * LD);
    const float4 v1 = *reinterpret_cast<const float4*>(yr + (k + 4) * LD);
    const FragB fb[4] = {frag_b(v0.x, v1.x), frag_b(v0.y, v1.y), frag_b(v0.z, v1.z), frag_b(v0.w, v1.w)};
    mma3(part, fa, fb);
  }
  add_chain(acc, part);
}

// acc[h][jj] += a warp's 16-row share of X Y over the 64 k, for products that 8 warps form together
// (the dK/dV kernel's dV and dK): X a P or dS tile (rows 16 wr + g (+ 8)), Y a staged slice or panel
// w columns wide of row stride LD. The warp takes the 32-column groups G = 2 h + wc below w; in group
// G, n-tile jj's column g is column 32 G + 4 g + jj of Y and k-slots t, t + 4 of the step from k are
// rows k + t, k + t + 4, so its accumulators hold columns 32 G + 8 t .. + 7 of rows g and g + 8 (c0,
// c2 of n-tile jj at + jj; c1, c3 at + 4 + jj).
template <int NT, int LD>
__device__ __forceinline__ void pair_steps(float (&acc)[2][4][4], const float* xr, const float* yr, int wc) {
  float part[NT][4];
  zero(part);
#pragma unroll 1
  for (int k = 0; k < BLOCK; k += 8) {
    const FragA fa = frag_a_slice<MMA_TILE_LD>(xr, k);
    FragB fb[NT];
#pragma unroll
    for (int h = 0; h < NT / 4; ++h) {
      const int col = 32 * (2 * h + wc);
      const float4 v0 = *reinterpret_cast<const float4*>(yr + k * LD + col);
      const float4 v1 = *reinterpret_cast<const float4*>(yr + (k + 4) * LD + col);
      fb[4 * h] = frag_b(v0.x, v1.x);
      fb[4 * h + 1] = frag_b(v0.y, v1.y);
      fb[4 * h + 2] = frag_b(v0.z, v1.z);
      fb[4 * h + 3] = frag_b(v0.w, v1.w);
    }
    mma3(part, fa, fb);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n / 4][n % 4][c] += part[n][c];
}

template <int LD>
__device__ __forceinline__ void pair_product_mma(float (&acc)[2][4][4], const float* x, const float* y, int w,
                                                 int wr, int wc) {
  const int g = lane_g(), t = lane_t();
  const float* xr = x + (wr + g) * MMA_TILE_LD + t;
  const float* yr = y + t * LD + 4 * g;
  if (32 * (2 + wc) < w) {
    pair_steps<8, LD>(acc, xr, yr, wc);
  } else {
    pair_steps<4, LD>(acc, xr, yr, wc);
  }
}

// The warp's share of a pair product (pair_product_mma's layout), times f, into rows row0 + wr + g
// (+ 8) below n_rows and columns c0 + 32 G + 8 t .. + 7 of a [.][d] matrix.
__device__ __forceinline__ void store_pair_mma(float* __restrict__ dst, const float (&acc)[2][4][4], int row0,
                                               int n_rows, int d, int c0, int w, float f, int wr, int wc) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = 32 * (2 * h + wc);
    if (col >= w) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wr + g + 8 * half;
      if (row >= n_rows) continue;
      const int e = 2 * half;
      const float4 lo = {acc[h][0][e] * f, acc[h][1][e] * f, acc[h][2][e] * f, acc[h][3][e] * f};
      const float4 hi = {acc[h][0][e + 1] * f, acc[h][1][e + 1] * f, acc[h][2][e + 1] * f, acc[h][3][e + 1] * f};
      float* p = dst + (size_t)row * d + c0 + col + 8 * t;
      *reinterpret_cast<float4*>(p) = lo;
      *reinterpret_cast<float4*>(p + 4) = hi;
    }
  }
}

// The warp's share of an output slice (slice_product_mma's layout), times f, into rows row0 + 16 (w /
// 4) + g (+ 8) below n_rows and columns c0 + col + 8 t .. + 7 of a [.][d] matrix. At w = 64 the sums of
// the second half of the k-rows pass through `scratch` (16 KB of shared memory that no thread reads
// any more) to the warps of the first, which store.
__device__ __forceinline__ void store_slice_mma(float* __restrict__ dst, float (&acc)[4][4], int row0,
                                                int n_rows, int d, int c0, int w, float f, float* scratch) {
  int col, k_begin, k_end;
  const bool has = slice_share(w, col, k_begin, k_end);
  if (w == 64) {
    // lanes of warp 4 r + 2 + h hand their 16 sums to the same lanes of warp 4 r + h
    float4* mine = reinterpret_cast<float4*>(scratch) + ((warp_id() >> 2) * 2 + (warp_id() & 1)) * 128 + 4 * (threadIdx.x & 31);
    __syncthreads();
    if (k_begin > 0) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) mine[jj] = make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
    }
    __syncthreads();
    if (k_begin > 0) return;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 o = mine[jj];
      acc[jj][0] += o.x, acc[jj][1] += o.y, acc[jj][2] += o.z, acc[jj][3] += o.w;
    }
  }
  if (!has) return;
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * (warp_id() >> 2) + g + 8 * half;
    if (row >= n_rows) continue;
    const int e = 2 * half;
    const float4 lo = {acc[0][e] * f, acc[1][e] * f, acc[2][e] * f, acc[3][e] * f};
    const float4 hi = {acc[0][e + 1] * f, acc[1][e + 1] * f, acc[2][e + 1] * f, acc[3][e + 1] * f};
    float* p = dst + (size_t)row * d + c0 + col + 8 * t;
    *reinterpret_cast<float4*>(p) = lo;
    *reinterpret_cast<float4*>(p + 4) = hi;
  }
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
// Design: CUDA-core FMAs, bound by operations (~0.17 ms at the 410M CE
// shape): thread (ty, tx) = (tid / 16, tid % 16) holds rows ty + 16 i (i < 4)
// of the query tile; in a score block the keys tx + 16 j (j < 4), so a row's
// 64 scores lie in the 16 lanes of one half-warp (row reductions are 4
// shuffles); in an output block the columns 4 tx + 64 h .. + 3 (h < 2, the
// second group only where the slice is wider than 64). Operands come from
// shared memory as 16-byte vectors.
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
      load_panel<PANEL_LD, THREADS>(buf, q, q0, q_len, d, p * PANEL_COLS);
      load_panel<PANEL_LD, THREADS>(buf + PANEL, k, kt * BLOCK, kv_len, d, p * PANEL_COLS);
    } else {
      load_slice<SLICE, THREADS>(buf, v, kt * BLOCK, kv_len, d, c0, w);
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
  store_block(o, acc, q0, q_len, d, c0, w, l_safe);  // o = acc / l, as _flash_kernel
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
// at float32. The CTA owns a key tile; per query tile: D / 64 score stages
// (K, Q, V and dO panels: S^T = K Q^T and dP^T = V dO^T), P^T = exp(S^T scale
// - lse) where kept and dS^T = P^T (dP^T - delta) into shared memory, then
// one stage of dV_s += P^T dO_s and dK_s += dS^T Q_s (at head_dim 64 in the
// score stage itself, from its dO and Q panels); dK scaled at the end.
// Design: every product in 3xTF32 on the tensor cores (bound ~0.13 ms by
// operations at the 410M CE shape at wgmma's 495 TFLOP/s, its bytes ~0.12
// ms; scripts/mma_tf32_rate.py measures the rate of the mma.sync issued
// here, PERF.md). 16 warps of at
// most 128 registers: a warp holds a 16 x 32 share of S^T (warps 0-7) or of
// dP^T (8-15), 16 floats a thread, and a 16-row share of the dV slice (0-7)
// or of the dK slice (8-15), 32 floats; the fragments are split into TF32
// pairs in registers as they are read, so shared memory keeps one f32 copy
// of each panel. The warps leave S^T and dP^T in their tiles, and all 16
// form P^T and dS^T from them in place, 8 elements a thread, with lse and
// delta of the query tile copied to shared memory with the tile's first
// stage; rows of S^T are keys, so P^T and dS^T are the A operands of the
// slice products as they lie.
// ---------------------------------------------------------------------------
template <int SW>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ mask, float* __restrict__ dk,
                         float* __restrict__ dv, int heads, int q_len, int kv_len, int d, int causal, float scale) {
  const int slice = blockIdx.x, kt = blockIdx.y, bh = blockIdx.z;
  const int c0 = slice * SW, w = min(SW, d - c0), k0 = kt * BLOCK;
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
  float* const dst = pt + MMA_PTILE;
  float* const vec = smem + DkvSmem::VEC0;  // [tile parity][lse, delta][64]
  const int n_qt = (q_len + BLOCK - 1) / BLOCK;
  const int first = causal ? kt : 0;  // causal: query tiles before the key tile see none of its keys
  // at head_dim 64 (one panel) a tile is one stage: dV and dK take dO and Q from its panels
  const int np = (d + MMA_PANEL_COLS - 1) / MMA_PANEL_COLS;
  const bool fused = np == 1;
  const int per_tile = fused ? 1 : np + 1, n_stages = (n_qt - first) * per_tile;

  auto load_stage = [&](int st) {
    const int tile = st / per_tile, p = st - tile * per_tile, q0 = (first + tile) * BLOCK;
    float* buf = smem + (st & 1) * DkvSmem::STAGE;
    if (p < np) {
      const int col = p * MMA_PANEL_COLS;
      load_panel<MMA_PANEL_LD, MMA_THREADS, MMA_PANEL_COLS>(buf, k, k0, kv_len, d, col);
      load_panel<MMA_PANEL_LD, MMA_THREADS, MMA_PANEL_COLS>(buf + MMA_PANEL, q, q0, q_len, d, col);
      load_panel<MMA_PANEL_LD, MMA_THREADS, MMA_PANEL_COLS>(buf + 2 * MMA_PANEL, v, k0, kv_len, d, col);
      load_panel<MMA_PANEL_LD, MMA_THREADS, MMA_PANEL_COLS>(buf + 3 * MMA_PANEL, dout, q0, q_len, d, col);
      if (p == 0 && threadIdx.x < 2 * BLOCK) {  // lse, delta of the tile's queries (0 past q_len)
        const int row = q0 + (threadIdx.x & (BLOCK - 1));
        const float* src = threadIdx.x < BLOCK ? lse : delta;
        cp_async4(vec + (tile & 1) * 2 * BLOCK + threadIdx.x, row < q_len ? src + row : src, row < q_len);
      }
    } else {
      load_slice<MMA_SLICE_LD, MMA_THREADS>(buf, dout, q0, q_len, d, c0, w);
      load_slice<MMA_SLICE_LD, MMA_THREADS>(buf + MMA_SLICE_TILE, q, q0, q_len, d, c0, w);
    }
    cp_async_commit();
  };

  const int g = lane_g(), t = lane_t();
  const int r_loc = score_row() + g, c_loc = score_col() + 2 * t;  // the thread's first score row, column
  // the element-wise pass: the thread's key row and its columns 4 (tid % 8) + 32 h .. + 3
  const int e_row = threadIdx.x >> 3, e_col = 4 * (threadIdx.x & 7);
  const bool e_key_ok = key_kept(mask_row, k0 + e_row, kv_len);
  // o_acc: the warp's 16-row share of the dV slice (warps 0-7) or of the dK slice (8-15); sp: its share
  // of S^T or of dP^T
  float o_acc[2][4][4], sp[4][4];
  zero(o_acc[0]);
  zero(o_acc[1]);

  if (n_stages > 0) load_stage(0);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed, and every thread is done with stage st - 1
    if (st + 1 < n_stages) load_stage(st + 1);
    const int tile = st / per_tile, p = st - tile * per_tile, q0 = (first + tile) * BLOCK;
    const float* buf = smem + (st & 1) * DkvSmem::STAGE;
    if (p == np) {  // dV_s += P^T dO_s (warps 0-7) and dK_s += dS^T Q_s (warps 8-15)
      const bool dv_warp = first_product();
      pair_product_mma<MMA_SLICE_LD>(o_acc, dv_warp ? pt : dst, buf + (dv_warp ? 0 : MMA_SLICE_TILE), w,
                                     16 * ((warp_id() >> 1) & 3), warp_id() & 1);
      continue;
    }
    if (p == 0) zero(sp);
    score_stage_mma(sp, buf);
    if (p + 1 < np) continue;
    // accumulator (j, 2 half + e) is key r_loc + 8 half, query c_loc + 8 j + e: S^T into pt, dP^T into dst
    float* const share = first_product() ? pt : dst;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(share + (r_loc + 8 * half) * MMA_TILE_LD + c_loc + 8 * j) =
            make_float2(sp[j][2 * half], sp[j][2 * half + 1]);
    __syncthreads();
    const float* const lv = vec + (tile & 1) * 2 * BLOCK;
    const int key = k0 + e_row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = e_col + 32 * h, at = e_row * MMA_TILE_LD + c;
      float4 s4 = *reinterpret_cast<const float4*>(pt + at), d4 = *reinterpret_cast<const float4*>(dst + at);
      const float4 l4 = *reinterpret_cast<const float4*>(lv + c), de4 = *reinterpret_cast<const float4*>(lv + BLOCK + c);
      float* sv = &s4.x;
      float* dv4 = &d4.x;
      const float* lse_v = &l4.x;
      const float* delta_v = &de4.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + c + i;  // the query of this column
        const bool kp = row < q_len && e_key_ok && (!causal || key <= row);
        const float pij = kp ? expf(sv[i] * scale - lse_v[i]) : 0.0f;
        sv[i] = pij;
        dv4[i] = pij * (dv4[i] - delta_v[i]);
      }
      *reinterpret_cast<float4*>(pt + at) = s4;
      *reinterpret_cast<float4*>(dst + at) = d4;
    }
    if (fused) {  // dV_s += P^T dO and dK_s += dS^T Q from the stage's dO and Q panels
      __syncthreads();
      const bool dv_warp = first_product();
      pair_product_mma<MMA_PANEL_LD>(o_acc, dv_warp ? pt : dst, buf + (dv_warp ? 3 : 1) * MMA_PANEL, w,
                                     16 * ((warp_id() >> 1) & 3), warp_id() & 1);
    }
  }

  if (first_product()) {
    store_pair_mma(dv, o_acc, k0, kv_len, d, c0, w, 1.0f, 16 * ((warp_id() >> 1) & 3), warp_id() & 1);
  } else {
    store_pair_mma(dk, o_acc, k0, kv_len, d, c0, w, scale, 16 * ((warp_id() >> 1) & 3), warp_id() & 1);
  }
}

// ---------------------------------------------------------------------------
// dQ. Replaces _flash_bwd_dq_kernel (mafed_tpu/kernels/attention.py:294) at
// float32. The CTA owns a query tile; per key tile: D / 64 score stages (Q, K,
// dO and V panels: S = Q K^T and dP = dO V^T), dS = P (dP - delta) into shared
// memory, then one stage of dQ_s += dS K_s (at head_dim 64 in the score stage
// itself, from its K panel); dQ scaled at the end.
// Design: as dK/dV's, 3xTF32 on the tensor cores in 16 warps (bound ~0.10 ms
// at the 410M CE shape, by bytes); a warp holds a 16 x 32 share of S or dP
// and of the dQ slice; the element-wise pass forms dS from the S and dP
// tiles, with the key tile's mask copied to shared memory with its first
// stage and lse and delta of the thread's query row in registers.
// ---------------------------------------------------------------------------
template <int SW>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const int* __restrict__ mask, float* __restrict__ dq,
                        int heads, int q_len, int kv_len, int d, int causal, float scale) {
  const int slice = blockIdx.x, qt = blockIdx.y, bh = blockIdx.z;
  const int c0 = slice * SW, w = min(SW, d - c0), q0 = qt * BLOCK;
  q += (size_t)bh * q_len * d;
  dout += (size_t)bh * q_len * d;
  dq += (size_t)bh * q_len * d;
  k += (size_t)bh * kv_len * d;
  v += (size_t)bh * kv_len * d;
  lse += (size_t)bh * q_len;
  delta += (size_t)bh * q_len;
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * kv_len;

  extern __shared__ __align__(16) float smem[];
  float* const stile = smem + DqSmem::TILE0;  // S
  float* const dst = stile + MMA_PTILE;       // dP, then dS
  int* const kmask = reinterpret_cast<int*>(smem + DqSmem::VEC0);  // [tile parity][64]
  const int n_kt = (kv_len + BLOCK - 1) / BLOCK;
  const int upper = causal ? min(qt + 1, n_kt) : n_kt;
  // at head_dim 64 (one panel) a tile is one stage: dQ takes K from its panel
  const int np = (d + MMA_PANEL_COLS - 1) / MMA_PANEL_COLS;
  const bool fused = np == 1;
  const int per_tile = fused ? 1 : np + 1, n_stages = upper * per_tile;

  auto load_stage = [&](int st) {
    const int kt = st / per_tile, p = st - kt * per_tile;
    float* buf = smem + (st & 1) * DqSmem::STAGE;
    if (p < np) {
      const int col = p * MMA_PANEL_COLS;
      load_panel<MMA_PANEL_LD, MMA_THREADS, MMA_PANEL_COLS>(buf, q, q0, q_len, d, col);
      load_panel<MMA_PANEL_LD, MMA_THREADS, MMA_PANEL_COLS>(buf + MMA_PANEL, k, kt * BLOCK, kv_len, d, col);
      load_panel<MMA_PANEL_LD, MMA_THREADS, MMA_PANEL_COLS>(buf + 2 * MMA_PANEL, dout, q0, q_len, d, col);
      load_panel<MMA_PANEL_LD, MMA_THREADS, MMA_PANEL_COLS>(buf + 3 * MMA_PANEL, v, kt * BLOCK, kv_len, d, col);
      if (p == 0 && mask_row != nullptr && threadIdx.x < BLOCK) {  // the key tile's mask (0 past kv_len)
        const int key = kt * BLOCK + threadIdx.x;
        cp_async4(kmask + (kt & 1) * BLOCK + threadIdx.x, key < kv_len ? mask_row + key : mask_row, key < kv_len);
      }
    } else {
      load_slice<MMA_SLICE_LD, MMA_THREADS>(buf, k, kt * BLOCK, kv_len, d, c0, w);
    }
    cp_async_commit();
  };

  const int g = lane_g(), t = lane_t();
  const int r_loc = score_row() + g, c_loc = score_col() + 2 * t;  // the thread's first score row, column
  // the element-wise pass: the thread's query row and its columns 4 (tid % 8) + 32 h .. + 3
  const int e_row = threadIdx.x >> 3, e_col = 4 * (threadIdx.x & 7), row = q0 + e_row;
  const float row_lse = row < q_len ? lse[row] : INFINITY, row_delta = row < q_len ? delta[row] : 0.0f;
  float dq_acc[4][4], sp[4][4];  // sp: the warp's share of S or of dP
  zero(dq_acc);

  if (n_stages > 0) load_stage(0);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed, and every thread is done with stage st - 1
    if (st + 1 < n_stages) load_stage(st + 1);
    const int kt = st / per_tile, p = st - kt * per_tile;
    const float* buf = smem + (st & 1) * DqSmem::STAGE;
    if (p == np) {  // dQ_s += dS K_s
      slice_product_mma<MMA_SLICE_LD>(dq_acc, dst, buf, w);
      continue;
    }
    if (p == 0) zero(sp);
    score_stage_mma(sp, buf);
    if (p + 1 < np) continue;
    // accumulator (j, 2 half + e) is query r_loc + 8 half, key c_loc + 8 j + e: S into stile, dP into dst
    float* const share = first_product() ? stile : dst;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(share + (r_loc + 8 * half) * MMA_TILE_LD + c_loc + 8 * j) =
            make_float2(sp[j][2 * half], sp[j][2 * half + 1]);
    __syncthreads();
    const int* const km = kmask + (kt & 1) * BLOCK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = e_col + 32 * h, at = e_row * MMA_TILE_LD + c;
      const float4 s4 = *reinterpret_cast<const float4*>(stile + at);
      float4 d4 = *reinterpret_cast<const float4*>(dst + at);
      const float* sv = &s4.x;
      float* dv4 = &d4.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kt * BLOCK + c + i;
        const bool kp = key < kv_len && (mask_row == nullptr || km[c + i] > 0) && (!causal || key <= row);
        const float pij = kp ? expf(sv[i] * scale - row_lse) : 0.0f;
        dv4[i] = pij * (dv4[i] - row_delta);
      }
      *reinterpret_cast<float4*>(dst + at) = d4;
    }
    if (fused) {  // dQ_s += dS K from the stage's K panel
      __syncthreads();
      slice_product_mma<MMA_PANEL_LD>(dq_acc, dst, buf + MMA_PANEL, w);
    }
  }

  store_slice_mma(dq, dq_acc, q0, q_len, d, c0, w, scale, smem);
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
  flash_bwd_dkv_f32_kernel<SLICE><<<f32_grid(head_dim, kv_len, batch_heads), MMA_THREADS, DkvSmem::BYTES,
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
  flash_bwd_dq_f32_kernel<SLICE><<<f32_grid(head_dim, q_len, batch_heads), MMA_THREADS, DqSmem::BYTES,
                                   (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (const int*)mask, (float*)dq, heads, q_len, kv_len, head_dim, causal, scale);
  return cudaGetLastError();
}
