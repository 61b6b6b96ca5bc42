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
// Which unit multiplies. All three kernels multiply on the tensor cores, in
// 3xTF32 (mma.sync.m16n8k8 .tf32, the Sm80 tensor-op instruction, which Hopper
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
// memory, and four of the seven products (O = P V in the forward, dV = P^T
// dO, dK = dS^T Q, dQ = dS K) read their B operand N-major from the row-major
// [seq][D] tensors; mma.sync fragments are gathered by each thread from any
// layout.
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous [batch*heads, seq, D]
// float32; lse and delta [batch*heads, q_len] float32; the key-padding mask
// [batch, kv_len] int32 (or null). Causal calls need kv_len == q_len.
//
// Grids. Head_dim D is a runtime argument of every kernel (any multiple of 32
// from 64 on whose slices below are 64 columns or more: 64, 96, 128, 256 and
// every multiple of 128). A CTA of 16 warps (512 threads) owns one 64-row tile
// (of queries for the forward and dQ, of keys for dK/dV) and one slice of the
// output columns; the grid is (slices, tiles, batch x heads).
// - The forward's slice is all of D up to FWD_SLICE = 512 columns (an
//   instantiation at each of 64, 96 and 128, and one at 512 for every D
//   above), so the CTA of a query tile forms each 64 x 64 score tile once,
//   over all of D, and no two CTAs form the same one; only past 512 columns
//   do the slices of a tile (512 columns each, the last one fewer) each form
//   it again, which bounds the accumulators for any D.
// - The backward kernels' slice is at most SLICE = 128 columns, so neither
//   the accumulators nor shared memory grow with D. Each CTA computes the
//   whole 64 x 64 score tile over all of D itself, from 64-column panels of
//   both operands, then forms only its slice's products; the slices of one
//   tile run the same instructions on the same data in the same order, so
//   they agree on every score bit for bit.
// The work of a CTA is a sequence of stages, each one cp.async group in one
// of two shared buffers: per streamed tile, score stages (panels of both
// operands) and then slice stages (the V, K, or dO and Q rows of the slice).
// The next stage's copies start before the current stage is computed. P and
// dS pass to the slice products through shared memory. No atomics: every
// output element is written once, by one thread, so two runs agree bit for
// bit.
//
// Bound on the H100, at the 410M CE shape (48 x 16 heads, 336 tokens,
// head_dim 64, causal): the kept pairs' products are ~11 GFLOP for the
// forward, three times over in 3xTF32 at the 495 TFLOP/s of TF32: ~0.07 ms,
// where moving its bytes takes ~0.08 ms; the backward kernels do 2x and 1.5x
// the forward's products: ~0.13 and ~0.10 ms, where moving their bytes takes
// ~0.12 and ~0.10 ms. Each kernel's design note says what it does about its
// bound; PERF.md has their times (scripts/flash_variants.py --dtype float32
// compares versions of this file on the card).
//
// Nothing is allocated on the device here: the Python wrapper allocates the
// outputs, and every launch goes on the stream it is given.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;                  // rows of a query tile and of a key tile
constexpr int MMA_THREADS = 512;           // every kernel's: 16 warps
constexpr int SLICE = 128;                 // most output columns of a backward CTA, and of a piece of the forward's
constexpr int FWD_SLICE = 512;             // most output columns of a forward CTA
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

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
// The forward at slices of SW columns (SW = head_dim up to 128, else FWD_SLICE): at SW = 64 and 96 two
// CTAs an SM, each with ~108 KB of shared memory and at most 64 registers a thread, whose score stages
// hold 64 head_dim columns of the Q and K tiles (COLS); at SW = 128 and 512 one CTA an SM with 128
// registers a thread (the 16 or 64 output accumulators), whose score stages hold 128 columns. Shared
// memory: Q, K panels or a V piece; the two halves of S (the first then P); alpha and l of the query
// tile's rows, then the key tile's mask, by tile parity
template <int SW> struct FwdShape {
  static constexpr int CTAS = SW < SLICE ? 2 : 1;  // CTAs an SM
  static constexpr int COLS = SW < SLICE ? MMA_PANEL_COLS : SLICE;
  static constexpr int LD = COLS + 8;
  static constexpr int PANEL = BLOCK * LD;
  using Mem = Smem<2 * PANEL, MMA_SLICE_TILE, 2, MMA_PTILE, 4 * BLOCK>;
};
// K, Q, V, dO panels or dO, Q slices; S^T then P^T, dP^T then dS^T; lse and delta of the query
// tile, by tile parity
using DkvSmem = Smem<4 * MMA_PANEL, 2 * MMA_SLICE_TILE, 2, MMA_PTILE, 4 * BLOCK>;
// Q, K, dO, V panels or a K slice; S, dP then dS; the key tile's mask, by tile parity
using DqSmem = Smem<4 * MMA_PANEL, MMA_SLICE_TILE, 2, MMA_PTILE, 2 * BLOCK>;

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
template <int LD, int NTHREADS, int COLS>
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
// 3xTF32 tensor-core products
//
// A CTA of 16 warps. In a backward score stage, warps 0-7 form the first
// product (S or S^T) and warps 8-15 the second (dP or dP^T), each warp a 16 x 32 share
// of its 64 x 64 tile (rows 16 ((w / 2) % 4), columns 32 (w % 2)). In dK/dV's
// slice stage warps 0-7 form dV and warps 8-15 dK, each warp rows 16 ((w / 2)
// % 4) and the 32-column groups 2 h + w % 2 below w (pair_product_mma); in
// dQ's every warp forms a 16 x 32 share of the 64 x w output: rows 16 (w /
// 4), the 32-column group w % 4; at w = 64 the warps of groups 2 and 3 take
// groups 0 and 1 over the second half of the 64 k, and their sums are added
// in at the end; at w = 96 group 3 has none (slice_product_mma). The
// forward's score stage takes the shares of a backward one, its two halves
// of the stage's columns in place of the two products; its P V the shares
// of out_col (its design note says how). Fragments
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

// The forward's output shares: of a piece NT x 32 columns wide (NT = 2, 3 or 4: the 64-, 96- and
// 128-column slices), warp w holds rows 16 (w / 4) + g (+ 8) of the columns from col = 8 NT (w % 4); its
// n-tile jj's column g is column col + NT g + jj, so its accumulators hold columns col + 2 NT t .. + 2 NT
// - 1 of rows g and g + 8 (c0, c2 of n-tile jj at + jj; c1, c3 at + NT + jj).
template <int NT> __device__ __forceinline__ int out_col() { return 8 * NT * (warp_id() & 3); }
__device__ __forceinline__ int out_row() { return 16 * (warp_id() >> 2); }

// b = NT consecutive floats from p: one 64- or 128-bit read at NT = 2 or 4, so that the B reads of a
// share's k-row hit 32 banks a phase (rows t at a stride == 8 mod 32, columns NT g), and three at NT = 3
// (banks 8 t + 3 g + jj: 32 different banks in a warp)
template <int NT> __device__ __forceinline__ void load_cols(float (&b)[NT], const float* p) {
  if constexpr (NT == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
  } else if constexpr (NT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    b[0] = v.x, b[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < NT; ++i) b[i] = p[i];
  }
}

// O_piece = alpha O_piece + P V_piece: acc = acc alpha + the warp's share of X Y over the 64 keys (X the P
// tile, Y a staged V piece of row stride MMA_SLICE_LD), alpha_lo in its rows g, alpha_hi in rows g + 8;
// k-slots t, t + 4 of the step from k are keys k + t, k + t + 4, so a thread's B values of one key are
// NT consecutive floats. The products of the piece form one chain from zero; to hold the registers of
// the output accumulators, the k-steps are not unrolled and each n-tile's B pair is split just before
// its three products.
template <int NT>
__device__ __forceinline__ void pv_piece_mma(float (&acc)[NT][4], const float* x, const float* y, float alpha_lo,
                                             float alpha_hi) {
  const int g = lane_g(), t = lane_t();
  const float* xr = x + (out_row() + g) * MMA_TILE_LD + t;
  const float* yr = y + t * MMA_SLICE_LD + out_col<NT>() + NT * g;
  float part[NT][4];
  zero(part);
#pragma unroll 1
  for (int k = 0; k < BLOCK; k += 8) {
    const FragA fa = frag_a_slice<MMA_TILE_LD>(xr, k);
    float b0[NT], b1[NT];
    load_cols<NT>(b0, yr + k * MMA_SLICE_LD);
    load_cols<NT>(b1, yr + (k + 4) * MMA_SLICE_LD);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      const FragB fb = frag_b(b0[jj], b1[jj]);
      mma_tf32(part[jj], fa.small, fb.big);
      mma_tf32(part[jj], fa.big, fb.small);
      mma_tf32(part[jj], fa.big, fb.big);
    }
  }
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    acc[jj][0] = acc[jj][0] * alpha_lo + part[jj][0];
    acc[jj][1] = acc[jj][1] * alpha_lo + part[jj][1];
    acc[jj][2] = acc[jj][2] * alpha_hi + part[jj][2];
    acc[jj][3] = acc[jj][3] * alpha_hi + part[jj][3];
  }
}

// The warp's share of an output piece divided by l_lo in rows g and by l_hi in rows g + 8, into rows
// row0 + out_row() + g (+ 8) below n_rows and columns c0 + out_col() + 2 NT t .. of a [.][d] matrix.
template <int NT>
__device__ __forceinline__ void store_piece(float* __restrict__ dst, const float (&acc)[NT][4], int row0, int n_rows,
                                            int d, int c0, float l_lo, float l_hi) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + out_row() + g + 8 * half;
    if (row >= n_rows) continue;
    const int e = 2 * half;
    const float l = half ? l_hi : l_lo;
    float out[2 * NT];
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) out[jj] = acc[jj][e] / l, out[NT + jj] = acc[jj][e + 1] / l;
    float* p = dst + (size_t)row * d + c0 + out_col<NT>() + 2 * NT * t;
#pragma unroll
    for (int i = 0; i < NT; ++i) *reinterpret_cast<float2*>(p + 2 * i) = make_float2(out[2 * i], out[2 * i + 1]);
  }
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

// ---------------------------------------------------------------------------
// Forward. Replaces _flash_kernel (mafed_tpu/kernels/attention.py:81-153) at
// float32. The CTA owns a query tile and a slice of SW output columns (SW =
// head_dim for D = 64, 96 and 128, else FWD_SLICE = 512); per key tile:
// ceil(D / COLS) score stages (COLS columns of the Q and K tiles each), the
// online softmax of the 64 x 64 score tile into P, then a stage for each
// 128-column piece of the slice: O_piece = alpha O_piece + P V_piece; o = O /
// l at the end.
// Design: every product in 3xTF32 on the tensor cores, the score tile formed
// once over all of D (bound ~0.08 ms by bytes at the 410M CE shape). In a
// score stage warps 0-7 sum the first half of the stage's columns and warps
// 8-15 the second, each warp a 16 x 32 share of the tile as a fresh chain
// (score_half_mma) that it adds to its half's running sums in shared memory
// (the first stage of a tile stores them); every reader takes S as the first
// half plus the second. The softmax pass runs on all 512 threads, eight a row
// (8 keys each; a row's max and sum are three shuffles, whose xor pairs give
// each of the eight the same bits): the row's m and l stay in the registers of
// its eight threads, P goes over the first half's sums and the row's alpha to
// shared memory. In a piece's stage every warp forms a share of P V_piece, 16
// rows by a quarter of the piece's columns (out_col), over all 64 keys as a
// fresh chain, added to its accumulators times alpha. The accumulators are
// SW / 32 x 4 floats a thread (64 at SW = 512, within the 128 registers of 512
// threads). The instantiations of D up to 128 have every width as a constant;
// at 64 and 96 two CTAs share an SM (64 registers, 64-column score stages,
// ~108 KB of shared memory each), so that one CTA's loads and softmax overlap
// the other's products (PERF.md has the variants' times); at 128 and 512 one
// CTA holds an SM (~171 KB: two stages of 128-column Q and K panels or a V
// piece, the two score halves, alpha and l of the rows and the key tile's
// mask). Slice 0 writes lse.
// ---------------------------------------------------------------------------

// part = the warp's 16 x 32 share of Q K^T over columns k_begin .. k_end - 1 of a score stage (a Q and
// a K panel of row stride LD): rows score_row() + g (+ 8) of Q; n-tile j's column g is key score_col()
// + 8 j + g; k-slots t, t + 4 of the step from k are columns k + 2t, k + 2t + 1 of both.
template <int LD>
__device__ __forceinline__ void score_half_mma(float (&part)[4][4], const float* buf, int k_begin, int k_end) {
  const int g = lane_g(), t = lane_t();
  const float* ar = buf + (score_row() + g) * LD + 2 * t;
  const float* br = buf + BLOCK * LD + (score_col() + g) * LD + 2 * t;
  zero(part);
#pragma unroll 2
  for (int k = k_begin; k < k_end; k += 8) {
    const FragA fa = frag_a<LD>(ar, k);
    FragB fb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(br + 8 * j * LD + k);
      fb[j] = frag_b(v.x, v.y);
    }
    mma3(part, fa, fb);
  }
}

template <int SW>
__global__ void __launch_bounds__(MMA_THREADS, FwdShape<SW>::CTAS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const int* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int heads,
                     int q_len, int kv_len, int head_dim, int causal, float scale) {
  constexpr int PIECES = SW <= SLICE ? 1 : SW / SLICE, COLS = FwdShape<SW>::COLS, LD = FwdShape<SW>::LD;
  constexpr int NT = SW <= SLICE ? SW / 32 : 4;  // n-tiles of a warp's share of a piece
  using FwdSmem = typename FwdShape<SW>::Mem;
  // up to 128 columns the instantiation is of head_dim itself: one slice, every width a constant
  const int d = SW <= SLICE ? SW : head_dim, slice = SW <= SLICE ? 0 : blockIdx.x;
  const int qt = blockIdx.y, bh = blockIdx.z;
  const int c0 = slice * SW, w = min(SW, d - c0), q0 = qt * BLOCK;
  q += (size_t)bh * q_len * d;
  k += (size_t)bh * kv_len * d;
  v += (size_t)bh * kv_len * d;
  o += (size_t)bh * q_len * d;
  lse += (size_t)bh * q_len;
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * kv_len;

  extern __shared__ __align__(16) float smem[];
  float* const s_lo = smem + FwdSmem::TILE0;  // the first half's sums of S, then P
  float* const s_hi = s_lo + MMA_PTILE;       // the second half's
  float* const row_alpha = smem + FwdSmem::VEC0;
  float* const row_l = row_alpha + BLOCK;
  int* const kmask = reinterpret_cast<int*>(row_l + BLOCK);  // [tile parity][64]
  const int n_kt = (kv_len + BLOCK - 1) / BLOCK;
  const int upper = causal ? min(qt + 1, n_kt) : n_kt;
  const int ns = (d + COLS - 1) / COLS;  // score stages a key tile
  const int per_tile = ns + (w + SLICE - 1) / SLICE, n_stages = upper * per_tile;

  auto load_stage = [&](int st) {
    const int kt = st / per_tile, p = st - kt * per_tile;
    float* buf = smem + (st & 1) * FwdSmem::STAGE;
    if (p < ns) {
      const int col = p * COLS, sc = min(COLS, d - col);
      load_slice<LD, MMA_THREADS>(buf, q, q0, q_len, d, col, sc);
      load_slice<LD, MMA_THREADS>(buf + BLOCK * LD, k, kt * BLOCK, kv_len, d, col, sc);
      if (p == 0 && mask_row != nullptr && threadIdx.x < BLOCK) {  // the key tile's mask (0 past kv_len)
        const int key = kt * BLOCK + threadIdx.x;
        cp_async4(kmask + (kt & 1) * BLOCK + threadIdx.x, key < kv_len ? mask_row + key : mask_row, key < kv_len);
      }
    } else {
      const int col = c0 + (p - ns) * SLICE;
      load_slice<MMA_SLICE_LD, MMA_THREADS>(buf, v, kt * BLOCK, kv_len, d, col, min(SLICE, c0 + w - col));
    }
    cp_async_commit();
  };

  const int g = lane_g(), t = lane_t();
  const int r_loc = score_row() + g, c_loc = score_col() + 2 * t;  // the thread's first score row, column
  float* const s_mine = first_product() ? s_lo : s_hi;            // the half the warp sums
  // the softmax pass: the thread's query row and its columns 4 (tid % 8) + 32 h .. + 3
  const int e_row = threadIdx.x >> 3, e_col = 4 * (threadIdx.x & 7), row = q0 + e_row;
  const int o_row = out_row() + g;  // the warp's output rows: o_row and o_row + 8
  float m = -INFINITY, l = 0.0f;    // row e_row's
  float acc[PIECES][NT][4];
#pragma unroll
  for (int pp = 0; pp < PIECES; ++pp) zero(acc[pp]);

  if (n_stages > 0) load_stage(0);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed, and every thread is done with stage st - 1
    if (st + 1 < n_stages) load_stage(st + 1);
    const int kt = st / per_tile, p = st - kt * per_tile;
    const float* buf = smem + (st & 1) * FwdSmem::STAGE;
    if (p >= ns) {  // O_piece = alpha O_piece + P V_piece
      const int piece = p - ns;
      const float a_lo = row_alpha[o_row], a_hi = row_alpha[o_row + 8];
#pragma unroll
      for (int pp = 0; pp < PIECES; ++pp)
        if (pp == piece) pv_piece_mma<NT>(acc[pp], s_lo, buf, a_lo, a_hi);
      continue;
    }
    const int sc = min(COLS, d - p * COLS), half = sc >> 1;
    float part[4][4];
    score_half_mma<LD>(part, buf, first_product() ? 0 : half, first_product() ? half : sc);
    // accumulator (j, 2 hf + e) is row r_loc + 8 hf, key c_loc + 8 j + e: into the half's running sums
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float2* at = reinterpret_cast<float2*>(s_mine + (r_loc + 8 * hf) * MMA_TILE_LD + c_loc + 8 * j);
        float2 x = make_float2(part[j][2 * hf], part[j][2 * hf + 1]);
        if (p > 0) {
          const float2 sum = *at;
          x = make_float2(sum.x + x.x, sum.y + x.y);
        }
        *at = x;
      }
    if (p + 1 < ns) continue;
    __syncthreads();
    // the tile's online softmax, as _flash_kernel's body: row e_row, keys e_col + 32 h + i
    const int* const km = kmask + (kt & 1) * BLOCK;
    float s[8];
    bool kp[8];
    float mx = NEG;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = e_col + 32 * h, at = e_row * MMA_TILE_LD + c;
      const float4 lo4 = *reinterpret_cast<const float4*>(s_lo + at);
      const float4 hi4 = *reinterpret_cast<const float4*>(s_hi + at);
      const float lo[4] = {lo4.x, lo4.y, lo4.z, lo4.w}, hi[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kt * BLOCK + c + i, n = 4 * h + i;
        kp[n] = key < kv_len && (mask_row == nullptr || km[c + i] > 0) && (!causal || key <= row);
        s[n] = kp[n] ? (lo[i] + hi[i]) * scale : NEG;
        mx = fmaxf(mx, s[n]);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n] = kp[n] ? expf(s[n] - m_new) : 0.0f;
      sum += s[n];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(s_lo + e_row * MMA_TILE_LD + e_col + 32 * h) =
          make_float4(s[4 * h], s[4 * h + 1], s[4 * h + 2], s[4 * h + 3]);
    if ((threadIdx.x & 7) == 0) row_alpha[e_row] = alpha;
  }

  // o = acc / l, as _flash_kernel (l of the warp's rows through shared memory); slice 0 writes lse
  const float l_safe = l == 0.0f ? 1.0f : l;
  if ((threadIdx.x & 7) == 0) {
    row_l[e_row] = l_safe;
    if (slice == 0 && row < q_len) lse[row] = l == 0.0f ? INFINITY : m + logf(l_safe);
  }
  __syncthreads();
  const float l_lo = row_l[o_row], l_hi = row_l[o_row + 8];
#pragma unroll
  for (int pp = 0; pp < PIECES; ++pp)
    if (pp * SLICE < w) store_piece<NT>(o, acc[pp], q0, q_len, d, c0 + pp * SLICE, l_lo, l_hi);
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

__host__ __forceinline__ dim3 f32_grid(int head_dim, int len, int batch_heads, int slice = SLICE) {
  return dim3((head_dim + slice - 1) / slice, (len + BLOCK - 1) / BLOCK, batch_heads);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The forward at slices of SW columns: head_dim itself up to 128, else FWD_SLICE
template <int SW>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
                           int batch_heads, int heads, int q_len, int kv_len, int head_dim, int causal,
                           float scale, void* stream) {
  constexpr size_t bytes = FwdShape<SW>::Mem::BYTES;
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<SW>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<SW><<<f32_grid(head_dim, q_len, batch_heads, SW), MMA_THREADS, bytes,
                             (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)mask, (float*)o, (float*)lse, heads, q_len,
      kv_len, head_dim, causal, scale);
  return cudaGetLastError();
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
  auto launch = head_dim == 64 ? launch_fwd_f32<64> : head_dim == 96 ? launch_fwd_f32<96>
              : head_dim == SLICE ? launch_fwd_f32<SLICE> : launch_fwd_f32<FWD_SLICE>;
  return launch(q, k, v, mask, o, lse, batch_heads, heads, q_len, kv_len, head_dim, causal, scale, stream);
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
