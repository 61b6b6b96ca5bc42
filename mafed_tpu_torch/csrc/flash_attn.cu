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
// Design. Each CTA owns one 64-row tile: of queries for the forward and dQ,
// of keys for dK/dV (the forward at 96, 128 and 256: FWD_WG_* query tiles).
// The other operands stream through shared memory in 64-row tiles, loaded by
// TMA through a 2-stage mbarrier ring. Every product
// is wgmma; scores, softmax statistics and accumulators stay in registers,
// and P and dS pass from one product's accumulator to the next product as
// register A fragments, never through shared memory (sm90.cuh holds the TMA,
// mbarrier and wgmma wrappers). The ragged end of a sequence is handled in
// every loop: rows past the end load as zeros, their keys are dropped from
// the keep bits, and their outputs are never stored.
//
// Head dims. Every kernel is a template over D (64, 96, 128 and 256 are
// instantiated) and over WG, the number of warpgroups (128 threads each) in
// the CTA. A thread of a warpgroup holds D / 2 f32 of a 64-row x D
// accumulator, so at D = 256 one accumulator is 128 registers of the 255 a
// thread may have.
//
// The forward at D = 96, 128 and 256 (fwd_cta) splits query rows over its
// warpgroups: a CTA holds FWD_WG_* warpgroups, each with its own 64-row query
// tile and all of its O, and each forms each 64 x 64 score tile once over all
// of D; the warpgroups share each K/V tile of the CTA's ring, so a CTA streams
// K and V once for all of its query tiles. Its tiles are [64][D] with nothing
// padded: at D = 96 three 32-column panels with the 64-byte swizzle (O += P V
// in one m64n96k16 a k-step), at 128 and 256 D / 64 panels of 64 columns
// (one m64n128k16 or m64n256k16 a k-step). At D = 64 a CTA is one warpgroup
// with one query tile.
//
// The dQ kernel at D = 256 is one warpgroup with all of dQ. At 64 and 128
// the dK/dV and dQ kernels are one warpgroup a 64-row tile over
// ceil(D / 64) panels of 64 columns (`panels`). dK/dV at 256 and 96 (dkv_cta,
// below) has a body of its own:
//
// dK/dV at D = 256 splits each score tile over its two warpgroups: dK and dV
// are 256 registers a thread together, so warpgroup w owns columns 128 w ..
// 128 w + 127 of both, and forms S^T and dP^T for queries 32 w .. 32 w + 31 of
// the tile only (m64n32k16 over all of D), so each score element is formed
// once in the CTA. The warpgroups then exchange P^T and dS^T, rounded to bf16
// as the next products read them, through two 8 KB panels of shared memory
// (an exchange of the f32 scores would not fit beside the 192 KB of tiles;
// the bf16 one does, ~210 KB in all), and each adds P^T dO and dS^T Q over
// all 64 queries into its columns.
//
// D = 96. The forward and dK/dV keep [64][96] tiles without padding: three
// 32-column panels with the 64-byte swizzle (12 KB a tile), the score products
// in 6 k-steps, the products into the 96 output columns (O += P V, dV += P^T
// dO, dK += dS^T Q) one m64n96k16 a k-step. The dQ kernel runs the D = 128
// tile: its tensor maps are 96 columns wide, so TMA fills columns 96..127 of
// the second panel with zeros (as it fills rows past a sequence's end); its
// score products stop at column 96 (6 of the 8 k-steps), and its product into
// the second 64-column panel of dQ runs columns 96..127 too, which come out
// zero and are never stored.
//
// The warpgroups of each kernel and head_dim are FWD_WG_*, DKV_WG_*, DQ_WG_*
// below.
//
// Every multiple of 128 from 384 on (a runtime head_dim) takes the wide
// kernels further down (flash_*_wide_kernel), whose shared memory and
// accumulators do not grow with D: the forward one CTA a query tile and a
// piece of up to 512 output columns, one warpgroup a 128-column slice of it,
// each score tile formed once (split over D, the partials summed through
// shared memory) up to 512 columns; dK/dV and dQ a grid axis over
// 128-column slices of the output, each slice forming the score tile
// itself.
//
// Nothing is allocated on the device here: the Python wrapper allocates the
// outputs, and every launch goes on the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BLOCK = 64;               // rows of a query tile and of a key tile
constexpr int WARPS = 4;                // each warp owns 16 rows of its warpgroup's tile
constexpr int THREADS = WARPS * 32;     // one warpgroup
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

// 64-column panels of a [64][D] tile: D = 96 is padded to two (dQ)
__host__ __device__ constexpr int panels(int d) { return (d + 63) / 64; }

// Warpgroups of the backward kernels at head_dim 256 (64 takes one
// everywhere). dK/dV: two, each forming the score columns of half the
// queries and owning half of dK and dV (dkv_cta). dQ: at the 1B CE shape
// [48, 8, 336, 256] on an H100 SXM at 700 W (scripts/flash_variants.py, each
// pair timed in turns) 0.182 ms with one against 0.200 with two.
constexpr int DKV_WG_256 = 2, DQ_WG_256 = 1;
// At head_dim 128 and 96, at the 1.4B CE shape [48, 16, 336, 128] and the
// GPT-NeoX-20B-width one [48, 64, 336, 96] (the same card and script, three
// rounds in turns): dK/dV at 128 0.224-0.247 ms with one warpgroup against
// 0.371-0.372 with two (two warpgroups of 168 registers fit one CTA per SM,
// one of 234 fits two); dQ 0.154-0.167 / 0.532-0.560 with one against
// 0.185-0.192 / 0.603-0.625 with two. dK/dV at 96 (dkv_cta): one warpgroup;
// at [48, 64, 336, 96] 0.70-0.74 ms (200 registers, two CTAs an SM) against
// 0.82-0.86 with two a CTA, each with its own 64-key tile and sharing each
// Q/dO tile (one CTA an SM, also with 3 or 4 stages), and 0.75-0.77 held to
// three CTAs an SM (168 registers, spills).
constexpr int DKV_WG_128 = 1, DQ_WG_128 = 1;
constexpr int DKV_WG_96 = 1, DQ_WG_96 = 1;
// The forward at 96, 128 and 256 (fwd_cta): FWD_WG_* warpgroups a CTA, each
// with its own 64-row query tile, sharing each K/V tile of a ring of STAGES
// stages. On an H100 SXM at 700 W (scripts/flash_variants.py,
// three rounds in turns), at the CE shape [48, 64, 336, 96]: 0.402-0.412 ms
// with two (~121 registers, 74 KB: two CTAs an SM), 0.404-0.408 with two and
// three stages, 0.481-0.486 with one (61 KB: three CTAs an SM), 0.564-0.566
// with one and three stages, 0.508 with three warpgroups. At [48, 16, 336,
// 128]: 0.129-0.134 with two held to 128 registers (97 KB: two CTAs an SM),
// 0.180-0.184 with two at 138 registers (one CTA an SM), 0.176-0.192 with
// two and three stages (one CTA an SM), 0.165-0.171 with one, 0.154-0.160
// with three. At [48, 8, 336, 256]: 0.143-0.154 with two (195 registers,
// 193 KB: one CTA an SM), 0.209-0.217 with one.
constexpr int FWD_WG_96 = 2, FWD_WG_128 = 2, FWD_WG_256 = 2;

// The warp of this thread within its warpgroup: rows 16 warp .. 16 warp + 15.
__device__ __forceinline__ int wg_warp() { return (threadIdx.x % THREADS) / 32; }

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

// The keep bits of this thread's row r_i = 16 warp + lane / 4 + 8 i of a
// query tile against the key tile whose bits are kbits, shifted so that bit
// 8 j + c says whether its accumulator column 8 j + 2 (lane % 4) + c is kept.
// On the diagonal tile only keys 0..r_i are (causal).
__device__ __forceinline__ uint64_t row_keep_bits(uint64_t kbits, bool diag, int i) {
  const int lane = threadIdx.x % 32;
  const int row = wg_warp() * 16 + lane / 4 + 8 * i;
  return (diag ? kbits & ((2ull << row) - 1) : kbits) >> (2 * (lane % 4));
}

// Store NPW 64-column panels (from panel p0) of a 64-row wgmma accumulator
// of the tile at row0 into rows of D columns, times `scale`, as bf16 pairs;
// rows at or past n_rows and columns at or past D (the padding of D = 96) are
// never stored.
template <int D, int NPW>
__device__ __forceinline__ void store_acc_rows(bf16* __restrict__ dst, const float (&acc)[NPW][32], int row0,
                                               int n_rows, float scale, int p0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg_warp() * 16 + lane / 4 + 8 * i;
    if (row >= n_rows) continue;
    bf16* out = dst + (size_t)row * D + p0 * 64 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (D % 64 == 0 || (p0 + n) * 64 + 8 * j < D)
          *reinterpret_cast<uint32_t*>(out + n * 64 + 8 * j) =
              sm90::pack_bf16(acc[n][4 * j + 2 * i] * scale, acc[n][4 * j + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Forward. Replaces _flash_kernel (mafed_tpu/kernels/attention.py:81-153).
//
// Bound on the H100: memory. At the 410M CE shape (48x16 heads, 336 tokens,
// head_dim 64) it moves ~132 MB (q, k, v read, o written) for ~11 GFLOP of
// causal work: ~40 us at 3.35 TB/s against ~11 us of tensor-core time; at the
// 1B CE shape (48x8 heads of 256) ~265 MB for ~22 GFLOP, ~79 us against
// ~22 us. The k/v of one head stays in L2 across that head's query tiles, so
// what counts is that every SM keeps loads in flight and never waits on its
// own arithmetic.
//
// Design. A CTA owns one 64-row query tile (at D = 96, 128 and 256: FWD_WG_*
// of them) of one (batch, head). Thread 0 loads Q once and streams 64-key K/V
// tiles with TMA through a ring of stages, one mbarrier each, so tile j + 1
// is in flight while tile j is computed. S = Q K^T is wgmma with both
// operands K-major in shared memory; the scores, the online-softmax
// statistics m and l, and the O accumulator stay in registers: a thread holds
// two rows of each warp's 16-row slice, so a row reduction is two shuffles
// within its quad. The softmax runs in the log2 domain (the scale folded into
// log2(e), exp2 on the special-function unit); at D = 64 it masks only the
// tiles that need it (the diagonal one, where the loop stops, and those with
// a dropped key), at 96, 128 and 256 every tile. P, rounded to bf16, goes
// from the S accumulator straight into the A fragment of O += P V (V read
// MN-major). At D = 64: about 41 KB of shared memory and under 100 registers
// a thread, 5 CTAs per SM. (Issuing S of tile
// j + 1 while P V of tile j runs measured slower on the H100: at D = 64, and
// at D = 96 0.538-0.540 ms against 0.481 with one warpgroup a CTA, 0.80
// against 0.40 with two, whose 150 registers fit one CTA an SM.)
//
// At D = 96, 128 and 256 (fwd_cta) a CTA's time is set by its serial chain
// (wait for the tile, S, softmax, P V, barrier, refill) more than by its
// bytes, and a wide O leaves room for few warpgroups an SM. Splitting O's
// panels over two warpgroups (the earlier form at 256, and at 96 on the
// padded 128 tile) let each warpgroup hold half of O but made each form the
// whole score tile itself, so every S was computed twice. Here each
// warpgroup owns a 64-row query tile and all of its O (48, 64 or 128
// accumulators a thread), forms each S once over all of D, and adds P V in
// one m64nDk16 a k-step, V read MN-major across its panels (LBO); FWD_WG_*
// warpgroups a CTA share each K/V tile, so a CTA streams half the K/V bytes a
// query row. Products a key tile and query tile, in m64n64k16-equivalents:
// D / 16 for S and D / 16 for P V (at 256: 16 + 16, where the panel split
// issued 2 x (16 + 8)). At 96 the tiles lose their padding (12 KB instead of
// 16: three 32-column panels with the 64-byte swizzle, read by TMA in
// 32 x 64 boxes); Q plus two K/V stages take ~74 KB, 121 registers a thread:
// two CTAs an SM. At 128 two query tiles and two stages take ~97 KB and, held
// to 128 registers (flash_fwd_kernel<128, 2>), two CTAs share an SM; at 256
// ~193 KB and 195 registers, one CTA an SM.
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint64_t keep = MASKED ? row_keep_bits(kbits, diag, i) : 0;
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

// Shared memory of the forward at D = 64 and of the dQ kernels, byte
// offsets from the 1024-aligned base: ONCE query-side tiles loaded once (Q; Q
// and dO), the K and V stages of the ring, each stage's keep bits, and the
// barriers (the once-loaded tiles', then one per stage).
template <int D, int ONCE> struct QTileSmem {
  static constexpr uint32_t TILE = panels(D) * sm90::PANEL_BYTES;
  static constexpr uint32_t K = ONCE * TILE;
  static constexpr uint32_t V = K + STAGES * TILE;
  static constexpr uint32_t KEEP = V + STAGES * TILE;   // STAGES x uint64 keep bits
  static constexpr uint32_t BAR = KEEP + STAGES * 8;
  static constexpr size_t ALLOC = BAR + (1 + STAGES) * 8 + 1024;  // + room to align the base
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (sm90::smem_addr(raw) & 1023)) & 1023);
}

// The K/V ring of a kernel that owns a query tile (forward, dQ): key tiles
// 0 .. upper - 1 stream through STAGES stages, one barrier each, with each
// tile's keep bits. A loop step waits for its tile (wait), fetches the next
// tile's keep bits before its products (next_keep), and after them stores
// those bits and refills the stage it used (advance).
template <int D, int ONCE> struct KvRing {
  using L = QTileSmem<D, ONCE>;
  unsigned char* smem;
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  const int* mask_row;
  int bh, kv_len, upper;

  __device__ __forceinline__ uint64_t* bar(int i) const { return reinterpret_cast<uint64_t*>(smem + L::BAR) + i; }
  __device__ __forceinline__ uint64_t* keep_slot(int s) const {
    return reinterpret_cast<uint64_t*>(smem + L::KEEP) + s;
  }
  // shared addresses of the tiles, for wgmma descriptors
  __device__ __forceinline__ uint32_t once_tile(int i) const { return sm90::smem_addr(smem + i * L::TILE); }
  __device__ __forceinline__ uint32_t k_tile(int s) const { return sm90::smem_addr(smem + L::K + s * L::TILE); }
  __device__ __forceinline__ uint32_t v_tile(int s) const { return sm90::smem_addr(smem + L::V + s * L::TILE); }

  __device__ __forceinline__ void load_kv(int kt, int s) const {
    sm90::mbar_expect_tx(bar(1 + s), 2 * L::TILE);
    sm90::tma_load_tile<D>(smem + L::K + s * L::TILE, tm_k, bar(1 + s), kt * BLOCK, bh);
    sm90::tma_load_tile<D>(smem + L::V + s * L::TILE, tm_v, bar(1 + s), kt * BLOCK, bh);
  }

  // Initialise the barriers and tile 0's keep bits, then (thread 0) load the
  // ONCE tiles of query rows q0.. onto barrier 0 and fill the stages.
  __device__ __forceinline__ void start(const CUtensorMap* const (&once)[ONCE], int q0) const {
    const int tid = threadIdx.x;
    if (tid == 0) {
      for (int i = 0; i < 1 + STAGES; ++i) sm90::mbar_init(bar(i), 1);
      sm90::fence_mbar_init();
    }
    if (tid < 64 && upper > 0) store_keep_bits(keep_slot(0), keep_key(mask_row, 0, kv_len));
    __syncthreads();
    if (tid == 0) {
      sm90::mbar_expect_tx(bar(0), ONCE * L::TILE);
      for (int i = 0; i < ONCE; ++i) sm90::tma_load_tile<D>(smem + i * L::TILE, once[i], bar(0), q0, bh);
      for (int s = 0; s < STAGES && s < upper; ++s) load_kv(s, s);
    }
  }

  __device__ __forceinline__ void wait_once() const { sm90::mbar_wait(bar(0), 0); }
  __device__ __forceinline__ void wait(int kt) const { sm90::mbar_wait(bar(1 + kt % STAGES), (kt / STAGES) & 1); }
  __device__ __forceinline__ uint64_t keep_bits(int kt) const { return *keep_slot(kt % STAGES); }
  __device__ __forceinline__ bool next_keep(int kt) const {
    return threadIdx.x < 64 && kt + 1 < upper && keep_key(mask_row, (kt + 1) * BLOCK, kv_len);
  }
  __device__ __forceinline__ void advance(int kt, bool next) const {
    if (threadIdx.x < 64 && kt + 1 < upper) store_keep_bits(keep_slot((kt + 1) % STAGES), next);
    __syncthreads();  // every warp is done with tile kt's stage
    if (threadIdx.x == 0 && kt + STAGES < upper) load_kv(kt + STAGES, kt % STAGES);
  }
};

// The forward at D = 96, 128 and 256 (flash_fwd_kernel<D, WG>, below): WG
// warpgroups own a 64-row query tile each and share each K/V tile of a ring
// of STAGES stages; thread 0 issues every load. Its tiles are [64][D] with
// nothing padded: at 96 three 32-column panels with the 64-byte swizzle, at
// 128 and 256 D / 64 panels of 64 columns with the 128-byte swizzle
// (sm90.cuh).
template <int D, int WG> struct FwdSmem {  // byte offsets from the 1024-aligned base
  static constexpr uint32_t TILE = BLOCK * D * 2;      // a [64][D] bf16 tile
  static constexpr uint32_t K = WG * TILE;             // after the WG query tiles
  static constexpr uint32_t V = K + STAGES * TILE;
  static constexpr uint32_t KEEP = V + STAGES * TILE;  // STAGES x uint64 keep bits
  static constexpr uint32_t BAR = KEEP + STAGES * 8;   // the Q tiles', then one per stage
  static constexpr size_t ALLOC = BAR + (1 + STAGES) * 8 + 1024;
};

// A [64][D] tile by TMA: at 96 three 32-column boxes with the 64-byte
// swizzle (the unpadded tiles of fwd_cta and dkv_cta), else D / 64 boxes of
// 64 columns with the 128-byte one.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                          int plane) {
  if constexpr (D == 96)
    sm90::tma_load_tile_sw64<D>(dst, map, bar, row, plane);
  else
    sm90::tma_load_tile<D>(dst, map, bar, row, plane);
}

// K-major descriptor of k-step kk of a [64][D] tile (Q or K of S = Q K^T; K
// and Q, V and dO of S^T and dP^T), in load_tile's layout.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  if constexpr (D == 96)
    return sm90::desc_k_major_sw64(tile, kk);
  else
    return sm90::desc_k_major(tile, kk);
}

// k-step kk of O += P V over all D columns: one m64nDk16, P (bf16) from
// registers, V MN-major across its panels.
template <int D>
__device__ __forceinline__ void fwd_pv(float (&acc)[D / 2], const uint32_t (&a)[4], uint32_t sV, int kk) {
  if constexpr (D == 96)
    sm90::wgmma_rs_n96(acc, a, sm90::desc_mn_major_sw64(sV, kk));
  else if constexpr (D == 128)
    sm90::wgmma_rs_n128(acc, a, sm90::desc_mn_major(sV, 0, kk));
  else
    sm90::wgmma_rs_n256(acc, a, sm90::desc_mn_major(sV, 0, kk));
}

// One CTA of flash_fwd_kernel<D, WG> at D = 96, 128 or 256: query tiles
// WG x .. WG x + WG - 1 of one (batch, head); warpgroup w computes tile
// WG x + w from the key tiles it needs (causal: up to its diagonal), and the
// CTA streams the key tiles its last warpgroup needs.
template <int D, int WG>
__device__ __forceinline__ void fwd_cta(const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const int* __restrict__ mask, bf16* __restrict__ o,
                                        float* __restrict__ lse, int heads, int q_len, int kv_len, int causal,
                                        float scale) {
  static_assert(D == 96 || D == 128 || D == 256, "fwd_cta's tiles and products are built for 96, 128 and 256");
  using L = FwdSmem<D, WG>;
  const int tid = threadIdx.x, wg = tid / THREADS, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / heads;
  const int n_qt = (q_len + BLOCK - 1) / BLOCK, n_kt = (kv_len + BLOCK - 1) / BLOCK;
  const int qt_first = blockIdx.x * WG, n_tiles = min(WG, n_qt - qt_first), qt = qt_first + wg;
  const int upper = causal ? min(qt_first + n_tiles, n_kt) : n_kt;         // key tiles of the CTA
  const int mine = qt >= n_qt ? 0 : causal ? min(qt + 1, n_kt) : n_kt;     // of this warpgroup
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)b * kv_len;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* keep_slot = reinterpret_cast<uint64_t*>(smem + L::KEEP);
  const auto load_kv = [&](int kt, int s) {
    sm90::mbar_expect_tx(&bar[1 + s], 2 * L::TILE);
    load_tile<D>(smem + L::K + s * L::TILE, tm_k, &bar[1 + s], kt * BLOCK, bh);
    load_tile<D>(smem + L::V + s * L::TILE, tm_v, &bar[1 + s], kt * BLOCK, bh);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_mbar_init();
  }
  if (tid < 64 && upper > 0) store_keep_bits(&keep_slot[0], keep_key(mask_row, 0, kv_len));
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar[0], n_tiles * L::TILE);
    for (int w = 0; w < n_tiles; ++w)
      load_tile<D>(smem + w * L::TILE, tm_q, &bar[0], (qt_first + w) * BLOCK, bh);
    for (int s = 0; s < STAGES && s < upper; ++s) load_kv(s, s);
  }

  float acc[D / 2];  // O, m64nDk16: d[4 j + 2 i + c] = (row r_i, column 8 j + 2 (lane % 4) + c)
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // row max (log2 domain) and sum
  const float scale_log2 = scale * LOG2E;
  sm90::mbar_wait(&bar[0], 0);

  for (int kt = 0; kt < upper; ++kt) {
    const int s = kt % STAGES;
    // the next tile's keep bits: fetched now, stored after this tile's products
    const bool next_keep = tid < 64 && kt + 1 < upper && keep_key(mask_row, (kt + 1) * BLOCK, kv_len);
    sm90::mbar_wait(&bar[1 + s], (kt / STAGES) & 1);
    if (kt < mine) {  // the same for the whole warpgroup
      const uint32_t sQ = sm90::opaque(sm90::smem_addr(smem + wg * L::TILE));
      const uint32_t sK = sm90::smem_addr(smem + L::K + s * L::TILE);
      const uint32_t sV = sm90::smem_addr(smem + L::V + s * L::TILE);

      // S = Q K^T once, D / 16 k-steps
      float sc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = 0.0f;
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss(sc, desc_k<D>(sQ, kk), desc_k<D>(sK, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // every tile through the masked softmax: an unmasked copy for tiles
      // with no dropped key measured no faster, and its code took <128> past
      // the 128 registers of two CTAs an SM
      float alpha[2];
      softmax_tile<true>(sc, m, l, alpha, keep_slot[s], causal && kt == qt, scale_log2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * j + 2 * i] *= alpha[i];
          acc[4 * j + 2 * i + 1] *= alpha[i];
        }

      // O += P V over all D columns, P (bf16) from registers
      uint32_t pa[4][4];
      sm90::acc_to_a(sc, pa);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fwd_pv<D>(acc, pa[kk], sV, kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    if (tid < 64 && kt + 1 < upper) store_keep_bits(&keep_slot[(kt + 1) % STAGES], next_keep);
    __syncthreads();  // every warp is done with tile kt's stage
    if (tid == 0 && kt + STAGES < upper) load_kv(kt + STAGES, s);
  }

  // each warpgroup stores o and lse of its own rows; a warpgroup without a
  // tile (the last CTA's, at an odd count of tiles) stores nothing. (The
  // output pointers are formed here, not held through the loop.)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool empty = l[i] == 0.0f;
    const float l_safe = empty ? 1.0f : l[i];
    const int row = qt * BLOCK + wg_warp() * 16 + lane / 4 + 8 * i;
    if (row >= q_len) continue;
    const size_t at = (size_t)bh * q_len + row;  // row of the [batch*heads, q_len] outputs
    if (lane % 4 == 0) lse[at] = empty ? INFINITY : m[i] * LN2 + logf(l_safe);
    bf16* out = o + at * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          sm90::pack_bf16(acc[4 * j + 2 * i] / l_safe, acc[4 * j + 2 * i + 1] / l_safe);
  }
}

template <int D, int WG>
__global__ void __launch_bounds__(THREADS * WG)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ mask, bf16* __restrict__ o,
                 float* __restrict__ lse, int heads, int q_len, int kv_len, int causal, float scale) {
  if constexpr (D != 64) {  // WG query tiles a CTA (fwd_cta)
    fwd_cta<D, WG>(&tm_q, &tm_k, &tm_v, mask, o, lse, heads, q_len, kv_len, causal, scale);
  } else {
    static_assert(WG == 1, "at D = 64 a CTA is one warpgroup with one query tile");
    const int qt = blockIdx.x, bh = blockIdx.y, b = bh / heads;
    // wg is 0; its index arithmetic stays as the panel-split form had it,
    // which keeps this kernel's SASS
    const int wg = threadIdx.x / THREADS, lane = threadIdx.x % 32;
    const int q0 = qt * BLOCK;
    o += (size_t)bh * q_len * D;
    lse += (size_t)bh * q_len;
    const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)b * kv_len;

    extern __shared__ unsigned char smem_raw[];
    const int n_kt = (kv_len + BLOCK - 1) / BLOCK;
    const KvRing<D, 1> ring{aligned_smem(smem_raw), &tm_k, &tm_v, mask_row, bh, kv_len,
                            causal ? min(qt + 1, n_kt) : n_kt};
    ring.start({&tm_q}, q0);

    float acc[1][32];  // O: one 64-column panel
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[0][r] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // row max (log2 domain) and sum
    const float scale_log2 = scale * LOG2E;
    ring.wait_once();

    for (int kt = 0; kt < ring.upper; ++kt) {
      const int s = kt % STAGES;
      // the next tile's keep bits: fetched now, stored after this tile's products
      const bool next_keep = ring.next_keep(kt);
      ring.wait(kt);
      const uint32_t sQ = sm90::opaque(ring.once_tile(0));
      const uint32_t sK = ring.k_tile(s);
      const uint32_t sV = ring.v_tile(s);

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
      const uint64_t kbits = ring.keep_bits(kt);
      const bool diag = causal && kt == qt;
      float alpha[2];
      if (diag || kbits != ~0ull)
        softmax_tile<true>(sc, m, l, alpha, kbits, diag, scale_log2);
      else
        softmax_tile<false>(sc, m, l, alpha, kbits, false, scale_log2);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[0][4 * j + 2 * i] *= alpha[i];
          acc[0][4 * j + 2 * i + 1] *= alpha[i];
        }

      // O += P V, P (bf16) from registers
      uint32_t pa[4][4];
      sm90::acc_to_a(sc, pa);
      sm90::fence_regs(acc[0]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs(acc[0], pa[kk], sm90::desc_mn_major(sV, wg, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc[0]);
      ring.advance(kt, next_keep);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool empty = l[i] == 0.0f;
      const float l_safe = empty ? 1.0f : l[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[0][4 * j + 2 * i] /= l_safe;
        acc[0][4 * j + 2 * i + 1] /= l_safe;
      }
      const int row = q0 + wg_warp() * 16 + lane / 4 + 8 * i;
      if (wg == 0 && lane % 4 == 0 && row < q_len) lse[row] = empty ? INFINITY : m[i] * LN2 + logf(l_safe);
    }
    store_acc_rows<D, 1>(o, acc, q0, q_len, 1.0f, wg);
  }
}

// At 128 two CTAs share an SM: 2 x 256 threads, at most 128 registers a
// thread. (A minimum-CTA bound on the template itself changes the SASS of
// <64>, whose register count it does not need.)
template <>
__global__ void __launch_bounds__(THREADS * FWD_WG_128, 2)
flash_fwd_kernel<128, FWD_WG_128>(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ mask,
                                  bf16* __restrict__ o, float* __restrict__ lse, int heads, int q_len, int kv_len,
                                  int causal, float scale) {
  fwd_cta<128, FWD_WG_128>(&tm_q, &tm_k, &tm_v, mask, o, lse, heads, q_len, kv_len, causal, scale);
}

// ---------------------------------------------------------------------------
// dK, dV. Replaces _flash_bwd_dkv_kernel (mafed_tpu/kernels/attention.py:230-291).
//
// Bound on the H100: memory at VQA lengths. Per head it reads q, k, v, do
// (4 x T x D bf16) plus lse and delta, and writes dk, dv; its ~4 products per
// kept (q, k) pair are ~22 GFLOP at the 410M CE shape, ~22 us of tensor-core
// time against ~55 us for the bytes (1B: ~44 GFLOP, ~45 us against ~119 us).
//
// Design. One CTA owns one 64-key tile of one (batch, head). Thread 0 loads K
// and V once with TMA and streams 64-query Q/dO tiles through a ring of
// STAGES stages, from the diagonal tile on when causal. Per tile: S^T = K Q^T
// and dP^T = V dO^T are wgmma with both operands K-major in shared memory,
// committed as two groups; P^T = keep ? exp(S^T scale - lse) : 0 is formed in
// registers (log2 domain) as soon as S^T lands; then dS^T = P^T (dP^T -
// delta) in f32, and dV += P^T dO, dK += dS^T Q with P^T and dS^T rounded to
// bf16 (dO and Q read MN-major). dK and dV stay in registers for the whole
// sweep. lse and delta come in with ordinary loads (their rows are T x 4
// bytes, which TMA takes only when T is a multiple of 4); rows past q_len read
// lse = +inf, delta = 0, so their p is 0.
//
// At D = 64 and 128 (the template's own body) one warpgroup holds all of dK
// and dV, P^T and dS^T go from the score accumulators straight into the A
// fragments of their products, and dV's product is issued while dP^T still
// runs. D = 64: about 50 KB of shared memory and ~165 registers a thread, 3
// CTAs per SM. D = 128: 234 registers, no spill, 97 KB, two CTAs per SM (two
// warpgroups of 168 registers would fit only one CTA per SM).
//
// At D = 256 (dkv_cta) dK and dV alone are 256 registers a thread, so two
// warpgroups share the key tile, warpgroup w with columns 128 w .. 128 w + 127
// of dK and dV. An earlier form had each warpgroup form the whole S^T and dP^T
// over all of D, so the score products, two thirds of the tensor-core work,
// ran twice (0.29-0.31 ms at [48, 8, 336, 256], against 0.27-0.28 here, H100
// SXM at 700 W, scripts/flash_variants.py). Here warpgroup w forms them for queries 32 w .. 32 w + 31 of the
// tile only (m64n32k16, B starting 32 rows into each Q / dO panel: 4 KB, whole
// swizzle atoms), writes its columns of P^T and dS^T as bf16 into two [64
// keys][64 queries] panels of shared memory in the 128-byte layout, and after
// a barrier adds P^T dO and dS^T Q over all 64 queries into its columns (one
// m64n128k16 a k-step, both A operands K-major from those panels). Products a
// key and query tile, in m64n64k16-equivalents: 32 for the scores and 32 for
// dK and dV, against 2 x (32 + 16). The exchange carries only what the next
// products read, 16 KB (the f32 scores, 64 KB, would not fit beside the 192 KB
// of K, V and two Q/dO stages); the loop's closing barrier, which the ring's
// refill needs anyway, also frees the panels for the next tile (a second pair
// of panels measured no faster, nor did dV's product ahead of dS^T behind a
// second barrier, two m64n64k16 a k-step for dK and dV, or the two score
// chains interleaved or split over D).
//
// What holds both head_dims (PERF.md): the ring alone, every product taken
// out, already takes 0.184 ms at 256 and 0.603 ms at 96 (the Q/dO tiles of
// every key tile streamed through L2, ~4 TB/s); the products add ~0.09 /
// ~0.11 ms on top. Clusters of two CTAs sharing each Q/dO tile by TMA multicast
// measured 0.34 / 1.03 ms (the cluster launch alone 0.33 / 1.01), CTAs kept
// resident across key tiles and heads 0.30 / 0.75, and a producer warp with
// per-warp release of the ring's stages 0.33 / 0.88 (its 288 threads held to
// 168 registers, spilling).
//
// At D = 96 (dkv_cta) the tiles lose their padding: [64][96] as three
// 32-column panels with the 64-byte swizzle (12 KB instead of 16), S^T and
// dP^T in 6 k-steps, dV and dK one m64n96k16 a k-step (P^T and dS^T from
// registers, dO and Q MN-major across the three panels), where the padded
// tile ran two m64n64k16, a third of the second one on zeros.
// ---------------------------------------------------------------------------
template <int D, int WG> struct DkvSmem {  // byte offsets from the 1024-aligned base
  // a [64][D] tile: at 96 unpadded (three 32-column panels), else ceil(D / 64) 64-column panels
  static constexpr uint32_t TILE = D == 96 ? BLOCK * D * 2 : panels(D) * sm90::PANEL_BYTES;
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + TILE;
  static constexpr uint32_t Q = V + TILE;
  static constexpr uint32_t DO = Q + STAGES * TILE;
  static constexpr uint32_t XP = DO + STAGES * TILE;    // at 256: P^T, then dS^T, [64 keys][64 queries] panels
  static constexpr uint32_t LSE = XP + (D == 256 ? 2 * sm90::PANEL_BYTES : 0);  // STAGES x 64 f32
  static constexpr uint32_t DELTA = LSE + STAGES * 256;  // STAGES x 64 f32
  static constexpr uint32_t BAR = DELTA + STAGES * 256;  // K/V, then one per stage
  static constexpr size_t ALLOC = BAR + (1 + STAGES) * 8 + 1024;
};

// Store N columns, from column c0, of a 64-row m64nNk16 accumulator of the
// tile at row0 into rows of D columns, times `scale`, as bf16 pairs; rows at
// or past n_rows are never stored.
template <int D, int N>
__device__ __forceinline__ void store_acc_cols(bf16* __restrict__ dst, const float (&acc)[N / 2], int row0,
                                               int n_rows, float scale, int c0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg_warp() * 16 + lane / 4 + 8 * i;
    if (row >= n_rows) continue;
    bf16* out = dst + (size_t)row * D + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          sm90::pack_bf16(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

// acc = A B^T over all of D (S^T = K Q^T or dP^T = V dO^T), both K-major: at
// 96 all 64 queries of the tile (m64n64k16), at 256 the 32 rows of the B tile
// from sB (m64n32k16).
template <int D, int R>
__device__ __forceinline__ void dkv_scores(float (&acc)[R], uint32_t sA, uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (D == 256)
      sm90::wgmma_ss_n32(acc, sm90::desc_k_major(sA, kk), sm90::desc_k_major(sB, kk), kk > 0);
    else
      sm90::wgmma_ss(acc, desc_k<D>(sA, kk), desc_k<D>(sB, kk), kk > 0);
  }
}

// One CTA of flash_bwd_dkv_kernel<D, WG> at D = 96 or 256: key tile x, the
// query tiles it needs (causal: from its diagonal). At 96 one warpgroup; at
// 256 two, each forming the scores of half the queries and owning half of dK
// and dV, P^T and dS^T exchanged through shared memory.
template <int D, int WG>
__device__ __forceinline__ void dkv_cta(const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const CUtensorMap* tm_do, const float* __restrict__ lse,
                                        const float* __restrict__ delta, const int* __restrict__ mask,
                                        bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int q_len,
                                        int kv_len, int causal, float scale) {
  static_assert(D == 96 || D == 256, "dkv_cta's tiles and products are built for 96 and 256");
  static_assert(D == 96 ? WG == 1 : WG == 2, "at 256 the scores and dK, dV split over two warpgroups");
  using L = DkvSmem<D, WG>;
  constexpr bool SPLIT = D == 256;                // score columns split over the warpgroups, P^T and dS^T exchanged
  constexpr int QW = SPLIT ? BLOCK / WG : BLOCK;  // queries of a tile in this warpgroup's S^T and dP^T
  constexpr int CW = SPLIT ? D / WG : D;          // columns of dK and dV this warpgroup owns
  const int tid = threadIdx.x, wg = tid / THREADS, warp = wg_warp(), lane = tid % 32;
  const int bh = blockIdx.y, b = bh / heads;
  const int n_qt = (q_len + BLOCK - 1) / BLOCK;
  const int kt = blockIdx.x, first = causal ? kt : 0;  // causal: queries before k0 contribute nothing
  const int n_it = n_qt - first;
  const int k0 = kt * BLOCK, c0 = SPLIT ? wg * CW : 0, q_off = SPLIT ? wg * QW : 0;
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

  auto load_qdo = [&](int qt, int s) {
    sm90::mbar_expect_tx(&bar[1 + s], 2 * L::TILE);
    load_tile<D>(smem + L::Q + s * L::TILE, tm_q, &bar[1 + s], qt * BLOCK, bh);
    load_tile<D>(smem + L::DO + s * L::TILE, tm_do, &bar[1 + s], qt * BLOCK, bh);
  };
  // lse (threads 0-63) or delta (64-127) of query q0 + tid % 64; other
  // warpgroups' threads fetch and store nothing
  auto fetch_row_stat = [&](int q0) {
    const int qrow = q0 + tid % 64;
    if (tid < 64) return qrow < q_len ? lse[qrow] : INFINITY;
    return tid < THREADS && qrow < q_len ? delta[qrow] : 0.0f;
  };
  auto store_row_stat = [&](int s, float x) {
    if (tid < 64)
      s_lse[s * 64 + tid] = x * LOG2E;  // log2 domain, +inf stays +inf
    else if (tid < THREADS)
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
    load_tile<D>(smem + L::K, tm_k, &bar[0], k0, bh);
    load_tile<D>(smem + L::V, tm_v, &bar[0], k0, bh);
    for (int s = 0; s < STAGES && s < n_it; ++s) load_qdo(first + s, s);
  }

  // S^T, dP^T: m64n{QW}k16, d[4 j + 2 i + c] = (key r_i, query q_off + 8 j + 2 (lane % 4) + c);
  // dK, dV: m64n{CW}k16 over columns c0 ..
  float dk_acc[CW / 2], dv_acc[CW / 2], st[QW / 2], dpt[QW / 2];
#pragma unroll
  for (int r = 0; r < QW / 2; ++r) st[r] = dpt[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < CW / 2; ++r) dk_acc[r] = dv_acc[r] = 0.0f;
  sm90::mbar_wait(&bar[0], 0);

  for (int it = 0; it < n_it; ++it) {
    const int qt = first + it, s = it % STAGES;
    const float next_stat = it + 1 < n_it ? fetch_row_stat((qt + 1) * BLOCK) : 0.0f;
    sm90::mbar_wait(&bar[1 + s], (it / STAGES) & 1);
    const uint32_t sK = sm90::opaque(sm90::smem_addr(smem + L::K));
    const uint32_t sV = sm90::opaque(sm90::smem_addr(smem + L::V));
    const uint32_t sQ = sm90::smem_addr(smem + L::Q + s * L::TILE);
    const uint32_t sDO = sm90::smem_addr(smem + L::DO + s * L::TILE);

    // S^T and dP^T of this warpgroup's queries (at 256 from row q_off of
    // the Q and dO panels: q_off x 128 bytes) as two groups
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
    dkv_scores<D>(st, sK, sQ + q_off * 128);
    sm90::wgmma_commit();
    dkv_scores<D>(dpt, sV, sDO + q_off * 128);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(st);

    // p^T in registers: rows are keys, columns the warpgroup's queries; at
    // 256 also into the exchange panel as bf16 (its rounding for dV)
    [[maybe_unused]] unsigned char* xp = smem + L::XP;
    const bool diag = causal && qt == kt;
    const float* t_lse = s_lse + s * 64 + q_off;
    const float* t_delta = s_delta + s * 64 + q_off;
#pragma unroll
    for (int j = 0; j < QW / 8; ++j) {
      const int col0 = 8 * j + 2 * (lane % 4);
      const float2 lse2 = *reinterpret_cast<const float2*>(t_lse + col0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp * 16 + lane / 4 + 8 * i;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 4 * j + 2 * i + c;
          const bool keep = key_keep[i] && (!diag || row <= q_off + col0 + c);
          st[r] = keep ? sm90::exp2_approx(fmaf(st[r], scale_log2, -(c ? lse2.y : lse2.x))) : 0.0f;
        }
        if constexpr (SPLIT)
          *reinterpret_cast<uint32_t*>(xp + sm90::sw128_offset(row, q_off + col0)) =
              sm90::pack_bf16(st[4 * j + 2 * i], st[4 * j + 2 * i + 1]);
      }
    }
    if constexpr (!SPLIT) {  // dV += P^T dO while dP^T runs, P^T (bf16) from registers
      uint32_t pa[4][4];
      sm90::acc_to_a(st, pa);
      sm90::fence_regs(dv_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs_n96(dv_acc, pa[kk], sm90::desc_mn_major_sw64(sDO, kk));
      sm90::wgmma_commit();
    }

    // ds^T = p^T (dp^T - delta)
    sm90::wgmma_wait<SPLIT ? 0 : 1>();
    sm90::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < QW / 8; ++j) {
      const int col0 = 8 * j + 2 * (lane % 4);
      const float2 delta2 = *reinterpret_cast<const float2*>(t_delta + col0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 4 * j + 2 * i + c;
          dpt[r] = st[r] * (dpt[r] - (c ? delta2.y : delta2.x));
        }
        if constexpr (SPLIT)
          *reinterpret_cast<uint32_t*>(xp + sm90::PANEL_BYTES +
                                       sm90::sw128_offset(warp * 16 + lane / 4 + 8 * i, q_off + col0)) =
              sm90::pack_bf16(dpt[4 * j + 2 * i], dpt[4 * j + 2 * i + 1]);
      }
    }
    if constexpr (SPLIT) {
      // dV += P^T dO and dK += dS^T Q over all 64 queries into this
      // warpgroup's columns, once both halves of P^T and dS^T are written
      sm90::fence_proxy_async();
      __syncthreads();
      const uint32_t sX = sm90::smem_addr(xp);
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss_n128(dv_acc, sm90::desc_k_major(sX, kk), sm90::desc_mn_major(sDO, c0 / 64, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss_n128(dk_acc, sm90::desc_k_major(sX + sm90::PANEL_BYTES, kk),
                            sm90::desc_mn_major(sQ, c0 / 64, kk));
    } else {  // dK += dS^T Q, dS^T (bf16) from registers
      uint32_t dsa[4][4];
      sm90::acc_to_a(dpt, dsa);
      sm90::fence_regs(dk_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs_n96(dk_acc, dsa[kk], sm90::desc_mn_major_sw64(sQ, kk));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);

    if (it + 1 < n_it) store_row_stat((it + 1) % STAGES, next_stat);
    __syncthreads();  // every warp is done with stage s (and at 256 with the exchange panels)
    if (tid == 0 && it + STAGES < n_it) load_qdo(qt + STAGES, s);
  }

  store_acc_cols<D, CW>(dv, dv_acc, k0, kv_len, 1.0f, c0);
  store_acc_cols<D, CW>(dk, dk_acc, k0, kv_len, scale, c0);
}

template <int D, int WG>
__global__ void __launch_bounds__(THREADS * WG)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ mask,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int q_len, int kv_len, int causal,
                     float scale) {
  static_assert(D % 16 == 0 && panels(D) % WG == 0, "tiles are 64-column panels, split evenly over warpgroups");
  using L = DkvSmem<D, WG>;
  constexpr int NPW = panels(D) / WG;  // dK and dV panels of each warpgroup
  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / heads;
  const int tid = threadIdx.x, warp = wg_warp(), lane = tid % 32, p0 = tid / THREADS * NPW;
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
  // lse (threads 0-63) or delta (64-127) of query q0 + tid % 64; other
  // warpgroups' threads fetch and store nothing
  auto fetch_row_stat = [&](int q0) {
    const int qrow = q0 + tid % 64;
    if (tid < 64) return qrow < q_len ? lse[qrow] : INFINITY;
    return tid < THREADS && qrow < q_len ? delta[qrow] : 0.0f;
  };
  auto store_row_stat = [&](int s, float x) {
    if (tid < 64)
      s_lse[s * 64 + tid] = x * LOG2E;  // log2 domain, +inf stays +inf
    else if (tid < THREADS)
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

  float dk_acc[NPW][32], dv_acc[NPW][32], st[32], dpt[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    st[r] = dpt[r] = 0.0f;
#pragma unroll
    for (int n = 0; n < NPW; ++n) dk_acc[n][r] = dv_acc[n][r] = 0.0f;
  }
  sm90::mbar_wait(&bar[0], 0);

  for (int it = 0; it < n_it; ++it) {
    const int qt = first + it, s = it % STAGES;
    const float next_stat = it + 1 < n_it ? fetch_row_stat((qt + 1) * BLOCK) : 0.0f;
    sm90::mbar_wait(&bar[1 + s], (it / STAGES) & 1);
    const uint32_t sK = sm90::opaque(sm90::smem_addr(smem + L::K));
    const uint32_t sV = sm90::opaque(sm90::smem_addr(smem + L::V));
    const uint32_t sQ = sm90::smem_addr(smem + L::Q + s * L::TILE);
    const uint32_t sDO = sm90::smem_addr(smem + L::DO + s * L::TILE);

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
    for (int n = 0; n < NPW; ++n) sm90::fence_regs(dv_acc[n]);
    sm90::wgmma_fence();
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs(dv_acc[n], pa[kk], sm90::desc_mn_major(sDO, p0 + n, kk));
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
    for (int n = 0; n < NPW; ++n) sm90::fence_regs(dk_acc[n]);
    sm90::wgmma_fence();
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs(dk_acc[n], dsa[kk], sm90::desc_mn_major(sQ, p0 + n, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NPW; ++n) {
      sm90::fence_regs(dv_acc[n]);
      sm90::fence_regs(dk_acc[n]);
    }

    if (it + 1 < n_it) store_row_stat((it + 1) % STAGES, next_stat);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && it + STAGES < n_it) load_qdo(qt + STAGES, s);
  }

  store_acc_rows<D, NPW>(dv, dv_acc, k0, kv_len, 1.0f, p0);
  store_acc_rows<D, NPW>(dk, dk_acc, k0, kv_len, scale, p0);
}

// At 96 and 256 the kernel is dkv_cta (the template's body above runs 64 and 128).
template <>
__global__ void __launch_bounds__(THREADS * DKV_WG_96)
flash_bwd_dkv_kernel<96, DKV_WG_96>(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                                    const float* __restrict__ lse, const float* __restrict__ delta,
                                    const int* __restrict__ mask, bf16* __restrict__ dk, bf16* __restrict__ dv,
                                    int heads, int q_len, int kv_len, int causal, float scale) {
  dkv_cta<96, DKV_WG_96>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, mask, dk, dv, heads, q_len, kv_len, causal, scale);
}

template <>
__global__ void __launch_bounds__(THREADS * DKV_WG_256)
flash_bwd_dkv_kernel<256, DKV_WG_256>(const __grid_constant__ CUtensorMap tm_q,
                                      const __grid_constant__ CUtensorMap tm_k,
                                      const __grid_constant__ CUtensorMap tm_v,
                                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                                      const float* __restrict__ delta, const int* __restrict__ mask,
                                      bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int q_len,
                                      int kv_len, int causal, float scale) {
  dkv_cta<256, DKV_WG_256>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, mask, dk, dv, heads, q_len, kv_len, causal,
                           scale);
}

// ---------------------------------------------------------------------------
// dQ. Replaces _flash_bwd_dq_kernel (mafed_tpu/kernels/attention.py:294-347).
//
// Bound on the H100: memory. At the 410M CE shape it reads q, k, v, do, lse
// and delta and writes dq, ~167 MB: ~50 us at 3.35 TB/s, against ~16 GFLOP
// (three products per kept (query, key) pair), ~17 us of tensor-core time
// (1B: ~331 MB, ~99 us against ~33 us). As in the forward, the k/v of one
// head stays in L2 across its query tiles, so what counts is keeping loads in
// flight on every SM.
//
// Design. The forward's, with dP and dS where the forward has O and the
// softmax. One CTA owns one 64-row query tile of one (batch, head). Thread 0
// loads Q and dO once with TMA and streams 64-key K/V tiles through the
// forward's ring (KvRing), up to the diagonal when causal. Per tile: S = Q K^T
// and dP = dO V^T are wgmma with both operands K-major in shared memory,
// committed as two groups; P = keep ? exp(S scale - lse) : 0 is formed in the
// S registers (log2 domain) while dP still runs, every tile masked with the
// forward's keep bits (an unmasked path for tiles with no dropped key
// measured no faster: the select hides behind the loads); then
// dS = P (dP - delta) in the dP registers, rounded to bf16 straight into the
// A fragments of dQ += dS K, which reads the K tile MN-major, the same shared
// tile that S read K-major. dS never goes to shared memory. lse and delta of
// a thread's two rows are loaded once into registers by ordinary loads
// (+inf and 0 past q_len, so those rows get p = 0), and dQ stays in registers
// until it is scaled once and stored. At D = 64: about 49 KB of shared memory
// and 122 registers a thread, 4 CTAs per SM. At D = 256: 198 KB (one CTA per
// SM) and one warpgroup, the 128-register dQ beside S and dP: 218 registers,
// no spill. At D = 128 (and 96): 97 KB, two CTAs per SM, one warpgroup, 154
// registers.
// ---------------------------------------------------------------------------
// p = keep ? 2^(s scale log2(e) - lse log2(e)) : 0, in place, for this
// thread's two rows of one 64-key tile.
__device__ __forceinline__ void probs_tile(float (&sc)[32], const float (&lse_log2)[2], uint64_t kbits, bool diag,
                                           float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint64_t keep = row_keep_bits(kbits, diag, i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = sc[4 * j + 2 * i + c];
        x = sm90::exp2_approx(fmaf(x, scale_log2, -lse_log2[i]));
        x = ((keep >> (8 * j + c)) & 1) ? x : 0.0f;
      }
  }
}

template <int D, int WG>
__global__ void __launch_bounds__(THREADS * WG)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ mask,
                    bf16* __restrict__ dq, int heads, int q_len, int kv_len, int causal, float scale) {
  static_assert(D % 16 == 0 && panels(D) % WG == 0, "tiles are 64-column panels, split evenly over warpgroups");
  constexpr int NPW = panels(D) / WG;  // dQ panels of each warpgroup
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / heads;
  const int warp = wg_warp(), lane = threadIdx.x % 32, p0 = threadIdx.x / THREADS * NPW;
  const int q0 = qt * BLOCK;
  dq += (size_t)bh * q_len * D;
  lse += (size_t)bh * q_len;
  delta += (size_t)bh * q_len;
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)b * kv_len;

  extern __shared__ unsigned char smem_raw[];
  const int n_kt = (kv_len + BLOCK - 1) / BLOCK;
  const KvRing<D, 2> ring{aligned_smem(smem_raw), &tm_k, &tm_v, mask_row, bh, kv_len,
                          causal ? min(qt + 1, n_kt) : n_kt};
  ring.start({&tm_q, &tm_do}, q0);

  // lse (log2 domain, +inf stays +inf) and delta of this thread's rows
  float lse_log2[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * i;
    lse_log2[i] = row < q_len ? lse[row] * LOG2E : INFINITY;
    row_delta[i] = row < q_len ? delta[row] : 0.0f;
  }
  float dq_acc[NPW][32], sc[32], dp[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    sc[r] = dp[r] = 0.0f;
#pragma unroll
    for (int n = 0; n < NPW; ++n) dq_acc[n][r] = 0.0f;
  }
  const float scale_log2 = scale * LOG2E;
  ring.wait_once();

  for (int kt = 0; kt < ring.upper; ++kt) {
    const int s = kt % STAGES;
    // the next tile's keep bits: fetched now, stored after this tile's products
    const bool next_keep = ring.next_keep(kt);
    ring.wait(kt);
    const uint32_t sQ = sm90::opaque(ring.once_tile(0));
    const uint32_t sDO = sm90::opaque(ring.once_tile(1));
    const uint32_t sK = ring.k_tile(s);
    const uint32_t sV = ring.v_tile(s);

    // S and dP as two groups; P is formed while dP still runs
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss(sc, sm90::desc_k_major(sQ, kk), sm90::desc_k_major(sK, kk), kk > 0);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss(dp, sm90::desc_k_major(sDO, kk), sm90::desc_k_major(sV, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sc);

    probs_tile(sc, lse_log2, ring.keep_bits(kt), causal && kt == qt, scale_log2);

    // dS = P (dP - delta); dQ += dS K on this warpgroup's panels, dS (bf16)
    // from registers, K read MN-major
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 4 * j + 2 * i + c;
          dp[r] = sc[r] * (dp[r] - row_delta[i]);
        }
    uint32_t dsa[4][4];
    sm90::acc_to_a(dp, dsa);
#pragma unroll
    for (int n = 0; n < NPW; ++n) sm90::fence_regs(dq_acc[n]);
    sm90::wgmma_fence();
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs(dq_acc[n], dsa[kk], sm90::desc_mn_major(sK, p0 + n, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NPW; ++n) sm90::fence_regs(dq_acc[n]);
    ring.advance(kt, next_keep);
  }

  store_acc_rows<D, NPW>(dq, dq_acc, q0, q_len, scale, p0);
}

// ---------------------------------------------------------------------------
// Wide heads: head_dim 384, 512, 640, ... (every multiple of 128 from 384 on,
// a runtime argument). Same three Pallas kernels, same numerics and masks as
// the kernels above.
//
// Why not the kernels above at D = 384. Their tiles are [64][D] and grow with
// D: the forward's Q + 2-stage K/V ring is 240 KB at 384, dQ's and dK/dV's
// 288 KB, past the 227 KB a CTA may have. Their accumulators grow with D too:
// dK and dV of one 64-key tile at 384 are 2 x 64 x 384 f32, 49,152 of the SM's
// 65,536 registers, before S^T and dP^T.
//
// The forward (flash_fwd_wide_kernel, below) owns one 64-row query tile and
// one piece of up to WIDE_FWD_PIECE = 512 output columns a CTA, one
// warpgroup for each 128-column slice of its piece (3 at 384, 4 at 512), and
// forms each score tile once, split over D; its design note is with it.
//
// dK/dV and dQ. A grid axis over SW-column slices of the output (SW = 128:
// three slices at 384, four at 512, eight at 1024). The CTA of slice s
// computes the whole 64 x 64 score tile S (and dP) over all of D, then only
// its slice's products: dV_s += P^T dO_s and dK_s += dS^T Q_s; dQ_s += dS K_s.
// Its accumulators are then those of the <128> kernels (one warpgroup),
// whatever D. Every operand streams in 64-row x 64-column panels through one
// TMA ring of WIDE_STAGES slots of two panels, one mbarrier each: a score
// product takes one slot per 64 columns of D (the A panel, then the B
// panel), a slice product one slot (the slice's panels of its B operand).
// Shared memory does not grow with D, so every multiple of 128 runs. A slot
// is refilled once the wgmma that read it has completed on every warp
// (`WideRing::release`): the score products keep one k-group in flight while
// the previous slot is released. Every slice computes the same scores by the
// same instructions in the same order.
//
// Cost. The score products, and the loads of their Q and K (dO and V)
// panels, repeat D / SW times; each CTA reads its operands from L2: a
// (query tile, key tile) pair loads D / SW x (D / 64 x 16 KB + 16 KB) per
// score product (dQ two, dK/dV two), ~6.5 TB/s from L2 at the CE shapes by
// that count (PERF.md; reckoned from the loads issued, not measured). One
// CTA barrier for every slot. Bound on the H100 as for the kernels above:
// memory at VQA lengths (the times are in PERF.md).
// ---------------------------------------------------------------------------
// The ring's slots of the wide dK/dV and dQ kernels. At the CE shapes
// [48, 16, 336, 384] and [48, 4, 336, 512] on an H100 SXM at 700 W
// (scripts/flash_variants.py, three rounds in turns) six stages left both
// kernels' times unchanged.
constexpr int WIDE_STAGES = 4;
// Output columns of one CTA of the wide dK/dV and dQ kernels (kernels/build.py
// WIDE_SLICE mirrors it). dK/dV holds two slice accumulators beside S^T and
// dP^T: at 256 that is 320 registers a thread. A 256-column slice (half the
// repeated score products) measured slower (the same script and shapes): dQ
// 0.71-0.73 / 2.14-2.15 ms (244 registers) against 0.70-0.72 / 1.61-1.63 at
// 128.
constexpr int WIDE_SLICE = 128;
// A slice is one slot's two 64-column panels, and divides every wide head_dim
// (a multiple of 128): no slice is partial.
static_assert(WIDE_SLICE == 128, "the ring slots, slice loads and stores assume slices of two panels");

// Shared memory of a wide kernel, byte offsets from the 1024-aligned base:
// the ring's slots, the current key tile's keep bits, the current query
// tile's lse (log2 domain) and delta (dK/dV), the ring's barriers.
template <int SW> struct WideSmem {
  static_assert(SW == WIDE_SLICE, "the wide kernels are built at WIDE_SLICE");
  static constexpr uint32_t SLOT = 2 * sm90::PANEL_BYTES;
  static constexpr uint32_t KEEP = WIDE_STAGES * SLOT;
  static constexpr uint32_t LSE = KEEP + 8;     // 64 f32
  static constexpr uint32_t DELTA = LSE + 256;  // 64 f32
  static constexpr uint32_t BAR = DELTA + 256;  // one per slot
  static constexpr size_t ALLOC = BAR + WIDE_STAGES * 8 + 1024;
};

// The ring of a wide kernel. Items 0 .. total - 1 of the kernel's sweep
// stream through the slots in order, item g in slot g % WIDE_STAGES; thread 0
// issues the loads through the kernel's `load(g)`, which calls `pair` or
// `slice`.
template <int SW> struct WideRing {
  using L = WideSmem<SW>;
  unsigned char* smem;
  int bh, total;

  __device__ __forceinline__ uint64_t* bar(int g) const {
    return reinterpret_cast<uint64_t*>(smem + L::BAR) + g % WIDE_STAGES;
  }
  __device__ __forceinline__ uint32_t slot(int g) const {
    return sm90::smem_addr(smem + (g % WIDE_STAGES) * L::SLOT);
  }
  // The A and B panels of a score product: 64 columns from col of rows
  // row_a.. of map a and of rows row_b.. of map b.
  __device__ __forceinline__ void pair(int g, const CUtensorMap* a, int row_a, const CUtensorMap* b, int row_b,
                                       int col) const {
    unsigned char* dst = smem + (g % WIDE_STAGES) * L::SLOT;
    sm90::mbar_expect_tx(bar(g), 2 * sm90::PANEL_BYTES);
    sm90::tma_load_3d(dst, a, bar(g), col, row_a, bh);
    sm90::tma_load_3d(dst + sm90::PANEL_BYTES, b, bar(g), col, row_b, bh);
  }
  // The SW / 64 panels of slice c0.. of rows row.. of map m.
  __device__ __forceinline__ void slice(int g, const CUtensorMap* m, int row, int c0) const {
    unsigned char* dst = smem + (g % WIDE_STAGES) * L::SLOT;
    sm90::mbar_expect_tx(bar(g), SW / 64 * sm90::PANEL_BYTES);
#pragma unroll
    for (int p = 0; p < SW / 64; ++p)
      sm90::tma_load_3d(dst + p * sm90::PANEL_BYTES, m, bar(g), c0 + 64 * p, row, bh);
  }
  template <class Load> __device__ __forceinline__ void start(const Load& load) const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < WIDE_STAGES; ++i) sm90::mbar_init(bar(i), 1);
      sm90::fence_mbar_init();
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int g = 0; g < WIDE_STAGES && g < total; ++g) load(g);
  }
  __device__ __forceinline__ void wait(int g) const { sm90::mbar_wait(bar(g), (g / WIDE_STAGES) & 1); }
  // Item g's products have completed on this warp: once every warp is here,
  // its slot takes item g + WIDE_STAGES. Also orders the shared-memory writes
  // before it (keep bits, lse, delta) before the reads after it.
  template <class Load> __device__ __forceinline__ void release(int g, const Load& load) const {
    __syncthreads();
    if (threadIdx.x == 0 && g + WIDE_STAGES < total) load(g + WIDE_STAGES);
  }
};

// acc = A B^T over all of D from items g .. g + n_panels - 1 (the A panel and
// the B panel of 64 columns each, both K-major). Returns with acc complete
// and every one of those items released.
template <int SW, class Load>
__device__ __forceinline__ void wide_scores(float (&acc)[32], const WideRing<SW>& ring, int g, int n_panels,
                                            const Load& load) {
  sm90::fence_regs(acc);
  for (int p = 0; p < n_panels; ++p, ++g) {
    ring.wait(g);
    const uint32_t a = ring.slot(g), b = a + sm90::PANEL_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss(acc, sm90::desc_k_major(a, kk), sm90::desc_k_major(b, kk), p > 0 || kk > 0);
    sm90::wgmma_commit();
    if (p > 0) {
      sm90::wgmma_wait<1>();
      ring.release(g - 1, load);
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  ring.release(g - 1, load);
}

// acc[n] += A . (panel n of item g), A the bf16 fragments of a 64-column
// accumulator, the item's panels MN-major; then item g is released.
template <int SW, class Load>
__device__ __forceinline__ void wide_slice_product(float (&acc)[SW / 64][32], const uint32_t (&a)[4][4],
                                                   const WideRing<SW>& ring, int g, const Load& load) {
  ring.wait(g);
  const uint32_t b = ring.slot(g);
#pragma unroll
  for (int n = 0; n < SW / 64; ++n) sm90::fence_regs(acc[n]);
  sm90::wgmma_fence();
#pragma unroll
  for (int n = 0; n < SW / 64; ++n)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs(acc[n], a[kk], sm90::desc_mn_major(b, n, kk));
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < SW / 64; ++n) sm90::fence_regs(acc[n]);
  ring.release(g, load);
}

// Store slice c0.. (SW columns) of a 64-row accumulator of the tile at row0
// into rows of d columns, times `scale`, as bf16 pairs; rows at or past
// n_rows are never stored.
template <int SW>
__device__ __forceinline__ void store_wide_rows(bf16* __restrict__ dst, const float (&acc)[SW / 64][32], int row0,
                                                int n_rows, int d, int c0, float scale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg_warp() * 16 + lane / 4 + 8 * i;
    if (row >= n_rows) continue;
    bf16* out = dst + (size_t)row * d + c0 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < SW / 64; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + n * 64 + 8 * j) =
            sm90::pack_bf16(acc[n][4 * j + 2 * i] * scale, acc[n][4 * j + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Wide forward. Replaces _flash_kernel (mafed_tpu/kernels/attention.py:81-153)
// at every multiple of 128 from 384 on.
//
// Design. A CTA owns one 64-row query tile and one piece of up to
// WIDE_FWD_PIECE = 512 output columns, with one warpgroup for each 128-column
// slice of its piece: 3 at 384, 4 at 512. The grid is (pieces, query tiles,
// batch x heads); D is cut into ceil(D / 512) pieces of ceil(slices /
// pieces) warpgroups each (640: two pieces of 3, the last slice slot of the
// second empty; 1024: two of 4). Warpgroup w of piece p owns slice s = p W +
// w, O[:, 128 s .. 128 s + 127] (m64n128k16: 64 f32 a thread).
// - Q loaded once: up to 512 columns Q's tile stays in shared memory for the
//   whole key loop (48 KB at 384, 64 KB at 512). K and V tiles stream
//   through TMA, each loaded once a CTA, on barriers of their own: K of tile
//   j + 1 loads while the softmax and P V of tile j run, V of tile j + 1
//   while S of tile j + 1 is formed.
// - The score tile formed once, split over D: warpgroup w forms the partial
//   S_w = Q[:, slice w] K[:, slice w]^T, a whole 64 x 64 tile that reads
//   only its slice, in two halves of 32 keys (8 k-steps of m64n32k16 each,
//   16 registers). The partials meet in shared memory: each warpgroup writes
//   its registers in fragment order (`wide_xchg`) into its own K slice,
//   which only its own products read: the first half's into K's rows 0..31,
//   which the second half's products no longer read, the second half's into
//   rows 32..63 once those products have completed. After one CTA barrier
//   every thread reads the same fragment positions of every warpgroup's
//   partial and sums them in the same order, slice 0 first: every warpgroup
//   then holds a bit-identical S, and softmax_tile gives the same m, l and
//   alpha in each. Warpgroup 0 of piece 0 alone writes lse.
// - P V on the slice: P (bf16) goes to A fragments and O_w += P V[:, slice w]
//   runs as one m64n128k16 a k-step, V read MN-major from the slice's two
//   panels.
// Past 512 columns a CTA forms S over all of D in rounds of W slices (slice
// r W + w of round r to warpgroup w, its partial summed over its rounds in
// one m64n64k16 accumulator, written whole once the last round's products
// have completed), with Q's slices loaded beside K's each round; the pieces
// of a tile each form S again, by the same instructions in the same order,
// so they agree bit for bit. That bounds shared memory and the accumulators
// for any D.
//
// Budgets. Q, K and V take 3 x W x 16 KB (192 KB at 512, 144 KB at 384 of the
// 205,872 B allocated); the exchange takes no room of its own (W x 16 KB,
// each partial in its own K slice). Registers: 64 for O, 32 for S, 16 for
// P's fragments, at most 128 a thread (512 threads, one CTA an SM; at 384
// one CTA an SM too, by shared memory). Built for the H100 (PERF.md), the
// products over the whole 64 x 64 tile at once (32 registers) spilled 4-36 B
// at 128 in every form tried, the last with m and l in shared memory and the
// keep bits fetched after the products; so m and l live in shared memory (a
// float4 a thread, read and written once a key tile), the keep bits are
// fetched after the products, and up to 512 columns the partial is formed in
// halves: 128 registers, no spill.
//
// Cost (reckoned from the loads issued, not measured). A (query tile, key
// tile) pair loads K and V once from L2, 2 x 64 x D x 2 bytes (96 KB at 384,
// 128 KB at 512), and a CTA Q once: at the CE shapes [48, 16, 336, 384] and
// [48, 4, 336, 512] (6 query tiles and 21 causal pairs a head) ~1.81 and
// ~0.60 GB, where 128-column slice CTAs that each formed the whole score
// tile loaded D / 128 x (D / 64 x 16 KB + 16 KB) a pair (~5.5 and ~2.4 GB).
// Three CTA barriers a key tile (the partials written, read, V read), where
// the slice CTAs took one a 64-column panel (nine a key tile at 512).
// ---------------------------------------------------------------------------
// Output columns of one CTA of the wide forward (kernels/build.py
// WIDE_FWD_PIECE mirrors it), and its most warpgroups: one a WIDE_SLICE slice
constexpr int WIDE_FWD_PIECE = 512;
constexpr int WIDE_FWD_WG = WIDE_FWD_PIECE / WIDE_SLICE;

// Shared memory of the wide forward, byte offsets from the 1024-aligned base:
// Q, K and V as WIDE_FWD_WG slices each ([64][128]: two 64-column panels, 16
// KB), slice w of each at w x SLICE; the keep bits of two key tiles; the
// barriers (Q, K, V); each thread's row max and sum (its m and l, a float4).
struct WideFwdSmem {
  static constexpr uint32_t SLICE = 2 * sm90::PANEL_BYTES;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + WIDE_FWD_WG * SLICE;
  static constexpr uint32_t V = K + WIDE_FWD_WG * SLICE;
  static constexpr uint32_t KEEP = V + WIDE_FWD_WG * SLICE;  // 2 x uint64, by key tile parity
  static constexpr uint32_t BAR = KEEP + 2 * 8;
  static constexpr uint32_t ML = BAR + 32;
  static constexpr size_t ALLOC = ML + WIDE_FWD_WG * THREADS * 16 + 1024;
};

// Byte offset, within its warpgroup's K slice, of float4 r4 (registers 4 r4
// .. 4 r4 + 3: keys 8 r4 .. 8 r4 + 7 of its two rows) of thread t's partial S: the first
// half's (r4 < 4) in K's rows 0..31 of both panels (bytes 0..4095 and
// 8192..12287), the second half's in rows 32..63; consecutive threads at
// consecutive 16 bytes, so a warp's stores and loads take no bank twice in a
// phase.
__device__ __forceinline__ uint32_t wide_xchg(int r4, int t) {
  return (uint32_t)((r4 / 4) * 4096 + (r4 / 2 % 2) * 8192 + (r4 % 2) * 2048 + t * 16);
}

// PW is WIDE_FWD_PIECE: a template argument only so that kernels/build.py
// names the instantiation as it names the others.
template <int PW>
__global__ void __launch_bounds__(PW / WIDE_SLICE * THREADS, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ mask, bf16* __restrict__ o,
                      float* __restrict__ lse, int heads, int q_len, int kv_len, int d, int causal, float scale) {
  static_assert(PW == WIDE_FWD_PIECE, "the shared memory holds WIDE_FWD_WG slices of each tile");
  using L = WideFwdSmem;
  const int tid = threadIdx.x, wg = tid / THREADS, t = tid % THREADS, lane = tid % 32;
  const int nwg = blockDim.x / THREADS;                // W: the slices of a piece
  const int n_sl = d / WIDE_SLICE, rounds = (n_sl + nwg - 1) / nwg;
  const int piece = blockIdx.x, qt = blockIdx.y, bh = blockIdx.z;
  const int sl = piece * nwg + wg, q0 = qt * BLOCK;    // this warpgroup's output slice (none past n_sl)
  const int n_kt = (kv_len + BLOCK - 1) / BLOCK, upper = causal ? min(qt + 1, n_kt) : n_kt;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* keep_slot = reinterpret_cast<uint64_t*>(smem + L::KEEP);
  // the keep bit of key k0 + tid (tid < 64)
  const auto keep = [&](int k0) {
    return keep_key(mask == nullptr ? nullptr : mask + (size_t)(blockIdx.z / heads) * kv_len, k0, kv_len);
  };
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v;
  // n slices of rows row.. of map m, from slice first, into dst on barrier br (thread 0)
  const auto load_slices = [&](uint32_t dst, const CUtensorMap* m, uint64_t* br, int row, int first, int n) {
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        sm90::tma_load_3d(smem + dst + i * L::SLICE + p * sm90::PANEL_BYTES, m, br,
                          (first + i) * WIDE_SLICE + 64 * p, row, bh);
  };
  // round r of key tile kt onto the K barrier: K's slices r W .. and, past one round, Q's
  const auto load_round = [&](int kt, int r) {
    const int first = r * nwg, n = min(nwg, n_sl - first);
    sm90::mbar_expect_tx(&bar[1], (rounds > 1 ? 2 : 1) * n * L::SLICE);
    if (rounds > 1) load_slices(L::Q, mq, &bar[1], q0, first, n);
    load_slices(L::K, mk, &bar[1], kt * BLOCK, first, n);
  };
  // the V slices of this CTA's piece for key tile kt onto the V barrier
  const auto load_v = [&](int kt) {
    const int first = piece * nwg, n = min(nwg, n_sl - first);
    sm90::mbar_expect_tx(&bar[2], n * L::SLICE);
    load_slices(L::V, mv, &bar[2], kt * BLOCK, first, n);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_mbar_init();
  }
  if (tid < 64 && upper > 0) store_keep_bits(&keep_slot[0], keep(0));
  __syncthreads();
  if (tid == 0 && upper > 0) {
    if (rounds == 1) {  // Q once, for the whole key loop
      sm90::mbar_expect_tx(&bar[0], n_sl * L::SLICE);
      load_slices(L::Q, mq, &bar[0], q0, 0, n_sl);
    }
    load_round(0, 0);
    load_v(0);
  }

  float acc[64];  // O's slice, m64n128k16: d[4 j + 2 i + c] = (row r_i, column 8 j + 2 (lane % 4) + c)
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0.0f;
  float4* ml = reinterpret_cast<float4*>(smem + L::ML) + tid;  // row max (log2 domain) and sum of rows r_0, r_1
  *ml = make_float4(-INFINITY, -INFINITY, 0.0f, 0.0f);
  if (rounds == 1 && upper > 0) sm90::mbar_wait(&bar[0], 0);

  int k_phase = 0;  // completed phases of the K barrier
  for (int kt = 0; kt < upper; ++kt) {
    // this warpgroup's partial S over its slices of D, written in fragment order into its own K slice
    unsigned char* xs = smem + L::K;
    float sc[32];
    if (rounds == 1) {
      // one round: the partial in two halves of 32 keys (m64n32k16), each written as soon as it is formed into
      // the K rows its products no longer read
      sm90::mbar_wait(&bar[1], k_phase++ & 1);
      const uint32_t sQw = sm90::opaque(sm90::smem_addr(smem + L::Q + wg * L::SLICE));
      const uint32_t sKw = sm90::opaque(sm90::smem_addr(smem + L::K + wg * L::SLICE));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sh[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) sh[r] = 0.0f;
        sm90::fence_regs(sh);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WIDE_SLICE / 16; ++kk)
          sm90::wgmma_ss_n32(sh, sm90::desc_k_major(sQw, kk), sm90::desc_k_major(sKw + h * 4096, kk), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sh);
#pragma unroll
        for (int r4 = 0; r4 < 4; ++r4)
          *reinterpret_cast<float4*>(xs + wg * L::SLICE + wide_xchg(4 * h + r4, t)) =
              make_float4(sh[4 * r4], sh[4 * r4 + 1], sh[4 * r4 + 2], sh[4 * r4 + 3]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = 0.0f;
      for (int r = 0; r < rounds; ++r) {
        sm90::mbar_wait(&bar[1], k_phase++ & 1);
        if (r * nwg + wg < n_sl) {  // the same for the whole warpgroup
          const uint32_t sQw = sm90::opaque(sm90::smem_addr(smem + L::Q + wg * L::SLICE));
          const uint32_t sKw = sm90::opaque(sm90::smem_addr(smem + L::K + wg * L::SLICE));
          sm90::fence_regs(sc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < WIDE_SLICE / 16; ++kk)
            sm90::wgmma_ss(sc, sm90::desc_k_major(sQw, kk), sm90::desc_k_major(sKw, kk), r > 0 || kk > 0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(sc);
        }
        if (r + 1 < rounds) {
          __syncthreads();  // every warpgroup is done with round r's slices
          if (tid == 0) load_round(kt, r + 1);
        }
      }
#pragma unroll
      for (int r4 = 0; r4 < 8; ++r4)
        *reinterpret_cast<float4*>(xs + wg * L::SLICE + wide_xchg(r4, t)) =
            make_float4(sc[4 * r4], sc[4 * r4 + 1], sc[4 * r4 + 2], sc[4 * r4 + 3]);
    }

    // the next tile's keep bits, stored before the partials are read; then the partials meet in the K
    // slices, S summed slice 0 first in every warpgroup
    const bool next_keep = tid < 64 && kt + 1 < upper && keep((kt + 1) * BLOCK);
    if (tid < 64 && kt + 1 < upper) store_keep_bits(&keep_slot[(kt + 1) % 2], next_keep);
    __syncthreads();  // every partial written
#pragma unroll
    for (int r4 = 0; r4 < 8; ++r4) {
      float4 s = *reinterpret_cast<const float4*>(xs + wide_xchg(r4, t));
#pragma unroll
      for (int w = 1; w < WIDE_FWD_WG; ++w) {
        if (w < nwg) {
          const float4 x = *reinterpret_cast<const float4*>(xs + w * L::SLICE + wide_xchg(r4, t));
          s.x += x.x;
          s.y += x.y;
          s.z += x.z;
          s.w += x.w;
        }
      }
      sc[4 * r4] = s.x;
      sc[4 * r4 + 1] = s.y;
      sc[4 * r4 + 2] = s.z;
      sc[4 * r4 + 3] = s.w;
    }
    sm90::fence_proxy_async();  // the exchange's accesses before the next tile's TMA writes to the K slices
    __syncthreads();            // every partial read: the K slices take the next tile
    if (tid == 0 && kt + 1 < upper) load_round(kt + 1, 0);

    // every tile through the masked softmax, as fwd_cta's
    float alpha[2];
    float4 mlv = *ml;
    float m[2] = {mlv.x, mlv.y}, l[2] = {mlv.z, mlv.w};
    softmax_tile<true>(sc, m, l, alpha, keep_slot[kt % 2], causal && kt == qt, scale * LOG2E);
    *ml = make_float4(m[0], m[1], l[0], l[1]);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }

    // O_w += P V[:, slice], P (bf16) from registers
    uint32_t pa[4][4];
    sm90::acc_to_a(sc, pa);
    sm90::mbar_wait(&bar[2], kt & 1);
    if (sl < n_sl) {  // the same for the whole warpgroup
      const uint32_t sVw = sm90::opaque(sm90::smem_addr(smem + L::V + wg * L::SLICE));
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs_n128(acc, pa[kk], sm90::desc_mn_major(sVw, 0, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    __syncthreads();  // every warpgroup is done with tile kt's V
    if (tid == 0 && kt + 1 < upper) load_v(kt + 1);
  }

  // o of this warpgroup's slice; lse once a row, by warpgroup 0 of piece 0
  const float4 mlv = *ml;
  const float m[2] = {mlv.x, mlv.y}, l[2] = {mlv.z, mlv.w};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool empty = l[i] == 0.0f;
    const float l_safe = empty ? 1.0f : l[i];
    const int row = q0 + wg_warp() * 16 + lane / 4 + 8 * i;
    if (row >= q_len) continue;
    const size_t at = (size_t)bh * q_len + row;  // row of the [batch*heads, q_len] outputs
    if (piece == 0 && wg == 0 && lane % 4 == 0) lse[at] = empty ? INFINITY : m[i] * LN2 + logf(l_safe);
    if (sl >= n_sl) continue;
    bf16* out = o + at * d + sl * WIDE_SLICE + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          sm90::pack_bf16(acc[4 * j + 2 * i] / l_safe, acc[4 * j + 2 * i + 1] / l_safe);
  }
}

// dK, dV. Grid (slices, key tiles, batch x heads). Per query tile: items
// 0 .. np - 1 the (K, Q) panels of S^T, item np the slice of dO, items
// np + 1 .. 2 np the (V, dO) panels of dP^T, item 2 np + 1 the slice of Q.
template <int SW>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ mask, bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
                          int q_len, int kv_len, int d, int causal, float scale) {
  constexpr int SP = SW / 64;  // dK and dV panels of the slice
  const int c0 = blockIdx.x * SW, kt = blockIdx.y, bh = blockIdx.z, b = bh / heads;
  const int tid = threadIdx.x, warp = wg_warp(), lane = tid % 32, np = d / 64, k0 = kt * BLOCK;
  dk += (size_t)bh * kv_len * d;
  dv += (size_t)bh * kv_len * d;
  lse += (size_t)bh * q_len;
  delta += (size_t)bh * q_len;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* s_lse = reinterpret_cast<float*>(smem + WideSmem<SW>::LSE);
  float* s_delta = reinterpret_cast<float*>(smem + WideSmem<SW>::DELTA);

  // this thread's keys k0 + r_i, r_i = 16 warp + lane / 4 + 8 i
  bool key_keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + lane / 4 + 8 * i;
    key_keep[i] = key < kv_len && (mask == nullptr || mask[(size_t)b * kv_len + key] > 0);
  }

  const int n_qt = (q_len + BLOCK - 1) / BLOCK;
  const int first = causal ? kt : 0;  // causal: queries before k0 contribute nothing
  const int n_it = max(n_qt - first, 0), per_tile = 2 * np + 2;
  const WideRing<SW> ring{smem, bh, n_it * per_tile};
  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v, *mdo = &tm_do;
  const auto load = [=](int g) {
    const int row = (first + g / per_tile) * BLOCK, i = g % per_tile;
    if (i < np)
      ring.pair(g, mk, k0, mq, row, 64 * i);
    else if (i == np)
      ring.slice(g, mdo, row, c0);
    else if (i <= 2 * np)
      ring.pair(g, mv, k0, mdo, row, 64 * (i - np - 1));
    else
      ring.slice(g, mq, row, c0);
  };
  ring.start(load);

  float dk_acc[SP][32], dv_acc[SP][32], st[32], dpt[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    st[r] = dpt[r] = 0.0f;
#pragma unroll
    for (int n = 0; n < SP; ++n) dk_acc[n][r] = dv_acc[n][r] = 0.0f;
  }
  const float scale_log2 = scale * LOG2E;

  int g = 0;
  for (int it = 0; it < n_it; ++it) {
    const int qt = first + it;
    // lse (threads 0-63, log2 domain) and delta (64-127) of the tile's
    // queries: +inf and 0 past q_len, so those queries get p = 0. Read after
    // the score products' releases; the last reader of the previous tile's
    // passed the release of its Q slice.
    {
      const int qrow = qt * BLOCK + tid % 64;
      if (tid < 64)
        s_lse[tid] = qrow < q_len ? lse[qrow] * LOG2E : INFINITY;
      else
        s_delta[tid - 64] = qrow < q_len ? delta[qrow] : 0.0f;
    }
    wide_scores(st, ring, g, np, load);  // S^T = K Q^T
    g += np;

    // p^T in registers: rows are keys, columns are the tile's queries
    const bool diag = causal && qt == kt;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col0 = 8 * j + 2 * (lane % 4);
      const float2 lse2 = *reinterpret_cast<const float2*>(s_lse + col0);
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
    {
      uint32_t pa[4][4];
      sm90::acc_to_a(st, pa);
      wide_slice_product(dv_acc, pa, ring, g++, load);  // dV_s += P^T dO_s
    }

    wide_scores(dpt, ring, g, np, load);  // dP^T = V dO^T
    g += np;
    // ds^T = p^T (dp^T - delta)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 delta2 = *reinterpret_cast<const float2*>(s_delta + 8 * j + 2 * (lane % 4));
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
    wide_slice_product(dk_acc, dsa, ring, g++, load);  // dK_s += dS^T Q_s
  }

  store_wide_rows<SW>(dv, dv_acc, k0, kv_len, d, c0, 1.0f);
  store_wide_rows<SW>(dk, dk_acc, k0, kv_len, d, c0, scale);
}

// dQ. Grid (slices, query tiles, batch x heads). Per key tile: items
// 0 .. np - 1 the (Q, K) panels of S, items np .. 2 np - 1 the (dO, V)
// panels of dP, item 2 np the slice of K.
template <int SW>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ mask, bf16* __restrict__ dq, int heads, int q_len, int kv_len,
                         int d, int causal, float scale) {
  constexpr int SP = SW / 64;  // dQ panels of the slice
  const int c0 = blockIdx.x * SW, qt = blockIdx.y, bh = blockIdx.z, b = bh / heads;
  const int warp = wg_warp(), lane = threadIdx.x % 32, np = d / 64, q0 = qt * BLOCK;
  dq += (size_t)bh * q_len * d;
  lse += (size_t)bh * q_len;
  delta += (size_t)bh * q_len;
  const int* mask_row = mask == nullptr ? nullptr : mask + (size_t)b * kv_len;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* keep_word = reinterpret_cast<uint64_t*>(smem + WideSmem<SW>::KEEP);
  const int n_kt = (kv_len + BLOCK - 1) / BLOCK, upper = causal ? min(qt + 1, n_kt) : n_kt;
  const int per_tile = 2 * np + 1;
  const WideRing<SW> ring{smem, bh, upper * per_tile};
  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v, *mdo = &tm_do;
  const auto load = [=](int g) {
    const int row = g / per_tile * BLOCK, i = g % per_tile;
    if (i < np)
      ring.pair(g, mq, q0, mk, row, 64 * i);
    else if (i < 2 * np)
      ring.pair(g, mdo, q0, mv, row, 64 * (i - np));
    else
      ring.slice(g, mk, row, c0);
  };
  ring.start(load);

  // lse (log2 domain, +inf stays +inf) and delta of this thread's rows
  float lse_log2[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * i;
    lse_log2[i] = row < q_len ? lse[row] * LOG2E : INFINITY;
    row_delta[i] = row < q_len ? delta[row] : 0.0f;
  }
  float dq_acc[SP][32], sc[32], dp[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    sc[r] = dp[r] = 0.0f;
#pragma unroll
    for (int n = 0; n < SP; ++n) dq_acc[n][r] = 0.0f;
  }
  const float scale_log2 = scale * LOG2E;

  int g = 0;
  for (int kt = 0; kt < upper; ++kt) {
    // read after the score products' releases; the last reader of the
    // previous tile's bits passed the release of its K slice
    if (threadIdx.x < 64) store_keep_bits(keep_word, keep_key(mask_row, kt * BLOCK, kv_len));
    wide_scores(sc, ring, g, np, load);  // S = Q K^T
    g += np;
    wide_scores(dp, ring, g, np, load);  // dP = dO V^T
    g += np;
    probs_tile(sc, lse_log2, *keep_word, causal && kt == qt, scale_log2);
    // dS = P (dP - delta)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 4 * j + 2 * i + c;
          dp[r] = sc[r] * (dp[r] - row_delta[i]);
        }
    uint32_t dsa[4][4];
    sm90::acc_to_a(dp, dsa);
    wide_slice_product(dq_acc, dsa, ring, g++, load);  // dQ_s += dS K_s
  }

  store_wide_rows<SW>(dq, dq_acc, q0, q_len, d, c0, scale);
}

// ---------------------------------------------------------------------------
// Launch of one instantiation: one tensor map per bf16 input, encoded on the
// host per launch; the dynamic shared-memory limit raised for the kernel.
// ---------------------------------------------------------------------------
template <int D, int WG>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
                       int batch_heads, int heads, int q_len, int kv_len, int causal, float scale,
                       cudaStream_t stream) {
  // at 96 boxes of 32 columns with the 64-byte swizzle (fwd_cta's unpadded tiles)
  const auto make_map = D == 96 ? sm90_host::make_map_3d_sw64 : sm90_host::make_map_3d;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err;
  if ((err = make_map(&tm_q, q, batch_heads, q_len, D)) != cudaSuccess) return err;
  if ((err = make_map(&tm_k, k, batch_heads, kv_len, D)) != cudaSuccess) return err;
  if ((err = make_map(&tm_v, v, batch_heads, kv_len, D)) != cudaSuccess) return err;
  constexpr size_t smem = D == 64 ? QTileSmem<D, 1>::ALLOC : FwdSmem<D, WG>::ALLOC;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (q_len + BLOCK - 1) / BLOCK;
  const dim3 grid((n_qt + WG - 1) / WG, batch_heads);  // WG query tiles a CTA
  flash_fwd_kernel<D, WG><<<grid, THREADS * WG, smem, stream>>>(
      tm_q, tm_k, tm_v, (const int*)mask, (bf16*)o, (float*)lse, heads, q_len, kv_len, causal, scale);
  return cudaGetLastError();
}

template <int D, int WG>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                           const void* delta, const void* mask, void* dk, void* dv, int batch_heads, int heads,
                           int q_len, int kv_len, int causal, float scale, cudaStream_t stream) {
  // at 96 boxes of 32 columns with the 64-byte swizzle (dkv_cta's unpadded tiles)
  const auto make_map = D == 96 ? sm90_host::make_map_3d_sw64 : sm90_host::make_map_3d;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = make_map(&tm_q, q, batch_heads, q_len, D)) != cudaSuccess) return err;
  if ((err = make_map(&tm_k, k, batch_heads, kv_len, D)) != cudaSuccess) return err;
  if ((err = make_map(&tm_v, v, batch_heads, kv_len, D)) != cudaSuccess) return err;
  if ((err = make_map(&tm_do, dout, batch_heads, q_len, D)) != cudaSuccess) return err;
  using L = DkvSmem<D, WG>;
  constexpr size_t smem = L::ALLOC;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((kv_len + BLOCK - 1) / BLOCK, batch_heads);
  flash_bwd_dkv_kernel<D, WG><<<grid, THREADS * WG, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta, (const int*)mask, (bf16*)dk, (bf16*)dv,
      heads, q_len, kv_len, causal, scale);
  return cudaGetLastError();
}

template <int D, int WG>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                          const void* delta, const void* mask, void* dq, int batch_heads, int heads, int q_len,
                          int kv_len, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = sm90_host::make_map_3d(&tm_q, q, batch_heads, q_len, D)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_k, k, batch_heads, kv_len, D)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_v, v, batch_heads, kv_len, D)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_do, dout, batch_heads, q_len, D)) != cudaSuccess) return err;
  constexpr size_t smem = QTileSmem<D, 2>::ALLOC;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + BLOCK - 1) / BLOCK, batch_heads);
  flash_bwd_dq_kernel<D, WG><<<grid, THREADS * WG, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta, (const int*)mask, (bf16*)dq, heads, q_len,
      kv_len, causal, scale);
  return cudaGetLastError();
}

// The wide dK/dV and dQ kernels: grid (slices, tiles, batch x heads), one warpgroup.
__host__ __forceinline__ dim3 wide_grid(int head_dim, int len, int batch_heads) {
  return dim3(head_dim / WIDE_SLICE, (len + BLOCK - 1) / BLOCK, batch_heads);
}

// The wide forward: grid (pieces, query tiles, batch x heads), ceil(D / WIDE_FWD_PIECE) pieces of
// ceil(slices / pieces) slices, one warpgroup a slice.
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
                            int batch_heads, int heads, int q_len, int kv_len, int d, int causal, float scale,
                            cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err;
  if ((err = sm90_host::make_map_3d(&tm_q, q, batch_heads, q_len, d)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_k, k, batch_heads, kv_len, d)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_v, v, batch_heads, kv_len, d)) != cudaSuccess) return err;
  constexpr size_t smem = WideFwdSmem::ALLOC;
  err = cudaFuncSetAttribute(flash_fwd_wide_kernel<WIDE_FWD_PIECE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int slices = d / WIDE_SLICE, pieces = (slices + WIDE_FWD_WG - 1) / WIDE_FWD_WG;
  const int wgs = (slices + pieces - 1) / pieces;
  const dim3 grid(pieces, (q_len + BLOCK - 1) / BLOCK, batch_heads);
  flash_fwd_wide_kernel<WIDE_FWD_PIECE><<<grid, THREADS * wgs, smem, stream>>>(
      tm_q, tm_k, tm_v, (const int*)mask, (bf16*)o, (float*)lse, heads, q_len, kv_len, d, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, const void* mask, void* dk, void* dv, int batch_heads,
                                int heads, int q_len, int kv_len, int d, int causal, float scale,
                                cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = sm90_host::make_map_3d(&tm_q, q, batch_heads, q_len, d)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_k, k, batch_heads, kv_len, d)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_v, v, batch_heads, kv_len, d)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_do, dout, batch_heads, q_len, d)) != cudaSuccess) return err;
  constexpr size_t smem = WideSmem<WIDE_SLICE>::ALLOC;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wide_kernel<WIDE_SLICE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wide_kernel<WIDE_SLICE><<<wide_grid(d, kv_len, batch_heads), THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta, (const int*)mask, (bf16*)dk, (bf16*)dv,
      heads, q_len, kv_len, d, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd_dq_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                               const void* delta, const void* mask, void* dq, int batch_heads, int heads,
                               int q_len, int kv_len, int d, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = sm90_host::make_map_3d(&tm_q, q, batch_heads, q_len, d)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_k, k, batch_heads, kv_len, d)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_v, v, batch_heads, kv_len, d)) != cudaSuccess) return err;
  if ((err = sm90_host::make_map_3d(&tm_do, dout, batch_heads, q_len, d)) != cudaSuccess) return err;
  constexpr size_t smem = WideSmem<WIDE_SLICE>::ALLOC;
  err = cudaFuncSetAttribute(flash_bwd_dq_wide_kernel<WIDE_SLICE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_kernel<WIDE_SLICE><<<wide_grid(d, q_len, batch_heads), THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta, (const int*)mask, (bf16*)dq, heads, q_len,
      kv_len, d, causal, scale);
  return cudaGetLastError();
}

// head_dim 384, 512, 640, ...: the wide kernels
__host__ __forceinline__ bool wide_head_dim(int head_dim) { return head_dim >= 384 && head_dim % 128 == 0; }

}  // namespace

// ---------------------------------------------------------------------------
// C launchers (bound from Python with ctypes). head_dim 64, 96, 128 and 256
// are instantiated, every multiple of 128 from 384 on takes the wide kernels;
// any other head_dim returns cudaErrorInvalidValue.
// ---------------------------------------------------------------------------

extern "C" cudaError_t flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                                      void* lse, int batch_heads, int heads, int q_len, int kv_len,
                                      int head_dim, int causal, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide_head_dim(head_dim))
    return launch_fwd_wide(q, k, v, mask, o, lse, batch_heads, heads, q_len, kv_len, head_dim, causal, scale, st);
  switch (head_dim) {
    case 64:
      return launch_fwd<64, 1>(q, k, v, mask, o, lse, batch_heads, heads, q_len, kv_len, causal, scale, st);
    case 96:
      return launch_fwd<96, FWD_WG_96>(q, k, v, mask, o, lse, batch_heads, heads, q_len, kv_len, causal, scale,
                                       st);
    case 128:
      return launch_fwd<128, FWD_WG_128>(q, k, v, mask, o, lse, batch_heads, heads, q_len, kv_len, causal, scale,
                                         st);
    case 256:
      return launch_fwd<256, FWD_WG_256>(q, k, v, mask, o, lse, batch_heads, heads, q_len, kv_len, causal, scale,
                                         st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" cudaError_t flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                          const void* lse, const void* delta, const void* mask, void* dk,
                                          void* dv, int batch_heads, int heads, int q_len, int kv_len,
                                          int head_dim, int causal, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide_head_dim(head_dim))
    return launch_bwd_dkv_wide(q, k, v, dout, lse, delta, mask, dk, dv, batch_heads, heads, q_len, kv_len,
                               head_dim, causal, scale, st);
  switch (head_dim) {
    case 64:
      return launch_bwd_dkv<64, 1>(q, k, v, dout, lse, delta, mask, dk, dv, batch_heads, heads, q_len, kv_len,
                                   causal, scale, st);
    case 96:
      return launch_bwd_dkv<96, DKV_WG_96>(q, k, v, dout, lse, delta, mask, dk, dv, batch_heads, heads, q_len,
                                           kv_len, causal, scale, st);
    case 128:
      return launch_bwd_dkv<128, DKV_WG_128>(q, k, v, dout, lse, delta, mask, dk, dv, batch_heads, heads, q_len,
                                             kv_len, causal, scale, st);
    case 256:
      return launch_bwd_dkv<256, DKV_WG_256>(q, k, v, dout, lse, delta, mask, dk, dv, batch_heads, heads, q_len,
                                             kv_len, causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" cudaError_t flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                         const void* lse, const void* delta, const void* mask, void* dq,
                                         int batch_heads, int heads, int q_len, int kv_len, int head_dim,
                                         int causal, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide_head_dim(head_dim))
    return launch_bwd_dq_wide(q, k, v, dout, lse, delta, mask, dq, batch_heads, heads, q_len, kv_len, head_dim,
                              causal, scale, st);
  switch (head_dim) {
    case 64:
      return launch_bwd_dq<64, 1>(q, k, v, dout, lse, delta, mask, dq, batch_heads, heads, q_len, kv_len, causal,
                                  scale, st);
    case 96:
      return launch_bwd_dq<96, DQ_WG_96>(q, k, v, dout, lse, delta, mask, dq, batch_heads, heads, q_len, kv_len,
                                         causal, scale, st);
    case 128:
      return launch_bwd_dq<128, DQ_WG_128>(q, k, v, dout, lse, delta, mask, dq, batch_heads, heads, q_len, kv_len,
                                           causal, scale, st);
    case 256:
      return launch_bwd_dq<256, DQ_WG_256>(q, k, v, dout, lse, delta, mask, dq, batch_heads, heads, q_len, kv_len,
                                           causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
