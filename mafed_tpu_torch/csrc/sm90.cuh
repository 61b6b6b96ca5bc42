// Hopper (sm_90a) building blocks for the flash kernels: TMA tile loads,
// mbarriers, wgmma and its shared-memory descriptors, and the host-side
// tensor maps. Inline PTX only; nothing here allocates or synchronises the
// device.
//
// Shared-memory tiles. Every bf16 tile is [64 rows][D] and is stored as
// ceil(D/64) panels of [64 rows][64 columns]: one row of a panel is 128
// bytes, and TMA writes it with the 128-byte swizzle (the 16-byte chunk c of
// row r lands at chunk c ^ (r % 8)). A panel is 8 KB and 1024-byte aligned, so
// the swizzle, which is a function of the shared address, is the same for TMA
// and wgmma. Columns past D (D = 96: 96..127 of the second panel) arrive as
// zeros.
//
// wgmma m64n64k16 reads such a panel in two ways:
//   K-major (rows are M or N, the 64 columns are K): k-step kk starts 32 bytes
//     further along the row; SBO = 1024 bytes (the next 8 rows), LBO unused.
//   MN-major (rows are K, the 64 columns are N; B of P.V, P^T.dO, dS^T.Q):
//     k-step kk starts 16 rows (2048 bytes) further down; SBO = 1024 bytes
//     (the next 8 rows of K), LBO = the next 64-column panel: the forward at
//     D = 128 and 256 reads V's N over all of its panels in one m64n128k16 or
//     m64n256k16 (`wgmma_rs_n128`, `wgmma_rs_n256`); unused at N = 64.
//
// The bf16 forward at D = 96 stores its tiles without padding: three panels
// of [64 rows][32 columns], a row 64 bytes, written by TMA with the 64-byte
// swizzle (the 16-byte chunk c of row r lands at chunk c ^ ((r / 2) % 4); the
// pattern repeats every 512 bytes, 8 rows). A panel is 4 KB. Its descriptors
// (layout type 2, `desc_sw64`):
//   K-major (Q and K of S = Q K^T): k-step kk is panel kk / 2, 32 bytes along
//     the row for odd kk; SBO = 512 bytes (the next 8 rows), LBO unused.
//   MN-major (V of O += P V, N = 96 in one product): k-step kk starts 16 rows
//     (1024 bytes) further down; SBO = 512 bytes (the next 8 rows of K), LBO =
//     the next 32-column panel (4 KB: N runs over three panels).
// The bf16 dK/dV kernel at D = 256 also writes two [64 keys][64 queries]
// panels itself (P^T and dS^T, bf16, in the 128-byte layout TMA would give
// them: `sw128_offset`) and reads them K-major as the A operand of m64n128k16
// products whose B (dO, Q) is MN-major (`wgmma_ss_n128`); a thread's stores
// reach wgmma's reads through `fence_proxy_async` and a barrier.
// tests/test_torch_d96_layout.py, tests/test_torch_fwd_layout.py and
// tests/test_torch_dkv_layout.py emulate the TMA writes and these reads.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int PANEL = 64;                          // columns of a panel (128 bytes of bf16)
constexpr uint32_t PANEL_BYTES = 64 * PANEL * 2;   // one [64][64] bf16 panel
constexpr int PANEL_SW64 = 32;                               // columns of a 64-byte-swizzled panel
constexpr uint32_t PANEL_SW64_BYTES = 64 * PANEL_SW64 * 2;   // one [64][32] bf16 panel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A phase that never
// completes (a load that was never issued) traps, which fails the launch,
// instead of hanging the device: no wait in these kernels lasts a millisecond.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t spins = 0; !mbar_try_wait(addr, parity); ++spins)
    if (spins == (1u << 26)) __trap();
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Box {64 columns, 64 rows, 1} at (col, row, plane) of a 3-D map into `dst`;
// completion is counted on `bar`. Rows past the map's length arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row,
                                            int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// A [64][D] tile: ceil(D/64) panels of one box each, all on one barrier; a
// box counts its whole 8 KB on the barrier, the zeros past the map's edge
// included.
template <int D>
__device__ __forceinline__ void tma_load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                              int plane) {
#pragma unroll
  for (int p = 0; p < (D + PANEL - 1) / PANEL; ++p)
    tma_load_3d(dst + p * PANEL_BYTES, map, bar, p * PANEL, row, plane);
}

// A [64][D] tile as D / 32 panels of [64][32], one box each of a map made by
// make_map_3d_sw64, all on one barrier.
template <int D>
__device__ __forceinline__ void tma_load_tile_sw64(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                                   int plane) {
  static_assert(D % PANEL_SW64 == 0, "no padded panel");
#pragma unroll
  for (int p = 0; p < D / PANEL_SW64; ++p)
    tma_load_3d(dst + p * PANEL_SW64_BYTES, map, bar, p * PANEL_SW64, row, plane);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptors take the tile's shared-memory address (smem_addr). Inside a
// loop, pass it through `opaque` first: then the compiler rebuilds each
// descriptor where a wgmma uses it instead of hoisting all of them out of the
// loop and holding them in registers (at D = 256 the 16 k-steps of two
// once-loaded tiles would hold 64 registers).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

// K-major operand: k-step kk of a [64][D] tile at shared address `tile`.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * PANEL_BYTES + (kk % 4) * 32, 16, 1024);
}

// MN-major B operand: rows [16 kk, 16 kk + 16) of panel n of a [64][D] tile.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int n, int kk) {
  return desc_sw128(tile + n * PANEL_BYTES + kk * 2048, PANEL_BYTES, 1024);
}

__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= 2ull << 62;  // 64-byte swizzle
  return d;
}

// K-major operand: k-step kk of a [64][D] tile of 32-column panels at shared address `tile`.
__device__ __forceinline__ uint64_t desc_k_major_sw64(uint32_t tile, int kk) {
  return desc_sw64(tile + (kk / 2) * PANEL_SW64_BYTES + (kk % 2) * 32, 16, 512);
}

// MN-major B operand: rows [16 kk, 16 kk + 16) of a [64][D] tile of 32-column
// panels, all of its D columns.
__device__ __forceinline__ uint64_t desc_mn_major_sw64(uint32_t tile, int kk) {
  return desc_sw64(tile + kk * 1024, PANEL_SW64_BYTES, 512);
}

// Byte offset of element (row, col) of a [64][64] bf16 panel in the 128-byte
// swizzle (the 16-byte chunk c of row r at chunk c ^ (r % 8)), as TMA writes
// it and desc_k_major reads it; the panel 1024-byte aligned.
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Orders this thread's generic shared-memory stores before later reads of the
// async proxy (wgmma's operands), once a barrier has passed.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most N committed groups are still in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the order of register reads and writes of an accumulator against the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_D32                                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),  \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_D32_LIST                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A . B, m64n64k16, A and B both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#define SM90_D16                                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SM90_D16_LIST "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (+)= A . B, m64n32k16, A and B both K-major in shared memory (B's 32 rows
// are N).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SM90_D16_LIST ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D16
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A . B, m64n64k16, A from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#define SM90_D48                                                                                                \
  SM90_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]),        \
      "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
      "+f"(d[47])
#define SM90_D48_LIST                                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47}"

// d += A . B, m64n96k16, A from registers (as in wgmma_rs), B MN-major in
// shared memory (desc_mn_major_sw64: 96 columns over three 32-column panels).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " SM90_D48_LIST
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D48
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#define SM90_D64 SM90_D32,                                                                                   \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_D64_LIST "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "           \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "           \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define SM90_D128 SM90_D64,                                                                                          \
    "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),          \
    "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),          \
    "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),          \
    "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),          \
    "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),      \
    "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),  \
    "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
    "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define SM90_D128_LIST "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                 \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                 \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                 \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                 \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                 \
    "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "     \
    "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d += A . B, m64n128k16, A from registers (as in wgmma_rs), B MN-major in
// shared memory (desc_mn_major: 128 columns over two 64-column panels, LBO).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A . B, m64n128k16, A K-major in shared memory, B MN-major in shared
// memory (desc_mn_major: 128 columns over two 64-column panels, LBO).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64_LIST ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : SM90_D64
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d += A . B, m64n256k16, A from registers (as in wgmma_rs), B MN-major in
// shared memory (desc_mn_major: 256 columns over four 64-column panels, LBO).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_D128_LIST
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef SM90_D128
#undef SM90_D128_LIST
#undef SM90_D64
#undef SM90_D64_LIST
#undef SM90_D48
#undef SM90_D48_LIST
#undef SM90_D32
#undef SM90_D32_LIST
#undef SM90_D16
#undef SM90_D16_LIST

// 2^x on the special-function unit; -inf gives 0, results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of m64nNk16 (f32): thread t of the warpgroup holds, for
// each 8-column block j, d[4j + 2i + c] = element (16 (t / 32) + (t % 32) / 4
// + 8 i, 8 j + 2 (t % 4) + c). Two bf16 of one register, low half first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The accumulator of a 64-column product as the A operand of the next
// product, k-step kk (columns 16 kk .. 16 kk + 15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

namespace sm90_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime has loaded, so
// that the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A contiguous [planes, rows, d] bf16 tensor, read in boxes of {64, 64, 1}
// with the 128-byte swizzle. Rows past `rows` of a plane, and columns past d
// (d = 96), read as zeros.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* ptr, int planes, int rows, int d) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same tensor as make_map_3d's, read in boxes of {32, 64, 1} with the
// 64-byte swizzle (tma_load_tile_sw64): d a multiple of 32, so no box reaches
// past column d - 1.
inline cudaError_t make_map_3d_sw64(CUtensorMap* map, const void* ptr, int planes, int rows, int d) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorMisalignedAddress;
  if (d % 32 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {32, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90_host
