// Hopper (sm_90a) building blocks of the flash-attention kernels: TMA tensor
// maps and loads, mbarriers, wgmma shared-memory descriptors and the
// wgmma.mma_async products (bf16 in, f32 accumulate) in raw PTX.
//
// Tiles.  Every tile a kernel loads by TMA is rows x 64 bf16: one 128-byte
// row of a [B, T, H, D] tensor's head a tile row, with the 128-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_128B), so that an 8-row group is one 1024-byte
// swizzle atom and tiles sit on 1024-byte boundaries.  A head of D = 128 is
// two such tiles (its halves d < 64 and d >= 64), one after the other.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"; CUTLASS's
// make_gmma_desc has the canonical layouts):
//   K-major (the contraction runs along the 128-byte row: Q and K in Q.K^T,
//   K and Q, V and dO in the backward's transposed scores): start address
//   at the k-step's 32-byte column, stride between 8-row groups (SBO) 1024
//   bytes; the leading offset is unused inside one swizzle row.
//   MN-major (the operand's rows are the contraction: V in P.V, dO and Q in
//   the dK/dV products, read with tnspB = 1): start address at the k-step's
//   16th row, 8-row groups 1024 bytes apart.  The wrappers issue one product
//   per 64-column half, so the offset between 64-column blocks is never read;
//   both offsets are set to 1024 bytes.
//
// Register A operands (RS products) are loaded or packed anew for every
// tile: fragments loaded once and held in registers across a loop of
// products gave wrong results from the second tile on, in the dK/dV kernel
// (also with the held fragments pinned by fence_regs around every product
// and after every wait) and in a trial of the forward without setmaxnreg;
// the cause is not known.  So an operand that stays fixed across a loop is
// either reloaded by ldmatrix every tile (the dK/dV kernel's K and V at
// D = 64) or read from shared memory by every product (SS: Q in the
// forward, Q and dO in the dQ kernel).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

constexpr int kTileBytesPerRow = 128;  // 64 bf16
constexpr int kAtomBytes = 1024;       // 8 rows of 128 bytes

// ------------------------------------------------------------ tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over a bf16 [B, T, H, D] tensor read through its strides (elements;
// head_dim contiguous), boxes of `rows` x 64: dims (D, H, T, B), box
// (64, 1, rows, 1).  Rows at or past T are filled with zeros by the
// hardware.  TMA needs a 16-byte-aligned base and strides of whole 16
// bytes, which the wrapper checks.
cudaError_t make_tile_map(CUtensorMap* map, const void* base, int B, int T, int H, int D,
                          long long sb, long long st, long long sh, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// -------------------------------------------------------------- mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` more of TMA traffic in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// lasts 2^34 cycles (several seconds) can only be a broken pipeline: it
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ------------------------------------------------------------ exponential

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the SFU (ex2.approx, relative error ~2^-22; 0 for x <= -126): the
// kernels fold log2(e) into the score scale and take exp(x) as 2^(x log2 e).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------- TMA

// One rows x 64 box at (d0, h, t0, b) of `map` into `dst` (1024-aligned),
// completing on `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int d0, int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(h), "r"(t0),
      "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ----------------------------------------------------------------- wgmma

// Descriptor of a 128B-swizzled operand at shared address `p`.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (uint64_t(kAtomBytes >> 4) << 32) | (uint64_t(1) << 62);
}

// K-major: k-step ks (16 elements) of a rows x 64 tile, rows from row0
// (a multiple of 8).
__device__ __forceinline__ uint64_t desc_k_major(const __nv_bfloat16* tile, int row0, int ks) {
  return desc_sw128(reinterpret_cast<const char*>(tile) + row0 * kTileBytesPerRow + ks * 32,
                    16);
}

// MN-major (read with tnspB = 1): k-step kk (16 rows) of a rows x 64 tile.
__device__ __forceinline__ uint64_t desc_mn_major(const __nv_bfloat16* tile, int kk) {
  return desc_sw128(reinterpret_cast<const char*>(tile) + kk * 16 * kTileBytesPerRow,
                    kAtomBytes);
}

// The A fragments of k-step ks (16 head columns) of the 16 rows from row0 of
// a TMA tile of rows x 64 (128B-swizzled; a D = 128 head is two such tiles,
// `rows` rows apart), by ldmatrix.
__device__ __forceinline__ void load_a_sw128(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                             int rows, int row0, int ks, int lane) {
  const int row = row0 + (lane & 15);
  const int chunk = ((ks % 4) * 2 + (lane >> 4)) ^ (row & 7);  // 16-byte chunk, swizzled
  ldmatrix_x4(r, reinterpret_cast<const char*>(tile) + (ks / 4) * rows * kTileBytesPerRow +
                     row * kTileBytesPerRow + chunk * 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Hand registers between warpgroups (all four warps of a warpgroup run it):
// a producer gives up what it does not need, consumers take it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// not move their uses across this point (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (m64 x n64, f32) += A . B, A and B read from shared memory through
// their descriptors; scale_d = 0 overwrites d instead of adding.
template <int TnspB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TnspB));
}

// d (m64 x n64, f32) += A . B, A from registers (mma.sync's A fragment
// layout, one 16-row slab a warp), B from shared memory.
template <int TnspB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TnspB));
}

}  // namespace
