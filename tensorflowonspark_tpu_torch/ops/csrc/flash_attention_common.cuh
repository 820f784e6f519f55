// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): tile sizes, the key-padding bias, the bf16
// tensor-core fragments (ldmatrix, mma.sync m16n8k16) and the 16-byte row
// staging.  Each .cu builds into its own shared library, so every helper here
// has internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries a tile
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 128;  // four warps; in the bf16 kernels each owns 16 rows
constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-30f;
constexpr int kPad = 8;        // bf16 elements of padding per staged row

// Additive bias of key kj: 0 where it is attended, -1e30 where the mask hides
// it or where it lies past Tk (the ragged edge never counts).
__device__ __forceinline__ float key_bias(const uint8_t* __restrict__ mask, int b,
                                          int Tk, int kj) {
  if (kj >= Tk) return kNegInf;
  return (mask == nullptr || mask[(long long)b * Tk + kj]) ? 0.f : kNegInf;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16, row-major) * b (16x8, col-major); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments (16 rows x 16 columns) of rows [row0, row0 + 16) and columns
// [col0, col0 + 16) of a bf16 tile staged with leading dimension ld.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                       int ld, int row0, int col0, int lane) {
  ldmatrix_x4(r, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// The B fragments of two 8-column groups, for a product against the
// transpose of a staged tile: rows [n0, n0 + 16) of the tile are the two
// groups' columns, its columns [k0, k0 + 16) the contraction.  r[0], r[1]
// feed group n0 / 8; r[2], r[3] group n0 / 8 + 1.
__device__ __forceinline__ void load_b_t(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                         int ld, int n0, int k0, int lane) {
  ldmatrix_x4(r, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// The B fragments of two 8-column groups, for a product against a staged tile
// as it is: its rows [k0, k0 + 16) are the contraction, its columns
// [n0, n0 + 16) the two groups.
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                       int ld, int k0, int n0, int lane) {
  ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                           (lane >> 4) * 8);
}

// Rows [t0, t0 + 64) of a [T, D] slab into shared memory, 16 bytes a load;
// rows at or past T are zeros.  The wrapper checks the 16-byte alignment.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long stride_t, int t0, int T,
                                           int tid) {
  constexpr int kVec = 8;
  constexpr int kChunks = D / kVec;
  for (int idx = tid; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * kVec;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(src + t * stride_t + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

// The same for float32 rows, one element a load, into rows of D + 1 floats
// (the padding keeps row-strided reads on distinct banks).
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               long long stride_t, int t0, int T,
                                               int tid) {
  for (int idx = tid; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int t = t0 + r;
    dst[r * (D + 1) + d] = t < T ? src[t * stride_t + d] : 0.f;
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once per
// instantiation (the attribute belongs to the device function).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace

extern "C" const char* tfos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
