// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): tile sizes, the key-padding bias, ldmatrix, the
// bf16 packing of f32 pairs and the float32 kernels' row staging.  Each .cu
// builds into its own shared library, so every helper here has internal
// linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries a tile
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 128;  // four warps: one warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-30f;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [t0, t0 + 64) of a float32 [T, D] slab into shared memory, one element
// a load, into rows of D + 1 floats (the padding keeps row-strided reads on
// distinct banks); rows at or past T are zeros.
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
