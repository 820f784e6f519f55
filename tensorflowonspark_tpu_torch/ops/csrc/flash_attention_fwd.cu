// Flash-attention forward for Hopper (sm_90a), plain C entry point for ctypes.
//
// Replaces the TPU kernel `_fwd_kernel` (launched by `_fwd_impl`) in
// tensorflowonspark_tpu/ops/flash_attention.py: online-softmax attention over
// streamed K/V tiles with f32 scores scaled by `scale`, an additive key-padding
// bias (0 or -1e30), a causal and sliding-window mask by absolute position, and
// outputs `out` (q's dtype) and `lse = m + log l` (f32).  A row whose keys are
// all masked keeps m pinned at -1e30 and returns out = 0, lse = +1e30, exactly
// as the TPU kernel does.
//
// What bounds it on the H100.  Per (batch, head) the work is 4*Tq*Tk*D flops
// over (2*Tq + 2*Tk)*D elements, so at BERT's D = 64, T = 384 the arithmetic
// intensity (~96 flop/byte in bf16) sits below the card's ~295 flop/byte ridge:
// the ideal kernel is bound by HBM bytes, about 11 us for B=16, H=12.  What the
// design does about the bytes is what makes a flash kernel: the Tq x Tk score
// matrix never leaves the chip, each CTA reads its Q tile once and streams K/V
// once, and ragged edges are masked in the kernel instead of copying padded
// tensors.  q/k/v are read in their [B, T, H, D] layout through strides, so the
// caller makes no transposes.  What keeps it from the bound: the bf16 kernel
// uses the tensor cores through mma.sync (not wgmma, which Hopper needs for
// its full rate) and loads K/V synchronously (no TMA, no double buffering), so
// loads and math do not overlap inside a CTA; the float32 kernel runs its
// inner products as f32 FMAs on CUDA cores (67 TFLOP/s peak).  wgmma, TMA and
// warp specialisation are later work.
//
// Both kernels: one CTA of 128 threads per (64-query tile, head, batch), K/V
// tiles of 64 keys staged through shared memory, o/m/l in f32 registers.
//
// float32 (flash_fwd_f32_kernel): tiles staged as f32.  Thread (tr, tc) =
// (tid / 8, tid % 8) owns query rows tr + 16*i (i < 4); for the score tile it
// owns key columns tc + 8*j (j < 8), for the output tile head columns tc + 8*j
// (j < D/8).  The eight threads of a row are eight adjacent lanes, so row max
// and row sum are three xor-shuffles.
//
// bfloat16 (flash_fwd_mma_kernel): see the comment above it.
//
// Numerics kept from the TPU kernel: o, m, l accumulate in f32; p is rounded
// to the value dtype before the p.V product while l sums the unrounded p; the
// K loop is trimmed to the tiles a causal/windowed query tile can see.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-30f;

template <int D>
constexpr size_t f32_smem_bytes() {
  // Qs, Ks padded to D+1 floats a row (no bank conflicts on row-strided
  // reads), Vs unpadded (read along D), Ps padded to kBK+1, one bias row.
  return sizeof(float) *
         (size_t(kBQ) * (D + 1) + size_t(kBK) * (D + 1) + size_t(kBK) * D +
          size_t(kBQ) * (kBK + 1) + kBK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ lse, int H,
                     int Tq, int Tk, long long qsb, long long qst, long long qsh,
                     long long ksb, long long kst, long long ksh, long long vsb,
                     long long vst, long long vsh, float scale, int causal,
                     int window) {
  constexpr int DP = D + 1;
  constexpr int SP = kBK + 1;
  constexpr int OJ = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* Ps = Vs + kBK * D;
  float* bias_s = Ps + kBQ * SP;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tc = tid & 7;
  const int tr = tid >> 3;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    Qs[r * DP + d] = qi < Tq ? qb[qi * qst + d] : 0.f;
  }

  // Keys this query tile can see: all of them, or under causal masking
  // those at or below its last row, and under a window those above its
  // first row's band.
  int kbeg = 0, kend = Tk;
  if (causal) {
    kend = min(Tk, q0 + kBQ);
    if (window > 0) kbeg = max(0, q0 - (window - 1));
  }
  const int j0 = kbeg / kBK;
  const int nk = (kend + kBK - 1) / kBK;

  float m[4], l[4], o[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OJ; ++j) o[i][j] = 0.f;
  }

  for (int jt = j0; jt < nk; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the last tile's Ks/Vs/Ps reads are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int kj = k0 + r;
      const bool in = kj < Tk;
      Ks[r * DP + d] = in ? kb[kj * kst + d] : 0.f;
      Vs[r * D + d] = in ? vb[kj * vst + d] : 0.f;
    }
    if (tid < kBK) {
      const int kj = k0 + tid;
      float bias = kNegInf;  // ragged edge: padded keys never count
      if (kj < Tk) bias = (mask == nullptr || mask[(long long)b * Tk + kj]) ? 0.f : kNegInf;
      bias_s[tid] = bias;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tc + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr + 16 * i;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tc + 8 * j;
        float x = s[i][j] * scale + bias_s[col];
        if (causal) {
          const int kpos = k0 + col;
          bool keep = qpos >= kpos;
          if (window > 0) keep = keep && (kpos > qpos - window);
          if (!keep) x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[row * SP + tc + 8 * j] = p;  // f32 values: no rounding
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = Vs[kk * D + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

  __syncthreads();  // Qs is reused to stage the output tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tr + 16 * i;
    const bool valid = m[i] > kNegInf * 0.5f;
    const float lsafe = fmaxf(l[i], kEps);
#pragma unroll
    for (int j = 0; j < OJ; ++j)
      Qs[row * DP + tc + 8 * j] = valid ? o[i][j] / lsafe : 0.f;
    const int qi = q0 + row;
    if (tc == 0 && qi < Tq)
      lse[((long long)b * H + h) * Tq + qi] = valid ? m[i] + logf(lsafe) : -kNegInf;
  }
  __syncthreads();
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    if (qi < Tq)
      out[(((long long)b * Tq + qi) * H + h) * D + d] = Qs[r * DP + d];
  }
}

// ---------------------------------------------------------------- bf16 path
//
// bf16 inputs take the tensor cores: mma.sync m16n8k16 (bf16 in, f32
// accumulate).  Same CTA shape (128 threads, 64 queries, 64-key tiles); each
// warp owns 16 query rows.  Q's fragments stay in registers for the whole K
// loop; K and V tiles are staged in shared memory as bf16 with rows padded by
// 8 elements so that ldmatrix's eight row reads hit distinct banks.  S = Q.K^T
// lands in the mma accumulator layout (a thread holds rows g and g+8 of the
// warp's 16, columns 2t and 2t+1 of each 8-key group); after the online
// softmax the same registers, rounded to bf16, are the A operand of P.V, so P
// never touches shared memory.  Row max and sum are two xor-shuffles among
// the four lanes that share a row.

constexpr int kPad = 8;  // bf16 elements of padding per staged row

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(kBQ + 2 * kBK) * (D + kPad) +
         sizeof(float) * kBK;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int H, int Tq, int Tk, long long qsb, long long qst,
                     long long qsh, long long ksb, long long kst, long long ksh,
                     long long vsb, long long vst, long long vsh, float scale,
                     int causal, int window) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;    // k-steps of Q.K^T
  constexpr int NS = kBK / 8;   // 8-key column groups of S
  constexpr int NO = D / 8;     // 8-wide column groups of O
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;
  float* bias_s = reinterpret_cast<float*>(Vs + kBK * LD);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  stage_rows<D>(Qs, q + b * qsb + h * qsh, qst, q0, Tq, tid);
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  int kbeg = 0, kend = Tk;
  if (causal) {
    kend = min(Tk, q0 + kBQ);
    if (window > 0) kbeg = max(0, q0 - (window - 1));
  }
  const int j0 = kbeg / kBK;
  const int nk = (kend + kBK - 1) / kBK;

  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int jt = j0; jt < nk; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the last tile's Ks/Vs reads are done
    stage_rows<D>(Ks, kb, kst, k0, Tk, tid);
    stage_rows<D>(Vs, vb, vst, k0, Tk, tid);
    if (tid < kBK) {
      const int kj = k0 + tid;
      float bias = kNegInf;  // ragged edge: padded keys never count
      if (kj < Tk) bias = (mask == nullptr || mask[(long long)b * Tk + kj]) ? 0.f : kNegInf;
      bias_s[tid] = bias;
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bf[4];  // b0, b1 of key groups 2np and 2np+1
        ldmatrix_x4(bf, Ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bf[2], bf[3]);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale + bias_s[col];
        if (causal) {
          const int qpos = q0 + warp * 16 + g + (e >> 1) * 8;
          const int kpos = k0 + col;
          bool keep = qpos >= kpos;
          if (window > 0) keep = keep && (kpos > qpos - window);
          if (!keep) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      alpha[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        psum[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 1);
      psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 2);
      l[hh] = alpha[hh] * l[hh] + psum[hh];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P.V: P's A fragments come straight from S's accumulators, rounded
    // to bf16 (the TPU kernel's p.astype(v.dtype)).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bf[4];  // b0, b1 of head-dim groups 2dp and 2dp+1
        ldmatrix_x4_trans(bf, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + hh * 8;
    if (qi >= Tq) continue;
    const bool valid = m[hh] > kNegInf * 0.5f;
    const float lsafe = fmaxf(l[hh], kEps);
    __nv_bfloat16* orow = out + (((long long)b * Tq + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const float x0 = valid ? o[j][2 * hh] / lsafe : 0.f;
      const float x1 = valid ? o[j][2 * hh + 1] / lsafe : 0.f;
      *reinterpret_cast<uint32_t*>(orow + j * 8) = pack_bf16(x0, x1);
    }
    if (t == 0)
      lse[((long long)b * H + h) * Tq + qi] = valid ? m[hh] + logf(lsafe) : -kNegInf;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* lse, int B, int H, int Tq, int Tk, long long qsb,
           long long qst, long long qsh, long long ksb, long long kst,
           long long ksh, long long vsb, long long vst, long long vsh,
           float scale, int causal, int window, cudaStream_t stream) {
  // bf16 takes the tensor-core kernel, float32 the f32-FMA one
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr size_t smem = kMma ? mma_smem_bytes<D>() : f32_smem_bytes<D>();
  auto kernel = [] {
    if constexpr (kMma) return &flash_fwd_mma_kernel<D>;
    else return &flash_fwd_f32_kernel<D>;
  }();
  static bool configured = false;  // the attribute is per device function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, Tq, Tk, qsb, qst,
      qsh, ksb, kst, ksh, vsb, vst, vsh, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  mask: null, or a
// contiguous [B, Tk] bool array (1 = attend).  window <= 0: no window.
// Returns a cudaError_t (0 = launched); nothing is synchronised.
extern "C" int tfos_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* lse, int B, int H, int Tq, int Tk, int head_dim, int dtype,
    long long qsb, long long qst, long long qsh, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh, float scale,
    int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFOS_LAUNCH(T, D)                                                      \
  return launch<T, D>(q, k, v, mask, out, lse, B, H, Tq, Tk, qsb, qst, qsh,    \
                      ksb, kst, ksh, vsb, vst, vsh, scale, causal, window, s)
  if (dtype == 0 && head_dim == 64) TFOS_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) TFOS_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) TFOS_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) TFOS_LAUNCH(__nv_bfloat16, 128);
#undef TFOS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tfos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
