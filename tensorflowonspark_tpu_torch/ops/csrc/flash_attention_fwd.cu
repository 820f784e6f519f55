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
// caller makes no transposes.
//
// bfloat16 (flash_fwd_tma_kernel, see the comment above it) is built for
// Hopper: TMA loads K/V tiles into a ring of shared-memory stages guarded by
// mbarriers, so the next tile's copy overlaps this tile's math, and every
// product is a wgmma (hopper.cuh).  Each CTA's K/V loop is short at BERT's
// shape (384 keys: six 64-key tiles), so the load of the first tile is not
// hidden inside a CTA; two CTAs share an SM instead.  The softmax takes
// exp(x) as 2^(x log2 e) on the SFU, with log2 e folded into the scale.
// The tiles (64 queries a CTA, 64-key K/V tiles, 3 stages) were the
// fastest of four choices timed at the BERT shape (PERF.md, Findings).
//
// float32 (flash_fwd_f32_kernel): one CTA of 128 threads per (64-query tile,
// head, batch), K/V tiles of 64 keys staged through shared memory as f32,
// inner products as f32 FMAs on the CUDA cores (67 TFLOP/s peak).  Thread
// (tr, tc) = (tid / 8, tid % 8) owns query rows tr + 16*i (i < 4); for the
// score tile it owns key columns tc + 8*j (j < 8), for the output tile head
// columns tc + 8*j (j < D/8).  The eight threads of a row are eight adjacent
// lanes, so row max and row sum are three xor-shuffles.
//
// Numerics kept from the TPU kernel: o, m, l accumulate in f32; p is rounded
// to the value dtype before the p.V product while l sums the unrounded p; the
// K loop is trimmed to the tiles a causal/windowed query tile can see.

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace {

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
    if (tid < kBK) bias_s[tid] = key_bias(mask, b, Tk, k0 + tid);
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
// flash_fwd_tma_kernel: a CTA of one consumer warpgroup (64 queries) and
// one producer warp.  The producer loads the CTA's Q tile once, then
// streams 64-key K/V tiles through a ring of kFwdStages shared-memory stages
// by TMA, each stage guarded by a "full" mbarrier (the tile's bytes and the
// producer's 32 arrivals: its lanes also write the stage's key-padding bias
// row) and an "empty" one (one arrival a consumer warp).  Per tile, the
// consumer warpgroup:
//   S = Q.K^T       SS wgmma m64n64k16, Q and K both K-major;
//   scale, bias, causal/window mask and the online softmax in the
//   accumulator registers (per 8-column group the wgmma accumulator is
//   mma.sync's C layout: rows g and g + 8 of the warp's 16, columns 2t and
//   2t + 1), row max and sum over the 4 lanes of a row;
//   P rounded to bf16 and packed as A fragments in registers;
//   O += P.V        RS wgmma m64n64k16 per 64-column half, V MN-major;
// and releases the stage once the wgmma.wait_group that covers P.V returns,
// while the producer's next loads are already in flight.  Rows past Tk in a
// tile arrive as zeros (the TMA box's out-of-bounds fill) and carry a -1e30
// bias; rows past Tq are computed and not stored.

constexpr int kFwdStages = 3;               // K/V tiles in flight
constexpr int kFwdThreads = kThreads + 32;  // the consumer warpgroup, the producer warp

template <int D>
struct FwdTiles {
  static constexpr uint32_t kStageBytes = 2u * kBK * D * 2;  // K and V
  static constexpr size_t kSmem = kAtomBytes  // room to align the base to 1024
                                  + size_t(kBQ) * D * 2 + size_t(kFwdStages) * kStageBytes +
                                  size_t(kFwdStages) * kBK * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int H, int Tq, int Tk, float scale,
                     int causal, int window) {
  constexpr int STAGES = kFwdStages;
  constexpr int HALVES = D / 64;  // 64-column halves of the head
  constexpr int KS = D / 16;      // k-steps of Q.K^T
  constexpr int NS = kBK / 8;     // 8-key column groups of S
  constexpr int KK = kBK / 16;    // k-steps of P.V
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t q_bar, full_bar[STAGES], empty_bar[STAGES];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAtomBytes - 1) & ~uintptr_t(kAtomBytes - 1));
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base);  // [HALVES][kBQ][64]
  __nv_bfloat16* Ks = Qs + kBQ * D;            // [STAGES][HALVES][kBK][64]
  __nv_bfloat16* Vs = Ks + STAGES * kBK * D;   // [STAGES][HALVES][kBK][64]
  float* bias_s = reinterpret_cast<float*>(Vs + STAGES * kBK * D);  // [STAGES][kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // Keys this query tile can see: all of them, or under causal masking
  // those at or below its last row, and under a window those above its
  // first row's band.
  int kbeg = 0, kend = Tk;
  if (causal) {
    kend = min(Tk, q0 + kBQ);
    if (window > 0) kbeg = max(0, q0 - (window - 1));
  }
  const int j0 = kbeg / kBK;
  const int nk = max(0, (kend + kBK - 1) / kBK - j0);

  if (tid == 0) {
    mbar_init(&q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 32);
      mbar_init(&empty_bar[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(&q_bar, kBQ * D * 2);
      for (int hf = 0; hf < HALVES; ++hf)
        tma_load_tile(Qs + hf * kBQ * 64, &tm_q, &q_bar, hf * 64, h, q0, b);
    }
    for (int i = 0; i < nk; ++i) {
      const int st = i % STAGES;
      const int k0 = (j0 + i) * kBK;
      if (i >= STAGES) mbar_wait(&empty_bar[st], ((i / STAGES) & 1) ^ 1);
      for (int c = lane; c < kBK; c += 32)
        bias_s[st * kBK + c] = key_bias(mask, b, Tk, k0 + c) * kLog2e;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_bar[st], FwdTiles<D>::kStageBytes);
        for (int hf = 0; hf < HALVES; ++hf) {
          tma_load_tile(Ks + (st * HALVES + hf) * kBK * 64, &tm_k, &full_bar[st], hf * 64, h,
                        k0, b);
          tma_load_tile(Vs + (st * HALVES + hf) * kBK * 64, &tm_v, &full_bar[st], hf * 64, h,
                        k0, b);
        }
      } else {
        mbar_arrive(&full_bar[st]);
      }
    }
    return;
  }

  // the consumer warpgroup: rows wl * 16 + g (+ 8) of the CTA's tile
  const int wl = warp;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wl * 16 + g;

  float o[HALVES][32];
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[hf][r] = 0.f;
  // Scores are kept in log2 units (x log2 e): m is the running max of those,
  // p = 2^(x - m), and lse = m ln 2 + log l at the end.
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(&q_bar, 0);
  for (int i = 0; i < nk; ++i) {
    const int st = i % STAGES;
    const int k0 = (j0 + i) * kBK;
    const __nv_bfloat16* Kst = Ks + st * HALVES * kBK * 64;
    const __nv_bfloat16* Vst = Vs + st * HALVES * kBK * 64;
    const float* bias = bias_s + st * kBK;
    mbar_wait(&full_bar[st], (i / STAGES) & 1);

    float s[NS * 4];
#pragma unroll
    for (int r = 0; r < NS * 4; ++r) s[r] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_n64<0>(s, desc_k_major(Qs + (ks / 4) * kBQ * 64, 0, ks % 4),
                      desc_k_major(Kst + (ks / 4) * kBK * 64, 0, ks % 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        float x = fmaf(s[4 * j + e], scale2, bias[col]);
        if (causal) {
          const int qpos = row0 + (e >> 1) * 8;
          const int kpos = k0 + col;
          bool keep = qpos >= kpos;
          if (window > 0) keep = keep && (kpos > qpos - window);
          if (!keep) x = kNegInf;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      alpha[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int r = 0; r < NS * 4; ++r) {
      const float p = ex2(s[r] - m[(r >> 1) & 1]);
      psum[(r >> 1) & 1] += p;
      s[r] = p;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 1);
      psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 2);
      l[hh] = alpha[hh] * l[hh] + psum[hh];
    }
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int r = 0; r < 32; ++r) o[hf][r] *= alpha[(r >> 1) & 1];

    // O += P.V: P's A fragments come straight from S's accumulators, rounded
    // to bf16 (the TPU kernel's p.astype(v.dtype)).
    uint32_t pa[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) fence_regs(o[hf]);
    wgmma_fence();  // o was rescaled and pa written outside wgmma
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
        wgmma_rs_n64<1>(o[hf], pa[kk], desc_mn_major(Vst + hf * kBK * 64, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) fence_regs(o[hf]);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) fence_regs(pa[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = row0 + hh * 8;
    if (qi >= Tq) continue;
    const bool valid = m[hh] > kNegInf * 0.5f;
    const float lsafe = fmaxf(l[hh], kEps);
    __nv_bfloat16* orow = out + (((long long)b * Tq + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x0 = valid ? o[hf][4 * j + 2 * hh] / lsafe : 0.f;
        const float x1 = valid ? o[hf][4 * j + 2 * hh + 1] / lsafe : 0.f;
        *reinterpret_cast<uint32_t*>(orow + hf * 64 + j * 8) = pack_bf16(x0, x1);
      }
    if (t == 0)
      lse[((long long)b * H + h) * Tq + qi] = valid ? m[hh] * kLn2 + logf(lsafe) : -kNegInf;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* mask, void* out,
                void* lse, int B, int H, int Tq, int Tk, long long qsb, long long qst,
                long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
                long long vst, long long vsh, float scale, int causal, int window,
                cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err;
  if ((err = make_tile_map(&tm_q, q, B, Tq, H, D, qsb, qst, qsh, kBQ)) ||
      (err = make_tile_map(&tm_k, k, B, Tk, H, D, ksb, kst, ksh, kBK)) ||
      (err = make_tile_map(&tm_v, v, B, Tk, H, D, vsb, vst, vsh, kBK)))
    return (int)err;
  auto kernel = &flash_fwd_tma_kernel<D>;
  static bool configured = false;
  if ((err = allow_smem(kernel, FwdTiles<D>::kSmem, configured))) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kFwdThreads, FwdTiles<D>::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Tq, Tk, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* mask, void* out,
               void* lse, int B, int H, int Tq, int Tk, long long qsb, long long qst,
               long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
               long long vst, long long vsh, float scale, int causal, int window,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  auto kernel = &flash_fwd_f32_kernel<D>;
  static bool configured = false;
  if (cudaError_t err = allow_smem(kernel, smem, configured)) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), static_cast<float*>(lse), H, Tq, Tk, qsb, qst, qsh, ksb,
      kst, ksh, vsb, vst, vsh, scale, causal, window);
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
#define TFOS_LAUNCH(F, D)                                                      \
  return F<D>(q, k, v, mask, out, lse, B, H, Tq, Tk, qsb, qst, qsh, ksb, kst,  \
              ksh, vsb, vst, vsh, scale, causal, window, s)
  if (dtype == 0 && head_dim == 64) TFOS_LAUNCH(launch_f32, 64);
  if (dtype == 0 && head_dim == 128) TFOS_LAUNCH(launch_f32, 128);
  if (dtype == 1 && head_dim == 64) TFOS_LAUNCH(launch_bf16, 64);
  if (dtype == 1 && head_dim == 128) TFOS_LAUNCH(launch_bf16, 128);
#undef TFOS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
