// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, plain C entry points for ctypes.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` (launched by
// `_bwd_impl`) in tensorflowonspark_tpu/ops/flash_attention.py.  Both recompute
// the attention probabilities from the forward's saved log-sum-exp instead of
// storing them: p = exp(s * scale + bias - lse), with the forward's key-padding
// bias (0 or -1e30), causal and sliding-window masks by absolute position.  With
// dO the output's gradient and delta = rowsum(out * dO) (computed by the caller):
//   dQ kernel:   dp = dO.V^T, ds = p * (dp - delta), dq = scale * sum_k ds.K
//   dK/dV kernel: dv = sum_q p^T.dO, dk = scale * sum_q ds^T.q
// A row whose keys are all masked has lse = +1e30, so its p, and its share of
// every gradient, is exactly 0.
//
// What bounds them on the H100.  At BERT's shape (B=16, T=384, H=12, D=64,
// bf16) the dQ kernel does three T x T x D products a (batch, head) over q, k,
// v, dO, lse, delta and dq (~48 MB, ~14 us at 3.35 TB/s; ~11 GFLOP, ~11 us at
// 989 TFLOP/s), the dK/dV kernel four products over the same plus dk (~57 MB,
// ~17 us; ~15 GFLOP, ~15 us): both sit at the ridge, bound by bytes by a
// small margin.  What the design does about the bytes: the T x T probability
// and gradient tiles never leave the chip, each CTA reads its own rows once and
// streams the other side's tiles, and q/k/v/dO are read through their strides
// in the [B, T, H, D] layout with the ragged edges masked in the kernel, so the
// caller makes no transposes or padded copies.  Each kernel owns its output
// tile, so no atomics are needed and the results are deterministic.  What
// keeps them from the bound: mma.sync (not wgmma), synchronous tile loads with
// no double buffering, and the dK/dV kernel re-reads the Q/dO tiles once per
// key tile; wgmma, TMA and a fused kernel are later work.
//
// Both kernels: one CTA of 128 threads per (64-row tile, head, batch); the
// other side streams through shared memory in 64-row tiles.
//   dQ:   CTA per 64 queries; K/V tiles stream; dq accumulates in f32.
//   dK/dV: CTA per 64 keys; Q/dO/lse/delta tiles stream, from the causal
//         diagonal and up to the end of the window; dk, dv accumulate in f32.
//
// bfloat16 takes the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate): each warp owns 16 rows of its CTA's tile; the score-shaped
// accumulators (S, dP) are re-packed to bf16 as the A operand of the next
// product, so p and ds never touch shared memory.  Numerics: dQ rounds ds to
// k's dtype before ds.K, as the TPU kernel does; dK/dV rounds p and ds to bf16
// before p^T.dO and ds^T.q, where the TPU kernel keeps them in f32, so its
// bf16 results differ from the plain version by a relative ~2^-9 a term.
// float32 keeps every value in f32 and runs its products as FMAs on the CUDA
// cores (67 TFLOP/s peak), with thread (tr, tc) = (tid / 8, tid % 8) owning
// rows tr + 16 i (i < 4) and columns tc + 8 j of each tile.

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

// Strides (elements) of q, k, v and dO over batch, sequence and head.
struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
};

// The tiles a causal/windowed query tile at q0 can see: keys [kbeg, kend).
__device__ __forceinline__ void key_range(int q0, int Tk, int causal, int window,
                                          int& kbeg, int& kend) {
  kbeg = 0;
  kend = Tk;
  if (causal) {
    kend = min(Tk, q0 + kBQ);
    if (window > 0) kbeg = max(0, q0 - (window - 1));
  }
}

// The queries [qbeg, qend) that can see some key of the tile at k0.
__device__ __forceinline__ void query_range(int k0, int Tq, int causal, int window,
                                            int& qbeg, int& qend) {
  qbeg = 0;
  qend = Tq;
  if (causal) {
    qbeg = min(Tq, k0);
    if (window > 0) qend = min(Tq, k0 + kBK - 1 + window);
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  if (!causal) return true;
  return qpos >= kpos && (window <= 0 || kpos > qpos - window);
}

// ------------------------------------------------------------- float32 dQ

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  // Qs, dOs, Ks, Vs of D + 1 floats a row; the ds tile of kBK + 1; one bias row
  return sizeof(float) * (4 * size_t(64) * (D + 1) + size_t(kBQ) * (kBK + 1) + kBK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const uint8_t* __restrict__ mask,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int H,
                    int Tq, int Tk, Strides st, float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int SP = kBK + 1;
  constexpr int OJ = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * DP;
  float* Ks = dOs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* dSs = Vs + kBK * DP;
  float* bias_s = dSs + kBQ * SP;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tc = tid & 7;
  const int tr = tid >> 3;

  stage_rows_f32<D>(Qs, q + b * st.qb + h * st.qh, st.qt, q0, Tq, tid);
  stage_rows_f32<D>(dOs, dout + b * st.ob + h * st.oh, st.ot, q0, Tq, tid);
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;

  float lse_r[4], delta_r[4];  // rows past Tq: p = 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    const long long at = ((long long)b * H + h) * Tq + qi;
    lse_r[i] = qi < Tq ? lse[at] : -kNegInf;
    delta_r[i] = qi < Tq ? delta[at] : 0.f;
  }

  int kbeg, kend;
  key_range(q0, Tk, causal, window, kbeg, kend);
  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;

  for (int jt = kbeg / kBK; jt < (kend + kBK - 1) / kBK; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the last tile's Ks/Vs/dSs reads are done
    stage_rows_f32<D>(Ks, kb, st.kt, k0, Tk, tid);
    stage_rows_f32<D>(Vs, vb, st.vt, k0, Tk, tid);
    if (tid < kBK) bias_s[tid] = key_bias(mask, b, Tk, k0 + tid);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(tr + 16 * i) * DP + d];
        ov[i] = dOs[(tr + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[(tc + 8 * j) * DP + d];
        vv[j] = Vs[(tc + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tc + 8 * j;
        float x = s[i][j] * scale + bias_s[col];
        if (!visible(q0 + row, k0 + col, causal, window)) x = kNegInf;
        const float p = expf(x - lse_r[i]);
        dSs[row * SP + col] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();  // dSs complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float dsv[4], kv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(tr + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) kv[j] = Ks[kk * DP + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Tq) continue;
    float* row = dq + (((long long)b * Tq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < OJ; ++j) row[tc + 8 * j] = acc[i][j] * scale;
  }
}

// ---------------------------------------------------------- float32 dK/dV

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  // Ks, Vs, Qs, dOs of D + 1 floats a row; the p and ds tiles of kBQ + 1;
  // lse and delta of the query tile
  return sizeof(float) *
         (4 * size_t(64) * (D + 1) + 2 * size_t(kBK) * (kBQ + 1) + 2 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ mask,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Tq, int Tk, Strides st,
                     float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int SP = kBQ + 1;
  constexpr int OJ = D / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * DP;
  float* Qs = Vs + kBK * DP;
  float* dOs = Qs + kBQ * DP;
  float* Ps = dOs + kBQ * DP;
  float* dSs = Ps + kBK * SP;
  float* lse_s = dSs + kBK * SP;
  float* delta_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tc = tid & 7;
  const int tr = tid >> 3;

  stage_rows_f32<D>(Ks, k + b * st.kb + h * st.kh, st.kt, k0, Tk, tid);
  stage_rows_f32<D>(Vs, v + b * st.vb + h * st.vh, st.vt, k0, Tk, tid);
  const float* qb = q + b * st.qb + h * st.qh;
  const float* ob = dout + b * st.ob + h * st.oh;
  const long long lse_row = ((long long)b * H + h) * Tq;

  float bias_r[4];  // rows are keys here
#pragma unroll
  for (int i = 0; i < 4; ++i) bias_r[i] = key_bias(mask, b, Tk, k0 + tr + 16 * i);

  int qbeg, qend;
  query_range(k0, Tq, causal, window, qbeg, qend);
  float dka[4][OJ], dva[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = qbeg / kBQ; it < (qend + kBQ - 1) / kBQ; ++it) {
    const int q0 = it * kBQ;
    __syncthreads();  // the last tile's Qs/dOs/Ps/dSs reads are done
    stage_rows_f32<D>(Qs, qb, st.qt, q0, Tq, tid);
    stage_rows_f32<D>(dOs, ob, st.ot, q0, Tq, tid);
    if (tid < kBQ) {  // queries past Tq: p = 0
      const int qi = q0 + tid;
      lse_s[tid] = qi < Tq ? lse[lse_row + qi] : -kNegInf;
      delta_s[tid] = qi < Tq ? delta[lse_row + qi] : 0.f;
    }
    __syncthreads();

    // p^T = exp(K.Q^T * scale + bias - lse): rows keys, columns queries
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[4], qv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = Ks[(tr + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) qv[j] = Qs[(tc + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tc + 8 * j;
        float x = s[i][j] * scale + bias_r[i];
        if (!visible(q0 + col, k0 + row, causal, window)) x = kNegInf;
        Ps[row * SP + col] = expf(x - lse_s[col]);
      }
    }

    // dp^T = V.dO^T; ds^T = p^T * (dp^T - delta).  Each thread reads back only
    // the p values it wrote, so no barrier is needed before this.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float vv[4], ov[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) vv[i] = Vs[(tr + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) ov[j] = dOs[(tc + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(vv[i], ov[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tc + 8 * j;
        dSs[row * SP + col] = Ps[row * SP + col] * (s[i][j] - delta_s[col]);
      }
    }
    __syncthreads();  // Ps and dSs complete

    // dv += p^T.dO, dk += ds^T.q
#pragma unroll 2
    for (int qq = 0; qq < kBQ; ++qq) {
      float pv[4], dsv[4], ov[OJ], qv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(tr + 16 * i) * SP + qq];
        dsv[i] = dSs[(tr + 16 * i) * SP + qq];
      }
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        ov[j] = dOs[qq * DP + tc + 8 * j];
        qv[j] = Qs[qq * DP + tc + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          dva[i][j] = fmaf(pv[i], ov[j], dva[i][j]);
          dka[i][j] = fmaf(dsv[i], qv[j], dka[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + tr + 16 * i;
    if (kj >= Tk) continue;
    const long long at = (((long long)b * Tk + kj) * H + h) * D;
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      dk[at + tc + 8 * j] = dka[i][j] * scale;
      dv[at + tc + 8 * j] = dva[i][j];
    }
  }
}

// ----------------------------------------------------------------- bf16 dQ
//
// Each warp owns 16 queries.  Per K/V tile, S = Q.K^T and dP = dO.V^T land in
// the mma accumulator layout (a thread holds rows g and g + 8 of the warp's
// 16, columns 2t and 2t + 1 of each 8-key group); ds is formed in place in S's
// registers, rounded to bf16 and multiplied by the K tile read transposed.

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(2 * kBQ + 2 * kBK) * (D + kPad) +
         sizeof(float) * kBK;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const uint8_t* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Tq, int Tk, Strides st,
                    float scale, int causal, int window) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;   // k-steps over the head dim
  constexpr int NS = kBK / 8;  // 8-key column groups of S
  constexpr int NO = D / 8;    // 8-wide column groups of dq
  extern __shared__ __align__(16) unsigned char smem_dq[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_dq);
  __nv_bfloat16* dOs = Qs + kBQ * LD;
  __nv_bfloat16* Ks = dOs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;
  float* bias_s = reinterpret_cast<float*>(Vs + kBK * LD);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  stage_rows<D>(Qs, q + b * st.qb + h * st.qh, st.qt, q0, Tq, tid);
  stage_rows<D>(dOs, dout + b * st.ob + h * st.oh, st.ot, q0, Tq, tid);
  const __nv_bfloat16* kb = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + h * st.vh;

  float lse_r[2], delta_r[2];  // rows g and g + 8; past Tq: p = 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + 8 * hh;
    const long long at = ((long long)b * H + h) * Tq + qi;
    lse_r[hh] = qi < Tq ? lse[at] : -kNegInf;
    delta_r[hh] = qi < Tq ? delta[at] : 0.f;
  }

  int kbeg, kend;
  key_range(q0, Tk, causal, window, kbeg, kend);
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int jt = kbeg / kBK; jt < (kend + kBK - 1) / kBK; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the last tile's Ks/Vs reads are done (and Qs/dOs staged)
    stage_rows<D>(Ks, kb, st.kt, k0, Tk, tid);
    stage_rows<D>(Vs, vb, st.vt, k0, Tk, tid);
    if (tid < kBK) bias_s[tid] = key_bias(mask, b, Tk, k0 + tid);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], oa[4];
      load_a(qa, Qs, LD, warp * 16, ks * 16, lane);
      load_a(oa, dOs, LD, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4], vf[4];
        load_b_t(kf, Ks, LD, np * 16, ks * 16, lane);
        load_b_t(vf, Vs, LD, np * 16, ks * 16, lane);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * np], oa, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], oa, vf[2], vf[3]);
      }
    }

#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int hh = e >> 1;
        float x = s[j][e] * scale + bias_s[col];
        if (!visible(q0 + warp * 16 + g + 8 * hh, k0 + col, causal, window)) x = kNegInf;
        s[j][e] = expf(x - lse_r[hh]) * (dp[j][e] - delta_r[hh]);  // ds
      }
    }

    // dq += ds.K: ds's A fragments come straight from its accumulators,
    // rounded to bf16 (the TPU kernel's ds.astype(k.dtype)).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
        uint32_t kf[4];
        load_b(kf, Ks, LD, kk * 16, dp2 * 16, lane);
        mma_bf16(acc[2 * dp2], da, kf[0], kf[1]);
        mma_bf16(acc[2 * dp2 + 1], da, kf[2], kf[3]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + 8 * hh;
    if (qi >= Tq) continue;
    __nv_bfloat16* row = dq + (((long long)b * Tq + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(acc[j][2 * hh] * scale, acc[j][2 * hh + 1] * scale);
  }
}

// -------------------------------------------------------------- bf16 dK/dV
//
// Each warp owns 16 keys.  Per Q/dO tile, S^T = K.Q^T and dP^T = V.dO^T land
// with keys as rows and queries as columns, so p^T and ds^T are A operands as
// they stand: dv += p^T.dO and dk += ds^T.q take the Q/dO tiles read
// transposed.  lse and delta are per column here, read from shared memory.

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(2 * kBK + 2 * kBQ) * (D + kPad) +
         sizeof(float) * 2 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int H, int Tq, int Tk, Strides st, float scale, int causal,
                     int window) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;   // k-steps over the head dim
  constexpr int NS = kBQ / 8;  // 8-query column groups of S^T
  constexpr int NO = D / 8;    // 8-wide column groups of dk, dv
  extern __shared__ __align__(16) unsigned char smem_dkv[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_dkv);
  __nv_bfloat16* Vs = Ks + kBK * LD;
  __nv_bfloat16* Qs = Vs + kBK * LD;
  __nv_bfloat16* dOs = Qs + kBQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kBQ * LD);
  float* delta_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  stage_rows<D>(Ks, k + b * st.kb + h * st.kh, st.kt, k0, Tk, tid);
  stage_rows<D>(Vs, v + b * st.vb + h * st.vh, st.vt, k0, Tk, tid);
  const __nv_bfloat16* qb = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* ob = dout + b * st.ob + h * st.oh;
  const long long lse_row = ((long long)b * H + h) * Tq;

  float bias_r[2];  // keys g and g + 8 of the warp's 16
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    bias_r[hh] = key_bias(mask, b, Tk, k0 + warp * 16 + g + 8 * hh);

  int qbeg, qend;
  query_range(k0, Tq, causal, window, qbeg, qend);
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = qbeg / kBQ; it < (qend + kBQ - 1) / kBQ; ++it) {
    const int q0 = it * kBQ;
    __syncthreads();  // the last tile's Qs/dOs reads are done (and Ks/Vs staged)
    stage_rows<D>(Qs, qb, st.qt, q0, Tq, tid);
    stage_rows<D>(dOs, ob, st.ot, q0, Tq, tid);
    if (tid < kBQ) {  // queries past Tq: p = 0
      const int qi = q0 + tid;
      lse_s[tid] = qi < Tq ? lse[lse_row + qi] : -kNegInf;
      delta_s[tid] = qi < Tq ? delta[lse_row + qi] : 0.f;
    }
    __syncthreads();

    float s[NS][4];  // S^T, then p^T, then ds^T
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4];
      load_a(ka, Ks, LD, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t qf[4];
        load_b_t(qf, Qs, LD, np * 16, ks * 16, lane);
        mma_bf16(s[2 * np], ka, qf[0], qf[1]);
        mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int hh = e >> 1;
        float x = s[j][e] * scale + bias_r[hh];
        if (!visible(q0 + col, k0 + warp * 16 + g + 8 * hh, causal, window)) x = kNegInf;
        s[j][e] = expf(x - lse_s[col]);
      }
    }

    // dv += p^T.dO (p rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
        uint32_t of[4];
        load_b(of, dOs, LD, kk * 16, dp2 * 16, lane);
        mma_bf16(dva[2 * dp2], pa, of[0], of[1]);
        mma_bf16(dva[2 * dp2 + 1], pa, of[2], of[3]);
      }
    }

    // dp^T = V.dO^T; ds^T = p^T * (dp^T - delta)
    float dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t va[4];
      load_a(va, Vs, LD, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t of[4];
        load_b_t(of, dOs, LD, np * 16, ks * 16, lane);
        mma_bf16(dp[2 * np], va, of[0], of[1]);
        mma_bf16(dp[2 * np + 1], va, of[2], of[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] *= dp[j][e] - delta_s[j * 8 + 2 * t + (e & 1)];

    // dk += ds^T.q (ds rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
        uint32_t qf[4];
        load_b(qf, Qs, LD, kk * 16, dp2 * 16, lane);
        mma_bf16(dka[2 * dp2], da, qf[0], qf[1]);
        mma_bf16(dka[2 * dp2 + 1], da, qf[2], qf[3]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = k0 + warp * 16 + g + 8 * hh;
    if (kj >= Tk) continue;
    const long long at = (((long long)b * Tk + kj) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + j * 8) =
          pack_bf16(dka[j][2 * hh] * scale, dka[j][2 * hh + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + j * 8) =
          pack_bf16(dva[j][2 * hh], dva[j][2 * hh + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* mask,
              const void* dout, const void* lse, const void* delta, void* dq, int B,
              int H, int Tq, int Tk, const Strides& st, float scale, int causal,
              int window, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr size_t smem = kMma ? dq_mma_smem_bytes<D>() : dq_f32_smem_bytes<D>();
  auto kernel = [] {
    if constexpr (kMma) return &flash_dq_mma_kernel<D>;
    else return &flash_dq_f32_kernel<D>;
  }();
  static bool configured = false;
  if (cudaError_t err = allow_smem(kernel, smem, configured)) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Tq, Tk, st, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* mask,
               const void* dout, const void* lse, const void* delta, void* dk,
               void* dv, int B, int H, int Tq, int Tk, const Strides& st,
               float scale, int causal, int window, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr size_t smem = kMma ? dkv_mma_smem_bytes<D>() : dkv_f32_smem_bytes<D>();
  auto kernel = [] {
    if constexpr (kMma) return &flash_dkv_mma_kernel<D>;
    else return &flash_dkv_f32_kernel<D>;
  }();
  static bool configured = false;
  if (cudaError_t err = allow_smem(kernel, smem, configured)) return (int)err;
  dim3 grid((Tk + kBK - 1) / kBK, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, st, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  mask: null, or a
// contiguous [B, Tk] bool array (1 = attend).  lse, delta: contiguous
// [B, H, Tq] float32.  q/k/v/dout are read through the strides given (head_dim
// contiguous); dq/dk/dv are written contiguous [B, T, H, D].  window <= 0: no
// window.  Each returns a cudaError_t (0 = launched); nothing is synchronised.
#define TFOS_BWD_ARGS                                                            \
  const void *q, const void *k, const void *v, const void *mask,               \
      const void *dout, const void *lse, const void *delta
#define TFOS_BWD_SHAPE                                                           \
  int B, int H, int Tq, int Tk, int head_dim, int dtype, long long qsb,        \
      long long qst, long long qsh, long long ksb, long long kst, long long ksh, \
      long long vsb, long long vst, long long vsh, long long osb, long long ost, \
      long long osh, float scale, int causal, int window, void *stream

extern "C" int tfos_flash_attention_bwd_dq(TFOS_BWD_ARGS, void* dq, TFOS_BWD_SHAPE) {
  const Strides st{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFOS_LAUNCH(T, D)                                                       \
  return launch_dq<T, D>(q, k, v, mask, dout, lse, delta, dq, B, H, Tq, Tk, st, \
                         scale, causal, window, s)
  if (dtype == 0 && head_dim == 64) TFOS_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) TFOS_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) TFOS_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) TFOS_LAUNCH(__nv_bfloat16, 128);
#undef TFOS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int tfos_flash_attention_bwd_dkv(TFOS_BWD_ARGS, void* dk, void* dv,
                                            TFOS_BWD_SHAPE) {
  const Strides st{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFOS_LAUNCH(T, D)                                                           \
  return launch_dkv<T, D>(q, k, v, mask, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, \
                          scale, causal, window, s)
  if (dtype == 0 && head_dim == 64) TFOS_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) TFOS_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) TFOS_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) TFOS_LAUNCH(__nv_bfloat16, 128);
#undef TFOS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
