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
// tile, so no atomics are needed and the results are deterministic.
//
//   dQ (flash_dq_*): CTA per 64 queries (bf16: flash_dq_tma_kernel, a TMA
//     ring + wgmma, see the comment above it); K/V tiles of 64 keys stream
//     over the causal/window range of keys; dq accumulates in f32.
//   dK/dV (flash_dkv_*): CTA per 64 keys (bf16: flash_dkv_tma_kernel, a TMA
//     ring + wgmma, see the comment above it); Q/dO/lse/delta tiles stream
//     from the causal diagonal up to the end of the window; dk, dv
//     accumulate in f32.
//
// Numerics: dQ rounds ds to k's dtype before ds.K, as the TPU kernel does;
// dK/dV rounds p and ds to bf16 before p^T.dO and ds^T.q, where the TPU kernel
// keeps them in f32, so its bf16 results differ from the plain version by a
// relative ~2^-9 a term.  Both bf16 kernels keep the score-shaped
// accumulators (S, dP) in wgmma's register layout and re-pack them to bf16 as
// the A operand of the next product, so p and ds never touch shared memory.
// float32 keeps every value in f32 and runs its products as FMAs on the CUDA
// cores (67 TFLOP/s peak), with thread (tr, tc) = (tid / 8, tid % 8) owning
// rows tr + 16 i (i < 4) and columns tc + 8 j of each tile.

#include "flash_attention_common.cuh"
#include "hopper.cuh"

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

// The queries [qbeg, qend) that can see some key of the tile of bk keys at k0.
__device__ __forceinline__ void query_range(int k0, int bk, int Tq, int causal, int window,
                                            int& qbeg, int& qend) {
  qbeg = 0;
  qend = Tq;
  if (causal) {
    qbeg = min(Tq, k0);
    if (window > 0) qend = min(Tq, k0 + bk - 1 + window);
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
  query_range(k0, kBK, Tq, causal, window, qbeg, qend);
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
// flash_dq_tma_kernel: a CTA of one consumer warpgroup, owning 64 queries,
// and one producer warpgroup.  The producer loads the CTA's Q and dO tiles
// once by TMA, then streams the 64-key K and V tiles of [kbeg, kend)
// through a ring of kDqStages shared-memory stages ("full" and "empty"
// mbarriers as in the forward); its first warp's lanes also write each
// stage's 64 key-padding biases (times log2 e; -1e30 past Tk).  The
// producer warpgroup gives its registers up (setmaxnreg) to the consumer,
// as in the dK/dV kernel.  Per K/V tile, the consumer warpgroup:
//   S = Q.K^T, dP = dO.V^T          SS wgmma m64n64k16, all four operands
//                                    K-major in shared memory, in two
//                                    commit groups;
//   p = 2^(S scale log2 e + bias - lse log2 e) in S's registers while
//   dP's product runs, then ds = p * (dP - delta);
//   dQ += dS.K                       RS wgmma, ds rounded to bf16 and
//                                    packed from S's accumulators as the A
//                                    operand (the TPU kernel's
//                                    ds.astype(k.dtype)), K read MN-major,
//                                    one product per 64-column half;
// and releases the stage after the wait_group that covers dQ's product.
// Q and dO are read from shared memory by every product (SS), so no
// register A fragment is held across the K/V loop (hopper.cuh); SS was 2%
// faster than reloading them by ldmatrix every tile.  Rows past Tq have
// lse = +1e30, so their p is 0, and are not stored; dq is scaled at the
// end; each CTA owns its queries, so no atomics.  At D = 64 three CTAs share
// an SM (on an H100 at the BERT shape, 0.037 ms against 0.044 with two;
// PERF.md, Findings).

constexpr int kDqStages = 3;              // K/V tiles in flight
constexpr int kDqThreads = 2 * kThreads;  // the consumer and producer warpgroups

template <int D>
struct DqTiles {
  // CTAs an SM, and registers a thread after the split.  D = 64: three CTAs
  // (67 KB of shared memory each), 80 registers a thread at launch (65536 /
  // 768, rounded down to 8); the producer keeps 24 and the consumer takes
  // 136, which hold dq, S, dP and ds's fragments without spilling.  D = 128:
  // dq is twice as large, so 128 at launch, 40 and 216 as in the dK/dV
  // kernel (its 131 KB of shared memory hold it to one CTA an SM).
  static constexpr int kCtasPerSm = D == 64 ? 3 : 2;
  static constexpr int kProducerRegs = D == 64 ? 24 : 40;
  static constexpr int kConsumerRegs = D == 64 ? 136 : 216;
  static constexpr uint32_t kQOBytes = 2u * kBQ * D * 2;     // Q and dO
  static constexpr uint32_t kStageBytes = 2u * kBK * D * 2;  // K and V
  static constexpr size_t kSmem = kAtomBytes + kQOBytes + size_t(kDqStages) * kStageBytes +
                                  size_t(kDqStages) * kBK * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kDqThreads, DqTiles<D>::kCtasPerSm)
flash_dq_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o,
                    const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
                    int Tq, int Tk, float scale, int causal, int window) {
  constexpr int STAGES = kDqStages;
  constexpr int HALVES = D / 64;
  constexpr int KS = D / 16;     // k-steps of S and dP over the head dim
  constexpr int KK = kBK / 16;   // k-steps of dQ over a tile's keys
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qo_bar, full_bar[STAGES], empty_bar[STAGES];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAtomBytes - 1) & ~uintptr_t(kAtomBytes - 1));
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base);  // [HALVES][kBQ][64]
  __nv_bfloat16* dOs = Qs + kBQ * D;                            // [HALVES][kBQ][64]
  __nv_bfloat16* Ks = dOs + kBQ * D;           // [STAGES][HALVES][kBK][64]
  __nv_bfloat16* Vs = Ks + STAGES * kBK * D;   // [STAGES][HALVES][kBK][64]
  float* bias_s = reinterpret_cast<float*>(Vs + STAGES * kBK * D);  // [STAGES][kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  int kbeg, kend;
  key_range(q0, Tk, causal, window, kbeg, kend);
  const int j0 = kbeg / kBK;
  const int nk = max(0, (kend + kBK - 1) / kBK - j0);

  if (tid == 0) {
    mbar_init(&qo_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 32);
      mbar_init(&empty_bar[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup; its first warp works
    setmaxnreg_dec<DqTiles<D>::kProducerRegs>();
    if (warp != 4) return;
    if (lane == 0) {
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(&qo_bar, DqTiles<D>::kQOBytes);
      for (int hf = 0; hf < HALVES; ++hf) {
        tma_load_tile(Qs + hf * kBQ * 64, &tm_q, &qo_bar, hf * 64, h, q0, b);
        tma_load_tile(dOs + hf * kBQ * 64, &tm_o, &qo_bar, hf * 64, h, q0, b);
      }
    }
    for (int i = 0; i < nk; ++i) {
      const int st = i % STAGES;
      const int k0 = (j0 + i) * kBK;
      if (i >= STAGES) mbar_wait(&empty_bar[st], ((i / STAGES) & 1) ^ 1);
      for (int c = lane; c < kBK; c += 32)
        bias_s[st * kBK + c] = key_bias(mask, b, Tk, k0 + c) * kLog2e;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_bar[st], DqTiles<D>::kStageBytes);
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
  setmaxnreg_inc<DqTiles<D>::kConsumerRegs>();

  // the consumer warpgroup: rows wl * 16 + g (+ 8) of the CTA's tile
  const int wl = warp;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wl * 16 + g;
  // p = 2^(S scale log2 e + bias log2 e - lse log2 e); rows past Tq: p = 0
  const float scale2 = scale * kLog2e;
  float lse2[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = row0 + 8 * hh;
    const long long at = ((long long)b * H + h) * Tq + qi;
    lse2[hh] = (qi < Tq ? lse[at] : -kNegInf) * kLog2e;
    delta_r[hh] = qi < Tq ? delta[at] : 0.f;
  }

  float acc[HALVES][32];
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[hf][r] = 0.f;

  mbar_wait(&qo_bar, 0);
  for (int i = 0; i < nk; ++i) {
    const int st = i % STAGES;
    const int k0 = (j0 + i) * kBK;
    const __nv_bfloat16* Kst = Ks + st * HALVES * kBK * 64;
    const __nv_bfloat16* Vst = Vs + st * HALVES * kBK * 64;
    const float* bias = bias_s + st * kBK;
    mbar_wait(&full_bar[st], (i / STAGES) & 1);

    float s[32], dp[32];  // S, then p, then ds; dP
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_n64<0>(s, desc_k_major(Qs + (ks / 4) * kBQ * 64, 0, ks % 4),
                      desc_k_major(Kst + (ks / 4) * kBK * 64, 0, ks % 4), 1);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_n64<0>(dp, desc_k_major(dOs + (ks / 4) * kBQ * 64, 0, ks % 4),
                      desc_k_major(Vst + (ks / 4) * kBK * 64, 0, ks % 4), 1);
    wgmma_commit();

    // p while dP's product runs
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int col = (r >> 2) * 8 + 2 * t + (r & 1);
      const int hh = (r >> 1) & 1;
      float x = fmaf(s[r], scale2, bias[col]);
      if (!visible(row0 + 8 * hh, k0 + col, causal, window)) x = kNegInf;
      s[r] = ex2(x - lse2[hh]);
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // ds = p * (dp - delta), rounded to bf16 as dQ's A fragments
    uint32_t da[KK][4];
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] *= dp[r] - delta_r[(r >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      da[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      da[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      da[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      da[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) fence_regs(acc[hf]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
        wgmma_rs_n64<1>(acc[hf], da[kk], desc_mn_major(Kst + hf * kBK * 64, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) fence_regs(acc[hf]);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) fence_regs(da[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = row0 + 8 * hh;
    if (qi >= Tq) continue;
    __nv_bfloat16* row = dq + (((long long)b * Tq + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(row + hf * 64 + j * 8) =
            pack_bf16(acc[hf][r] * scale, acc[hf][r + 1] * scale);
      }
  }
}

// -------------------------------------------------------------- bf16 dK/dV
//
// flash_dkv_tma_kernel: a CTA of one consumer warpgroup, owning 64 keys,
// and one producer warpgroup.  The producer loads the CTA's K and V tiles
// once by TMA, then streams 64-query Q and dO tiles through a ring of
// kDkvStages shared-memory stages (TMA, "full" and "empty" mbarriers as in
// the forward); its first warp's lanes also write each stage's 64 lse and
// delta values (plain loads: a tensor map over [B*H, Tq] f32 would need
// Tq*4 to be a multiple of 16).  The producer warpgroup gives its
// registers up (setmaxnreg) to the consumer, which holds four 64 x 64 f32
// accumulators: a 5-warp CTA would put 3 warps on one of the SM's four
// register partitions and so be held to 168 registers a thread.  Keys
// 64 a CTA and 3 stages were the fastest of four choices timed at the BERT
// shape (PERF.md, Findings).
//
// Per Q tile, the consumer warpgroup, keys as rows and queries as columns:
//   S^T = K.Q^T, dP^T = V.dO^T      wgmma m64n64k16, Q and dO K-major; at
//                                    D = 64 K and V are A fragments taken
//                                    into registers by ldmatrix (RS: half
//                                    the shared-memory traffic of SS, which
//                                    at n64 would saturate it), at D = 128
//                                    read from shared memory (SS);
//   p^T = exp(S^T * scale + bias - lse[col]) in the accumulator registers;
//   dV += P^T.dO                     RS wgmma, P^T rounded to bf16 in
//                                    registers, dO read MN-major;
//   ds^T = p^T * (dP^T - delta[col]) while that product runs;
//   dK += dS^T.Q                     RS wgmma, Q read MN-major;
// so the same shared-memory Q and dO tiles serve as K-major and MN-major
// operands.  The stage is released after the wait_group that covers dK's
// product.  dK is scaled at the end; each CTA owns its keys, so no atomics.

constexpr int kDkvStages = 3;                // Q/dO tiles in flight
constexpr int kDkvThreads = 2 * kThreads;    // the consumer and producer warpgroups
// Registers a thread after the split: the launch gives every thread
// 65536 / (256 threads x 2 CTAs an SM) = 128; the producer keeps 40 and
// the consumer takes 216.
constexpr int kDkvProducerRegs = 40;
constexpr int kDkvConsumerRegs = 216;

template <int D>
struct DkvTiles {
  static constexpr uint32_t kKVBytes = 2u * kBK * D * 2;     // K and V
  static constexpr uint32_t kStageBytes = 2u * kBQ * D * 2;  // Q and dO
  static constexpr size_t kSmem = kAtomBytes + kKVBytes + size_t(kDkvStages) * kStageBytes +
                                  size_t(kDkvStages) * 2 * kBQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 2)
flash_dkv_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o,
                     const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk, float scale,
                     int causal, int window) {
  constexpr int STAGES = kDkvStages;
  constexpr int BK = kBK;
  constexpr int BQ = kBQ;
  constexpr int HALVES = D / 64;
  constexpr int KS = D / 16;     // k-steps over the head dim
  constexpr int KK = BQ / 16;    // k-steps over a tile's queries
  constexpr bool kRegKV = D == 64;  // K and V as register A operands
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t kv_bar, full_bar[STAGES], empty_bar[STAGES];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAtomBytes - 1) & ~uintptr_t(kAtomBytes - 1));
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(base);  // [HALVES][BK][64]
  __nv_bfloat16* Vs = Ks + BK * D;                              // [HALVES][BK][64]
  __nv_bfloat16* Qs = Vs + BK * D;             // [STAGES][HALVES][BQ][64]
  __nv_bfloat16* dOs = Qs + STAGES * BQ * D;   // [STAGES][HALVES][BQ][64]
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * BQ * D);  // [STAGES][BQ]
  float* delta_s = lse_s + STAGES * BQ;                            // [STAGES][BQ]

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  int qbeg, qend;
  query_range(k0, BK, Tq, causal, window, qbeg, qend);
  const int i0 = qbeg / BQ;
  const int nq = max(0, (qend + BQ - 1) / BQ - i0);

  if (tid == 0) {
    mbar_init(&kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 32);
      mbar_init(&empty_bar[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup; its first warp works
    setmaxnreg_dec<kDkvProducerRegs>();
    if (warp != 4) return;
    if (lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_o);
      mbar_arrive_expect_tx(&kv_bar, DkvTiles<D>::kKVBytes);
      for (int hf = 0; hf < HALVES; ++hf) {
        tma_load_tile(Ks + hf * BK * 64, &tm_k, &kv_bar, hf * 64, h, k0, b);
        tma_load_tile(Vs + hf * BK * 64, &tm_v, &kv_bar, hf * 64, h, k0, b);
      }
    }
    const long long lse_row = ((long long)b * H + h) * Tq;
    for (int i = 0; i < nq; ++i) {
      const int st = i % STAGES;
      const int q0 = (i0 + i) * BQ;
      if (i >= STAGES) mbar_wait(&empty_bar[st], ((i / STAGES) & 1) ^ 1);
      for (int c = lane; c < BQ; c += 32) {  // queries past Tq: p = 0
        const int qi = q0 + c;
        lse_s[st * BQ + c] = (qi < Tq ? lse[lse_row + qi] : -kNegInf) * kLog2e;
        delta_s[st * BQ + c] = qi < Tq ? delta[lse_row + qi] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_bar[st], DkvTiles<D>::kStageBytes);
        for (int hf = 0; hf < HALVES; ++hf) {
          tma_load_tile(Qs + (st * HALVES + hf) * BQ * 64, &tm_q, &full_bar[st], hf * 64, h,
                        q0, b);
          tma_load_tile(dOs + (st * HALVES + hf) * BQ * 64, &tm_o, &full_bar[st], hf * 64,
                        h, q0, b);
        }
      } else {
        mbar_arrive(&full_bar[st]);
      }
    }
    return;
  }
  setmaxnreg_inc<kDkvConsumerRegs>();

  // the consumer warpgroup: keys wl * 16 + g (+ 8) of the CTA's tile
  const int wl = warp;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + wl * 16 + g;
  // p = 2^(S^T scale log2 e + bias log2 e - lse log2 e): lse arrives in
  // shared memory already times log2 e
  const float scale2 = scale * kLog2e;
  float bias_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) bias_r[hh] = key_bias(mask, b, Tk, key0 + 8 * hh) * kLog2e;

  float dka[HALVES][32], dva[HALVES][32];
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
    for (int r = 0; r < 32; ++r) dka[hf][r] = dva[hf][r] = 0.f;

  mbar_wait(&kv_bar, 0);
  for (int i = 0; i < nq; ++i) {
    // K's and V's A fragments are loaded anew every tile (hopper.cuh,
    // "Register A operands")
    uint32_t kf[kRegKV ? KS : 1][4], vf[kRegKV ? KS : 1][4];
    if constexpr (kRegKV) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a_sw128(kf[ks], Ks, BK, wl * 16, ks, lane);
        load_a_sw128(vf[ks], Vs, BK, wl * 16, ks, lane);
      }
    }
    const int st = i % STAGES;
    const int q0 = (i0 + i) * BQ;
    const __nv_bfloat16* Qst = Qs + st * HALVES * BQ * 64;
    const __nv_bfloat16* dOst = dOs + st * HALVES * BQ * 64;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;
    mbar_wait(&full_bar[st], (i / STAGES) & 1);

    float s[32], dp[32];  // S^T, then p^T, then ds^T; dP^T
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t dq_ = desc_k_major(Qst + (ks / 4) * BQ * 64, 0, ks % 4);
      const uint64_t do_ = desc_k_major(dOst + (ks / 4) * BQ * 64, 0, ks % 4);
      if constexpr (kRegKV) {
        wgmma_rs_n64<0>(s, kf[ks], dq_);
        wgmma_rs_n64<0>(dp, vf[ks], do_);
      } else {
        wgmma_ss_n64<0>(s, desc_k_major(Ks + (ks / 4) * BK * 64, 0, ks % 4), dq_, 1);
        wgmma_ss_n64<0>(dp, desc_k_major(Vs + (ks / 4) * BK * 64, 0, ks % 4), do_, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int col = (r >> 2) * 8 + 2 * t + (r & 1);
      const int hh = (r >> 1) & 1;
      float x = fmaf(s[r], scale2, bias_r[hh]);
      if (!visible(q0 + col, key0 + 8 * hh, causal, window)) x = kNegInf;
      s[r] = ex2(x - lse_t[col]);
    }

    // dv += p^T.dO (p rounded to bf16)
    uint32_t pa[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) fence_regs(dva[hf]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
        wgmma_rs_n64<1>(dva[hf], pa[kk], desc_mn_major(dOst + hf * BQ * 64, kk));
    wgmma_commit();

    // ds^T = p^T * (dp^T - delta), while dV's product runs; dk += ds^T.q
    // (ds rounded to bf16)
#pragma unroll
    for (int r = 0; r < 32; ++r)
      s[r] *= dp[r] - delta_t[(r >> 2) * 8 + 2 * t + (r & 1)];
    uint32_t da[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      da[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      da[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      da[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      da[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) fence_regs(dka[hf]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
        wgmma_rs_n64<1>(dka[hf], da[kk], desc_mn_major(Qst + hf * BQ * 64, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
      fence_regs(dva[hf]);
      fence_regs(dka[hf]);
    }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = key0 + 8 * hh;
    if (kj >= Tk) continue;
    const long long at = (((long long)b * Tk + kj) * H + h) * D + 2 * t;
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(dk + at + hf * 64 + j * 8) =
            pack_bf16(dka[hf][r] * scale, dka[hf][r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + hf * 64 + j * 8) =
            pack_bf16(dva[hf][r], dva[hf][r + 1]);
      }
  }
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* mask,
                  const void* dout, const void* lse, const void* delta, void* dq, int B, int H,
                  int Tq, int Tk, const Strides& st, float scale, int causal, int window,
                  cudaStream_t stream) {
  constexpr size_t smem = dq_f32_smem_bytes<D>();
  auto kernel = &flash_dq_f32_kernel<D>;
  static bool configured = false;
  if (cudaError_t err = allow_smem(kernel, smem, configured)) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, Tq, Tk, st, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v, const void* mask,
                   const void* dout, const void* lse, const void* delta, void* dq, int B,
                   int H, int Tq, int Tk, const Strides& st, float scale, int causal,
                   int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  cudaError_t err;
  if ((err = make_tile_map(&tm_q, q, B, Tq, H, D, st.qb, st.qt, st.qh, kBQ)) ||
      (err = make_tile_map(&tm_k, k, B, Tk, H, D, st.kb, st.kt, st.kh, kBK)) ||
      (err = make_tile_map(&tm_v, v, B, Tk, H, D, st.vb, st.vt, st.vh, kBK)) ||
      (err = make_tile_map(&tm_o, dout, B, Tq, H, D, st.ob, st.ot, st.oh, kBQ)))
    return (int)err;
  auto kernel = &flash_dq_tma_kernel<D>;
  static bool configured = false;
  if ((err = allow_smem(kernel, DqTiles<D>::kSmem, configured))) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kDqThreads, DqTiles<D>::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<const uint8_t*>(mask),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Tq, Tk, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* mask,
                   const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                   int B, int H, int Tq, int Tk, const Strides& st, float scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = dkv_f32_smem_bytes<D>();
  auto kernel = &flash_dkv_f32_kernel<D>;
  static bool configured = false;
  if (cudaError_t err = allow_smem(kernel, smem, configured)) return (int)err;
  dim3 grid((Tk + kBK - 1) / kBK, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), H,
      Tq, Tk, st, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* mask,
                    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                    int B, int H, int Tq, int Tk, const Strides& st, float scale, int causal,
                    int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  cudaError_t err;
  if ((err = make_tile_map(&tm_q, q, B, Tq, H, D, st.qb, st.qt, st.qh, kBQ)) ||
      (err = make_tile_map(&tm_k, k, B, Tk, H, D, st.kb, st.kt, st.kh, kBK)) ||
      (err = make_tile_map(&tm_v, v, B, Tk, H, D, st.vb, st.vt, st.vh, kBK)) ||
      (err = make_tile_map(&tm_o, dout, B, Tq, H, D, st.ob, st.ot, st.oh, kBQ)))
    return (int)err;
  auto kernel = &flash_dkv_tma_kernel<D>;
  static bool configured = false;
  if ((err = allow_smem(kernel, DkvTiles<D>::kSmem, configured))) return (int)err;
  dim3 grid((Tk + kBK - 1) / kBK, H, B);
  kernel<<<grid, kDkvThreads, DkvTiles<D>::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<const uint8_t*>(mask),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, scale,
      causal, window);
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
#define TFOS_LAUNCH(F, D)                                                                 \
  return F<D>(q, k, v, mask, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, window, s)
  if (dtype == 0 && head_dim == 64) TFOS_LAUNCH(launch_dq_f32, 64);
  if (dtype == 0 && head_dim == 128) TFOS_LAUNCH(launch_dq_f32, 128);
  if (dtype == 1 && head_dim == 64) TFOS_LAUNCH(launch_dq_bf16, 64);
  if (dtype == 1 && head_dim == 128) TFOS_LAUNCH(launch_dq_bf16, 128);
#undef TFOS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int tfos_flash_attention_bwd_dkv(TFOS_BWD_ARGS, void* dk, void* dv,
                                            TFOS_BWD_SHAPE) {
  const Strides st{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFOS_LAUNCH(F, D)                                                            \
  return F<D>(q, k, v, mask, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale, causal, \
              window, s)
  if (dtype == 0 && head_dim == 64) TFOS_LAUNCH(launch_dkv_f32, 64);
  if (dtype == 0 && head_dim == 128) TFOS_LAUNCH(launch_dkv_f32, 128);
  if (dtype == 1 && head_dim == 64) TFOS_LAUNCH(launch_dkv_bf16, 64);
  if (dtype == 1 && head_dim == 128) TFOS_LAUNCH(launch_dkv_bf16, 128);
#undef TFOS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
