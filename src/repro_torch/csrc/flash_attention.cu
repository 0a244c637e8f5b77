// Blocked online-softmax attention in fp32 on the CUDA cores (sm_90a),
// never forming S×S:
//   o = softmax(mask(softcap(scale · q kᵀ))) v
// with GQA (query head h reads KV head h / group), a causal mask offset by
// Skv − Sq, a sliding window, tanh soft-capping and the real kv length.
//
// Replaces: flash_attention_pallas / _flash_kernel in
//   src/repro/kernels/flash_attention/flash_attention.py (the TPU kernel),
// for fp32 inputs.  bf16 goes to flash_attention_wgmma.cu (tensor cores);
// TF32 tensor cores could not hold the reference's fp32 tolerance of 2e-5.
// Plain version: repro_torch.kernels.flash_attention.ref.flash_attention_ref
// (the blocked form of models/layers.flash_attention_jnp).
//
// Numerics, as the TPU kernel: scores, running max, running sum and the
// output accumulator in fp32; masked scores are -1e30 (not -inf, so a tile
// masked for a whole row gives exp(0) and is wiped by the next correction
// instead of NaN); the result is acc / (l + 1e-30).
//
// What bounds it on an H100: operations.  Causal prefill at B 4, Hq 16,
// S 4,096, dh 128 is 2.75e11 FLOP; the fp32 CUDA cores' peak (67 TFLOP/s)
// allows no better than 4.1 ms.  fp32 is not the serving dtype: it runs for
// the card ≡ CPU checks, so this design stays the simple one.
//
// Design: one block of 256 threads per (64 query rows, query head, batch).
// The q tile is staged once in shared memory; the kernel then walks
// 32-key tiles of K and V (rows padded by one word so column reads are free
// of bank conflicts).  Each thread computes a 4×2 patch of the 64×32 score
// tile, four threads per row reduce its max and sum with shuffles, and each
// thread keeps a 4 × D/16 patch of the output accumulator in registers.  Key
// tiles that are masked for every row of the query tile (above the causal
// diagonal, behind the window) are not visited: their contribution is wiped
// by the correction factor once a row has a real maximum, and every row has
// one (Sq ≤ Skv).  Ragged Sq, Skv, dh and dv are bounds on the loads and
// stores (zero-filled in shared memory), not padding of the inputs; the
// head-dim bucket D (64, 128, 256) is a template argument.  q, k and v are
// read through their batch, head and row strides (unit stride in the last
// dimension), so the transposed projections need no copy; o is contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;  // 16 × 16
constexpr float kNeg = -1e30f;

struct Params {
  int group, sq, skv, dh, dv, hq;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  float scale, softcap;  // softcap 0 → none
  int causal, window;    // window 0 → none
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1) + 3 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ out, const Params p) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;    // row stride of sQ and sK
  constexpr int PS = kBK + 1;  // row stride of sP
  constexpr int NJ = D / 16;   // output columns per thread
  float* sQ = smem;            // [kBQ][QS]
  float* sK = sQ + kBQ * QS;   // [kBK][QS]
  float* sV = sK + kBK * QS;   // [kBK][D]
  float* sP = sV + kBK * D;    // [kBQ][PS] scores, then p
  float* sM = sP + kBQ * PS;   // running max per row
  float* sL = sM + kBQ;        // running sum per row
  float* sC = sL + kBQ;        // this tile's correction per row

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const float* qg = q + b * p.qsb + h * p.qsh;
  const float* kg = k + b * p.ksb + hk * p.ksh;
  const float* vg = v + b * p.vsb + hk * p.vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    sQ[r * QS + c] = (row < p.sq && c < p.dh) ? qg[row * p.qss + c] : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kNeg;
    sL[tid] = 0.f;
  }

  // keys that some row of this tile can see
  const int off = p.skv - p.sq;
  const int last_row = min(q0 + kBQ, p.sq) - 1;
  const int k_hi = p.causal ? min(p.skv, last_row + off + 1) : p.skv;
  const int k_lo = p.window > 0 ? max(0, q0 + off - p.window + 1) / kBK * kBK : 0;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done with sK, sV, sP
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, key = k0 + r;
      sK[r * QS + c] = (key < p.skv && c < p.dh) ? kg[key * p.kss + c] : 0.f;
      sV[r * D + c] = (key < p.skv && c < p.dv) ? vg[key * p.vss + c] : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16i and keys tx + 16j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k0v = sK[tx * QS + d], k1v = sK[(tx + 16) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = sQ[(ty + 16 * i) * QS + d];
        s[i][0] += qv * k0v;
        s[i][1] += qv * k1v;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.skv;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        sP[r * PS + c] = ok ? x : kNeg;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, eight keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = sP + r * PS + part * 8;
      const float m_old = sM[r];
      float mx = kNeg;
#pragma unroll
      for (int e = 0; e < 8; ++e) mx = fmaxf(mx, row[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        row[e] = expf(row[e] - m_new);
        sum += row[e];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {  // every lane of the row has read sM[r] (the shuffles)
        const float corr = expf(m_old - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc · corr + P V for rows ty + 16i and columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }
  __syncthreads();  // sL is written (also when no tile was visited)

  float* og = out + ((long long)b * p.hq + h) * p.sq * p.dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row >= p.sq) continue;
    const float den = sL[r] + 1e-30f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.dv) og[(long long)row * p.dv + c] = acc[i][j] / den;
    }
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, const Params& p,
             void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.hq, B);
  flash_kernel<D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, p);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int Sq, int Skv, int dh, int dv, long long qsb, long long qsh, long long qss,
           long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
           long long vss, double scale, int causal, int window, double softcap, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 || dh < 1 || dv < 1 ||
      window < 0 || softcap < 0.0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{Hq / Hkv, Sq, Skv, dh, dv, Hq, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
                 (float)scale, (float)softcap, causal, window};
  const int d = dh > dv ? dh : dv;
  if (d <= 64) return launch_d<64>(q, k, v, out, B, p, stream);
  if (d <= 128) return launch_d<128>(q, k, v, out, B, p, stream);
  if (d <= 256) return launch_d<256>(q, k, v, out, B, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define FLASH_ARGS                                                                            \
  const void *q, const void *k, const void *v, void *out, int B, int Hq, int Hkv, int Sq,     \
      int Skv, int dh, int dv, long long qsb, long long qsh, long long qss, long long ksb,    \
      long long ksh, long long kss, long long vsb, long long vsh, long long vss, double scale, \
      int causal, int window, double softcap, void *stream
#define FLASH_PASS                                                                          \
  q, k, v, out, B, Hq, Hkv, Sq, Skv, dh, dv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, \
      scale, causal, window, softcap, stream

extern "C" int flash_attention_f32(FLASH_ARGS) { return launch(FLASH_PASS); }
