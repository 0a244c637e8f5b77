// Blocked online-softmax attention in fp32 for Hopper (sm_90a), on the
// tensor cores at fp32 accuracy (3×TF32), never forming S×S:
//   o = softmax(mask(softcap(scale · q kᵀ))) v
// with GQA (query head h reads KV head h / group), a causal mask offset by
// Skv − Sq, a sliding window, tanh soft-capping and the real kv length.
//
// Replaces: flash_attention_pallas / _flash_kernel in
//   src/repro/kernels/flash_attention/flash_attention.py (the TPU kernel),
// for fp32 inputs; bf16 goes to flash_attention_wgmma.cu.
// Plain version: repro_torch.kernels.flash_attention.ref.flash_attention_ref
// (the blocked form of models/layers.flash_attention_jnp).
//
// Numerics, as the TPU kernel: scores, running max, running sum, the
// softmax's exp and the output accumulator in fp32; masked scores are -1e30
// (not -inf, so a tile masked for a whole row gives exp(0) and is wiped by
// the next correction instead of NaN); the result is acc / (l + 1e-30).
// log2(e) is folded into the scale, so p = 2^(x − m) in fp32.
//
// Precision.  A TF32 operand keeps 10 of fp32's 23 mantissa bits: one TF32
// pass moves each product by up to 2^-10, which left the reference's fp32
// tolerance of 2e-5 (~1e-3 off at qwen3's heads).  3×TF32 splits each
// operand x into hi, x rounded to TF32 (to nearest, ties away), and
// lo = x − hi (exact in fp32, |lo| ≤ 2^-11 |x|), and takes a·b as
// lo_a·hi_b + hi_a·lo_b + hi_a·hi_b: products of TF32 values are exact, the
// dropped lo_a·lo_b is below 2^-22 |a·b|, and the tensor core reads lo's top
// 19 bits, within 2^-21 |a·b|.  The small products go in first, then hi·hi,
// per k-step of 8 (CUTLASS's 3×TF32 order).  What is left is the tensor
// core's own rounding of its sums, which drops bits: so a score is summed
// in two halves (even and odd k-steps) and a tile's P·V apart from O, added
// to it in fp32.
//
// What bounds it on an H100: operations.  Causal prefill at B 4, Hq 16,
// S 4,096, dh 128 is 2.75e11 FLOP against 0.40 GB of q, k, v and o.  Three
// TF32 passes at the dense tensor-core rate (495 TFLOP/s) take no less than
// 1.67 ms; the fp32 CUDA cores (67 TFLOP/s) allow no better than 4.1 ms.
// mma.sync reaches ~64% of that tensor-core rate on this card, and the
// splits, loads and softmax share the issue slots with it.  Times beside
// both bounds: PERF.md §6 (chip_smoke.py's timing phase and
// tools/flash_ab.py, NVIDIA H100 80GB HBM3 at 700 W; the CUDA-core design
// this replaced took 13.1 ms).  wgmma is the next step: TF32 wgmma takes no
// transposed operand, so V would be transposed into shared memory, and the
// lo halves would need tiles of their own.
//
// Design: a block of four warps covers 64 query rows of one (batch, query
// head); blocks walk the query tiles heaviest first under causality.  Each
// warp owns 16 query rows, mma.sync's M: S = Q·Kᵀ and O += P·V are
// mma.sync.m16n8k8 TF32 with fp32 accumulators, three passes each, each
// pass a run of independent products (no product waits on the one before).
//  * The S fragment's rows live in a quad of lanes, so the softmax's max and
//    sum are quad shuffles: no shared round trip, no barrier.
//  * The product's k index is free to permute.  In Q·Kᵀ, k-slot t and t + 4
//    of lane t take head dims 2t and 2t + 1, so a lane's Q and K fragment
//    pairs are adjacent (one 8-byte load).  In P·V, they take keys 2t and
//    2t + 1, which are exactly the two columns of S that lane t holds: P's
//    A fragments are the softmax's registers, with no shuffle.
//  * The q tile is loaded once; K and V tiles (64 keys at D 64, 32 at 128,
//    16 at 256: two blocks an SM at D ≤ 128) arrive by cp.async (16 bytes a
//    thread where the rows are 16-byte aligned, else 4) into a two-stage
//    ring in shared memory; tile j + 1 is in flight while tile j computes,
//    and one block barrier per tile hands a stage over.  Rows are padded to
//    D + 8 words (Q, K) and D + 4 (V), which makes the fragment loads free
//    of bank conflicts.
//  * Each thread splits the fp32 operands it loads into hi and lo in
//    registers.  The O accumulator is 16 × D per warp in registers, D / 2
//    floats a thread; Q's fragments are read from shared memory, which
//    leaves the registers to O and a tile's P·V sums.
// Key tiles masked for every row of the block (above the causal diagonal,
// behind the window) are not visited; tiles that are wholly visible skip the
// per-element mask.  Ragged Sq, Skv, dh and dv are bounds on the loads
// (zero-filled) and stores, not padding of the inputs; k-steps past dh and
// passes of output column tiles past dv are skipped.  The head-dim bucket D
// (64, 128, 256, of max(dh, dv)) is a template argument.  q, k and v are
// read through their batch, head and row strides (unit stride in the last
// dimension); o is contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16;                // query rows per warp (mma's M)
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 8;                 // output column tiles (of 8) a P·V pass covers
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> __host__ __device__ constexpr int keys() { return D == 64 ? 64 : D == 128 ? 32 : 16; }  // keys per tile
template <int D> __host__ __device__ constexpr int k_stride() { return D + 8; }  // words ≡ 8 mod 32
template <int D> __host__ __device__ constexpr int v_stride() { return D + 4; }  // words ≡ 4 mod 16

template <int D>
constexpr size_t smem_bytes() {  // the q tile, then two stages of K and V
  return sizeof(float) * (kBQ * k_stride<D>() + 2 * keys<D>() * (k_stride<D>() + v_stride<D>()));
}

struct Params {
  int group, sq, skv, dh, dv, hq;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  float scale, softcap;  // softcap 0 → none
  int causal, window;    // window 0 → none
  int vec_q, vec_k, vec_v;  // rows 16-byte aligned: 16-byte copies
};

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding, without its test for infinity); lo = x − hi
// is exact in fp32 and enters the tensor core as it is,
// which reads a TF32 operand's top 19 bits, so lo·b is truncated within
// 2^-21 |x·b|.  A NaN x gives a NaN lo, so NaN still reaches the result.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a·b (mma.sync m16n8k8, TF32 operands, fp32 accumulator)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a·b
__device__ __forceinline__ void mma0(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {  // rest zero-filled
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// rows [row0, row0 + R) × columns [0, D) of a [n, ncols] matrix with row
// stride `stride` into shared memory with row stride S; rows ≥ n and columns
// ≥ ncols are zero-filled
template <int D, int S, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride, int row0, int n,
                                          int ncols, bool vec) {
  if (vec) {  // 16 bytes a copy
    constexpr int kChunks = D / 4;
    static_assert(R * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
    for (int it = 0; it < R * kChunks / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads, r = i / kChunks, c = i % kChunks * 4, row = row0 + r;
      const int valid = row < n ? max(0, min(4, ncols - c)) : 0;
      cp_async16(dst + r * S + c, valid ? src + row * stride + c : src, 4 * valid);
    }
  } else {  // 4 bytes a copy
    static_assert(R * D % kThreads == 0, "whole rounds of copies");
#pragma unroll 4
    for (int it = 0; it < R * D / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads, r = i / D, c = i % D, row = row0 + r;
      const bool ok = row < n && c < ncols;
      cp_async4(dst + r * S + c, ok ? src + row * stride + c : src, ok ? 4 : 0);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ out, const Params p) {
  constexpr int BK = keys<D>();  // keys per tile
  constexpr int NT = BK / 8;     // score column tiles per warp
  constexpr int ND = D / 8;      // output column tiles per warp
  constexpr int SK = k_stride<D>(), SV = v_stride<D>();
  static_assert(ND % kCols == 0, "output column tiles come in passes of kCols");
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [kBQ][SK]
  float* sK = sQ + kBQ * SK;    // [2][BK][SK]
  float* sV = sK + 2 * BK * SK;  // [2][BK][SV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, tig = lane & 3;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest query tiles first under causality
  const int h = blockIdx.x % p.hq, b = blockIdx.x / p.hq, hk = h / p.group;
  const int q0 = qt * kBQ;
  const float* qg = q + b * p.qsb + h * p.qsh;
  const float* kg = k + b * p.ksb + hk * p.ksh;
  const float* vg = v + b * p.vsb + hk * p.vsh;
  const int r0 = warp * kRows + gid;  // this lane's rows of the block: r0 and r0 + 8

  // keys that some row of this tile can see
  const int off = p.skv - p.sq;
  const int last_row = min(q0 + kBQ, p.sq) - 1;
  const int k_hi = p.causal ? min(p.skv, last_row + off + 1) : p.skv;
  const int k_lo = p.window > 0 ? max(0, q0 + off - p.window + 1) / BK * BK : 0;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  load_rows<D, SK, kBQ>(sQ, qg, p.qss, q0, p.sq, p.dh, p.vec_q);
  if (ntiles > 0) {
    load_rows<D, SK, BK>(sK, kg, p.kss, k_lo, p.skv, p.dh, p.vec_k);
    load_rows<D, SV, BK>(sV, vg, p.vss, k_lo, p.skv, p.dv, p.vec_v);
  }
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows r0, r0 + 8; m in log2 units
  const int qpos0 = q0 + r0 + off;
  const int nks = (p.dh + 7) / 8;  // k-steps of Q·Kᵀ; past dh q and k are zero
  const float scale2 = p.scale * kLog2e;
  // Q's A fragments: k-slots t and t + 4 of lane t are head dims 2t, 2t + 1
  const float* qa = sQ + r0 * SK + 2 * tig;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_lo + t * BK, stage = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed for every thread; every warp is done with tile t − 1
    if (t + 1 < ntiles) {
      load_rows<D, SK, BK>(sK + (stage ^ 1) * BK * SK, kg, p.kss, k0 + BK, p.skv, p.dh, p.vec_k);
      load_rows<D, SV, BK>(sV + (stage ^ 1) * BK * SV, vg, p.vss, k0 + BK, p.skv, p.dv, p.vec_v);
    }
    cp_async_commit();
    const float* kb = sK + stage * BK * SK + gid * SK + 2 * tig;  // key gid of each 8, dims 2t, 2t + 1
    const float* tV = sV + stage * BK * SV;

    // S = Q·Kᵀ: this warp's 16 rows × BK keys, two k-steps at a time into
    // two sums (even and odd k-steps), so each pass issues 2·NT independent
    // products and none waits on the one before it.  Past dh, q and k are
    // zero in shared memory up to D.
    float s[NT][4], s2[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
    }
    for (int ks = 0; ks < nks; ks += 2) {
      uint32_t ah[2][4], al[2][4], bh[2][NT][2], bl[2][NT][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * (ks + u));
        const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * SK + 8 * (ks + u));
        split(x0.x, ah[u][0], al[u][0]);
        split(x1.x, ah[u][1], al[u][1]);
        split(x0.y, ah[u][2], al[u][2]);
        split(x1.y, ah[u][3], al[u][3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(kb + 8 * j * SK + 8 * (ks + u));
          split(kv.x, bh[u][j][0], bl[u][j][0]);
          split(kv.y, bh[u][j][1], bl[u][j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(s[j], al[0], bh[0][j]), mma(s2[j], al[1], bh[1][j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(s[j], ah[0], bl[0][j]), mma(s2[j], ah[1], bl[1][j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(s[j], ah[0], bh[0][j]), mma(s2[j], ah[1], bh[1][j]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
    }

    // scores in log2 units (scale, softcap), then the mask; s[j][e] is row
    // r0 + 8·(e / 2), key k0 + 8j + 2·tig + e % 2
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = p.softcap > 0.f ? p.softcap * tanhf(s[j][e] * p.scale / p.softcap) * kLog2e : s[j][e] * scale2;
      }
    }
    const bool whole = k0 + BK <= p.skv && (!p.causal || k0 + BK - 1 <= q0 + off) &&
                       (p.window == 0 || last_row + off - k0 < p.window);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = qpos0 + 8 * (e >> 1), kpos = k0 + 8 * j + 2 * tig + (e & 1);
          const bool ok = kpos < p.skv && (!p.causal || kpos <= qpos) && (p.window == 0 || qpos - kpos < p.window);
          if (!ok) s[j][e] = kNeg;
        }
      }
    }
    // online softmax: the four lanes of a quad share a row
    float mx[2] = {kNeg, kNeg}, corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    // p = 2^(s − m), in place
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }

    // O = O·corr + P·V in passes of kCols output column tiles, kCols
    // independent products each; column tiles past dv are skipped a pass at a
    // time (they stay zero).  The tile's P·V is summed apart and added in fp32 (round to
    // nearest), so the tensor core's own rounding of its sums touches one
    // tile's terms, not the whole row of keys.
#pragma unroll
    for (int c = 0; c < ND / kCols; ++c) {
      if (8 * kCols * c >= p.dv) break;
      float pv[kCols][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // P's A fragment: k-slots t and t + 4 of lane t are keys 2t and 2t + 1
        // of the 8, the two columns of S this lane holds (split again for
        // each pass of column tiles, which keeps P's halves out of registers)
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
        const float* vb = tV + (8 * j + 2 * tig) * SV + 8 * kCols * c + gid;
        uint32_t bh[kCols][2], bl[kCols][2];
#pragma unroll
        for (int n = 0; n < kCols; ++n) {
          split(vb[8 * n], bh[n][0], bl[n][0]);
          split(vb[SV + 8 * n], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kCols; ++n) {
          if (j == 0) {
            mma0(pv[n], pl, bh[n]);
          } else {
            mma(pv[n], pl, bh[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < kCols; ++n) mma(pv[n], ph, bl[n]);
#pragma unroll
        for (int n = 0; n < kCols; ++n) mma(pv[n], ph, bh[n]);
      }
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[kCols * c + n][e] = fmaf(acc[kCols * c + n][e], corr[e >> 1], pv[n][e]);
      }
    }
  }

  // acc[n][e] is row r0 + 8·(e / 2), column 8n + 2·tig + e % 2
  float* og = out + ((long long)b * p.hq + h) * p.sq * p.dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= p.sq) continue;
    const float den = l[r] + 1e-30f;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * tig + e;
        if (c < p.dv) og[(long long)row * p.dv + c] = acc[n][2 * r + e] / den;
      }
    }
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, const Params& p, void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * p.hq, (p.sq + kBQ - 1) / kBQ);
  flash_kernel<D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, p);
  return static_cast<int>(cudaGetLastError());
}

// rows of x start on 16 bytes: base and every stride (in floats) aligned
bool rows_aligned(const void* x, long long sb, long long sh, long long ss) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 && ss % 4 == 0;
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv, int Sq, int Skv,
           int dh, int dv, long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
           long long kss, long long vsb, long long vsh, long long vss, double scale, int causal, int window,
           double softcap, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 || dh < 1 || dv < 1 || window < 0 ||
      softcap < 0.0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{Hq / Hkv, Sq, Skv, dh, dv, Hq, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
                 (float)scale, (float)softcap, causal, window, rows_aligned(q, qsb, qsh, qss),
                 rows_aligned(k, ksb, ksh, kss), rows_aligned(v, vsb, vsh, vss)};
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
