// Multi-spring constitutive update (Iai 1993, modified Ramberg-Osgood
// backbone with Masing hysteresis) for Hopper (sm_90a).
//
// Replaces: multispring_pallas / _ms_kernel in
//   src/repro/kernels/multispring/multispring.py (the TPU kernel).
// Plain version: repro_torch.fem.multispring.update + hysteretic_damping.
//
// What bounds it on an H100: bytes, if the arithmetic is kept lean.  Each
// spring reads 40 B of state (4 floats + 2 int32 flags in fp64) and writes
// 40 B back.  The backbone's power x^β has no fp64 unit: each one is an
// inlined log2/exp2 sequence of about a hundred fp64 instructions, so the
// number of powers per spring decides whether the fp64 pipe or memory sets
// the pace.  In the streamed path the state's bytes also cross the host link.
//
// Design: one warp per evaluation point, lanes over springs (spring index
// fastest), so each warp's state loads and stores are 32 consecutive values
// of one [P,S] row: fully coalesced, with no padding of S to 128 lanes (the
// TPU artefact).
//  - Memory first: the warp copies the state of up to kChunk = 160 springs
//    (⌈150/32⌉ = 5 a lane) into its slice of shared memory with cp.async
//    before any arithmetic, so all those loads are in flight together and
//    hold no registers; the spring loop that follows stays rolled, which
//    keeps the code and the register count small.
//  - One power per argument: x^β = exp2(β·log2 x) once, shared by τ and
//    dτ/dγ through one reciprocal of 1 + x^β; x = 0 gives 0 exactly (τ(0) = 0,
//    dτ/dγ(0) = G0).  A reversal adds the anchor's power; the damping
//    fraction at γ_max reuses the branch's power and reciprocal when
//    γ_max = |γ| (loading on the backbone) and takes its own otherwise.
//  - The 28 sums (σ 6, the upper triangle of D 21, the damping fraction 1),
//    padded to 32, are reduce-scattered over the warp by recursive halving:
//    16 + 8 + 4 + 2 + 1 = 31 shuffles a lane instead of 5 × 28, after which
//    lane r holds sum r and stores it.  Each sum is taken in a fixed order,
//    so the result is the same from run to run; no atomics.
// The tangent floor is g_min_frac·G0, read from the parameters (the TPU
// kernel hard-coded 1e-3·G0).
//
// k-set launch (the paper's 2SET): k members' points in one launch over
// k × P points.  ε, the state and every output are member-major [k·P, …]
// (the [k, P, …] tensors as they lie); the per-point material parameters
// [P] are shared, and point p reads parameter p mod P.  That costs one
// integer remainder per point, where repeating the parameters k times in
// the wrapper would write and then read 37.7 MB per member at the
// full-size mesh (4 × 1,179,648 fp64) on every launch.  k = 1 is the
// one-member kernel.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kNRed = 28;     // 6 σ + 21 D (upper triangle) + 1 frac, padded to 32 below
constexpr int kChunk = 160;   // springs a warp stages in shared memory per round
constexpr int kMaxWarps = 8;  // points (warps) per block: 256 threads leave 255 registers a thread

// One warp's staged spring state.
template <typename T>
struct Staged {
  T grev[kChunk], trev[kChunk], gprev[kChunk], gmax[kChunk];
  int dir[kChunk], virg[kChunk];
};

__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }
__device__ __forceinline__ float tpow_pos(float x, float y) { return exp2f(y * log2f(x)); }
__device__ __forceinline__ double tpow_pos(double x, double y) { return exp2(y * log2(x)); }

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(reinterpret_cast<uint64_t>(src)), "n"(N)
               : "memory");
}

template <typename T>
struct Backbone {
  T G0, inv_gr, be;
  // (|g|/γr)^β, exactly 0 at g = 0
  __device__ __forceinline__ T xpow(T g) const {
    const T x = tabs(g) * inv_gr;
    return x > T(0) ? tpow_pos(x, be) : T(0);
  }
  // τ(g) = G0 g / (1 + x^β) from xb = x^β
  __device__ __forceinline__ T tau(T g, T xb) const { return G0 * g / (T(1) + xb); }
};

// Recursive-halving reduce-scatter of v[0..2H) over the lanes that differ
// in bit H: the lane with that bit set keeps the upper half.
template <typename T, int H>
__device__ __forceinline__ void halve(T* v, int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const T keep = up ? v[H + j] : v[j];
    const T send = up ? v[j] : v[H + j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Two blocks of 256 threads per SM cap a thread at 128 registers, which
// leaves four warps per scheduler; unbounded, ptxas takes 136 and three fit.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps, 2) ms_update_kernel(
    const T* __restrict__ eps, const T* __restrict__ grev, const T* __restrict__ trev,
    const T* __restrict__ gprev, const T* __restrict__ gmax, const int* __restrict__ dir,
    const int* __restrict__ virg, const T* __restrict__ G0, const T* __restrict__ gr,
    const T* __restrict__ be, const T* __restrict__ bulk, const T* __restrict__ n,
    const T* __restrict__ w, T g_min_frac, int P, int S, int k,
    T* __restrict__ sig, T* __restrict__ D, T* __restrict__ frac,
    T* __restrict__ ngrev, T* __restrict__ ntrev, T* __restrict__ ngprev,
    T* __restrict__ ngmax, int* __restrict__ ndir, int* __restrict__ nvirg) {
  extern __shared__ __align__(16) unsigned char smem[];
  Staged<T>& st = reinterpret_cast<Staged<T>*>(smem)[threadIdx.y];
  const int lane = threadIdx.x;  // blockDim.x == 32: one warp per point
  // k·P ≤ INT_MAX (checked at launch): 32-bit point indices
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= k * P) return;  // uniform over the warp
  const int pm = p % P;    // the point's material parameters

  T e[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) e[k] = eps[6ll * p + k];
  const Backbone<T> bb{G0[pm], T(1) / gr[pm], be[pm]};
  const T g_floor = g_min_frac * bb.G0;

  T acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = T(0);

  for (int s0 = 0; s0 < S; s0 += kChunk) {
    // stage this lane's springs s0 + lane + 32k, every copy issued first;
    // a lane reads back only what it copied itself
    for (int j = lane; j < kChunk && s0 + j < S; j += 32) {
      const long long i = (long long)p * S + s0 + j;
      cp_async<sizeof(T)>(&st.grev[j], grev + i);
      cp_async<sizeof(T)>(&st.trev[j], trev + i);
      cp_async<sizeof(T)>(&st.gprev[j], gprev + i);
      cp_async<sizeof(T)>(&st.gmax[j], gmax + i);
      cp_async<4>(&st.dir[j], dir + i);
      cp_async<4>(&st.virg[j], virg + i);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");

    for (int j = lane; j < kChunk && s0 + j < S; j += 32) {
      const int s = s0 + j;
      const long long i = (long long)p * S + s;
      T ns[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) ns[a] = n[s * 6 + a];
      const T ws = w[s];

      T gamma = T(0);
#pragma unroll
      for (int a = 0; a < 6; ++a) gamma += e[a] * ns[a];

      const T g_prev = st.gprev[j];
      const T d = gamma - g_prev;
      const int moving = (d > T(0)) - (d < T(0));
      const int dir_old = st.dir[j];
      T gamma_rev = st.grev[j];
      T tau_rev = st.trev[j];
      int virgin = st.virg[j];

      if (moving != 0 && dir_old != 0 && moving != dir_old) {
        // reversal: the previous branch stress at γ_prev becomes the new
        // Masing anchor (backbone τ(γ_prev), or τ_rev + 2τ((γ_prev − γ_rev)/2))
        const T arg = virgin == 1 ? g_prev : T(0.5) * (g_prev - gamma_rev);
        const T t = bb.tau(arg, bb.xpow(arg));
        tau_rev = virgin == 1 ? t : tau_rev + T(2) * t;
        gamma_rev = g_prev;
        virgin = 0;
      }
      const int direction = moving != 0 ? moving : dir_old;
      const T gm_old = st.gmax[j];
      const T ag = tabs(gamma);
      const bool on_backbone = ag >= gm_old;
      if (on_backbone) virgin = 1;  // rejoin the backbone
      const T gamma_max = ag > gm_old ? ag : gm_old;

      // the branch: backbone at γ, or the Masing branch 2τ((γ − γ_rev)/2)
      const T arg = virgin == 1 ? gamma : T(0.5) * (gamma - gamma_rev);
      const T xb = bb.xpow(arg);
      const T r = T(1) / (T(1) + xb);
      const T t = bb.G0 * arg * r;
      const T tau = virgin == 1 ? t : tau_rev + T(2) * t;
      T g_tan = bb.G0 * (T(1) + (T(1) - bb.be) * xb) * (r * r);
      if (g_tan < g_floor) g_tan = g_floor;
      // damping fraction at γ_max: on the backbone γ_max = |γ|, the branch's x^β
      const T rm = on_backbone ? r : T(1) / (T(1) + bb.xpow(gamma_max));

      ngrev[i] = gamma_rev;
      ntrev[i] = tau_rev;
      ngprev[i] = gamma;
      ngmax[i] = gamma_max;
      ndir[i] = direction;
      nvirg[i] = virgin;

      const T tw = tau * ws;
      const T gw = g_tan * ws;
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[a] += tw * ns[a];
      int q = 6;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) acc[q++] += gw * ns[a] * ns[b];
      }
      acc[kNRed - 1] += T(1) - rm;
    }
  }

  // lane r ends with sum r (sums 28..31 are the zero padding)
  halve<T, 16>(acc, lane);
  halve<T, 8>(acc, lane);
  halve<T, 4>(acc, lane);
  halve<T, 2>(acc, lane);
  halve<T, 1>(acc, lane);
  const T v = acc[0];
  const int r = lane;
  if (r < 6) {
    sig[6ll * p + r] = r < 3 ? v + bulk[pm] * (e[0] + e[1] + e[2]) : v;
  } else if (r < kNRed - 1) {
    int a = 0, b = r - 6;  // (a, b) of the r-6'th entry of the upper triangle, row by row
    while (b >= 6 - a) {
      b -= 6 - a;
      ++a;
    }
    b += a;
    const T x = (a < 3 && b < 3) ? v + bulk[pm] : v;
    D[36ll * p + a * 6 + b] = x;
    D[36ll * p + b * 6 + a] = x;
  } else if (r == kNRed - 1) {
    frac[p] = v / T(S);
  }
}

template <typename T>
int launch(const void* eps, const void* grev, const void* trev, const void* gprev,
           const void* gmax, const void* dir, const void* virg, const void* G0,
           const void* gr, const void* be, const void* bulk, const void* n, const void* w,
           double g_min_frac, int P, int S, int k, int tile_p, void* sig, void* D, void* frac,
           void* ngrev, void* ntrev, void* ngprev, void* ngmax, void* ndir, void* nvirg,
           void* stream) {
  if (tile_p < 1 || tile_p > kMaxWarps || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // per instantiation: the shared-memory ceiling, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(ms_update_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kMaxWarps * sizeof(Staged<T>)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long points = (long long)k * P;
  if (points > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (points > 0) {
    const dim3 block(32, tile_p);
    const dim3 grid(static_cast<unsigned>((points + tile_p - 1) / tile_p));
    ms_update_kernel<T><<<grid, block, tile_p * sizeof(Staged<T>), static_cast<cudaStream_t>(stream)>>>(
        (const T*)eps, (const T*)grev, (const T*)trev, (const T*)gprev, (const T*)gmax,
        (const int*)dir, (const int*)virg, (const T*)G0, (const T*)gr, (const T*)be,
        (const T*)bulk, (const T*)n, (const T*)w, T(g_min_frac), P, S, k, (T*)sig, (T*)D,
        (T*)frac, (T*)ngrev, (T*)ntrev, (T*)ngprev, (T*)ngmax, (int*)ndir, (int*)nvirg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MS_ARGS                                                                          \
  const void *eps, const void *grev, const void *trev, const void *gprev,                \
      const void *gmax, const void *dir, const void *virg, const void *G0, const void *gr, \
      const void *be, const void *bulk, const void *n, const void *w, double g_min_frac,  \
      int P, int S, int k, int tile_p, void *sig, void *D, void *frac, void *ngrev, void *ntrev, \
      void *ngprev, void *ngmax, void *ndir, void *nvirg, void *stream
#define MS_PASS                                                                          \
  eps, grev, trev, gprev, gmax, dir, virg, G0, gr, be, bulk, n, w, g_min_frac, P, S, k,  \
      tile_p, sig, D, frac, ngrev, ntrev, ngprev, ngmax, ndir, nvirg, stream

extern "C" int ms_update_f32(MS_ARGS) { return launch<float>(MS_PASS); }
extern "C" int ms_update_f64(MS_ARGS) { return launch<double>(MS_PASS); }
