// Multi-spring constitutive update (Iai 1993, modified Ramberg-Osgood
// backbone with Masing hysteresis) for Hopper (sm_90a).
//
// Replaces: multispring_pallas / _ms_kernel in
//   src/repro/kernels/multispring/multispring.py (the TPU kernel).
// Plain version: repro_torch.fem.multispring.update + hysteretic_damping.
//
// What bounds it on an H100: bytes.  Each spring reads 40 B of state
// (4 floats + 2 int32 flags in fp64) and writes 40 B back, about 80 B for
// ~150 flops, far below the card's ops:byte balance point.  In the streamed
// path those bytes also cross the host link, which is slower than HBM.
//
// Design: one warp per evaluation point, lanes over springs (spring index
// fastest), so each warp's state loads and stores are 32 consecutive values
// of one [P,S] row: fully coalesced, with no padding of S to 128 lanes (the
// TPU artefact).  The ragged edge (S = 150 is not a multiple of 32) is the
// loop bound `s < S`.  The per-spring branch logic is plain per-thread code.
// σ (6), the upper triangle of D (21) and the damping fraction (1) are
// reduced over the warp with an xor butterfly of shuffles: no shared memory,
// no __syncthreads, and a fixed order, so the result is the same from run
// to run.  The tangent floor is g_min_frac·G0, read from the parameters
// (the TPU kernel hard-coded 1e-3·G0).
#include <cuda_runtime.h>

namespace {

constexpr int kNRed = 28;  // 6 σ + 21 D (upper triangle) + 1 frac

__device__ __forceinline__ float tpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double tpow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }

template <typename T>
struct Backbone {
  T G0, gr, be;
  // τ(γ) = G0 γ / (1 + |γ/γr|^β)
  __device__ __forceinline__ T tau(T g) const {
    const T x = tabs(g) / gr;
    return G0 * g / (T(1) + tpow(x, be));
  }
  // dτ/dγ = G0 (1 + (1-β) x^β) / (1 + x^β)²
  __device__ __forceinline__ T tangent(T g) const {
    const T x = tabs(g) / gr;
    const T den = T(1) + tpow(x, be);
    return G0 * (T(1) + (T(1) - be) * tpow(x, be)) / (den * den);
  }
};

template <typename T>
__global__ void ms_update_kernel(
    const T* __restrict__ eps, const T* __restrict__ grev, const T* __restrict__ trev,
    const T* __restrict__ gprev, const T* __restrict__ gmax, const int* __restrict__ dir,
    const int* __restrict__ virg, const T* __restrict__ G0, const T* __restrict__ gr,
    const T* __restrict__ be, const T* __restrict__ bulk, const T* __restrict__ n,
    const T* __restrict__ w, T g_min_frac, int P, int S,
    T* __restrict__ sig, T* __restrict__ D, T* __restrict__ frac,
    T* __restrict__ ngrev, T* __restrict__ ntrev, T* __restrict__ ngprev,
    T* __restrict__ ngmax, int* __restrict__ ndir, int* __restrict__ nvirg) {
  const int lane = threadIdx.x;  // blockDim.x == 32: one warp per point
  const long long p = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= P) return;  // uniform over the warp

  T e[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) e[k] = eps[p * 6 + k];
  const Backbone<T> bb{G0[p], gr[p], be[p]};
  const T g_floor = g_min_frac * bb.G0;

  T acc[kNRed];
#pragma unroll
  for (int k = 0; k < kNRed; ++k) acc[k] = T(0);

  for (int s = lane; s < S; s += 32) {
    const long long i = p * S + s;
    T ns[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) ns[k] = n[s * 6 + k];
    const T ws = w[s];

    T gamma = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) gamma += e[k] * ns[k];

    const T g_prev = gprev[i];
    const T d = gamma - g_prev;
    const int moving = (d > T(0)) - (d < T(0));
    const int dir_old = dir[i];
    T gamma_rev = grev[i];
    T tau_rev = trev[i];
    int virgin = virg[i];

    const bool reversal = moving != 0 && dir_old != 0 && moving != dir_old;
    if (reversal) {
      // previous branch stress at γ_prev becomes the new Masing anchor
      const T tau_prev = virgin == 1
          ? bb.tau(g_prev)
          : tau_rev + T(2) * bb.tau(T(0.5) * (g_prev - gamma_rev));
      gamma_rev = g_prev;
      tau_rev = tau_prev;
      virgin = 0;
    }
    const int direction = moving != 0 ? moving : dir_old;
    const T gm_old = gmax[i];
    const T ag = tabs(gamma);
    if (ag >= gm_old) virgin = 1;  // rejoin the backbone
    const T gamma_max = ag > gm_old ? ag : gm_old;

    T tau, g_tan;
    if (virgin == 1) {
      tau = bb.tau(gamma);
      g_tan = bb.tangent(gamma);
    } else {
      const T h = T(0.5) * (gamma - gamma_rev);
      tau = tau_rev + T(2) * bb.tau(h);
      g_tan = bb.tangent(h);
    }
    if (g_tan < g_floor) g_tan = g_floor;

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
    int r = 6;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) acc[r++] += gw * ns[a] * ns[b];
    }
    acc[27] += T(1) - T(1) / (T(1) + tpow(gamma_max / bb.gr, bb.be));
  }

  // xor butterfly: every lane ends with the same sums, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kNRed; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }

  if (lane == 0) {
    const T bk = bulk[p];
    const T vol = e[0] + e[1] + e[2];
#pragma unroll
    for (int a = 0; a < 6; ++a) sig[p * 6 + a] = a < 3 ? acc[a] + bk * vol : acc[a];
    int r = 6;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) {
        const T v = (a < 3 && b < 3) ? acc[r] + bk : acc[r];
        D[p * 36 + a * 6 + b] = v;
        D[p * 36 + b * 6 + a] = v;
        ++r;
      }
    }
    frac[p] = acc[27] / T(S);
  }
}

template <typename T>
int launch(const void* eps, const void* grev, const void* trev, const void* gprev,
           const void* gmax, const void* dir, const void* virg, const void* G0,
           const void* gr, const void* be, const void* bulk, const void* n, const void* w,
           double g_min_frac, int P, int S, int tile_p, void* sig, void* D, void* frac,
           void* ngrev, void* ntrev, void* ngprev, void* ngmax, void* ndir, void* nvirg,
           void* stream) {
  if (tile_p < 1 || tile_p > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    const dim3 block(32, tile_p);
    const dim3 grid((P + tile_p - 1) / tile_p);
    ms_update_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        (const T*)eps, (const T*)grev, (const T*)trev, (const T*)gprev, (const T*)gmax,
        (const int*)dir, (const int*)virg, (const T*)G0, (const T*)gr, (const T*)be,
        (const T*)bulk, (const T*)n, (const T*)w, T(g_min_frac), P, S, (T*)sig, (T*)D,
        (T*)frac, (T*)ngrev, (T*)ntrev, (T*)ngprev, (T*)ngmax, (int*)ndir, (int*)nvirg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MS_ARGS                                                                          \
  const void *eps, const void *grev, const void *trev, const void *gprev,                \
      const void *gmax, const void *dir, const void *virg, const void *G0, const void *gr, \
      const void *be, const void *bulk, const void *n, const void *w, double g_min_frac,  \
      int P, int S, int tile_p, void *sig, void *D, void *frac, void *ngrev, void *ntrev, \
      void *ngprev, void *ngmax, void *ndir, void *nvirg, void *stream
#define MS_PASS                                                                          \
  eps, grev, trev, gprev, gmax, dir, virg, G0, gr, be, bulk, n, w, g_min_frac, P, S,     \
      tile_p, sig, D, frac, ngrev, ntrev, ngprev, ngmax, ndir, nvirg, stream

extern "C" int ms_update_f32(MS_ARGS) { return launch<float>(MS_PASS); }
extern "C" int ms_update_f64(MS_ARGS) { return launch<double>(MS_PASS); }
