// Matrix-free element-by-element (EBE) product for Hopper (sm_90a):
//   f_e = Σ_p wdet_p · coef_e · B_pᵀ D_p B_p u_e
// with B_p rebuilt from J⁻¹ and the reference shape-function gradients, so
// no K_e and no B is ever stored.
//
// Replaces: ebe_element_matvec_pallas / _ebe_kernel in
//   src/repro/kernels/ebe_matvec/ebe_matvec.py (the TPU kernel).
// Plain version: repro_torch.fem.spmv.ebe_element_matvec.
//
// What bounds it on an H100: bytes.  Per element it reads D (144 values),
// u (30), J⁻¹ (9), wdet (4) and coef (1) and writes f (30): about 1.7 KB in
// fp64 and 0.9 KB in fp32, for about 2.4 kflop, well below the card's
// ops:byte balance point in either type.
//
// Design: one thread per element, templated on float/double, with the
// 4 points × 10 nodes × 3 components unrolled; the element index is the
// thread index (the TPU's [k,E] transposes and 128-lane padding are not
// carried over).  The 120 reference gradients (GRADN_REF of the port's
// quadrature module, many of them zero) are staged once per block in shared
// memory.  The physical gradients are rebuilt per node from J⁻¹ where they
// are used, instead of being held for all 10 nodes, to keep the fp64
// register count down; __launch_bounds__ caps the block at 256 threads.
// The ragged edge is the bound `e < E`.  There are no atomics: the
// assembly (scatter) stays outside, deterministic, in PyTorch.
#include <cuda_runtime.h>

namespace {

constexpr int kNPoint = 4;
constexpr int kNNode = 10;
constexpr int kMaxThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ebe_kernel(const T* __restrict__ u, const T* __restrict__ D, const T* __restrict__ Jinv,
           const T* __restrict__ wdet, const T* __restrict__ coef,
           const T* __restrict__ gradn, int E, T* __restrict__ out) {
  __shared__ T gref[kNPoint * kNNode * 3];
  for (int i = threadIdx.x; i < kNPoint * kNNode * 3; i += blockDim.x) gref[i] = gradn[i];
  __syncthreads();

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;

  T ji[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) ji[k] = Jinv[e * 9 + k];
  const T c = coef ? coef[e] : T(1);
  const T* ue = u + e * 30;

  T f[30];
#pragma unroll
  for (int k = 0; k < 30; ++k) f[k] = T(0);

#pragma unroll
  for (int p = 0; p < kNPoint; ++p) {
    // displacement gradient H[i][j] = Σ_n u[n][i] · ∂N_n/∂x_j
    T H[3][3] = {{T(0), T(0), T(0)}, {T(0), T(0), T(0)}, {T(0), T(0), T(0)}};
#pragma unroll
    for (int nd = 0; nd < kNNode; ++nd) {
      const T* gr = gref + (p * kNNode + nd) * 3;
      T g[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) g[j] = gr[0] * ji[j] + gr[1] * ji[3 + j] + gr[2] * ji[6 + j];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const T ui = ue[nd * 3 + i];
#pragma unroll
        for (int j = 0; j < 3; ++j) H[i][j] += ui * g[j];
      }
    }
    const T eps[6] = {H[0][0], H[1][1], H[2][2], H[0][1] + H[1][0], H[1][2] + H[2][1],
                      H[2][0] + H[0][2]};
    // σ = D ε, scaled by the quadrature weight and the element coefficient
    const T* Dp = D + e * (kNPoint * 36) + p * 36;
    const T wp = wdet[e * kNPoint + p] * c;
    T sw[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      T s = T(0);
#pragma unroll
      for (int b = 0; b < 6; ++b) s += Dp[a * 6 + b] * eps[b];
      sw[a] = s * wp;
    }
    const T st[3][3] = {{sw[0], sw[3], sw[5]}, {sw[3], sw[1], sw[4]}, {sw[5], sw[4], sw[2]}};
    // f[n][i] += Σ_j σ_ij · ∂N_n/∂x_j   (Bᵀσ)
#pragma unroll
    for (int nd = 0; nd < kNNode; ++nd) {
      const T* gr = gref + (p * kNNode + nd) * 3;
      T g[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) g[j] = gr[0] * ji[j] + gr[1] * ji[3 + j] + gr[2] * ji[6 + j];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        f[nd * 3 + i] += st[i][0] * g[0] + st[i][1] * g[1] + st[i][2] * g[2];
    }
  }
#pragma unroll
  for (int k = 0; k < 30; ++k) out[e * 30 + k] = f[k];
}

template <typename T>
int launch(const void* u, const void* D, const void* Jinv, const void* wdet, const void* coef,
           const void* gradn, int E, int tile_e, void* out, void* stream) {
  if (tile_e < 1 || tile_e > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (E > 0) {
    const dim3 grid((E + tile_e - 1) / tile_e);
    ebe_kernel<T><<<grid, tile_e, 0, static_cast<cudaStream_t>(stream)>>>(
        (const T*)u, (const T*)D, (const T*)Jinv, (const T*)wdet, (const T*)coef,
        (const T*)gradn, E, (T*)out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ebe_element_matvec_f32(const void* u, const void* D, const void* Jinv,
                                      const void* wdet, const void* coef, const void* gradn,
                                      int E, int tile_e, void* out, void* stream) {
  return launch<float>(u, D, Jinv, wdet, coef, gradn, E, tile_e, out, stream);
}

extern "C" int ebe_element_matvec_f64(const void* u, const void* D, const void* Jinv,
                                      const void* wdet, const void* coef, const void* gradn,
                                      int E, int tile_e, void* out, void* stream) {
  return launch<double>(u, D, Jinv, wdet, coef, gradn, E, tile_e, out, stream);
}
