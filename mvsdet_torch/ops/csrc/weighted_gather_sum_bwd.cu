// Voxel-lift weighted gather backward for Hopper (sm_90a): two kernels.
//
// Forward (weighted_gather_sum.cu):  out[v, :] = sum_n w[n, v] feat[n, pix[n, v], :]
// With the cotangent g (V, C) of out:
//
//   dfeat[n, p, :] = sum_v [pix[n, v] = p] w[n, v] g[v, :]        (N, HW, C)
//   dw[n, v]       = <feat[n, pix[n, v], :], g[v, :]>              (N, V)
//
// `weighted_gather_sum_dfeat` replaces the Pallas kernel
// mvsdet_tpu/ops/pallas/lift_kernel.py `_dfeat_kernel`, and
// `weighted_gather_sum_dweight` replaces `_dweight_kernel` (both launched
// by `_vjp_bwd`).  pix takes no gradient.
//
// Design.  The TPU kernels build a (256, HW) one-hot in VMEM and contract it
// on the MXU, because the TPU gathers and scatters rows poorly.  Hopper
// does both well, so:
//  - d-feat is a scatter-add: one warp per (n, v) pair with a nonzero
//    weight, each lane adding float4 slices of w g[v] into row pix[n, v]
//    with fp32 atomics.  About a tenth of the pairs carry a weight, and
//    rows collide only where voxels of one view project to one pixel, so
//    contention is low.  The order of the atomic adds varies from run to
//    run, so the last bits of dfeat do too.  The caller zeroes dfeat.
//  - d-weight is a gather and a dot: one warp per (n, v) pair, every pair
//    including zero weights (as `_dweight_kernel` computes them), float4
//    loads of the feature row and of g[v], a warp-shuffle sum.
//
// Bound: bytes.  d-feat reads g and w once and makes one read-modify-write
// of the rows its weights select (2 flops per value); d-weight reads the
// selected rows and g once (2 flops per value).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
dfeat_kernel(const int* __restrict__ pix, const float* __restrict__ weight,
             const float* __restrict__ g, float* __restrict__ dfeat,
             int n, int hw, int n_vox, int c) {
  const long long pair = static_cast<long long>(blockIdx.x) * kWarpsPerBlock
                         + threadIdx.x / kWarp;
  if (pair >= static_cast<long long>(n) * n_vox) return;
  const float w = weight[pair];
  if (w == 0.f) return;
  const int i = static_cast<int>(pair / n_vox);
  const int vox = static_cast<int>(pair % n_vox);
  const int lane = threadIdx.x % kWarp;
  const float4* gv = reinterpret_cast<const float4*>(
      g + static_cast<long long>(vox) * c);
  float* row = dfeat + (static_cast<long long>(i) * hw + pix[pair]) * c;
  for (int q = lane; q < c / 4; q += kWarp) {
    const float4 x = __ldg(gv + q);
    atomicAdd(row + 4 * q + 0, __fmul_rn(x.x, w));
    atomicAdd(row + 4 * q + 1, __fmul_rn(x.y, w));
    atomicAdd(row + 4 * q + 2, __fmul_rn(x.z, w));
    atomicAdd(row + 4 * q + 3, __fmul_rn(x.w, w));
  }
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
dweight_kernel(const float* __restrict__ feat, const int* __restrict__ pix,
               const float* __restrict__ g, float* __restrict__ dw,
               int n, int hw, int n_vox, int c) {
  const long long pair = static_cast<long long>(blockIdx.x) * kWarpsPerBlock
                         + threadIdx.x / kWarp;
  if (pair >= static_cast<long long>(n) * n_vox) return;
  const int i = static_cast<int>(pair / n_vox);
  const int vox = static_cast<int>(pair % n_vox);
  const int lane = threadIdx.x % kWarp;
  const float4* row = reinterpret_cast<const float4*>(
      feat + (static_cast<long long>(i) * hw + pix[pair]) * c);
  const float4* gv = reinterpret_cast<const float4*>(
      g + static_cast<long long>(vox) * c);
  float acc = 0.f;
  for (int q = lane; q < c / 4; q += kWarp) {
    const float4 f = __ldg(row + q);
    const float4 x = __ldg(gv + q);
    acc = __fadd_rn(acc, __fmul_rn(f.x, x.x));
    acc = __fadd_rn(acc, __fmul_rn(f.y, x.y));
    acc = __fadd_rn(acc, __fmul_rn(f.z, x.z));
    acc = __fadd_rn(acc, __fmul_rn(f.w, x.w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) dw[pair] = acc;
}

unsigned blocks_for(int n, int n_vox) {
  const long long pairs = static_cast<long long>(n) * n_vox;
  return static_cast<unsigned>((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success); C must be a
// multiple of 4 and every pointer 16-byte aligned.  dfeat must be zeroed.
extern "C" int weighted_gather_sum_dfeat(const int* pix, const float* weight,
                                         const float* g, float* dfeat, int n,
                                         int hw, int n_vox, int c,
                                         cudaStream_t stream) {
  if (n == 0 || n_vox == 0 || c == 0) return 0;
  if (c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  dfeat_kernel<<<blocks_for(n, n_vox), kWarp * kWarpsPerBlock, 0, stream>>>(
      pix, weight, g, dfeat, n, hw, n_vox, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int weighted_gather_sum_dweight(const float* feat, const int* pix,
                                           const float* g, float* dw, int n,
                                           int hw, int n_vox, int c,
                                           cudaStream_t stream) {
  if (n == 0 || n_vox == 0) return 0;
  if (c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  dweight_kernel<<<blocks_for(n, n_vox), kWarp * kWarpsPerBlock, 0, stream>>>(
      feat, pix, g, dw, n, hw, n_vox, c);
  return static_cast<int>(cudaGetLastError());
}
