// Voxel-lift weighted gather forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel mvsdet_tpu/ops/pallas/lift_kernel.py
// `_fwd_kernel` (launched by `_forward`, public as `weighted_gather_sum`):
//
//   out[v, :] = sum_n weight[n, v] * feat[n, pix[n, v], :]     (V, C) fp32
//
// with feat (N, HW, C) f32, pix (N, V) int32 clipped to [0, HW), weight
// (N, V) f32.
//
// Design.  The TPU kernel builds a (256, HW) one-hot and multiplies it on
// the MXU only because the TPU gathers rows poorly.  Hopper gathers rows
// well, so this is a direct gather: one warp per voxel, a loop over the
// views in order n = 0..N-1 (the order of the XLA scan,
// mvsdet_tpu/ops/voxel_lift.py:136-151), rows whose weight is 0 skipped.
// A lane loads two float4 of each 256-channel row, so a warp reads a row
// as two coalesced 512-byte transactions, and the sum stays in fp32
// registers until one store of the (V, C) output: no atomics.  Each add is
// an unfused multiply then add (__fmul_rn, __fadd_rn), the exact rounding
// of the plain PyTorch loop it is held against.  A view's map is 4.9 MB at
// 60x80x256, so maps stay L2-resident while the voxels that see them are
// summed.
//
// Bound: bytes.  Two flops per gathered value against four bytes read:
// the kernel can only be as fast as it reads the rows its weights select.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kVecPerLane = 2;                             // float4 per lane
constexpr int kChanPerWarp = kWarp * kVecPerLane * 4;      // 256 channels

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
weighted_gather_sum_kernel(const float* __restrict__ feat,
                           const int* __restrict__ pix,
                           const float* __restrict__ weight,
                           float* __restrict__ out, int n, int hw,
                           int n_vox, int c) {
  const int lane = threadIdx.x % kWarp;
  const int vox = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (vox >= n_vox) return;
  const int c4 = c / 4;                                    // float4 per row
  const int vec0 = blockIdx.y * (kChanPerWarp / 4) + lane;

  float4 acc[kVecPerLane];
#pragma unroll
  for (int q = 0; q < kVecPerLane; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < n; ++i) {
    const long long iv = static_cast<long long>(i) * n_vox + vox;
    const float w = weight[iv];
    if (w == 0.f) continue;
    const float4* row = reinterpret_cast<const float4*>(
        feat + (static_cast<long long>(i) * hw + pix[iv]) * c);
#pragma unroll
    for (int q = 0; q < kVecPerLane; ++q) {
      const int vec = vec0 + q * kWarp;
      if (vec < c4) {
        const float4 f = __ldg(row + vec);
        acc[q].x = __fadd_rn(acc[q].x, __fmul_rn(f.x, w));
        acc[q].y = __fadd_rn(acc[q].y, __fmul_rn(f.y, w));
        acc[q].z = __fadd_rn(acc[q].z, __fmul_rn(f.z, w));
        acc[q].w = __fadd_rn(acc[q].w, __fmul_rn(f.w, w));
      }
    }
  }

  float4* o = reinterpret_cast<float4*>(out + static_cast<long long>(vox) * c);
#pragma unroll
  for (int q = 0; q < kVecPerLane; ++q) {
    const int vec = vec0 + q * kWarp;
    if (vec < c4) o[vec] = acc[q];
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success); C must be a multiple
// of 4 and every pointer 16-byte aligned.
extern "C" int weighted_gather_sum_fwd(const float* feat, const int* pix,
                                       const float* weight, float* out,
                                       int n, int hw, int n_vox, int c,
                                       cudaStream_t stream) {
  if (n_vox == 0 || c == 0) return 0;
  if (c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_vox + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (c + kChanPerWarp - 1) / kChanPerWarp);
  weighted_gather_sum_kernel<<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(
      feat, pix, weight, out, n, hw, n_vox, c);
  return static_cast<int>(cudaGetLastError());
}
