// Voxel-lift weighted gather forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel mvsdet_tpu/ops/pallas/lift_kernel.py
// `_fwd_kernel` (launched by `_forward`, public as `weighted_gather_sum`):
//
//   out[v, :] = sum_n weight[n, v] * feat[n, pix[n, v], :]     (V, C) fp32
//
// with feat (N, HW, C) fp32 or bf16, pix (N, V) int32 clipped to [0, HW),
// weight (N, V) fp32.  The bf16 variant is the lift of a model computing in
// bf16: its rows are the FPN's bf16 values, widened exactly to fp32 and
// multiplied by the fp32 weight, as the JAX package's XLA lift does
// (mvsdet_tpu/ops/voxel_lift.py:91-92, 145), so its output is the fp32
// kernel's on the widened rows, bit for bit.
//
// Design.  The TPU kernel builds a (256, HW) one-hot and multiplies it on
// the MXU only because the TPU gathers rows poorly.  Hopper gathers rows
// well, so this is a direct gather: one warp per voxel, a loop over the
// views in order n = 0..N-1 (the order of the XLA scan,
// mvsdet_tpu/ops/voxel_lift.py:136-151), rows whose weight is 0 skipped.
// A lane sums 8 channels of each 256-channel row: two float4 of an fp32
// row, or of a bf16 row one 16-byte load when C % 8 == 0 and two 8-byte
// loads otherwise, so a warp reads a row in coalesced 512-byte (fp32) or
// 256-512-byte (bf16) transactions.  The sum stays in fp32 registers until
// one store of the (V, C) output: no atomics.  Each add is an unfused
// multiply then add (__fmul_rn, __fadd_rn), the exact rounding of the
// plain PyTorch loop it is held against.  A view's map is 4.9 MB at
// 60x80x256 in fp32 (2.5 MB in bf16), so maps stay L2-resident while the
// voxels that see them are summed.
//
// Bound: bytes.  Two flops per gathered value against four (fp32) or two
// (bf16) bytes read: the kernel can only be as fast as it reads the rows
// its weights select.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kChanPerLane = 8;
constexpr int kChanPerWarp = kWarp * kChanPerLane;         // 256 channels

// bf16 -> fp32 is exact: the bf16 bits are the fp32's upper half.  `w`
// holds two bf16, the one at the lower address in its low half.
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// kLoad consecutive channels of a row in one load, widened to fp32.
template <typename T, int kLoad>
struct RowLoad;

template <>
struct RowLoad<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* x) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  }
};

template <>
struct RowLoad<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
  }
};

template <>
struct RowLoad<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
    x[4] = bf16_lo(u.z); x[5] = bf16_hi(u.z);
    x[6] = bf16_lo(u.w); x[7] = bf16_hi(u.w);
  }
};

// Lane `lane` of the warp on channel block blockIdx.y sums the loads
// (units of kLoad channels) lane + q * 32, q < kChanPerLane / kLoad, of
// that block's 256 channels.
template <typename T, int kLoad>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
weighted_gather_sum_kernel(const T* __restrict__ feat,
                           const int* __restrict__ pix,
                           const float* __restrict__ weight,
                           float* __restrict__ out, int n, int hw,
                           int n_vox, int c) {
  constexpr int kUnits = kChanPerLane / kLoad;
  const int lane = threadIdx.x % kWarp;
  const int vox = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (vox >= n_vox) return;
  const int units = c / kLoad;                             // loads per row
  const int unit0 = blockIdx.y * (kChanPerWarp / kLoad) + lane;

  float acc[kUnits][kLoad];
#pragma unroll
  for (int q = 0; q < kUnits; ++q)
#pragma unroll
    for (int j = 0; j < kLoad; ++j) acc[q][j] = 0.f;

  for (int i = 0; i < n; ++i) {
    const long long iv = static_cast<long long>(i) * n_vox + vox;
    const float w = weight[iv];
    if (w == 0.f) continue;
    const T* row = feat + (static_cast<long long>(i) * hw + pix[iv]) * c;
#pragma unroll
    for (int q = 0; q < kUnits; ++q) {
      const int u = unit0 + q * kWarp;
      if (u < units) {
        float x[kLoad];
        RowLoad<T, kLoad>::load(row + u * kLoad, x);
#pragma unroll
        for (int j = 0; j < kLoad; ++j)
          acc[q][j] = __fadd_rn(acc[q][j], __fmul_rn(x[j], w));
      }
    }
  }

  float* o = out + static_cast<long long>(vox) * c;
#pragma unroll
  for (int q = 0; q < kUnits; ++q) {
    const int u = unit0 + q * kWarp;
    if (u < units) {
      float4* dst = reinterpret_cast<float4*>(o + u * kLoad);
#pragma unroll
      for (int j = 0; j < kLoad / 4; ++j)
        dst[j] = make_float4(acc[q][4 * j], acc[q][4 * j + 1],
                             acc[q][4 * j + 2], acc[q][4 * j + 3]);
    }
  }
}

template <typename T, int kLoad>
int launch(const T* feat, const int* pix, const float* weight, float* out,
           int n, int hw, int n_vox, int c, cudaStream_t stream) {
  const dim3 grid((n_vox + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (c + kChanPerWarp - 1) / kChanPerWarp);
  weighted_gather_sum_kernel<T, kLoad>
      <<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(feat, pix, weight, out,
                                                    n, hw, n_vox, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success); C must be a
// multiple of 4 and every pointer 16-byte aligned.
extern "C" int weighted_gather_sum_fwd(const float* feat, const int* pix,
                                       const float* weight, float* out,
                                       int n, int hw, int n_vox, int c,
                                       cudaStream_t stream) {
  if (n_vox == 0 || c == 0) return 0;
  if (c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, 4>(feat, pix, weight, out, n, hw, n_vox, c, stream);
}

// The bf16-feature variant: 16-byte row loads when C % 8 == 0, 8-byte
// loads otherwise.
extern "C" int weighted_gather_sum_fwd_bf16(const __nv_bfloat16* feat,
                                            const int* pix,
                                            const float* weight, float* out,
                                            int n, int hw, int n_vox, int c,
                                            cudaStream_t stream) {
  if (n_vox == 0 || c == 0) return 0;
  if (c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (c % 8 == 0)
    return launch<__nv_bfloat16, 8>(feat, pix, weight, out, n, hw, n_vox, c,
                                    stream);
  return launch<__nv_bfloat16, 4>(feat, pix, weight, out, n, hw, n_vox, c,
                                  stream);
}
