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
// Bound: bytes.  Two flops per gathered value against four (fp32) or two
// (bf16) bytes read: the kernel can only be as fast as it reads the rows
// its weights select, the views' pix and weight, and writes the output.
//
// Design.  The TPU kernel builds a (256, HW) one-hot and multiplies it on
// the MXU only because the TPU gathers rows poorly.  Hopper gathers rows
// well, so this is a direct gather.  In the lift only a few views see a
// voxel (a tenth of the (view, voxel) pairs at the training step), so
// what costs is finding the selected rows, not adding them.  A CTA owns a
// tile of kTile consecutive voxels, one warp each, and one 256-channel
// block:
//
//   1. Stage.  The tile's weight and pix columns for a chunk of kChunk
//      views are copied into shared memory with cp.async, every copy at
//      once: for each view a 16-byte row of each array, half a DRAM
//      sector, whose other half the next tile's CTA, scheduled beside
//      it, reads from L2.  Chunks are double-buffered, so chunk k + 1 is
//      in flight while the warps walk chunk k.  Views past N and voxels
//      past V are filled with zeros (weight 0: never selected).
//   2. Compact.  A warp ballots its voxel's staged weights, 32 views a
//      ballot: the set bits of the 64-bit mask are its nonzero views in
//      ascending n.  A voxel that no view sees costs its share of the
//      staging and one store of zeros.
//   3. Rows in flight.  The warp takes the set bits kDepth at a time and
//      issues the loads of all kDepth rows before it adds the first, then
//      adds them in ascending n.  A lane holds 8 channels of a row: two
//      float4 of an fp32 row, of a bf16 row one 16-byte load when
//      C % 8 == 0 and two 8-byte loads otherwise, kept raw until the add.
//   4. Output.  The sum stays in fp32 registers across the chunks, in
//      ascending n, until one store of the (V, C) row: no atomics.
//
// A CTA holds its slot until its slowest warp is done, and the lists are
// uneven from voxel to voxel, so the tile is small: four voxels, 128
// threads, eight CTAs an SM at 64 registers a thread.  More rows in
// flight a warp (eight bf16 rows) spill at that register count.
//
// Each add is an unfused multiply then add (__fmul_rn, __fadd_rn), in
// ascending n (the order of the XLA scan, mvsdet_tpu/ops/voxel_lift.py:
// 136-151), the exact rounding of the plain PyTorch loop it is held
// against.  Consecutive voxels project to nearby pixels, so consecutive
// tiles, scheduled together, reuse the selected rows in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 4;                     // voxels per CTA, one warp each
constexpr int kThreads = kWarp * kTile;
constexpr int kChunk = 64;                   // views staged at a time
constexpr int kPitch = kTile + 1;            // odd: conflict-free ballots
constexpr int kDepth = 4;                    // rows loaded before the adds
constexpr int kChanPerLane = 8;
constexpr int kChanPerWarp = kWarp * kChanPerLane;         // 256 channels

struct Stage {
  float weight[kChunk][kPitch];
  int pix[kChunk][kPitch];
};

// bf16 -> fp32 is exact: the bf16 bits are the fp32's upper half.  `w`
// holds two bf16, the one at the lower address in its low half.
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// kLoad consecutive channels of a row in one load (`Raw`), widened to
// fp32 at the add.
template <typename T, int kLoad>
struct RowLoad;

template <>
struct RowLoad<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void widen(Raw f, float* x) {
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  }
};

template <>
struct RowLoad<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static void widen(Raw u, float* x) {
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
  }
};

template <>
struct RowLoad<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void widen(Raw u, float* x) {
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
    x[4] = bf16_lo(u.z); x[5] = bf16_hi(u.z);
    x[6] = bf16_lo(u.w); x[7] = bf16_hi(u.w);
  }
};

// A 4-byte cp.async, or 4 zero bytes when !valid (src-size 0).
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest has landed (in this thread's copies)
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy views [n0, n0 + kChunk) of the tile's voxels [v0, v0 + kTile).
__device__ __forceinline__ void stage(Stage& st, const int* __restrict__ pix,
                                      const float* __restrict__ weight,
                                      int n0, int n, int v0, int n_vox) {
  for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
    const int r = e / kTile, col = e % kTile;
    const bool valid = n0 + r < n && v0 + col < n_vox;
    const long long at =
        valid ? static_cast<long long>(n0 + r) * n_vox + v0 + col : 0;
    copy4(&st.weight[r][col], weight + at, valid);
    copy4(&st.pix[r][col], pix + at, valid);
  }
}

// Warp `threadIdx.x / 32` sums voxel v0 + warp; lane `lane` of it, on
// channel block blockIdx.y, the loads (units of kLoad channels)
// lane + q * 32, q < kChanPerLane / kLoad, of that block's 256 channels.
template <typename T, int kLoad>
__global__ void __launch_bounds__(kThreads, 8)
weighted_gather_sum_kernel(const T* __restrict__ feat,
                           const int* __restrict__ pix,
                           const float* __restrict__ weight,
                           float* __restrict__ out, int n, int hw,
                           int n_vox, int c) {
  using Row = RowLoad<T, kLoad>;
  constexpr int kUnits = kChanPerLane / kLoad;
  __shared__ Stage stages[2];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int v0 = blockIdx.x * kTile;
  const int units = c / kLoad;                             // loads per row
  const int unit0 = blockIdx.y * (kChanPerWarp / kLoad) + lane;

  float acc[kUnits][kLoad];
#pragma unroll
  for (int q = 0; q < kUnits; ++q)
#pragma unroll
    for (int j = 0; j < kLoad; ++j) acc[q][j] = 0.f;

  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0) stage(stages[0], pix, weight, 0, n, v0, n_vox);
  commit();
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks)
      stage(stages[(k + 1) % 2], pix, weight, (k + 1) * kChunk, n, v0,
            n_vox);
    commit();                                   // empty after the last
    wait_all_but_newest();
    __syncthreads();
    const Stage& st = stages[k % 2];
    const T* base = feat + static_cast<long long>(k) * kChunk * hw * c;

    // the voxel's nonzero views in this chunk, ascending
    unsigned long long views =
        __ballot_sync(~0u, st.weight[lane][warp] != 0.f) |
        static_cast<unsigned long long>(
            __ballot_sync(~0u, st.weight[lane + kWarp][warp] != 0.f))
            << 32;
    while (views) {
      typename Row::Raw raw[kDepth][kUnits];
      float w[kDepth];
      int taken = 0;
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        if (views) {
          const int i = __ffsll(static_cast<long long>(views)) - 1;
          views &= views - 1;
          w[s] = st.weight[i][warp];
          const T* row = base + (static_cast<long long>(i) * hw
                                 + st.pix[i][warp]) * c;
#pragma unroll
          for (int q = 0; q < kUnits; ++q) {
            const int u = unit0 + q * kWarp;
            if (u < units) raw[s][q] = Row::load(row + u * kLoad);
          }
          taken = s + 1;
        }
      }
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        if (s < taken) {
#pragma unroll
          for (int q = 0; q < kUnits; ++q) {
            if (unit0 + q * kWarp < units) {
              float x[kLoad];
              Row::widen(raw[s][q], x);
#pragma unroll
              for (int j = 0; j < kLoad; ++j)
                acc[q][j] = __fadd_rn(acc[q][j], __fmul_rn(x[j], w[s]));
            }
          }
        }
      }
    }
    __syncthreads();                  // the next stage overwrites this one
  }

  const int vox = v0 + warp;
  if (vox >= n_vox) return;
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
  const dim3 grid((n_vox + kTile - 1) / kTile,
                  (c + kChanPerWarp - 1) / kChanPerWarp);
  weighted_gather_sum_kernel<T, kLoad>
      <<<grid, kThreads, 0, stream>>>(feat, pix, weight, out, n, hw, n_vox,
                                      c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success); C must be a
// multiple of 4 and every pointer 16-byte aligned.  N = 0 writes zeros.
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
