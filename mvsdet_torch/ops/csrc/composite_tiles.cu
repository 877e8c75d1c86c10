// Tile compositor forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel mvsdet_tpu/ops/pallas/splat_kernel.py
// `_composite_kernel` (launched by `_composite_tiles_pallas`, public as
// `composite_tiles`).  Contract, per 16x16 tile t of a canvas `tiles_x`
// tiles wide (views may be stacked vertically):
//
//   data (T, 8, K) rows [mx, my, conic_a, conic_b, conic_c, opacity, 0, 0]
//   vals (T, C, K) per-slot channel values, slots depth-sorted near-first
//   out  (T, C+1, 256): channels, then the final transmittance
//
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx = px - mx, dy = py - my
//   alpha = min(op exp(min(power, 0)), 0.99), zeroed where power > 0 or
//           alpha < 1/255
//   out_c = sum_j exp(sum_{i<j} log1p(-alpha_i)) alpha_j v_cj
//
// with integer pixel coordinates px = tx*16 + p%16, py = ty*16 + p/16.
// Every slot is composited: there is no early stop at small transmittance,
// because the JAX kernel composites all K slots and the port must match it.
//
// Bound: operations.  A pair (pixel, slot) costs ~12 flops to find whether
// it is culled and, when active, ~2C + 6 more with three transcendentals
// (exp, log1p, and the exp of the running log-transmittance, a
// loop-carried dependency); the table is read once.  On the training
// step's tables only ~12% of the T * 256 * K pairs are active.
//
// Design (see composite_tiles.cuh).  K is split into segments of 128
// slots, one CTA per (tile, segment): 2560 CTAs at T = 160, K = 2048
// instead of one per tile, so enough warps are in flight to hide the
// log-T chain.  Staging drops slots below the opacity cutoff and gives the
// others a cull box; each warp walks only the slots whose box meets its 8x4
// pixel patch.  Pass 1 (composite_tiles_segment_kernel) writes, per pixel
// and segment, the channels composited from a local log-T of 0 and the
// segment's sum L_s of log1p(-alpha).  Pass 2
// (composite_tiles_combine_kernel) combines them in segment order:
//
//   out_c = sum_s exp(sum_{s'<s} L_s') acc_sc,   T_final = exp(sum_s L_s)
//
// Nothing is added atomically, so two launches give the same bits.  What
// bounds pass 1 now is the instructions a warp issues per listed slot
// (the per-pixel test and the three transcendentals, for all 32 lanes
// while about a third of them are active): capping its registers for
// more CTAs per SM did not make it faster on an H100.

#include "composite_tiles.cuh"

namespace {

using namespace ct;

template <int C>
__global__ void __launch_bounds__(kPixels)
composite_tiles_segment_kernel(const float* __restrict__ data,
                               const float* __restrict__ vals,
                               float* __restrict__ partials, int k,
                               int tiles_x) {
  segment_pass<C>(data, vals, partials, nullptr, k, tiles_x);
}

template <int C>
__global__ void __launch_bounds__(kPixels)
composite_tiles_combine_kernel(const float* __restrict__ partials,
                               float* __restrict__ out, int n_seg) {
  const int t = blockIdx.x;
  const int q = threadIdx.x;
  const float* pp = partials + static_cast<long long>(t) * n_seg * (C + 1)
                    * kPixels + q;
  float log_t = 0.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int s = 0; s < n_seg; ++s, pp += (C + 1) * kPixels) {
    const float tr = expf(log_t);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += tr * pp[c * kPixels];
    log_t += pp[C * kPixels];
  }
  float* o = out + static_cast<long long>(t) * (C + 1) * kPixels + q;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c * kPixels] = acc[c];
  o[C * kPixels] = expf(log_t);
}

// Every slot's cull as staging computes it, for the checks that hold the
// kernels' own boxes against the active pairs: keep (T, K) and box
// (T, 4, K).  Not part of the compositor's path.
__global__ void composite_tiles_cull_boxes_kernel(
    const float* __restrict__ data, unsigned char* __restrict__ keep,
    float* __restrict__ box, int n_tiles, int k) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= static_cast<long long>(n_tiles) * k) return;
  const long long t = i / k;
  const int j = static_cast<int>(i % k);
  float row[6], b[4];
#pragma unroll
  for (int r = 0; r < 6; ++r) row[r] = data[(t * kDataRows + r) * k + j];
  keep[i] = !(row[5] < kAlphaMin);
  cull_box(row, b);
#pragma unroll
  for (int r = 0; r < 4; ++r) box[(t * 4 + r) * k + j] = b[r];
}

template <int C>
cudaError_t launch(const float* data, const float* vals, float* out,
                   float* partials, int n_tiles, int k, int tiles_x,
                   cudaStream_t stream) {
  const int n_seg = segments(k);
  if (n_seg > 0) {
    composite_tiles_segment_kernel<C>
        <<<dim3(n_tiles, n_seg), kPixels, 0, stream>>>(data, vals, partials,
                                                       k, tiles_x);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  composite_tiles_combine_kernel<C><<<n_tiles, kPixels, 0, stream>>>(
      partials, out, n_seg);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the caller allocates for composite_tiles_fwd: the
// per-segment partials (T, S, C + 1, 256).
extern "C" long long composite_tiles_fwd_scratch(int n_tiles, int k, int c) {
  return static_cast<long long>(n_tiles) * segments(k) * (c + 1) * kPixels;
}

// Returns the launches' cudaError_t (0 on success); C must be 1..4.
extern "C" int composite_tiles_fwd(const float* data, const float* vals,
                                   float* out, float* scratch, int n_tiles,
                                   int k, int c, int tiles_x,
                                   cudaStream_t stream) {
  if (n_tiles == 0) return 0;
  switch (c) {
    case 1: return launch<1>(data, vals, out, scratch, n_tiles, k, tiles_x,
                             stream);
    case 2: return launch<2>(data, vals, out, scratch, n_tiles, k, tiles_x,
                             stream);
    case 3: return launch<3>(data, vals, out, scratch, n_tiles, k, tiles_x,
                             stream);
    case 4: return launch<4>(data, vals, out, scratch, n_tiles, k, tiles_x,
                             stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Writes keep (T, K) bytes and box (T, 4, K) floats for data (T, 8, K);
// returns the launch's cudaError_t.
extern "C" int composite_tiles_cull_boxes(const float* data,
                                          unsigned char* keep, float* box,
                                          int n_tiles, int k,
                                          cudaStream_t stream) {
  const long long n = static_cast<long long>(n_tiles) * k;
  if (n == 0) return 0;
  composite_tiles_cull_boxes_kernel<<<static_cast<unsigned>((n + 255) / 256),
                                      256, 0, stream>>>(data, keep, box,
                                                        n_tiles, k);
  return static_cast<int>(cudaGetLastError());
}
