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
//
// Design.  The TPU kernel builds the exclusive log-transmittance prefix as
// a triangular matmul because Mosaic has no cumsum; here each thread owns
// one pixel and walks the slots in order, so the prefix is a running sum in
// a register.  One CTA per tile, 256 threads.  The tile's table is staged
// through shared memory kChunk slots at a time and every thread reads the
// same slot at the same step (a broadcast, no bank conflicts).  Every slot
// is composited: there is no early stop at small transmittance, because
// the JAX kernel composites all K slots and the port must match it.
//
// Bound: operations.  Each (pixel, slot) pair costs ~12 + 2C flops and up
// to three transcendentals, while the table is read from device memory
// once per tile: at K=2048, C=3 that is ~100 flops per byte moved, five
// times the card's fp32 balance.  Pairs outside the splat (power > 0) or
// below the alpha cutoff skip the transcendentals and the accumulation.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // one thread per pixel
constexpr int kChunk = 256;             // slots staged per shared-memory step
constexpr int kDataRows = 8;

template <int C>
__global__ void __launch_bounds__(kPixels)
composite_tiles_kernel(const float* __restrict__ data,
                       const float* __restrict__ vals,
                       float* __restrict__ out, int k, int tiles_x) {
  __shared__ float s_data[6][kChunk];
  __shared__ float s_vals[C][kChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((t % tiles_x) * kTile + p % kTile);
  const float py = static_cast<float>((t / tiles_x) * kTile + p / kTile);
  const float* d = data + static_cast<long long>(t) * kDataRows * k;
  const float* v = vals + static_cast<long long>(t) * C * k;

  float log_t = 0.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int base = 0; base < k; base += kChunk) {
    const int n = min(kChunk, k - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = p; i < n; i += kPixels) {
#pragma unroll
      for (int r = 0; r < 6; ++r) s_data[r][i] = d[r * k + base + i];
#pragma unroll
      for (int c = 0; c < C; ++c) s_vals[c][i] = v[c * k + base + i];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float dx = px - s_data[0][j];
      const float dy = py - s_data[1][j];
      const float power = -0.5f * (s_data[2][j] * dx * dx
                                   + s_data[4][j] * dy * dy)
                          - s_data[3][j] * dx * dy;
      if (!(power <= 0.f)) continue;
      const float alpha = fminf(s_data[5][j] * expf(power), 0.99f);
      if (!(alpha >= 1.f / 255.f)) continue;
      const float w = expf(log_t) * alpha;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * s_vals[c][j];
      log_t += log1pf(-alpha);
    }
  }

  float* o = out + static_cast<long long>(t) * (C + 1) * kPixels;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c * kPixels + p] = acc[c];
  o[C * kPixels + p] = expf(log_t);
}

template <int C>
cudaError_t launch(const float* data, const float* vals, float* out,
                   int n_tiles, int k, int tiles_x, cudaStream_t stream) {
  composite_tiles_kernel<C><<<n_tiles, kPixels, 0, stream>>>(
      data, vals, out, k, tiles_x);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success); C must be 1..4.
extern "C" int composite_tiles_fwd(const float* data, const float* vals,
                                   float* out, int n_tiles, int k, int c,
                                   int tiles_x, cudaStream_t stream) {
  if (n_tiles == 0) return 0;
  switch (c) {
    case 1: return launch<1>(data, vals, out, n_tiles, k, tiles_x, stream);
    case 2: return launch<2>(data, vals, out, n_tiles, k, tiles_x, stream);
    case 3: return launch<3>(data, vals, out, n_tiles, k, tiles_x, stream);
    case 4: return launch<4>(data, vals, out, n_tiles, k, tiles_x, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
