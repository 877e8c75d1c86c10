// Tile compositor backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel mvsdet_tpu/ops/pallas/splat_kernel.py
// `_bwd_kernel` (launched by `_composite_tiles_bwd_pallas`, the custom VJP
// `_bwd` of `composite_tiles`).  With the forward of composite_tiles.cu and
// a cotangent g (T, C+1, 256) of its output, the loss per pixel is
//
//   L = sum_j w_j u_j + g_T T_final,   w_j = T_j alpha_j,
//   u_j = sum_c g_c v_cj,              T_j = prod_{i<j} (1 - alpha_i)
//
// and, per slot j,
//
//   dL/dv_cj    = g_c w_j
//   dL/dalpha_j = T_j u_j - (S_j + g_T T_final) / (1 - alpha_j),
//                 S_j = sum_{i>j} w_i u_i
//
// chained through the forward's masks to the six data rows exactly as the
// JAX kernel does: only `active` pairs whose unclipped alpha is below 0.99
// pass dalpha on, and the power terms only where power < 0.  Rows 6-7 of
// ddata are zero.  Each slot's gradients are sums over the tile's 256
// pixels; the outputs stay per tile, so no two CTAs write one address.
//
// Design.  One CTA per tile, a thread per pixel, the table staged through
// shared memory kChunk slots at a time, as in the forward.  The
// transmittance is never rebuilt by dividing T_final by (1 - alpha) back to
// front (the CUDA 3DGS rasterizer's way): at K = 2048 T_final underflows.
// The JAX log-space scheme is kept instead.  Phase A walks the slots front
// to back and stores each chunk's starting log-transmittance in a scratch
// buffer (T, K / kChunk, 256) that only the pixel's own thread reads back.
// Phase B walks the chunks back to front: a short forward pass over the
// chunk rebuilds each slot's exclusive log-transmittance in registers from
// the stored start, then a backward pass over the chunk carries the suffix
// sum S in a register.  Each slot's 6 + C per-pixel gradients are summed by
// warp shuffles and then over the 8 warps through shared memory, always in
// the same order, so the result is deterministic.
//
// Bound: operations.  Every (pixel, slot) pair is evaluated twice (phase A
// and B) at ~12 flops to find whether it is culled, and an active pair
// costs ~40 more flops and three transcendentals, plus the 6 + C shuffle
// reductions per slot; the table is read from device memory twice per tile.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // one thread per pixel
constexpr int kWarps = kPixels / 32;
constexpr int kChunk = 32;              // slots per shared-memory step
constexpr int kDataRows = 8;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.f / 255.f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Stage slots [base, base + kChunk) of the tile's table into shared memory;
// slots past k get opacity 0, which culls them.
template <int C>
__device__ __forceinline__ void stage(const float* d, const float* v, int k,
                                      int base, int p,
                                      float (&s_data)[6][kChunk],
                                      float (&s_vals)[C][kChunk]) {
  if (p < kChunk) {
    const int j = base + p;
    const bool in = j < k;
#pragma unroll
    for (int r = 0; r < 6; ++r) s_data[r][p] = in ? d[r * k + j] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) s_vals[c][p] = in ? v[c * k + j] : 0.f;
  }
}

template <int C>
__global__ void __launch_bounds__(kPixels)
composite_tiles_bwd_kernel(const float* __restrict__ data,
                           const float* __restrict__ vals,
                           const float* __restrict__ g,
                           float* __restrict__ ddata,
                           float* __restrict__ dvals,
                           float* __restrict__ log_t_start,
                           int k, int tiles_x) {
  __shared__ float s_data[6][kChunk];
  __shared__ float s_vals[C][kChunk];
  __shared__ float s_part[kWarps][6 + C][kChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const int n_chunks = (k + kChunk - 1) / kChunk;
  const float px = static_cast<float>((t % tiles_x) * kTile + p % kTile);
  const float py = static_cast<float>((t / tiles_x) * kTile + p / kTile);
  const float* d = data + static_cast<long long>(t) * kDataRows * k;
  const float* v = vals + static_cast<long long>(t) * C * k;
  float* dd = ddata + static_cast<long long>(t) * kDataRows * k;
  float* dv = dvals + static_cast<long long>(t) * C * k;
  float* lts = log_t_start + static_cast<long long>(t) * n_chunks * kPixels;

  // -- phase A: each chunk's starting log-transmittance -------------------
  float log_t = 0.f;
  for (int ci = 0; ci < n_chunks; ++ci) {
    __syncthreads();
    stage<C>(d, v, k, ci * kChunk, p, s_data, s_vals);
    __syncthreads();
    lts[ci * kPixels + p] = log_t;
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float dx = px - s_data[0][j];
      const float dy = py - s_data[1][j];
      const float power = -0.5f * (s_data[2][j] * dx * dx
                                   + s_data[4][j] * dy * dy)
                          - s_data[3][j] * dx * dy;
      if (!(power <= 0.f)) continue;
      const float alpha = fminf(s_data[5][j] * expf(power), kAlphaMax);
      if (!(alpha >= kAlphaMin)) continue;
      log_t += log1pf(-alpha);
    }
  }
  const float t_final = expf(log_t);

  const float* gp = g + static_cast<long long>(t) * (C + 1) * kPixels + p;
  float g_out[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g_out[c] = gp[c * kPixels];
  const float base = gp[C * kPixels] * t_final;

  // -- phase B: chunks back to front, suffix sum S carried ----------------
  float s_suffix = 0.f;
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int base_slot = ci * kChunk;
    __syncthreads();  // the previous chunk's s_part and table are consumed
    stage<C>(d, v, k, base_slot, p, s_data, s_vals);
    __syncthreads();

    // exclusive log-transmittance of every slot of the chunk
    float lte[kChunk];
    float cur = lts[ci * kPixels + p];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      lte[j] = cur;
      const float dx = px - s_data[0][j];
      const float dy = py - s_data[1][j];
      const float power = -0.5f * (s_data[2][j] * dx * dx
                                   + s_data[4][j] * dy * dy)
                          - s_data[3][j] * dx * dy;
      const float alpha_cl = fminf(s_data[5][j] * expf(fminf(power, 0.f)),
                                   kAlphaMax);
      if (power <= 0.f && alpha_cl >= kAlphaMin) cur += log1pf(-alpha_cl);
    }

#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const float mx = s_data[0][j], my = s_data[1][j];
      const float ca = s_data[2][j], cb = s_data[3][j], cc = s_data[4][j];
      const float dx = px - mx;
      const float dy = py - my;
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      const float exp_p = expf(fminf(power, 0.f));
      const float alpha_un = s_data[5][j] * exp_p;
      const float alpha_cl = fminf(alpha_un, kAlphaMax);
      const bool active = power <= 0.f && alpha_cl >= kAlphaMin;

      float grad[6 + C];
#pragma unroll
      for (int r = 0; r < 6 + C; ++r) grad[r] = 0.f;
      if (active) {
        const float alpha = alpha_cl;
        const float t_excl = expf(lte[j]);
        const float w = t_excl * alpha;
        float u = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) u += g_out[c] * s_vals[c][j];
        const float dalpha = t_excl * u - (s_suffix + base) / (1.f - alpha);
        s_suffix += w * u;
        if (alpha_un < kAlphaMax) {
          const float d_power = power < 0.f ? dalpha * alpha_un : 0.f;
          grad[0] = d_power * (ca * dx + cb * dy);
          grad[1] = d_power * (cc * dy + cb * dx);
          grad[2] = d_power * (-0.5f * dx * dx);
          grad[3] = d_power * (-dx * dy);
          grad[4] = d_power * (-0.5f * dy * dy);
          grad[5] = dalpha * exp_p;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) grad[6 + c] = g_out[c] * w;
      }
#pragma unroll
      for (int r = 0; r < 6 + C; ++r) {
        const float sum = warp_sum(grad[r]);
        if (lane == 0) s_part[warp][r][j] = sum;
      }
    }
    __syncthreads();

    // the 8 warps' partial sums, in warp order, to the tile's outputs
    for (int i = p; i < (kDataRows + C) * kChunk; i += kPixels) {
      const int r = i / kChunk;
      const int j = i % kChunk;
      const int slot = base_slot + j;
      if (slot >= k) continue;
      if (r >= 6 + C) {                       // rows 6-7 of ddata
        dd[(r - C) * k + slot] = 0.f;
        continue;
      }
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_part[w][r][j];
      if (r < 6) dd[r * k + slot] = sum;
      else dv[(r - 6) * k + slot] = sum;
    }
  }
}

template <int C>
cudaError_t launch(const float* data, const float* vals, const float* g,
                   float* ddata, float* dvals, float* scratch, int n_tiles,
                   int k, int tiles_x, cudaStream_t stream) {
  composite_tiles_bwd_kernel<C><<<n_tiles, kPixels, 0, stream>>>(
      data, vals, g, ddata, dvals, scratch, k, tiles_x);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the caller allocates: n_tiles * this * 256.
extern "C" int composite_tiles_bwd_chunks(int k) {
  return (k + kChunk - 1) / kChunk;
}

// Returns the launch's cudaError_t (0 on success); C must be 1..4.
extern "C" int composite_tiles_bwd(const float* data, const float* vals,
                                   const float* g, float* ddata, float* dvals,
                                   float* scratch, int n_tiles, int k, int c,
                                   int tiles_x, cudaStream_t stream) {
  if (n_tiles == 0 || k == 0) return 0;
  switch (c) {
    case 1: return launch<1>(data, vals, g, ddata, dvals, scratch, n_tiles, k,
                             tiles_x, stream);
    case 2: return launch<2>(data, vals, g, ddata, dvals, scratch, n_tiles, k,
                             tiles_x, stream);
    case 3: return launch<3>(data, vals, g, ddata, dvals, scratch, n_tiles, k,
                             tiles_x, stream);
    case 4: return launch<4>(data, vals, g, ddata, dvals, scratch, n_tiles, k,
                             tiles_x, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
