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
// pixels.
//
// Bound: operations.  An active pair costs ~40 flops and three
// transcendentals beyond the ~12-flop cull test, plus its share of the
// per-slot sums over the tile's pixels; the tables are read once.  The
// walk within a pixel is serial (the suffix S and the log-T carry), so
// the kernel needs many warps in flight to hide those chains.
//
// Design (see composite_tiles.cuh).  One CTA per (tile, segment of 128
// slots), as in the forward, so at T = 160, K = 2048 there are 2560 CTAs.
// Pass 1 (composite_tiles_bwd_segment_kernel) is the forward's segment
// pass; besides the partials (L_s and the local channel sums acc_s) it
// stores the local log-T at the start of every 32-slot group of kept slots.
// Pass 2 (composite_tiles_bwd_kernel) derives each segment's start state
// from the partials in segment order, with U_s = sum_c g_c acc_sc:
//
//   start log-T  = sum_{s'<s} L_s'
//   start suffix = sum_{s'>s} exp(sum_{s''<s'} L_s'') U_s' + g_T T_final
//
// and walks its own segment's groups back to front carrying S.  There is no
// serial walk over all K slots, and the transmittance is never rebuilt by
// dividing T_final by (1 - alpha) (the CUDA 3DGS rasterizer's way: at K =
// 2048 T_final underflows).  It stays in log space: a group's exclusive
// log-T values are its end value (the next group's stored start, or L_s)
// less the log1p(-alpha) of the listed slots after them.  The anchor every
// 32 slots bounds the rounding of that difference to ~32 float steps of
// |log-T|, so T is off by at most ~32 eps |log T| T < 1e-6 absolute.  Each
// pair is evaluated once (one exp(power), one log1p, one exp of log-T), in
// a loop that is not unrolled (unrolled over a 32-slot group, with the
// group's log-T in register arrays, the walk took 112 registers and ran
// three times slower on an H100 at the training step's tables).  A warp
// reduces a slot's 6 + C gradients only if one of its lanes is active
// there, in one transposed butterfly that leaves one sum per lane (16
// shuffles for up to 16 values, not 5 per value); the 8 warps' sums are
// added in shared memory in warp order.  Each CTA owns its segment's
// slots, so every output element is written once, by one CTA, without
// atomics, and two launches give the same bits.

#include "composite_tiles.cuh"

namespace {

using namespace ct;

// Transposed butterfly over a warp: x holds M values per lane; after it,
// lane l holds in x[0] the warp's sum of value l >> (5 - log2 M) (lanes
// that differ only in their low 5 - log2 M bits hold the same sum).
template <int M, int OFF>
__device__ __forceinline__ void reduce_scatter(float* x, int lane) {
  if constexpr (OFF > 0) {
    if constexpr (M > 1) {
      constexpr int kHalf = M / 2;
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float send = upper ? x[i] : x[i + kHalf];
        const float keep = upper ? x[i + kHalf] : x[i];
        x[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, OFF));
      }
      reduce_scatter<kHalf, OFF / 2>(x, lane);
    } else {
      x[0] = __fadd_rn(x[0], __shfl_xor_sync(kFull, x[0], OFF));
      reduce_scatter<1, OFF / 2>(x, lane);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kPixels)
composite_tiles_bwd_segment_kernel(const float* __restrict__ data,
                                   const float* __restrict__ vals,
                                   float* __restrict__ partials,
                                   float* __restrict__ starts, int k,
                                   int tiles_x) {
  segment_pass<C>(data, vals, partials, starts, k, tiles_x);
}

template <int C>
__global__ void __launch_bounds__(kPixels)
composite_tiles_bwd_kernel(const float* __restrict__ data,
                           const float* __restrict__ vals,
                           const float* __restrict__ g,
                           const float* __restrict__ partials,
                           const float* __restrict__ starts,
                           float* __restrict__ ddata,
                           float* __restrict__ dvals, int k, int tiles_x) {
  constexpr int kVals = 6 + C;                 // gradients per slot
  constexpr int kLog = kVals <= 8 ? 3 : 4;
  constexpr int kPad = 1 << kLog;
  __shared__ Segment<C> s;
  __shared__ float s_part[kWarps][kVals][kGroup];
  __shared__ unsigned s_mask[kWarps];

  const int t = blockIdx.x, seg = blockIdx.y, n_seg = gridDim.y;
  const int p = threadIdx.x, warp = p / 32, lane = p % 32;
  const int base = seg * kSeg;
  float* dd = ddata + static_cast<long long>(t) * kDataRows * k;
  float* dv = dvals + static_cast<long long>(t) * C * k;
  const int n = stage_segment<C>(
      data + static_cast<long long>(t) * kDataRows * k,
      vals + static_cast<long long>(t) * C * k, k, base, min(kSeg, k - base),
      p, s, dd, dv);
  const Pixel px = pixel_of(t, tiles_x, p);

  // the segment's start state, from every segment's partials in order
  const float* gp = g + static_cast<long long>(t) * (C + 1) * kPixels + px.q;
  float g_out[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g_out[c] = gp[c * kPixels];
  const float* pp = partials + static_cast<long long>(t) * n_seg * (C + 1)
                    * kPixels + px.q;
  float pre = 0.f, log_t = 0.f, s_suffix = 0.f, seg_log_t = 0.f;
  for (int s2 = 0; s2 < n_seg; ++s2, pp += (C + 1) * kPixels) {
    if (s2 == seg) {
      pre = log_t;
      seg_log_t = pp[C * kPixels];
    }
    if (s2 > seg) {
      float u = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) u += g_out[c] * pp[c * kPixels];
      s_suffix += expf(log_t) * u;
    }
    log_t += pp[C * kPixels];
  }
  const float tail = gp[C * kPixels] * expf(log_t);   // g_T T_final
  const float* st = starts + (static_cast<long long>(t) * n_seg + seg)
                    * kGroups * kPixels + px.q;

  for (int g0 = n > 0 ? (n - 1) / kGroup * kGroup : -1; g0 >= 0;
       g0 -= kGroup) {
    unsigned mask = group_mask(s, n, g0, px);
    // the local log-T after the group: where the next group starts, or
    // the segment's sum; each listed active slot's log1p(-alpha) is taken
    // off it back to front to give that slot's exclusive log-T
    float cur = g0 + kGroup < n ? st[(g0 / kGroup + 1) * kPixels] : seg_log_t;
    for (unsigned left = mask; left != 0u;) {
      const int i = 31 - __clz(left);
      left &= ~(1u << i);
      const int j = g0 + i;
      float dx, dy;
      const float power = power_at(s, j, px, dx, dy);
      const float exp_p = expf(fminf(power, 0.f));
      const float alpha_un = s.d[5][j] * exp_p;
      const float alpha_cl = fminf(alpha_un, kAlphaMax);
      const bool active = power <= 0.f && alpha_cl >= kAlphaMin;
      if (!__any_sync(kFull, active)) {
        mask &= ~(1u << i);
        continue;
      }
      float grad[kPad];
#pragma unroll
      for (int r = 0; r < kPad; ++r) grad[r] = 0.f;
      if (active) {
        cur -= log1pf(-alpha_cl);            // now the exclusive log-T
        const float ca = s.d[2][j], cb = s.d[3][j], cc = s.d[4][j];
        const float t_excl = expf(pre + cur);
        const float w = t_excl * alpha_cl;
        float u = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) u += g_out[c] * s.v[c][j];
        const float dalpha = t_excl * u - (s_suffix + tail)
                             / (1.f - alpha_cl);
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
      reduce_scatter<kPad, 16>(grad, lane);
      const int r = lane >> (5 - kLog);
      if ((lane & ((1 << (5 - kLog)) - 1)) == 0 && r < kVals)
        s_part[warp][r][i] = grad[0];
    }
    if (lane == 0) s_mask[warp] = mask;
    __syncthreads();

    // the 8 warps' sums, in warp order, to the group's slots
    for (int e = p; e < (kDataRows + C) * kGroup; e += kPixels) {
      const int r = e / kGroup, i = e % kGroup;
      if (g0 + i >= n) continue;
      const int slot = base + s.slot[g0 + i];
      if (r >= kVals) {                       // rows 6-7 of ddata
        dd[(r - C) * k + slot] = 0.f;
        continue;
      }
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (s_mask[w] >> i & 1u) sum += s_part[w][r][i];
      if (r < 6) dd[r * k + slot] = sum;
      else dv[(r - 6) * k + slot] = sum;
    }
    __syncthreads();
  }
}

template <int C>
cudaError_t launch(const float* data, const float* vals, const float* g,
                   float* ddata, float* dvals, float* scratch, int n_tiles,
                   int k, int tiles_x, cudaStream_t stream) {
  const dim3 grid(n_tiles, segments(k));
  float* partials = scratch;
  float* starts = scratch + static_cast<long long>(n_tiles) * segments(k)
                  * (C + 1) * kPixels;
  composite_tiles_bwd_segment_kernel<C><<<grid, kPixels, 0, stream>>>(
      data, vals, partials, starts, k, tiles_x);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  composite_tiles_bwd_kernel<C><<<grid, kPixels, 0, stream>>>(
      data, vals, g, partials, starts, ddata, dvals, k, tiles_x);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the caller allocates for composite_tiles_bwd: the
// partials (T, S, C + 1, 256), then the group starts (T, S, 4, 256).
extern "C" long long composite_tiles_bwd_scratch(int n_tiles, int k, int c) {
  return static_cast<long long>(n_tiles) * segments(k)
         * (c + 1 + kGroups) * kPixels;
}

// Returns the launches' cudaError_t (0 on success); C must be 1..4.
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
