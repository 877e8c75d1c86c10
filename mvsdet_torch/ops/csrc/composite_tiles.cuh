// Device code shared by the tile compositor's forward (composite_tiles.cu,
// K1) and backward (composite_tiles_bwd.cu, K2) for Hopper (sm_90a).
//
// Layout.  Tile t's table is data (T, 8, K) rows [mx, my, conic_a,
// conic_b, conic_c, opacity, 0, 0] and vals (T, C, K), slots depth-sorted
// near-first.  K is split into segments of kSeg slots; one CTA of 256
// threads owns one (tile, segment), a thread per pixel.  Warp w covers the
// 8x4 pixel patch at column (w % 2) * 8, row (w / 2) * 4 of the tile, so a
// splat's footprint meets few warps.  The segment is 128 slots: on an H100
// at the training step's tables (K = 2048) that ran K1 and K2 about 10%
// faster than 256 (more CTAs, shorter walks per warp) and than 64 (whose
// combine grows).
//
// Culling, exact.  A pair (pixel, slot) is active when power <= 0 and
// min(op exp(power), 0.99) >= 1/255.  Since alpha <= op, a slot with
// op < 1/255 is never active: staging drops it for the whole CTA (empty
// slots have op 0).  For every other slot staging computes once, in double,
// the axis-aligned box of the ellipse op exp(power) >= 1/255, widened
// against the float rounding of the per-pixel test (see cull_box).  A warp
// ballots which slots' boxes meet its patch and walks only those, with the
// exact per-pixel test; a skipped pair would have had alpha 0 and zero
// gradients, so skipping changes no value.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ct {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;   // one thread per pixel
constexpr int kWarps = kPixels / 32;
constexpr int kSeg = 128;                // slots per segment, <= kPixels:
                                         // thread p stages slot p
constexpr int kGroup = 32;               // slots per warp ballot
constexpr int kGroups = kSeg / kGroup;
static_assert(kSeg <= kPixels && kSeg % kGroup == 0, "segment size");
constexpr int kDataRows = 8;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.f / 255.f;
constexpr unsigned kFull = 0xffffffffu;

// Cull-box slack.  With cond = a c / det <= kMaxCond the float error of
// power is below 1.5e-3 of |power| near the box, and expf, the product with
// the opacity and the compare move the threshold by < 1e-6; so the box is
// taken for the level 2.02 tau + 1e-5 of the exact quadratic form instead of
// 2 tau (tau = ln(op / (1/255))), and widened by a pixel for the rounding of
// the box itself and of dx, dy.  Slots with a worse-conditioned conic, a
// conic that is not positive definite, or a number that is not finite get
// an unbounded box: they are never skipped.
constexpr double kMaxCond = 1e3;
constexpr double kLevelScale = 2.02;
constexpr double kLevelFloor = 1e-5;
constexpr double kMarginPx = 1.0;

inline int segments(int k) { return (k + kSeg - 1) / kSeg; }

struct Pixel {
  float px, py;  // integer pixel coordinates on the canvas
  float x0, y0;  // the first column and row of the warp's 8x4 patch
  int q;         // the pixel's index in the tile, y * 16 + x
};

__device__ __forceinline__ Pixel pixel_of(int t, int tiles_x, int p) {
  const int warp = p / 32, lane = p % 32;
  const int lx = (warp % 2) * 8, ly = (warp / 2) * 4;
  const int tx0 = (t % tiles_x) * kTile, ty0 = (t / tiles_x) * kTile;
  Pixel px;
  px.x0 = static_cast<float>(tx0 + lx);
  px.y0 = static_cast<float>(ty0 + ly);
  px.px = static_cast<float>(tx0 + lx + lane % 8);
  px.py = static_cast<float>(ty0 + ly + lane / 8);
  px.q = (ly + lane / 8) * kTile + lx + lane % 8;
  return px;
}

// One segment's kept slots, compacted in slot order.
template <int C>
struct Segment {
  float d[6][kSeg];
  float v[C][kSeg];
  float box[4][kSeg];  // xmin, xmax, ymin, ymax
  int slot[kSeg];      // the kept slot's index within the segment
  int count[kWarps];
};

__device__ __forceinline__ void cull_box(const float (&row)[6],
                                         float (&box)[4]) {
  const double a = row[2], b = row[3], c = row[4];
  const double det = a * c - b * b;
  bool ok = a > 0.0 && det > 0.0 && a * c <= kMaxCond * det;
#pragma unroll
  for (int r = 0; r < 6; ++r) ok = ok && isfinite(row[r]);
  if (!ok) {
    box[0] = box[2] = -INFINITY;
    box[1] = box[3] = INFINITY;
    return;
  }
  const double tau = fmax(log(static_cast<double>(row[5])
                              / static_cast<double>(kAlphaMin)), 0.0);
  const double level = kLevelScale * tau + kLevelFloor;
  const double hx = sqrt(level * c / det) + kMarginPx;
  const double hy = sqrt(level * a / det) + kMarginPx;
  box[0] = static_cast<float>(row[0] - hx);
  box[1] = static_cast<float>(row[0] + hx);
  box[2] = static_cast<float>(row[1] - hy);
  box[3] = static_cast<float>(row[1] + hy);
}

// Stage slots [base, base + len) of one tile's table: thread p loads slot
// base + p (coalesced per row), drops it if its opacity is below 1/255 and
// otherwise writes it, with its box, at its rank among the kept slots.
// Where dd and dv are given (the backward), a dropped slot's gradients are
// written as zero here.  Returns the number of kept slots.
template <int C>
__device__ __forceinline__ int stage_segment(const float* d, const float* v,
                                             int k, int base, int len, int p,
                                             Segment<C>& s, float* dd,
                                             float* dv) {
  const int warp = p / 32, lane = p % 32;
  float row[6], val[C];
  bool keep = false;
  if (p < len) {
#pragma unroll
    for (int r = 0; r < 6; ++r) row[r] = d[r * k + base + p];
#pragma unroll
    for (int c = 0; c < C; ++c) val[c] = v[c * k + base + p];
    keep = !(row[5] < kAlphaMin);
    if (!keep && dd != nullptr) {
#pragma unroll
      for (int r = 0; r < kDataRows; ++r) dd[r * k + base + p] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) dv[c * k + base + p] = 0.f;
    }
  }
  const unsigned ballot = __ballot_sync(kFull, keep);
  if (lane == 0) s.count[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u)), n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pos += s.count[w];
    n += s.count[w];
  }
  if (keep) {
    float box[4];
    cull_box(row, box);
#pragma unroll
    for (int r = 0; r < 6; ++r) s.d[r][pos] = row[r];
#pragma unroll
    for (int c = 0; c < C; ++c) s.v[c][pos] = val[c];
#pragma unroll
    for (int r = 0; r < 4; ++r) s.box[r][pos] = box[r];
    s.slot[pos] = p;
  }
  __syncthreads();
  return n;
}

template <int C>
__device__ __forceinline__ bool box_meets_patch(const Segment<C>& s, int j,
                                                const Pixel& px) {
  return s.box[0][j] <= px.x0 + 7.f && s.box[1][j] >= px.x0
      && s.box[2][j] <= px.y0 + 3.f && s.box[3][j] >= px.y0;
}

// The warp's ballot over kept slots [g0, g0 + 32): bit i is set when slot
// g0 + i exists and its box meets the warp's patch.
template <int C>
__device__ __forceinline__ unsigned group_mask(const Segment<C>& s, int n,
                                               int g0, const Pixel& px) {
  const int j = g0 + static_cast<int>(threadIdx.x % 32);
  return __ballot_sync(kFull, j < n && box_meets_patch(s, j, px));
}

// power = -0.5 (a dx^2 + c dy^2) - b dx dy at the pixel, rounded as the
// plain PyTorch version rounds it (the build turns off FMA contraction).
template <int C>
__device__ __forceinline__ float power_at(const Segment<C>& s, int j,
                                          const Pixel& px, float& dx,
                                          float& dy) {
  dx = px.px - s.d[0][j];
  dy = px.py - s.d[1][j];
  return -0.5f * (s.d[2][j] * dx * dx + s.d[4][j] * dy * dy)
         - s.d[3][j] * dx * dy;
}

// The forward over one staged segment for this thread's pixel, from a
// local log-transmittance of 0: accumulates acc_c = sum_j T_j alpha_j v_cj
// and log_t = sum_j log1p(-alpha_j) over the warp's listed slots.  Where
// `starts` is given, the local log-T at the start of each 32-slot group is
// stored at starts[group * 256] for the backward.
template <int C>
__device__ __forceinline__ void segment_forward(const Segment<C>& s, int n,
                                                const Pixel& px, float& log_t,
                                                float (&acc)[C],
                                                float* starts) {
  for (int g0 = 0; g0 < n; g0 += kGroup) {
    if (starts != nullptr) starts[(g0 / kGroup) * kPixels] = log_t;
    unsigned mask = group_mask(s, n, g0, px);
    while (mask) {
      const int j = g0 + __ffs(mask) - 1;
      mask &= mask - 1u;
      float dx, dy;
      const float power = power_at(s, j, px, dx, dy);
      if (!(power <= 0.f)) continue;
      const float alpha = fminf(s.d[5][j] * expf(power), kAlphaMax);
      if (!(alpha >= kAlphaMin)) continue;
      const float w = expf(log_t) * alpha;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * s.v[c][j];
      log_t += log1pf(-alpha);
    }
  }
}

// One CTA's segment pass: stage (tile blockIdx.x, segment blockIdx.y) and
// write its per-pixel partials (C local channel sums, then the segment's
// log-T sum) to partials (T, S, C + 1, 256); the backward also writes the
// 32-slot groups' starting log-T to starts (T, S, kGroups, 256).
template <int C>
__device__ __forceinline__ void segment_pass(const float* data,
                                             const float* vals,
                                             float* partials, float* starts,
                                             int k, int tiles_x) {
  __shared__ Segment<C> s;
  const int t = blockIdx.x, seg = blockIdx.y, n_seg = gridDim.y;
  const int base = seg * kSeg;
  const int n = stage_segment<C>(
      data + static_cast<long long>(t) * kDataRows * k,
      vals + static_cast<long long>(t) * C * k, k, base, min(kSeg, k - base),
      threadIdx.x, s, nullptr, nullptr);
  const Pixel px = pixel_of(t, tiles_x, threadIdx.x);
  const long long ts = static_cast<long long>(t) * n_seg + seg;
  float log_t = 0.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  segment_forward<C>(s, n, px, log_t, acc,
                     starts == nullptr ? nullptr
                                       : starts + ts * kGroups * kPixels
                                             + px.q);
  float* o = partials + ts * (C + 1) * kPixels + px.q;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c * kPixels] = acc[c];
  o[C * kPixels] = log_t;
}

}  // namespace ct

// The constants that mvsdet_torch/ops/splat_kernel.py keeps a copy of for
// its plain versions, in the order kSeg, kAlphaMin, kAlphaMax, kMaxCond,
// kLevelScale, kLevelFloor, kMarginPx.  Each library that includes this
// header exports it; the wrappers read it when they load the library and
// refuse one whose values differ from theirs.
extern "C" void composite_tiles_constants(double* out) {
  out[0] = ct::kSeg;
  out[1] = ct::kAlphaMin;
  out[2] = ct::kAlphaMax;
  out[3] = ct::kMaxCond;
  out[4] = ct::kLevelScale;
  out[5] = ct::kLevelFloor;
  out[6] = ct::kMarginPx;
}
