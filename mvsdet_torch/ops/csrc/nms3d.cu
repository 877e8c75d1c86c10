// Class-aware greedy 3D NMS for Hopper (sm_90a): the suppression mask,
// then the greedy picks.
//
// Replaces no TPU kernel: the JAX package's NMS (mvsdet_tpu/ops/nms.py) is
// plain XLA, and so is the port's plain version (ops/nms.py `_greedy_nms`
// over `aligned_iou_3d` or `rotated_iou_bev_exact`), which launches ~9
// kernels a pick and ~280 a chunk of the exact IoU: 2,300-5,400 launches
// a predict.  Contract, for M boxes, as `_greedy_nms` defines it:
//
//   suppress[i, j] = (iou(i, j) > thr and class[i] == class[j]) or i == j
//   pick t: i = the highest active score, the lowest index among ties
//           (torch.argmax's first of ties; a NaN is the highest);
//           a real pick if its score > -inf, which then clears suppress[i]
//   active = score where valid, -inf elsewhere
//
// iou(i, j) is box i's footprint clipped by box j's edges (the plain
// version's boxes1 and boxes2), so the mask is not symmetric bit for bit.
//
// Bound: latency.  The work is small: M^2 pair tests, of which only the
// same-class pairs (~29% of them in the benchmark's predicts, where one
// class dominates) need an IoU (a few hundred flops for the exact rotated
// one), and max_out picks, each of which waits for the one before it.
// Two launches:
//
//   1. nms3d_mask_kernel: a block of 8 warps owns 8 rows and one 64-column
//      word of the (M, ceil(M / 64)) uint64 mask.  The word's 64 column
//      boxes are staged in shared memory (their corners, z extent and
//      volume computed once); each warp takes a row, each lane a column,
//      tests the class before the IoU, and two ballots make the word.  Bit
//      b of word w of row i is column 64 w + b.  On an H100 this took 0.38
//      ms on an ARKit predict's 2,400 candidates, against 0.49 ms for one
//      thread a row looping over the word's 64 columns: a pair a thread
//      keeps more warps in flight to hide the clip's latency.  The grid's
//      x runs over the rows, so any M whose mask fits the card is taken.
//   2. nms3d_greedy_kernel: one block of 1024 threads walks the picks.
//      Each box's active score is an order-preserving key (32 bits for a
//      float32 score, 64 for a float64 one), in shared memory while the
//      keys fit there (M <= ~58,000 float32 keys on an H100), else in a
//      global scratch buffer; each thread reads and writes only its own
//      boxes' keys, so either needs no more barriers.  A pick is the
//      block's largest key and the lowest index that holds it (two warp
//      reductions, a barrier, two more), then each thread clears its own
//      boxes that the pick's mask row suppresses.  One barrier a pick, no
//      sort.  Once no box is active every later slot is empty, so the
//      block fills them and stops.
//
// The boxes come in float32, float64, bfloat16 or float16, and the IoU is
// computed as the plain version computes it in that dtype: PyTorch's
// elementwise ops run in float (double for float64) and round each result
// to the dtype, and its reductions (the volumes' product, the shoelace
// sum) accumulate in float and round once; F32, F64, BF16 and F16 below
// do the same, with the constants (1e-12, the threshold) rounded to the
// dtype as a Python scalar is.  The IoU bodies follow the plain versions
// operation by operation, and the build's --fmad=false keeps every
// product rounded on its own, so the kernel's IoU is the plain one's to
// within the order of the shoelace sum (and cosf/sinf against the CPU's):
// decisions at the threshold agree.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 64;            // columns of a mask block: one word
constexpr int kMaskRows = 8;         // rows of a mask block, a warp each
constexpr int kMaskThreads = kMaskRows * kWarp;
constexpr int kGreedyThreads = 1024; // 32 warps: a lane each at the end
static_assert(kGreedyThreads == kWarp * kWarp, "one warp reads every warp's");
constexpr int kSlots = 8;            // a quad clipped by 4 half-planes

// The boxes' dtype: S stores a value, C computes (PyTorch's opmath type),
// round() is an elementwise op's rounding of its result to S.
struct F32 {
  using S = float;
  using C = float;
  __device__ static C load(S v) { return v; }
  __device__ static S store(C v) { return v; }
  __device__ static C round(C v) { return v; }
};

struct F64 {
  using S = double;
  using C = double;
  __device__ static C load(S v) { return v; }
  __device__ static S store(C v) { return v; }
  __device__ static C round(C v) { return v; }
};

struct BF16 {
  using S = __nv_bfloat16;
  using C = float;
  __device__ static C load(S v) { return __bfloat162float(v); }
  __device__ static S store(C v) { return __float2bfloat16_rn(v); }
  __device__ static C round(C v) { return load(store(v)); }
};

struct F16 {
  using S = __half;
  using C = float;
  __device__ static C load(S v) { return __half2float(v); }
  __device__ static S store(C v) { return __float2half_rn(v); }
  __device__ static C round(C v) { return load(store(v)); }
};

__device__ __forceinline__ float cos_of(float x) { return cosf(x); }
__device__ __forceinline__ double cos_of(double x) { return cos(x); }
__device__ __forceinline__ float sin_of(float x) { return sinf(x); }
__device__ __forceinline__ double sin_of(double x) { return sin(x); }
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

template <class T>
__device__ __forceinline__ T at_least_zero(T x) {
  return x < T(0) ? T(0) : x;        // NaN passes, as torch.clamp_min
}

// A Python scalar as an op of dtype S sees it: rounded to S (1e-12 is 0
// in float16, as torch.clamp_min and > take it there).
template <class P>
__device__ __forceinline__ typename P::C scalar(double v) {
  return P::round(static_cast<typename P::C>(v));
}

// inter / clamp_min(union, 1e-12), as the plain versions end.
template <class P>
__device__ __forceinline__ typename P::C ratio(typename P::C inter,
                                               typename P::C vol_a,
                                               typename P::C vol_b) {
  using C = typename P::C;
  const C uni = P::round(P::round(vol_a + vol_b) - inter);
  const C tiny = scalar<P>(1e-12);
  return P::round(inter / (uni < tiny ? tiny : uni));
}

// x1 y1 z1 x2 y2 z2 corner boxes (`aligned_iou_3d`).
template <class P>
struct Aligned {
  using C = typename P::C;
  static constexpr int kDim = 6;
  C lo[3], hi[3], vol;

  __device__ static Aligned load(const typename P::S* __restrict__ boxes,
                                 int i) {
    const typename P::S* b = boxes + static_cast<long long>(i) * kDim;
    Aligned a;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.lo[k] = P::load(b[k]);
      a.hi[k] = P::load(b[3 + k]);
    }
    // torch.prod: accumulated in C, rounded once
    a.vol = P::round(at_least_zero(P::round(a.hi[0] - a.lo[0]))
                     * at_least_zero(P::round(a.hi[1] - a.lo[1]))
                     * at_least_zero(P::round(a.hi[2] - a.lo[2])));
    return a;
  }
};

template <class P>
__device__ typename P::C iou(const Aligned<P>& a, const Aligned<P>& b) {
  using C = typename P::C;
  C whd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const C lt = a.lo[k] > b.lo[k] ? a.lo[k] : b.lo[k];
    const C rb = a.hi[k] < b.hi[k] ? a.hi[k] : b.hi[k];
    whd[k] = at_least_zero(P::round(rb - lt));
  }
  const C inter = P::round(P::round(whd[0] * whd[1]) * whd[2]);
  return ratio<P>(inter, a.vol, b.vol);
}

// cx cy cz dx dy dz yaw boxes (`rotated_iou_bev_exact`): the BEV corners
// counter-clockwise (`_rotated_bev_corners`), the z extent, the volume.
template <class P>
struct Rotated {
  using C = typename P::C;
  static constexpr int kDim = 7;
  C x[4], y[4], zlo, zhi, vol;

  __device__ static Rotated load(const typename P::S* __restrict__ boxes,
                                 int i) {
    const typename P::S* b = boxes + static_cast<long long>(i) * kDim;
    C v[kDim];
#pragma unroll
    for (int k = 0; k < kDim; ++k) v[k] = P::load(b[k]);
    const C c = P::round(cos_of(v[6])), s = P::round(sin_of(v[6]));
    const C hx = P::round(v[3] / C(2)), hy = P::round(v[4] / C(2));
    const C lx[4] = {hx, -hx, -hx, hx}, ly[4] = {hy, hy, -hy, -hy};
    Rotated r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r.x[k] = P::round(P::round(P::round(c * lx[k])
                                 + P::round((-s) * ly[k])) + v[0]);
      r.y[k] = P::round(P::round(P::round(s * lx[k])
                                 + P::round(c * ly[k])) + v[1]);
    }
    const C hz = P::round(v[5] / C(2));
    r.zlo = P::round(v[2] - hz);
    r.zhi = P::round(v[2] + hz);
    r.vol = P::round(P::round(v[3] * v[4]) * v[5]);
    return r;
  }
};

// The area of a's footprint clipped by the four edges of b's
// (`_convex_quad_intersection_area`): each Sutherland-Hodgman step emits,
// for each live vertex in polygon order, the vertex if it is inside and
// the edge's crossing if the vertex and its successor lie on two sides and
// |denom| > 1e-12; candidates past slot 8 are dropped but counted, and a
// count over 8 leaves all 8 slots live.
template <class P>
__device__ typename P::C clipped_area(const Rotated<P>& a,
                                      const Rotated<P>& b) {
  using C = typename P::C;
  const C tiny = scalar<P>(1e-12);
  C px[kSlots], py[kSlots];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = a.x[k];
    py[k] = a.y[k];
  }
  int count = 4;
#pragma unroll 1
  for (int e = 0; e < 4; ++e) {
    const C x0 = b.x[e], y0 = b.y[e];
    const C ex = P::round(b.x[(e + 1) & 3] - x0);
    const C ey = P::round(b.y[(e + 1) & 3] - y0);
    const int live = count < kSlots ? count : kSlots;
    C qx[kSlots], qy[kSlots];
    int out = 0;
#pragma unroll 1
    for (int v = 0; v < live; ++v) {
      const int w = v + 1 == live ? 0 : v + 1;
      const C cx = px[v], cy = py[v], nx = px[w], ny = py[w];
      const bool c_in = P::round(P::round(ex * P::round(cy - y0))
                                 - P::round(ey * P::round(cx - x0))) >= C(0);
      const bool n_in = P::round(P::round(ex * P::round(ny - y0))
                                 - P::round(ey * P::round(nx - x0))) >= C(0);
      const C dx = P::round(nx - cx), dy = P::round(ny - cy);
      const C denom = P::round(P::round(ex * dy) - P::round(ey * dx));
      if (c_in) {
        if (out < kSlots) {
          qx[out] = cx;
          qy[out] = cy;
        }
        ++out;
      }
      if (c_in != n_in && abs_of(denom) > tiny) {
        const C t = P::round(P::round(P::round(ex * P::round(y0 - cy))
                                      - P::round(ey * P::round(x0 - cx)))
                             / denom);
        if (out < kSlots) {
          qx[out] = P::round(cx + P::round(t * dx));
          qy[out] = P::round(cy + P::round(t * dy));
        }
        ++out;
      }
    }
    const int kept = out < kSlots ? out : kSlots;
    for (int v = 0; v < kept; ++v) {
      px[v] = qx[v];
      py[v] = qy[v];
    }
    count = out;
  }
  if (count < 3) return C(0);
  const int live = count < kSlots ? count : kSlots;
  C sum = C(0);                      // torch.sum: accumulated in C
  for (int v = 0; v < live; ++v) {
    const int w = v + 1 == live ? 0 : v + 1;
    sum = sum + P::round(P::round(px[v] * py[w]) - P::round(py[v] * px[w]));
  }
  return P::round(C(0.5) * abs_of(P::round(sum)));
}

template <class P>
__device__ typename P::C iou(const Rotated<P>& a, const Rotated<P>& b) {
  using C = typename P::C;
  const C zhi = a.zhi < b.zhi ? a.zhi : b.zhi;
  const C zlo = a.zlo > b.zlo ? a.zlo : b.zlo;
  const C inter = P::round(clipped_area(a, b)
                           * at_least_zero(P::round(zhi - zlo)));
  return ratio<P>(inter, a.vol, b.vol);
}

// One warp a (row, word): a lane a column, then two ballots make the
// word.  Mask mode: the suppression bits.  IoU mode (`nms3d_iou`, for the
// tests): the (M, M) IoU itself, in the boxes' dtype, every pair.
template <class P, template <class> class Box, bool kIou>
__global__ void __launch_bounds__(kMaskThreads)
nms3d_mask_kernel(const typename P::S* __restrict__ boxes,
                  const long long* __restrict__ classes, int m, double thr,
                  unsigned long long* __restrict__ mask,
                  typename P::S* __restrict__ iou_out) {
  __shared__ Box<P> tile[kTile];
  __shared__ long long tile_class[kTile];
  const int col0 = blockIdx.y * kTile;
  const int cols = m - col0 < kTile ? m - col0 : kTile;
  if (threadIdx.x < cols) {
    tile[threadIdx.x] = Box<P>::load(boxes, col0 + threadIdx.x);
    if (!kIou) tile_class[threadIdx.x] = classes[col0 + threadIdx.x];
  }
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int i = blockIdx.x * kMaskRows + threadIdx.x / kWarp;
  if (i >= m) return;                              // the whole warp
  const Box<P> row = Box<P>::load(boxes, i);
  if (kIou) {
    for (int c = lane; c < cols; c += kWarp)
      iou_out[static_cast<long long>(i) * m + col0 + c] =
          P::store(iou(row, tile[c]));
    return;
  }
  const typename P::C threshold = scalar<P>(thr);
  const long long cls = classes[i];
  unsigned long long bits = 0;
#pragma unroll
  for (int h = 0; h < kTile / kWarp; ++h) {
    const int c = h * kWarp + lane;
    const bool hit = c < cols && (col0 + c == i || (
        tile_class[c] == cls && iou(row, tile[c]) > threshold));
    bits |= static_cast<unsigned long long>(
        __ballot_sync(0xffffffffu, hit)) << (h * kWarp);
  }
  if (lane == 0)
    mask[static_cast<long long>(i) * gridDim.y + blockIdx.y] = bits;
}

// Order-preserving keys of the scores: a larger score, a larger key; a
// NaN above every number (torch.argmax takes a NaN as the largest); -0 ==
// +0.  32 bits for float32 scores (and float16 and bfloat16 ones, exact in
// float32), 64 for float64.
template <class Key> struct Keys;

template <> struct Keys<unsigned> {
  using Score = float;
  static constexpr unsigned kInactive = 0x007fffffu;   // of(-inf)
  static constexpr unsigned kNaN = 0xffffffffu;
  __device__ static unsigned of(float v) {
    if (v != v) return kNaN;
    if (v == 0.f) v = 0.f;
    const unsigned u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  __device__ static unsigned warp_max(unsigned v) {
    return __reduce_max_sync(0xffffffffu, v);
  }
};

template <> struct Keys<unsigned long long> {
  using Score = double;
  static constexpr unsigned long long kInactive = 0x000fffffffffffffull;
  static constexpr unsigned long long kNaN = ~0ull;
  __device__ static unsigned long long of(double v) {
    if (v != v) return kNaN;
    if (v == 0.0) v = 0.0;
    const unsigned long long u = __double_as_longlong(v);
    const unsigned long long sign = 1ull << 63;
    return (u & sign) ? ~u : (u | sign);
  }
  __device__ static unsigned long long warp_max(unsigned long long v) {
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) {
      const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
      v = w > v ? w : v;
    }
    return v;
  }
};

template <class Key, bool kShared>
__global__ void __launch_bounds__(kGreedyThreads)
nms3d_greedy_kernel(const unsigned long long* __restrict__ mask,
                    const typename Keys<Key>::Score* __restrict__ scores,
                    const bool* __restrict__ valid, int m, int max_out,
                    long long* __restrict__ keep_idx,
                    bool* __restrict__ keep_mask, Key* __restrict__ scratch) {
  using K = Keys<Key>;
  extern __shared__ __align__(8) unsigned char shared_keys[];
  // (m,) active scores; each thread reads and writes only its own boxes'
  Key* key = kShared ? reinterpret_cast<Key*>(shared_keys) : scratch;
  // each warp's best key and its lowest index, in two buffers that
  // alternate from pick to pick, so one barrier a pick orders them: a warp
  // writes buffer t % 2 only after every warp has passed pick t - 1's
  // barrier, and so has read it
  __shared__ Key warp_key[2][kWarp];
  __shared__ unsigned warp_idx[2][kWarp];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const long long words = (m + 63) / 64;
  for (int j = tid; j < m; j += kGreedyThreads)
    key[j] = valid[j] ? K::of(scores[j]) : K::kInactive;
  for (int t = 0; t < max_out; ++t) {
    Key best = 0;                                  // 0: below every key
    unsigned at = 0xffffffffu;
    for (int j = tid; j < m; j += kGreedyThreads)
      if (key[j] > best) {                         // ascending j: first of ties
        best = key[j];
        at = j;
      }
    Key k = K::warp_max(best);
    unsigned i = __reduce_min_sync(0xffffffffu, best == k ? at : 0xffffffffu);
    if (lane == 0) {
      warp_key[t % 2][warp] = k;
      warp_idx[t % 2][warp] = i;
    }
    __syncthreads();
    best = warp_key[t % 2][lane];                  // every warp, the pick
    k = K::warp_max(best);
    i = __reduce_min_sync(0xffffffffu,
                          best == k ? warp_idx[t % 2][lane] : 0xffffffffu);
    if (k <= K::kInactive || k == K::kNaN) {       // no active box is left
      for (int s = t + tid; s < max_out; s += kGreedyThreads) {
        keep_idx[s] = 0;
        keep_mask[s] = false;
      }
      return;
    }
    if (tid == 0) {
      keep_idx[t] = i;
      keep_mask[t] = true;
    }
    const unsigned long long* row = mask + static_cast<long long>(i) * words;
    for (int j = tid; j < m; j += kGreedyThreads)
      if ((row[j / 64] >> (j % 64)) & 1ull) key[j] = K::kInactive;
  }
}

template <class P, template <class> class Box, bool kIou>
int launch_box(const void* boxes, const long long* classes, int m,
                double thr, unsigned long long* mask, void* iou_out,
                cudaStream_t stream) {
  const dim3 grid((m + kMaskRows - 1) / kMaskRows, (m + kTile - 1) / kTile);
  nms3d_mask_kernel<P, Box, kIou><<<grid, kMaskThreads, 0, stream>>>(
      static_cast<const typename P::S*>(boxes), classes, m, thr, mask,
      static_cast<typename P::S*>(iou_out));
  return static_cast<int>(cudaGetLastError());
}

template <class P, bool kIou>
int launch_precision(const void* boxes, const long long* classes, int m,
                int rotated, double thr, unsigned long long* mask,
                void* iou_out, cudaStream_t stream) {
  return rotated ? launch_box<P, Rotated, kIou>(boxes, classes, m, thr, mask,
                                                iou_out, stream)
                 : launch_box<P, Aligned, kIou>(boxes, classes, m, thr, mask,
                                                iou_out, stream);
}

// dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16 (`nms._BOX_DTYPES`)
template <bool kIou>
int launch_mask(const void* boxes, int dtype, const long long* classes,
                int m, int rotated, double thr, unsigned long long* mask,
                void* iou_out, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_precision<F32, kIou>(boxes, classes, m, rotated,
                                               thr, mask, iou_out, stream);
    case 1: return launch_precision<F64, kIou>(boxes, classes, m, rotated,
                                               thr, mask, iou_out, stream);
    case 2: return launch_precision<BF16, kIou>(boxes, classes, m, rotated,
                                                thr, mask, iou_out, stream);
    case 3: return launch_precision<F16, kIou>(boxes, classes, m, rotated,
                                               thr, mask, iou_out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Key>
int launch_greedy(const unsigned long long* mask, const void* scores,
                  const bool* valid, long long* keep_idx, bool* keep_mask,
                  int m, int max_out, void* scratch, cudaStream_t stream) {
  using Score = typename Keys<Key>::Score;
  const size_t smem = static_cast<size_t>(m) * sizeof(Key);
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, nms3d_greedy_kernel<Key, true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + attr.sharedSizeBytes > static_cast<size_t>(optin)) {
    nms3d_greedy_kernel<Key, false><<<1, kGreedyThreads, 0, stream>>>(
        mask, static_cast<const Score*>(scores), valid, m, max_out, keep_idx,
        keep_mask, static_cast<Key*>(scratch));
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms3d_greedy_kernel<Key, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms3d_greedy_kernel<Key, true><<<1, kGreedyThreads, smem, stream>>>(
      mask, static_cast<const Score*>(scores), valid, m, max_out, keep_idx,
      keep_mask, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success).  boxes (M, 6)
// corners, or (M, 7) yaw boxes when `rotated`, of `dtype` (0 float32, 1
// float64, 2 bfloat16, 3 float16); classes (M,) int64; mask (M, ceil(M /
// 64)) uint64, every word written.
extern "C" int nms3d_mask(const void* boxes, int dtype,
                          const long long* classes, unsigned long long* mask,
                          int m, int rotated, double thr,
                          cudaStream_t stream) {
  if (m <= 0) return 0;
  return launch_mask<false>(boxes, dtype, classes, m, rotated, thr, mask,
                            nullptr, stream);
}

// The (M, M) IoU that the mask thresholds, in the boxes' dtype, every
// pair computed.
extern "C" int nms3d_iou(const void* boxes, int dtype, void* iou_out, int m,
                         int rotated, cudaStream_t stream) {
  if (m <= 0) return 0;
  return launch_mask<true>(boxes, dtype, nullptr, m, rotated, 0.0, nullptr,
                           iou_out, stream);
}

// The greedy picks over `nms3d_mask`'s mask: keep_idx (max_out,) int64,
// 0 in empty slots, and keep_mask (max_out,) bool, every slot written.
// scores (M,) float32, or float64 when `scores_f64`; valid (M,) bool;
// scratch M * 8 bytes, which hold the keys when they do not fit in the
// block's shared memory.
extern "C" int nms3d_greedy(const unsigned long long* mask,
                            const void* scores, int scores_f64,
                            const bool* valid, long long* keep_idx,
                            bool* keep_mask, int m, int max_out,
                            void* scratch, cudaStream_t stream) {
  if (max_out <= 0) return 0;
  return scores_f64
      ? launch_greedy<unsigned long long>(mask, scores, valid, keep_idx,
                                          keep_mask, m, max_out, scratch,
                                          stream)
      : launch_greedy<unsigned>(mask, scores, valid, keep_idx, keep_mask, m,
                                max_out, scratch, stream);
}
