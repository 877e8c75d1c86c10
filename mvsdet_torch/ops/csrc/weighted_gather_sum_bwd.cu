// Voxel-lift weighted gather backward for Hopper (sm_90a): an index of the
// (view, voxel) pairs sorted by feature row, and the two kernels that walk
// it.
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
// by `_vjp_bwd`).  pix takes no gradient.  The TPU kernels build a
// (256, HW) one-hot in VMEM and contract it on the MXU.  Hopper gathers
// rows well, so both kernels here walk one index of the pairs keyed by the
// feature row r = n HW + pix[n, v] that each pair touches.
//
// `lift_rows` builds the index: row_start (N HW + 1) and pair (N V, the
// flat pair n V + v), v ascending within a row.  A counting sort with one
// CTA per (view, chunk of 1024 rows).  Each warp owns a contiguous range of
// v and counts its keys into its own column of shared counts (integer
// atomics, which are order-free), the CTA scans the counts, and each warp
// walks its range again in order to place its pairs, equal keys among 32
// ranked with __match_any_sync.  A lane keeps 8 pix loads in flight.
// View n's pairs fill [n V, (n + 1) V), so no CTA waits on another, and
// the same pix gives the same bits.
//
// d-feat (K4) is bound by its output: each of the N HW rows written once
// (196 MB at the training step's N = 40, HW = 4800, C = 256), beside the g
// rows of the nonzero-weight pairs, read from L2.  A warp owns a row and
// writes it once, zeros included: the sum of w g[v] over the row's
// nonzero-weight pairs in ascending v, from 0 (__fmul_rn, __fadd_rn), in
// registers.  A lane loads 4 index entries and their weights at a time,
// so a row of 2,500 clipped pairs is 20 round trips, not 80.  The rows are
// stored evict-first (__stcs), so the stream of them leaves g in L2.  No
// zero fill, no atomics: two launches give the same bits.
//
// d-weight (K5) computes every pair, zero weights included, as
// `_dweight_kernel` does.  Its byte bound counts each selected feature row
// once, but each pair reads its own g row (1 KB) from L2: 1 GB at the
// step's 1,024,000 pairs, which sets its pace.  A warp takes a run of
// kDweightRun consecutive index entries, keeps the current feature row in
// registers and reloads it only where the row changes, so a row is read
// once per run of pairs that share it (against one load per pair for a
// warp per pair), evict-first (__ldcs), as nothing reads it again.  Given
// a counter, each warp adds the rows it loaded to it.  The dot keeps a
// warp per pair's lane partition and shuffle butterfly.
//
// bf16 variants, for a model computing in bf16 (its lift gathers the FPN's
// bf16 rows): K4 keeps its walk and its fp32 sums and writes each d-feat
// row once in bf16, rounded to nearest even, as the cotangent of a bf16
// input is bf16 in JAX; that halves its write bytes (98 MB at the step's
// shape).  It equals the fp32 kernel's rows rounded once.  K5 reads bf16
// feature rows, 8 bytes per 4 channels, widened exactly to fp32, with fp32
// g and an fp32 dw: the fp32 kernel's result on the widened rows, bit for
// bit.  The index is the same for both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// lift_rows: rows of one view per CTA, warps per CTA, pix loads in flight
// per lane; the counts take kIndexSmem of dynamic shared memory
constexpr int kIndexRows = 1024;
constexpr int kIndexWarps = 16;
constexpr int kIndexThreads = kWarp * kIndexWarps;
constexpr int kRowsPerThread = kIndexRows / kIndexThreads;
constexpr int kIndexBatch = 8;
constexpr size_t kIndexSmem = sizeof(int) * kIndexWarps * kIndexRows;

// d-feat: warps (rows) per CTA, index entries a lane loads at a time
constexpr int kDfeatWarps = 8;
constexpr int kDfeatBatch = 4;

// d-weight: warps per CTA, index entries a warp walks
constexpr int kDweightWarps = 8;
constexpr int kDweightRun = 32;

// a lane holds up to kMaxVec float4 of a row: C <= 32 * 4 * kMaxVec
constexpr int kMaxVec = 4;

// Four consecutive channels of a row, as fp32, loaded evict-first: a
// float4, or 8 bytes of bf16 widened exactly (the bf16 bits are the fp32's
// upper half; the lower address's value sits in a word's low half).
template <typename T>
__device__ __forceinline__ float4 load4_stream(const T* p);

template <>
__device__ __forceinline__ float4 load4_stream<float>(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

template <>
__device__ __forceinline__ float4 load4_stream<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Two fp32 values rounded to nearest even bf16, `lo` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Four fp32 sums stored evict-first at channels 4q..4q+3 of an fp32 row,
// or of a bf16 row, each rounded once.
__device__ __forceinline__ void store4_stream(float* row, int q, float4 v) {
  __stcs(reinterpret_cast<float4*>(row) + q, v);
}

__device__ __forceinline__ void store4_stream(__nv_bfloat16* row, int q,
                                              float4 v) {
  __stcs(reinterpret_cast<uint2*>(row) + q,
         make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w)));
}

// Exclusive sum of x over the CTA's threads in thread order; `sums` holds
// one int per warp.  Ends with the CTA synchronised.
__device__ int block_exclusive_scan(int x, int* sums) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int incl = x;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == kWarp - 1) sums[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += sums[w];
  return base + incl - x;
}

// The chunk-local keys (pix - first, or -1 past the warp's range) of the
// kIndexBatch x 32 pairs from v = i on, loaded together.
__device__ __forceinline__ void load_keys(const int* vpix, int i, int end,
                                          int first, int* key) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int t = 0; t < kIndexBatch; ++t) {
    const int v = i + t * kWarp + lane;
    key[t] = v < end ? __ldg(vpix + v) - first : -1;
  }
}

__global__ void __launch_bounds__(kIndexThreads)
lift_rows_kernel(const int* __restrict__ pix, int* __restrict__ row_start,
                 int* __restrict__ pair, int n, int hw, int n_vox) {
  // count[w][r]: warp w's pairs in row r of the chunk, then where they go
  extern __shared__ int smem[];
  int (*count)[kIndexRows] = reinterpret_cast<int (*)[kIndexRows]>(smem);
  __shared__ int warp_below[kIndexWarps];
  __shared__ int scan_sums[kIndexWarps];
  const int chunks = (hw + kIndexRows - 1) / kIndexRows;
  const int view = blockIdx.x / chunks;
  const int first = (blockIdx.x % chunks) * kIndexRows;
  const int rows = min(kIndexRows, hw - first);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned lower = (1u << lane) - 1;
  const int span = (n_vox + kIndexWarps - 1) / kIndexWarps;
  const int begin = min(warp * span, n_vox);
  const int end = min(begin + span, n_vox);
  const int* vpix = pix + static_cast<long long>(view) * n_vox;
  int key[kIndexBatch];

  for (int i = threadIdx.x; i < kIndexWarps * kIndexRows; i += kIndexThreads)
    smem[i] = 0;
  __syncthreads();

  // 1. count this chunk's keys, and the view's pairs in rows before it
  int below = 0;
  for (int i = begin; i < end; i += kWarp * kIndexBatch) {
    load_keys(vpix, i, end, first, key);
#pragma unroll
    for (int t = 0; t < kIndexBatch; ++t) {
      const int v = i + t * kWarp + lane;
      below += v < end && key[t] < 0;
      if (key[t] >= 0 && key[t] < rows) atomicAdd(&count[warp][key[t]], 1);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    below += __shfl_xor_sync(kFull, below, off);
  if (lane == 0) warp_below[warp] = below;
  __syncthreads();

  // 2. each row's start in the chunk (a scan over rows) and each warp's
  //    offset within the row (a scan over warps)
  const int r0 = threadIdx.x * kRowsPerThread;
  int total[kRowsPerThread];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    int t = 0;
    for (int w = 0; w < kIndexWarps; ++w) {
      const int c = count[w][r0 + j];
      count[w][r0 + j] = t;
      t += c;
    }
    total[j] = t;
    sum += t;
  }
  int base = block_exclusive_scan(sum, scan_sums);
  int chunk_first = view * n_vox;
  for (int w = 0; w < kIndexWarps; ++w) chunk_first += warp_below[w];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    for (int w = 0; w < kIndexWarps; ++w) count[w][r0 + j] += base;
    if (r0 + j < rows)
      row_start[view * hw + first + r0 + j] = chunk_first + base;
    base += total[j];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) row_start[n * hw] = n * n_vox;
  __syncthreads();

  // 3. place: each warp walks its range again, in order
  for (int i = begin; i < end; i += kWarp * kIndexBatch) {
    load_keys(vpix, i, end, first, key);
#pragma unroll
    for (int t = 0; t < kIndexBatch; ++t) {
      const bool mine = key[t] >= 0 && key[t] < rows;
      const unsigned peers = __match_any_sync(kFull, mine ? key[t] : -1);
      const int slot = mine ? count[warp][key[t]] + __popc(peers & lower) : 0;
      __syncwarp();
      if (mine) {
        pair[chunk_first + slot] = view * n_vox + i + t * kWarp + lane;
        if ((peers & lower) == 0) count[warp][key[t]] += __popc(peers);
      }
      __syncwarp();
    }
  }
}

template <int kVec, typename T>
__global__ void __launch_bounds__(kWarp * kDfeatWarps)
dfeat_kernel(const int* __restrict__ row_start, const int* __restrict__ pair,
             const float* __restrict__ weight, const float* __restrict__ g,
             T* __restrict__ dfeat, int n_rows, int hw, int n_vox, int c) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kDfeatWarps + threadIdx.x / kWarp;
  if (row >= n_rows) return;
  const int c4 = c / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const int beg = row_start[row], end = row_start[row + 1];
  const int view_first = row / hw * n_vox;
  float4 acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e0 = beg; e0 < end; e0 += kWarp * kDfeatBatch) {
    int p[kDfeatBatch];
    float w[kDfeatBatch];
#pragma unroll
    for (int t = 0; t < kDfeatBatch; ++t) {
      const int e = e0 + t * kWarp + lane;
      p[t] = e < end ? __ldg(pair + e) : 0;
    }
#pragma unroll
    for (int t = 0; t < kDfeatBatch; ++t) {
      const int e = e0 + t * kWarp + lane;
      w[t] = e < end ? __ldg(weight + p[t]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kDfeatBatch; ++t) {
      unsigned nonzero = __ballot_sync(kFull, w[t] != 0.f);
      while (nonzero) {                     // the row's pairs in v order
        const int b = __ffs(nonzero) - 1;
        nonzero &= nonzero - 1;
        const float wb = __shfl_sync(kFull, w[t], b);
        const float4* gv = g4 + static_cast<long long>(
            __shfl_sync(kFull, p[t], b) - view_first) * c4;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int q = lane + k * kWarp;
          if (q < c4) {
            const float4 x = __ldg(gv + q);
            acc[k].x = __fadd_rn(acc[k].x, __fmul_rn(x.x, wb));
            acc[k].y = __fadd_rn(acc[k].y, __fmul_rn(x.y, wb));
            acc[k].z = __fadd_rn(acc[k].z, __fmul_rn(x.z, wb));
            acc[k].w = __fadd_rn(acc[k].w, __fmul_rn(x.w, wb));
          }
        }
      }
    }
  }
  T* out = dfeat + static_cast<long long>(row) * c;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int q = lane + k * kWarp;
    if (q < c4) store4_stream(out, q, acc[k]);
  }
}

template <int kVec, typename T>
__global__ void __launch_bounds__(kWarp * kDweightWarps)
dweight_kernel(const T* __restrict__ feat, const int* __restrict__ pix,
               const int* __restrict__ pair, const float* __restrict__ g,
               float* __restrict__ dw, int* __restrict__ row_loads,
               int n_pairs, int hw, int n_vox, int c) {
  const int lane = threadIdx.x % kWarp;
  const long long start =
      static_cast<long long>(blockIdx.x * kDweightWarps + threadIdx.x / kWarp)
      * kDweightRun;
  if (start >= n_pairs) return;
  const int stop = static_cast<int>(min(start + kDweightRun,
                                        static_cast<long long>(n_pairs)));
  const int c4 = c / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  int row = -1;                             // the row held in f
  int loads = 0;
  float4 f[kVec];
  for (int e0 = static_cast<int>(start); e0 < stop; e0 += kWarp) {
    const int e = e0 + lane;
    const int p = e < stop ? pair[e] : 0;
    const int view = p / n_vox;
    const int my_row = view * hw + pix[p];
    const int my_vox = p - view * n_vox;
    const int count = min(kWarp, stop - e0);
    float mine = 0.f;
    for (int j = 0; j < count; ++j) {
      const int r = __shfl_sync(kFull, my_row, j);
      const float4* gv = g4 + static_cast<long long>(
          __shfl_sync(kFull, my_vox, j)) * c4;
      if (r != row) {
        row = r;
        ++loads;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int q = lane + k * kWarp;
          f[k] = q < c4 ? load4_stream(feat + static_cast<long long>(r) * c
                                       + 4 * q)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int q = lane + k * kWarp;
        if (q < c4) {
          const float4 x = __ldg(gv + q);
          acc = __fadd_rn(acc, __fmul_rn(f[k].x, x.x));
          acc = __fadd_rn(acc, __fmul_rn(f[k].y, x.y));
          acc = __fadd_rn(acc, __fmul_rn(f[k].z, x.z));
          acc = __fadd_rn(acc, __fmul_rn(f[k].w, x.w));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
      if (lane == j) mine = acc;
    }
    if (e < stop) dw[p] = mine;
  }
  if (row_loads != nullptr && lane == 0) atomicAdd(row_loads, loads);
}

int vec_for(int c) { return (c / 4 + kWarp - 1) / kWarp; }

unsigned blocks(long long items, long long per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

template <typename T>
int launch_dfeat(const int* row_start, const int* pair, const float* weight,
                 const float* g, T* dfeat, int n, int hw, int n_vox, int c,
                 cudaStream_t stream) {
  const int n_rows = n * hw;
  if (n_rows == 0 || c == 0) return 0;
  if (c % 4 != 0 || vec_for(c) > kMaxVec)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = blocks(n_rows, kDfeatWarps);
  const int threads = kWarp * kDfeatWarps;
  switch (vec_for(c)) {
    case 1: dfeat_kernel<1, T><<<grid, threads, 0, stream>>>(
        row_start, pair, weight, g, dfeat, n_rows, hw, n_vox, c); break;
    case 2: dfeat_kernel<2, T><<<grid, threads, 0, stream>>>(
        row_start, pair, weight, g, dfeat, n_rows, hw, n_vox, c); break;
    case 3: dfeat_kernel<3, T><<<grid, threads, 0, stream>>>(
        row_start, pair, weight, g, dfeat, n_rows, hw, n_vox, c); break;
    default: dfeat_kernel<4, T><<<grid, threads, 0, stream>>>(
        row_start, pair, weight, g, dfeat, n_rows, hw, n_vox, c); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dweight(const T* feat, const int* pix, const int* pair,
                   const float* g, float* dw, int* row_loads, int n, int hw,
                   int n_vox, int c, cudaStream_t stream) {
  const int n_pairs = n * n_vox;
  if (n_pairs == 0) return 0;
  if (c % 4 != 0 || vec_for(c) > kMaxVec)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = blocks(n_pairs, kDweightRun * kDweightWarps);
  const int threads = kWarp * kDweightWarps;
  switch (vec_for(c)) {
    case 0:
    case 1: dweight_kernel<1, T><<<grid, threads, 0, stream>>>(
        feat, pix, pair, g, dw, row_loads, n_pairs, hw, n_vox, c); break;
    case 2: dweight_kernel<2, T><<<grid, threads, 0, stream>>>(
        feat, pix, pair, g, dw, row_loads, n_pairs, hw, n_vox, c); break;
    case 3: dweight_kernel<3, T><<<grid, threads, 0, stream>>>(
        feat, pix, pair, g, dw, row_loads, n_pairs, hw, n_vox, c); break;
    default: dweight_kernel<4, T><<<grid, threads, 0, stream>>>(
        feat, pix, pair, g, dw, row_loads, n_pairs, hw, n_vox, c); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success).  N HW and N V must
// fit in an int, every pix in [0, HW); C must be a multiple of 4, at most
// 32 * 4 * kMaxVec = 512, and every pointer 16-byte aligned.

// row_start (N HW + 1) and pair (N V) of `pix`, written whole.
extern "C" int lift_rows(const int* pix, int* row_start, int* pair, int n,
                         int hw, int n_vox, cudaStream_t stream) {
  if (n == 0 || hw == 0)
    return static_cast<int>(cudaMemsetAsync(row_start, 0, sizeof(int),
                                            stream));
  const cudaError_t err = cudaFuncSetAttribute(
      lift_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kIndexSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (hw + kIndexRows - 1) / kIndexRows;
  lift_rows_kernel<<<static_cast<unsigned>(n) * chunks, kIndexThreads,
                     kIndexSmem, stream>>>(pix, row_start, pair, n, hw,
                                           n_vox);
  return static_cast<int>(cudaGetLastError());
}

// dfeat (N HW, C), every row written, from the index of `lift_rows`: fp32,
// or the same sums rounded to bf16.
extern "C" int weighted_gather_sum_dfeat(const int* row_start,
                                         const int* pair, const float* weight,
                                         const float* g, float* dfeat, int n,
                                         int hw, int n_vox, int c,
                                         cudaStream_t stream) {
  return launch_dfeat(row_start, pair, weight, g, dfeat, n, hw, n_vox, c,
                      stream);
}

extern "C" int weighted_gather_sum_dfeat_bf16(
    const int* row_start, const int* pair, const float* weight,
    const float* g, __nv_bfloat16* dfeat, int n, int hw, int n_vox, int c,
    cudaStream_t stream) {
  return launch_dfeat(row_start, pair, weight, g, dfeat, n, hw, n_vox, c,
                      stream);
}

// dw (N, V), every pair, walking `pair` of `lift_rows` in runs of
// kDweightRun entries per warp, from fp32 or bf16 feature rows.
// `row_loads` is null, or a zeroed int on the card to which the launch
// adds the feature rows it loads.
extern "C" int weighted_gather_sum_dweight(const float* feat, const int* pix,
                                           const int* pair, const float* g,
                                           float* dw, int* row_loads, int n,
                                           int hw, int n_vox, int c,
                                           cudaStream_t stream) {
  return launch_dweight(feat, pix, pair, g, dw, row_loads, n, hw, n_vox, c,
                        stream);
}

extern "C" int weighted_gather_sum_dweight_bf16(
    const __nv_bfloat16* feat, const int* pix, const int* pair,
    const float* g, float* dw, int* row_loads, int n, int hw, int n_vox,
    int c, cudaStream_t stream) {
  return launch_dweight(feat, pix, pair, g, dw, row_loads, n, hw, n_vox, c,
                        stream);
}
