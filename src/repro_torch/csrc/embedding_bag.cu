// EmbeddingBag on Hopper (sm_90a): the kernel behind
// repro_torch.kernels.embedding_bag, the port of the JAX package's Pallas
// kernel src/repro/kernels/embedding_bag.py::embedding_bag (_bag_kernel).
// Built with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libembedding_bag.so embedding_bag.cu
//
// and bound with ctypes: a plain C interface, pointers and the stream as
// void*, no PyTorch headers (async_copy.cuh holds the PTX of the async
// copies and barriers).  The entry points return cudaGetLastError().
//
// For each bag b of indices [B, L] (int32, negative = padding) over a table
// [V, D] (fp32 or bf16, contiguous), with optional fp32 weights [B, L]:
//
//   sum:  out[b, :] = sum_{j: idx >= 0} w[b, j] * table[idx[b, j], :]
//   mean: the same divided by max(count of valid entries, 1)
//
// accumulated in fp32 registers in entry order and written once as fp32
// [B, D].  A fully padded bag (or L = 0) gives zeros; an id >= V makes its
// whole bag NaN, as jnp.take's fill mode does in the JAX package's oracle
// (the row itself is never read).
//
// Bound: bytes.  Every valid entry reads one row of D elements and does D
// fused multiply-adds on it, so the arithmetic is nothing beside the
// reads.  At two-tower's serve_p99 request ([512, 50] over 10M x 256 fp32,
// ~13k valid entries, zipf ids) the rows are ~13 MB, a few microseconds at
// the 3.35 TB/s of an H100 SXM's data sheet (700 W): the kernel is
// latency-bound, so what counts is how many memory latencies a bag waits
// on in a row.  At serve_bulk ([262144, 50]) it reads gigabytes and the
// memory rate is the limit.
//
// One block per bag, for any B with no padding copy (the TPU kernel tiles
// bags_per_block bags a grid step and needs B % bags_per_block == 0).
// Row offsets are 64-bit (int64_t(row) * D): the published item table has
// 2.56e9 elements, past what a 32-bit index reaches.  Two branches, chosen
// by shape and alignment in dispatch():
//
// * staged (rows of a multiple of 16 B, at most kMaxStagedRowBytes, in a
//   16 B aligned table, and a batch whose every bag can be resident at
//   once: the serve_p99 request, D = 256 fp32 at B = 512).  The first
//   warp reads a stage of kStageRows ids and weights, one a lane,
//   coalesced, into shared memory (the first kStages stages at once); then
//   every thread issues its 16 B of every valid row of those stages as
//   asynchronous copies into shared memory (cp.async, one group a stage),
//   so a bag of up to kStages x kStageRows entries waits on one latency
//   for its ids and one for all its rows, where a thread walking the bag
//   in registers waits on a pair per kUnroll entries.  No copy is issued
//   for padding or an id >= V.  Each thread then sums, in entry order and
//   with the same fmaf as the register branch, the bytes it copied: it
//   waits for its own groups only.  Longer bags use the ring: stage c +
//   kStages is issued once stage c is summed, its ids fetched meanwhile.
//   Shared memory, not registers, holds the rows in flight, so a block
//   holds up to kStages x kStageRows rows (64 KB at D = 256 fp32; just L
//   rows when the bag fits, 50 KB at L = 50, four blocks an SM: 528 on the
//   H100, one wave for 512 bags).
//   Why not one 1-D bulk copy (cp.async.bulk) per row, completing on an
//   mbarrier: a version built that way was slower on the H100 than these
//   per-thread copies at the serve_p99 request and than the register
//   branch, so many 1 KB bulk copies cost more than the loads they save.
// * registers (any other row: D = 10 or 18, an odd bf16 width, a table
//   view off a 16 B boundary; and a batch past one resident wave, as at
//   serve_bulk, where a block a bag holding its rows in shared memory
//   keeps fewer bytes in flight per SM than 32 blocks of 64 threads with
//   kUnroll loads each): threads stride over D with 16-byte loads of 4
//   fp32 (8 bytes of 4 bf16) when D % 4 == 0 and the table is aligned for
//   them, else one element a thread, and walk the bag's ids kUnroll at a
//   time, issuing those rows' loads before adding any of them.
//
// repro_embedding_bag_backward: the gradient of that function with
// respect to the table, for constant weights (or none).  The JAX package
// has no gradient kernel: it differentiates its oracle,
// src/repro/kernels/ref.py::embedding_bag, whose transpose of jnp.take
// scatter-adds into a dense [V, D] gradient.  Into grad [V, D] (fp32,
// zeroed by the caller) it adds, for every entry (b, j) with 0 <= id < V,
//
//   grad[id, :] += (g[b, :] / denom[b]) * w[b, j]
//
// with denom = max(count of entries with id >= 0, 1) for mean and 1 for
// sum: an id >= V counts in the mean's denominator but adds nothing
// (jnp.take's fill reads it as NaN, and its transpose drops it).  The
// terms are rounded as that transpose rounds them: g / denom first, then
// times w.
//
// Bound: bytes.  It reads g, the ids and the weights once and
// reads-modifies-writes each distinct row the batch touches; the memset
// of the [V, D] gradient is the caller's and is counted apart.  One block
// per bag and one thread per column (strided past kMaxThreads columns):
// consecutive threads add into consecutive words of one row, so a warp's
// adds go to L2 as one coalesced reduction.  The adds are fp32 atomics
// (red.global.add.f32): a row that many bags touch (a zipf-hot item)
// takes its adds one after another at L2, and their order changes from
// run to run, so the result's last bits do too (a sorted, segmented
// backward would fix both; ROADMAP queue 2).  Row offsets are 64-bit:
// the published item table has 2.56e9 elements.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"

namespace {

constexpr int kUnroll = 4;          // registers: rows in flight per thread
constexpr int kMaxThreads = 256;
constexpr int kStageRows = 32;      // staged: entries a stage
constexpr int kStages = 2;          // staged: the ring
constexpr int kMaxStagedRowBytes = 3072;  // 2 x 32 rows of it: 192 KB
constexpr int kSumUnroll = 8;       // staged: rows copied or summed at once

template <typename T, int VEC>
struct Row;                         // VEC consecutive elements -> fp32

template <>
struct Row<float, 1> {
  __device__ static void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};
template <>
struct Row<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <>
struct Row<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};
template <>
struct Row<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
embedding_bag_kernel(const T* __restrict__ table, int64_t vocab, int dim,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ weights, int bag_len,
                     int mean, float* __restrict__ out) {
  const int64_t bag = blockIdx.x;
  const int32_t* idx = indices + bag * bag_len;
  const float* wgt = weights == nullptr ? nullptr : weights + bag * bag_len;
  for (int d0 = threadIdx.x * VEC; d0 < dim; d0 += blockDim.x * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    int count = 0;                  // the same in every thread of the bag
    bool past_table = false;
    for (int j = 0; j < bag_len; j += kUnroll) {
      int32_t id[kUnroll];
      float w[kUnroll], v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        id[u] = j + u < bag_len ? __ldg(idx + j + u) : -1;
        w[u] = (wgt != nullptr && j + u < bag_len) ? __ldg(wgt + j + u) : 1.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (id[u] >= 0 && id[u] < vocab) {
          Row<T, VEC>::load(table + static_cast<int64_t>(id[u]) * dim + d0,
                            v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (id[u] >= 0) {
          ++count;
          past_table |= id[u] >= vocab;
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = fmaf(w[u], v[u][k], acc[k]);
        }
      }
    }
    const float denom = mean ? static_cast<float>(count > 1 ? count : 1) : 1.f;
    float* o = out + bag * dim + d0;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o[k] = past_table ? CUDART_NAN_F : acc[k] / denom;
  }
}

// 16 bytes of a row staged in shared memory -> fp32
template <typename T>
struct Staged;

template <>
struct Staged<float> {
  static constexpr int kVec = 4;
  __device__ static void load(const unsigned char* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <>
struct Staged<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const unsigned char* p, float (&v)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

// The staged branch: one block per bag, blockDim.x = D * sizeof(T) / 16
// rounded up to a warp, thread t owning bytes [16 t, 16 t + 16) of every
// row.  Dynamic shared memory holds the ring: kStages stages of
// kStageRows rows, or just the bag's L rows when the whole bag fits it
// (stage s at row s * kStageRows either way).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
embedding_bag_staged_kernel(const T* __restrict__ table, int64_t vocab,
                            int dim, const int32_t* __restrict__ indices,
                            const float* __restrict__ weights, int bag_len,
                            int mean, float* __restrict__ out) {
  constexpr int VEC = Staged<T>::kVec;
  extern __shared__ __align__(128) unsigned char rows[];
  __shared__ int32_t stage_id[kStages][kStageRows];
  __shared__ float stage_w[kStages][kStageRows];
  const int64_t bag = blockIdx.x;
  const int32_t* idx = indices + bag * bag_len;
  const float* wgt = weights == nullptr ? nullptr : weights + bag * bag_len;
  const int row_bytes = dim * static_cast<int>(sizeof(T));
  const int chunks = (bag_len + kStageRows - 1) / kStageRows;
  const int lane = threadIdx.x;       // threads < 32 read the ids
  const int d0 = threadIdx.x * VEC;
  const bool col = d0 < dim;
  // entry `lane` of chunk c: its id (-1 past the bag) and weight
  auto fetch = [&](int c, int32_t& id, float& w) {
    const int j = c * kStageRows + lane;
    id = j < bag_len ? __ldg(idx + j) : -1;
    w = wgt != nullptr && j < bag_len ? __ldg(wgt + j) : 1.f;
  };
  // this thread's 16 B of every valid row of chunk c, as one group
  auto copy_rows = [&](int c) {
    const int st = c % kStages;
    const int n = min(kStageRows, bag_len - c * kStageRows);
    if (col) {
      for (int j0 = 0; j0 < n; j0 += kSumUnroll) {
        int32_t id[kSumUnroll];
#pragma unroll
        for (int u = 0; u < kSumUnroll; ++u)
          id[u] = j0 + u < n ? stage_id[st][j0 + u] : -1;
#pragma unroll
        for (int u = 0; u < kSumUnroll; ++u) {
          if (id[u] >= 0 && id[u] < vocab)
            cp_async::copy16(
                rows + static_cast<size_t>(st * kStageRows + j0 + u) *
                           row_bytes + d0 * sizeof(T),
                table + static_cast<int64_t>(id[u]) * dim + d0);
        }
      }
    }
    cp_async::commit();
  };
  // the first kStages chunks' ids at once, then all their rows in flight
  if (lane < 32) {
    int32_t id[kStages];
    float w[kStages];
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      id[s] = -1;
      w[s] = 1.f;
      if (s < chunks) fetch(s, id[s], w[s]);
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      stage_id[s][lane] = id[s];
      stage_w[s][lane] = w[s];
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < chunks) copy_rows(s);
    else cp_async::commit();          // groups stay one per chunk
  }
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  int count = 0;                      // the same in every thread
  bool past_table = false;
  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages;
    const bool refill = c + kStages < chunks;
    int32_t next_id = -1;
    float next_w = 1.f;
    if (refill && lane < 32) fetch(c + kStages, next_id, next_w);
    cp_async::wait<kStages - 1>();    // chunk c's group has landed
    const int n = min(kStageRows, bag_len - c * kStageRows);
    for (int j0 = 0; j0 < n; j0 += kSumUnroll) {
      int32_t id[kSumUnroll];
      float w[kSumUnroll], v[kSumUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        id[u] = j0 + u < n ? stage_id[st][j0 + u] : -1;
        w[u] = stage_w[st][j0 + u];
      }
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        if (col && id[u] >= 0 && id[u] < vocab) {
          Staged<T>::load(rows + static_cast<size_t>(st * kStageRows + j0 +
                                                     u) * row_bytes +
                              d0 * sizeof(T), v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        if (id[u] >= 0) {
          ++count;
          past_table |= id[u] >= vocab;
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = fmaf(w[u], v[u][k], acc[k]);
        }
      }
    }
    if (refill) {                     // chunk c + kStages into stage st
      __syncthreads();                // every thread is done with its ids
      if (lane < 32) {
        stage_id[st][lane] = next_id;
        stage_w[st][lane] = next_w;
      }
      __syncthreads();
      copy_rows(c + kStages);
    } else {
      cp_async::commit();
    }
  }
  if (col) {
    const float denom =
        mean ? static_cast<float>(count > 1 ? count : 1) : 1.f;
    float* o = out + bag * dim + d0;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o[k] = past_table ? CUDART_NAN_F : acc[k] / denom;
  }
}

template <typename T, int VEC>
void launch(const void* table, long long vocab, int dim, const void* indices,
            const void* weights, long long batch, int bag_len, int mean,
            void* out, cudaStream_t stream) {
  const int lanes = (dim + VEC - 1) / VEC;
  int threads = (lanes + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  embedding_bag_kernel<T, VEC>
      <<<static_cast<unsigned>(batch), threads, 0, stream>>>(
          static_cast<const T*>(table), vocab, dim,
          static_cast<const int32_t*>(indices),
          static_cast<const float*>(weights), bag_len, mean,
          static_cast<float*>(out));
}

// The staged branch's block size and dynamic shared memory for rows of
// `dim` elements and bags of `bag_len`; false where it takes no such row.
template <typename T>
bool staged_shape(int dim, int bag_len, int* threads, size_t* smem) {
  const long long row_bytes = static_cast<long long>(dim) * sizeof(T);
  if (row_bytes % 16 != 0 || row_bytes > kMaxStagedRowBytes) return false;
  const int ring = kStages * kStageRows;
  *threads = static_cast<int>((row_bytes / 16 + 31) / 32 * 32);
  *smem = static_cast<size_t>(bag_len < ring ? bag_len : ring) * row_bytes;
  return true;
}

// How many blocks of the staged branch the current device holds at once
// for this shape (0 where the branch takes no such row).
template <typename T>
cudaError_t resident(int dim, int bag_len, long long* blocks) {
  *blocks = 0;
  int threads = 0;
  size_t smem = 0;
  if (!staged_shape<T>(dim, bag_len, &threads, &smem)) return cudaSuccess;
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      embedding_bag_staged_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStages * kStageRows * kMaxStagedRowBytes);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, embedding_bag_staged_kernel<T>, threads, smem);
  if (err == cudaSuccess) *blocks = static_cast<long long>(per_sm) * n_sm;
  return err;
}

template <typename T>
int dispatch(const void* table, long long vocab, int dim, const void* indices,
             const void* weights, long long batch, int bag_len, int mean,
             void* out, long long resident_blocks, cudaStream_t stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(table);
  int threads = 0;
  size_t smem = 0;
  if (staged_shape<T>(dim, bag_len, &threads, &smem) && at % 16 == 0 &&
      batch <= resident_blocks) {
    embedding_bag_staged_kernel<T>
        <<<static_cast<unsigned>(batch), threads, smem, stream>>>(
            static_cast<const T*>(table), vocab, dim,
            static_cast<const int32_t*>(indices),
            static_cast<const float*>(weights), bag_len, mean,
            static_cast<float*>(out));
    return 1;
  }
  // vector loads need D % 4 == 0 and the table aligned to 4 elements
  if (dim % 4 == 0 && at % (4 * sizeof(T)) == 0) {
    launch<T, 4>(table, vocab, dim, indices, weights, batch, bag_len, mean,
                 out, stream);
  } else {
    launch<T, 1>(table, vocab, dim, indices, weights, batch, bag_len, mean,
                 out, stream);
  }
  return 0;
}

// One block per bag: g [B, D], indices [B, L], weights [B, L] or null ->
// adds into grad [V, D].
__global__ void __launch_bounds__(kMaxThreads)
embedding_bag_backward_kernel(const float* __restrict__ g,
                              const int32_t* __restrict__ indices,
                              const float* __restrict__ weights,
                              int64_t vocab, int dim, int bag_len, int mean,
                              float* __restrict__ grad) {
  const int64_t bag = blockIdx.x;
  const int32_t* idx = indices + bag * bag_len;
  const float* wgt = weights == nullptr ? nullptr : weights + bag * bag_len;
  int count = 0;                    // the same in every thread of the bag
  if (mean) {
    for (int j = 0; j < bag_len; ++j) count += __ldg(idx + j) >= 0;
  }
  const float denom = mean ? static_cast<float>(count > 1 ? count : 1) : 1.f;
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    const float gd = __ldg(g + bag * dim + d) / denom;
    for (int j = 0; j < bag_len; ++j) {
      const int32_t id = __ldg(idx + j);
      if (id >= 0 && id < vocab) {
        const float w = wgt != nullptr ? __ldg(wgt + j) : 1.f;
        atomicAdd(grad + static_cast<int64_t>(id) * dim + d, gd * w);
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Once per device and shape, before
// the first launch of that shape there: *blocks = how many bags of
// `bag_len` over rows of `dim` the staged branch holds resident at once on
// the current device (0 where it takes no such row).  It also lets the
// branch take its ring of up to kStages x kStageRows x kMaxStagedRowBytes
// bytes of dynamic shared memory there, so a launch sets and queries
// nothing.
extern "C" int repro_embedding_bag_resident(int dtype, int dim, int bag_len,
                                            long long* blocks) {
  if (dtype == 0) return static_cast<int>(resident<float>(dim, bag_len,
                                                          blocks));
  if (dtype == 1)
    return static_cast<int>(resident<__nv_bfloat16>(dim, bag_len, blocks));
  return static_cast<int>(cudaErrorInvalidValue);
}

// mode: 0 = sum, 1 = mean.  weights may be null.  batch in [1, 2^31 - 1],
// dim >= 1, bag_len >= 0; resident_blocks from repro_embedding_bag_resident
// for this device and shape.  *staged is set to 1 when the staged branch
// ran, 0 for the register branch.
extern "C" int repro_embedding_bag(const void* table, int dtype,
                                   long long vocab, int dim,
                                   const void* indices, const void* weights,
                                   long long batch, int bag_len, int mode,
                                   void* out, long long resident_blocks,
                                   void* stream, int* staged) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    *staged = dispatch<float>(table, vocab, dim, indices, weights, batch,
                              bag_len, mode, out, resident_blocks, s);
  } else if (dtype == 1) {
    *staged = dispatch<__nv_bfloat16>(table, vocab, dim, indices, weights,
                                      batch, bag_len, mode, out,
                                      resident_blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradient of repro_embedding_bag's fp32 output with respect to its
// table, for constant weights: adds into grad [vocab, dim] (fp32, zeroed
// by the caller) from g [batch, dim] (fp32), indices [batch, bag_len]
// (int32, negative = padding) and weights [batch, bag_len] (fp32) or null.
// mode: 0 = sum, 1 = mean.  batch in [1, 2^31 - 1], dim >= 1, bag_len >= 0.
extern "C" int repro_embedding_bag_backward(const void* g,
                                            const void* indices,
                                            const void* weights,
                                            long long vocab, int dim,
                                            long long batch, int bag_len,
                                            int mode, void* grad,
                                            void* stream) {
  if (batch < 1 || batch > 0x7fffffffll || dim < 1 || bag_len < 0 ||
      vocab < 0 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = (dim + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  embedding_bag_backward_kernel<<<static_cast<unsigned>(batch), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights), vocab, dim, bag_len, mode,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}
