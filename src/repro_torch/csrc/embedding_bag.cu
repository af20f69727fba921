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
// The gradient of that function with respect to the table, for constant
// weights (or none), is two entry points that
// kernels/embedding_bag.embedding_bag_backward calls:
// repro_embedding_bag_backward_scale (mean only) and _level (once a
// level).  The JAX package has no gradient kernel: it differentiates its
// oracle, src/repro/kernels/ref.py::embedding_bag, whose transpose of
// jnp.take scatter-adds into a dense [V, D] gradient.  The fp32 [V, D]
// result holds in row v the sum, over the entries (b, j) whose id is v, of
//
//   (g[b, :] / denom[b]) * w[b, j]
//
// with denom = max(count of entries with id >= 0, 1) for mean and no
// division for sum: an id >= V counts in the mean's denominator but adds
// nothing (jnp.take's fill reads it as NaN, and its transpose drops it),
// padding adds nothing, and a row no entry names is 0.  Each term is
// rounded as that transpose rounds it: g / denom first (once a bag and
// column, by _scale), then times w.
//
// The sum is taken in one fixed order, so every run gives the same bits;
// kernels/ref.embedding_bag_backward_ordered is the plain version of
// exactly this order:
//
//   1. The wrapper's plan (embedding_bag_backward_sort and _plan, plain
//      torch) sorts the flat entries b * L + j stably by id, so each
//      row's terms run in ascending (b, j) order, and cuts each row's run
//      into chunks of kChunk consecutive terms.
//   2. Level 0: a group of kLevelLanes lanes a chunk sums its terms left to
//      right from +0.0f.
//   3. A row left with more than one partial has them summed again in
//      chunks of kChunk, in order, one level after another, until one
//      value is left: the hottest row of two-tower's train_batch (159,096
//      terms) takes 4 levels, where one warp adding its 4,972 partials in
//      a row would take milliseconds.
//   4. The chunk that leaves a row one value writes it into grad, once.
//      After the sort, the wrapper zeroes grad on the caller's stream
//      while the plan is made on another, and the levels follow the zeros
//      there, so a touched row is written twice (0, then its sum) and
//      every other row once.
//
// Every product and sum is __fmul_rn or __fadd_rn and the quotient
// __fdiv_rn, so no FMA contraction changes the order's rounding whatever
// the flags.
//
// Bound: bytes.  g, the ids and the weights read once and [V, D] written
// once (the zero fill writes the touched rows once more); the adds, one a
// valid entry and column, are far below the bytes.
// No atomics: a hot row costs a few levels of chunks, not a queue of adds
// at L2, and its adds no longer come in an order that changes each run.
// Most chunks are short (two-tower's zipf ids give ~3 terms a chunk), so a
// group's time is its chain of dependent loads: its chunk's place in the
// plan, then its terms' entries, then the rows of g they name (with their
// weights), kUnroll rows at once, each lane holding 16 bytes of every 32
// columns where D % 4 == 0 (D = 256 in one pass: eight 16-byte loads a
// lane a row).  Eight lanes a chunk put four chunks in a warp, so four
// such chains overlap where one chunk a warp left the card waiting;
// g's rows are read again for each entry that names them (mostly from
// L2).  Row offsets are 64-bit: the published item table has 2.56e9
// elements.

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
constexpr int kChunk = 32;          // backward: terms a chunk: BAG_CHUNK
constexpr int kLevelThreads = 256;  // backward: 32 chunks a block
constexpr int kLevelLanes = 8;      // backward: lanes a chunk
constexpr int kScaleThreads = 256;  // backward: 8 bags a block

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

// VEC consecutive fp32 of the gradient's arrays
template <int VEC>
struct F32;

template <>
struct F32<1> {
  __device__ static void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  __device__ static void store(float* p, const float (&v)[1]) { p[0] = v[0]; }
  // marked evict-first in L2: nothing here reads it again
  __device__ static void stream(float* p, const float (&v)[1]) {
    __stcs(p, v[0]);
  }
};
template <>
struct F32<4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static void stream(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

// The mean's terms' first rounding, once a bag: scaled[b, :] = g[b, :] /
// max(count of ids >= 0 in bag b, 1), one warp a bag.  Every term of bag b
// starts from this row, so the level pass divides nothing.
__global__ void __launch_bounds__(kScaleThreads)
bag_backward_scale_kernel(const float* __restrict__ g,
                          const int32_t* __restrict__ indices, int64_t batch,
                          int bag_len, int dim, float* __restrict__ scaled) {
  const int lane = threadIdx.x % 32;
  const int64_t b = (static_cast<int64_t>(blockIdx.x) * kScaleThreads +
                     threadIdx.x) / 32;
  if (b >= batch) return;                       // the whole warp leaves
  int count = 0;
  for (int j0 = 0; j0 < bag_len; j0 += 32) {
    const bool valid = j0 + lane < bag_len &&
                       __ldg(indices + b * bag_len + j0 + lane) >= 0;
    count += __popc(__ballot_sync(0xffffffffu, valid));
  }
  const float denom = static_cast<float>(count > 1 ? count : 1);
  for (int d = lane; d < dim; d += 32)
    scaled[b * dim + d] = __fdiv_rn(__ldg(g + b * dim + d), denom);
}

// The plan's per-row arrays (kernels/embedding_bag.BagPlan), [depth, R]
// flattened.
struct Plan {
  const int64_t* rows;         // [R]
  const int64_t* items;
  const int64_t* item_start;
  const int64_t* chunks;
  const int64_t* upto;
  int64_t n_rows;              // R
  int64_t size;                // depth * R
};

// One level of the plan, kLevelLanes lanes (G) a chunk, worked out as
// kernels/embedding_bag.level_chunks does: chunk k = k_begin + j is the i-th chunk
// of its row r at level l, a = at[j] = l * R + r; it sums that level's
// items item_start[a] + i * kChunk on, min(kChunk, items[a] - i * kChunk)
// of them, in order from +0.0f.  At level 0 (kTerms) item p is the term
// of flat entry perm[p] = b * bag_len + j': src's row b (g, or the mean's
// scaled g) times weights[perm[p]] where there are weights; later, row p
// of src (the partials of the level before).  Where r has one chunk at
// this level the sum is grad's row rows[r]; else row item_start[a + R] +
// i of partial_out.  A lane holds kPasses x VEC columns of every row, so
// each of a chunk's rows is read by kPasses loads a lane, kUnroll rows at
// once.
template <int VEC, bool kTerms>
__global__ void __launch_bounds__(kLevelThreads)
bag_backward_level_kernel(const float* __restrict__ src, int dim,
                          const int64_t* __restrict__ perm, int64_t bag_len,
                          const float* __restrict__ weights, const Plan plan,
                          const int64_t* __restrict__ at, int64_t k_begin,
                          int64_t n_chunks, float* __restrict__ grad,
                          float* __restrict__ partial_out) {
  constexpr int G = kLevelLanes;
  constexpr int kGroups = kLevelThreads / G;    // chunks a block
  constexpr int kSpan = G * VEC;                // columns a pass of a group
  constexpr int kPasses = VEC == 4 ? 256 / kSpan : 2;
  constexpr int kUnroll = kPasses * VEC >= 16 ? 2 : 4;
  // a group's items: the row of src each reads, and (level 0) its entry
  __shared__ int64_t item_row[kGroups][kChunk];
  __shared__ int64_t item_entry[kGroups][kChunk];
  const int gl = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kGroups + grp;
  int64_t first = 0, to = 0;
  int n = 0;                                    // 0: past the last chunk
  if (j < n_chunks) {
    const int64_t a = at[j];
    const int64_t c = plan.chunks[a];
    const int64_t i = k_begin + j - (plan.upto[a] - c);
    const int64_t left = plan.items[a] - i * kChunk;
    first = plan.item_start[a] + i * kChunk;
    n = left < kChunk ? static_cast<int>(left) : kChunk;
    to = c == 1 ? plan.rows[a % plan.n_rows]
                : -1 - (plan.item_start[a + plan.n_rows < plan.size
                                            ? a + plan.n_rows
                                            : plan.size - 1] + i);
  }
  for (int t = gl; t < n; t += G) {
    if constexpr (kTerms) {
      const int64_t e = perm[first + t];
      item_entry[grp][t] = e;
      item_row[grp][t] = e / bag_len;
    } else {
      item_row[grp][t] = first + t;
    }
  }
  __syncwarp();                                 // every lane reaches it
  if (n == 0) return;
  float* dst = to >= 0 ? grad + to * dim : partial_out + (-1 - to) * dim;
  for (int d0 = gl * VEC; d0 < dim; d0 += kPasses * kSpan) {
    float acc[kPasses][VEC];
#pragma unroll
    for (int c = 0; c < kPasses; ++c)
#pragma unroll
      for (int x = 0; x < VEC; ++x) acc[c][x] = 0.f;
    for (int t0 = 0; t0 < n; t0 += kUnroll) {
      float v[kUnroll][kPasses][VEC];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u >= n) continue;
        const int64_t row = item_row[grp][t0 + u];
#pragma unroll
        for (int c = 0; c < kPasses; ++c)
          if (d0 + c * kSpan < dim)
            F32<VEC>::load(src + row * dim + d0 + c * kSpan, v[u][c]);
        if constexpr (kTerms)
          w[u] = weights != nullptr
                     ? __ldg(weights + item_entry[grp][t0 + u]) : 1.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u >= n) continue;
#pragma unroll
        for (int c = 0; c < kPasses; ++c)
#pragma unroll
          for (int x = 0; x < VEC; ++x) {
            float y = v[u][c][x];
            if constexpr (kTerms) {
              if (weights != nullptr) y = __fmul_rn(y, w[u]);
            }
            acc[c][x] = __fadd_rn(acc[c][x], y);
          }
      }
    }
#pragma unroll
    for (int c = 0; c < kPasses; ++c)
      if (d0 + c * kSpan < dim) {
        if (to >= 0) F32<VEC>::stream(dst + d0 + c * kSpan, acc[c]);
        else F32<VEC>::store(dst + d0 + c * kSpan, acc[c]);  // read next
      }
  }
}

// A level's arguments, as repro_embedding_bag_backward_level takes them.
struct LevelArgs {
  const float* src;
  int dim;
  const int64_t* perm;
  int64_t bag_len;
  const float* weights;
  Plan plan;
  const int64_t* at;
  int64_t k_begin;
  int64_t n_chunks;
  float* grad;
  float* partial_out;
};

template <int VEC, bool kTerms>
cudaError_t launch_level(const LevelArgs& a, cudaStream_t stream) {
  constexpr int kGroups = kLevelThreads / kLevelLanes;
  const long long blocks = (a.n_chunks + kGroups - 1) / kGroups;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  bag_backward_level_kernel<VEC, kTerms>
      <<<static_cast<unsigned>(blocks), kLevelThreads, 0, stream>>>(
          a.src, a.dim, a.perm, a.bag_len, a.weights, a.plan, a.at,
          a.k_begin, a.n_chunks, a.grad, a.partial_out);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
// table, for constant weights (the header says what it computes), on
// `stream`.  scale (mean only): scaled [batch, dim] = g [batch, dim] (fp32)
// over each bag's count of ids >= 0 in indices [batch, bag_len] (int32,
// negative = padding), at least 1; batch >= 1, bag_len >= 0, dim >= 1.
extern "C" int repro_embedding_bag_backward_scale(const void* g,
                                                  const void* indices,
                                                  long long batch,
                                                  int bag_len, int dim,
                                                  void* scaled,
                                                  void* stream) {
  if (batch < 1 || bag_len < 0 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr long long kBags = kScaleThreads / 32;
  bag_backward_scale_kernel<<<static_cast<unsigned>(
                                  (batch + kBags - 1) / kBags),
                              kScaleThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(indices),
      batch, bag_len, dim, static_cast<float*>(scaled));
  return static_cast<int>(cudaGetLastError());
}

// level: one level of the plan (kernels/embedding_bag.BagPlan's arrays,
// int64: rows [n_rows], items, item_start, chunks and upto [size]; the
// level's at int64 [n_chunks] and k_begin; n_chunks >= 1).  Level 0
// passes perm (int64, the sorted flat entries) with src = g [batch, dim]
// (fp32; for mean, scale's output) and weights [batch, bag_len] (fp32, or
// null); a later level passes perm = null and src = the level before's
// partial_out.  Finished rows go into grad [vocab, dim] (fp32, zeroed),
// the other chunks' sums into partial_out [.., dim].
extern "C" int repro_embedding_bag_backward_level(
    const void* src, int dim, const void* perm, long long bag_len,
    const void* weights, const void* rows, const void* items,
    const void* item_start, const void* chunks, const void* upto,
    long long n_rows, long long size, const void* at, long long k_begin,
    long long n_chunks, void* grad, void* partial_out, void* stream) {
  if (dim < 1 || n_chunks < 1 || n_rows < 1 || size < n_rows ||
      (perm != nullptr && bag_len < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = dim % 4 == 0 && aligned16(src) && aligned16(grad) &&
                   aligned16(partial_out);
  const Plan plan{static_cast<const int64_t*>(rows),
                  static_cast<const int64_t*>(items),
                  static_cast<const int64_t*>(item_start),
                  static_cast<const int64_t*>(chunks),
                  static_cast<const int64_t*>(upto), n_rows, size};
  const LevelArgs a{static_cast<const float*>(src), dim,
                    static_cast<const int64_t*>(perm), bag_len,
                    static_cast<const float*>(weights), plan,
                    static_cast<const int64_t*>(at), k_begin, n_chunks,
                    static_cast<float*>(grad),
                    static_cast<float*>(partial_out)};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.perm != nullptr)
    err = vec ? launch_level<4, true>(a, s) : launch_level<1, true>(a, s);
  else
    err = vec ? launch_level<4, false>(a, s) : launch_level<1, false>(a, s);
  return static_cast<int>(err);
}
