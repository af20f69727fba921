// Factorization-machine second-order term on Hopper (sm_90a): the kernel
// behind repro_torch.kernels.fused_fm, the port of the JAX package's Pallas
// kernel src/repro/kernels/fused_fm.py::fused_fm (_fm_kernel).  Built with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_fm.so fused_fm.cu
//
// and bound with ctypes: a plain C interface, pointers and the stream as
// void*, no PyTorch headers (async_copy.cuh holds the PTX of the bulk copy
// and its barrier).  The entry point returns cudaGetLastError().
//
// For each sample b of emb [B, F, D] (fp32 or bf16, contiguous):
//
//   out[b] = 0.5 * sum_d [ (sum_f x[b,f,d])^2 - sum_f x[b,f,d]^2 ]
//
// accumulated in fp32 whatever the input type; only out [B] fp32 is written.
//
// Bound: bytes.  Each input element is read once and used for one add and
// one fused multiply-add, so at DeepFM's [512, 39, 10] fp32 the kernel moves
// 800,768 B (0.24 us at the 3.35 TB/s of an H100 SXM's data sheet, 700 W)
// and a single round trip to device memory is most of its time; at
// [262144, 39, 10] it reads 409 MB and the memory rate is the limit.
//
// Design: a streaming reduction over whole sample tiles.  A tile is S
// consecutive samples, one contiguous span of S*F*D elements.  The wrapper
// (kernels/fused_fm.py, plan()) picks S, the branch, the block and the grid
// from the shape; the kernel reads them from its parameters.
//
// * bulk branch (fm_bulk_kernel): one thread brings a whole tile into shared
//   memory with one 1-D bulk async copy (cp.async.bulk) completing on an
//   mbarrier, so a tile costs one round trip whatever F and D are.  A
//   persistent grid of a few blocks an SM walks the tiles through a ring of
//   kStages stages: tile t+1 lands while tile t is summed.  A bulk copy
//   takes 16 B aligned addresses and a multiple of 16 B, so the wrapper
//   picks S with S*F*D*sizeof(T) % 16 == 0 and takes this branch only for a
//   16 B aligned tensor; the batch's last tile may end off a 16 B boundary,
//   and its last < 16 B come by plain loads.
// * loads branch (fm_loads_kernel): what the bulk copy cannot take (a base
//   off 16 B, a tile of a multiple of 16 B larger than a stage).  The block
//   stages the tile's span by coalesced loads, 16 B where aligned and scalar
//   at the ragged head and tail, then sums the same way.  A sample larger
//   than the branch's buffer is not staged: the block (one sample a tile)
//   sums it where it lies, with the same loop.
//
// Sums: a sample's D columns are shared by `lanes` threads (the least power
// of two >= D, at most 32), thread g taking d = g, g + lanes, ...; each sums
// its column's F values from shared memory in field order with the square
// in the same loop (the order of the plain version and of the earlier
// one-warp-a-sample kernel), and the lanes' partial terms meet in a warp
// shuffle.  Unlike the TPU kernel, which tiles the batch into block_b rows
// and needs B % block_b == 0, any B, F and D are taken with no padding.

// Backward (fused_fm_backward_kernel, repro_fused_fm_backward): the JAX
// package has no gradient kernel (it differentiates its jnp oracle); this one
// is new.  Given g [B] fp32, the gradient of out, it writes
//
//   grad[b,f,d] = g[b] * (sum_f' x[b,f',d] - x[b,f,d])
//
// in emb's type, the sums in fp32.  Bound: bytes, x read once and grad
// written once (204.7 MB at DeepFM's training batch [65536, 39, 10] fp32,
// 0.0611 ms at 3.35 TB/s).  A block takes one tile of whole samples, staged
// by one bulk copy where every tile starts on 16 B (as the forward's bulk
// branch stages it), else read where it lies; it sums each column once into
// shared memory, then writes the tile's span with consecutive threads on
// consecutive elements.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;
constexpr int kStages = 2;                 // STAGES in kernels/fused_fm.py
constexpr int kMaxSmem = 48 * 1024;        // no opt-in attribute needed

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The FM terms of the n <= tile samples staged at x ([n, F, D]), written
// to out[0, n).  blockDim.x is a multiple of 32 and lanes divides 32, so
// every warp takes part in every shuffle; the pass count is the block's.
template <typename T>
__device__ __forceinline__ void tile_terms(const T* x, int n, int tile,
                                           int fields, int dim, int lanes,
                                           float* __restrict__ out) {
  const int per_pass = blockDim.x / lanes;
  const int g = threadIdx.x % lanes;
  const int64_t sample = static_cast<int64_t>(fields) * dim;
  for (int s0 = 0; s0 < tile; s0 += per_pass) {
    const int s = s0 + threadIdx.x / lanes;
    float part = 0.f;
    if (s < n) {
      const T* xs = x + s * sample;
      for (int d = g; d < dim; d += lanes) {
        float sum = 0.f, sq = 0.f;
#pragma unroll 8
        for (int f = 0; f < fields; ++f) {           // field order
          const float v = to_f32(xs[static_cast<int64_t>(f) * dim + d]);
          sum += v;
          sq = fmaf(v, v, sq);
        }
        part += sum * sum - sq;
      }
    }
    for (int off = lanes / 2; off > 0; off /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (g == 0 && s < n) out[s] = 0.5f * part;
  }
}

// Orders this thread's generic-proxy accesses of shared memory before a
// later bulk copy (async proxy) into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// bulk branch: whole tiles by one bulk copy each, a ring of kStages stages
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_fm_bulk_kernel(const T* __restrict__ emb, float* __restrict__ out,
                     int64_t batch, int fields, int dim, int tile, int lanes,
                     uint32_t stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int64_t sample = static_cast<int64_t>(fields) * dim;
  const int64_t n_tiles = (batch + tile - 1) / tile;
  auto stage = [&](int k) {
    return reinterpret_cast<T*>(smem + k * stage_bytes);
  };
  auto samples_in = [&](int64_t t) {
    const int64_t left = batch - t * tile;
    return static_cast<int>(left < tile ? left : tile);
  };
  // thread 0: tile t's whole 16 B into stage k, announced before issued
  auto issue = [&](int64_t t, int k) {
    const uint64_t bytes = static_cast<uint64_t>(samples_in(t)) * sample *
                           sizeof(T);
    const uint32_t whole = static_cast<uint32_t>(bytes & ~uint64_t{15});
    bulk::arrive_expect_tx(&full[k], whole);     // 0 bytes: a plain arrival
    if (whole > 0)
      bulk::copy(stage(k), emb + t * tile * sample, whole, &full[k]);
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < kStages; ++k) bulk::barrier_init(&full[k], 1);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < kStages; ++k) {
      const int64_t t = blockIdx.x + static_cast<int64_t>(k) * gridDim.x;
      if (t < n_tiles) issue(t, k);
    }
  int use = 0;                                   // this block's tiles so far
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++use) {
    const int k = use % kStages;
    bulk::wait(&full[k], (use / kStages) & 1);
    const int n = samples_in(t);
    const int64_t elems = n * sample;
    const int64_t whole = static_cast<int64_t>(
        (static_cast<uint64_t>(elems) * sizeof(T)) & ~uint64_t{15}) /
        static_cast<int64_t>(sizeof(T));
    if (whole < elems) {             // the batch's last < 16 B (uniform)
      const T* src = emb + t * tile * sample;
      for (int64_t i = whole + threadIdx.x; i < elems; i += blockDim.x)
        stage(k)[i] = src[i];
      __syncthreads();
    }
    tile_terms(stage(k), n, tile, fields, dim, lanes, out + t * tile);
    fence_proxy_async();
    __syncthreads();                 // every thread is done with stage k
    const int64_t next = t + static_cast<int64_t>(kStages) * gridDim.x;
    if (threadIdx.x == 0 && next < n_tiles) issue(next, k);
  }
}

// ---------------------------------------------------------------------------
// loads branch: the tile's span by coalesced loads
// ---------------------------------------------------------------------------

// Copies n elements from src to shared memory at buf (16 B aligned, room
// for n elements and 16 B more): the elements before src's first 16 B
// boundary and after its last one by scalar loads, the rest 16 B at a
// time.  Returns where the span starts in buf (src's offset in its 16 B).
template <typename T>
__device__ __forceinline__ T* copy_span(T* buf, const T* __restrict__ src,
                                        int64_t n) {
  constexpr int kVec = 16 / sizeof(T);
  const uint32_t mis = static_cast<uint32_t>(
      reinterpret_cast<uintptr_t>(src) & 15u);
  T* x = buf + mis / sizeof(T);                  // x and src agree mod 16 B
  int64_t head = ((16u - mis) & 15u) / sizeof(T);
  if (head > n) head = n;
  const int64_t vecs = (n - head) / kVec;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) x[i] = src[i];
  const uint4* s = reinterpret_cast<const uint4*>(src + head);
  uint4* d = reinterpret_cast<uint4*>(x + head);
  for (int64_t v = threadIdx.x; v < vecs; v += blockDim.x) d[v] = s[v];
  for (int64_t i = head + vecs * kVec + threadIdx.x; i < n; i += blockDim.x)
    x[i] = src[i];
  return x;
}

// staged: tiles through the shared-memory buffer; else (a sample larger
// than the buffer) the sums read the tile where it lies.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_fm_loads_kernel(const T* __restrict__ emb, float* __restrict__ out,
                      int64_t batch, int fields, int dim, int tile,
                      int lanes, bool staged) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  const int64_t sample = static_cast<int64_t>(fields) * dim;
  const int64_t n_tiles = (batch + tile - 1) / tile;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const T* src = emb + t * tile * sample;
    const int64_t left = batch - t * tile;
    const int n = static_cast<int>(left < tile ? left : tile);
    const T* x = staged ? copy_span(buf, src, n * sample) : src;
    __syncthreads();
    tile_terms(x, n, tile, fields, dim, lanes, out + t * tile);
    __syncthreads();                 // the buffer is free for the next tile
  }
}

// ---------------------------------------------------------------------------
// backward: grad[b,f,d] = g[b] * (sum_f' x[b,f',d] - x[b,f,d])
// ---------------------------------------------------------------------------
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One block a tile of `tile` whole samples (the grid covers the batch, one
// tile a block).  staged: the tile's span lands in shared memory by one
// bulk copy (the wrapper guarantees a 16 B aligned start for every tile),
// its last < 16 B by plain loads; else the tile is read where it lies.
// Then each (sample, column) sum over the fields, in field order, goes to
// shared memory, and the block writes the tile's gradient element by
// element, consecutive threads on consecutive elements.  Index arithmetic
// is 32-bit: the wrapper keeps tile * F * D below 2^31.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_fm_backward_kernel(const T* __restrict__ emb,
                         const float* __restrict__ g, T* __restrict__ grad,
                         int64_t batch, int fields, int dim, int tile,
                         uint32_t sums_bytes, bool staged) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full;
  float* sums = reinterpret_cast<float*>(smem);              // [tile, dim]
  T* buf = reinterpret_cast<T*>(smem + sums_bytes);          // 16 B aligned
  const int sample = fields * dim;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t left = batch - first;
  const int n = static_cast<int>(left < tile ? left : tile);
  const int elems = n * sample;
  const T* src = emb + first * sample;
  const T* x = src;
  if (staged) {
    const uint32_t whole = static_cast<uint32_t>(
        (static_cast<uint64_t>(elems) * sizeof(T)) & ~uint64_t{15});
    if (threadIdx.x == 0) bulk::barrier_init(&full, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk::arrive_expect_tx(&full, whole);      // 0 bytes: a plain arrival
      if (whole > 0) bulk::copy(buf, src, whole, &full);
    }
    for (int i = static_cast<int>(whole / sizeof(T)) + threadIdx.x;
         i < elems; i += blockDim.x)
      buf[i] = src[i];
    bulk::wait(&full, 0);
    __syncthreads();                             // the tail loads, too
    x = buf;
  }
  for (int p = threadIdx.x; p < n * dim; p += blockDim.x) {
    const T* xs = x + (p / dim) * sample + p % dim;
    float sum = 0.f;
#pragma unroll 8
    for (int f = 0; f < fields; ++f) sum += to_f32(xs[f * dim]);
    sums[p] = sum;
  }
  __syncthreads();
  T* out = grad + first * sample;
  for (int i = threadIdx.x; i < elems; i += blockDim.x) {
    const int s = i / sample;
    put(out + i, g[first + s] * (sums[s * dim + i % dim] - to_f32(x[i])));
  }
}

bool pow2_at_most_32(int x) { return x >= 1 && x <= kWarp && !(x & (x - 1)); }

template <typename T>
int launch(const void* emb, void* out, long long batch, int fields, int dim,
           int branch, int tile, int lanes, int threads, int blocks,
           int smem_bytes, cudaStream_t s) {
  const auto* x = static_cast<const T*>(emb);
  auto* o = static_cast<float*>(out);
  if (branch == 0) {
    fused_fm_bulk_kernel<T><<<blocks, threads, smem_bytes, s>>>(
        x, o, batch, fields, dim, tile, lanes,
        static_cast<uint32_t>(smem_bytes / kStages));
  } else {
    fused_fm_loads_kernel<T><<<blocks, threads, smem_bytes, s>>>(
        x, o, batch, fields, dim, tile, lanes, smem_bytes > 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  batch >= 1; fields, dim >= 0.  The
// rest is the wrapper's plan (kernels/fused_fm.py, plan()): branch 0 = bulk,
// 1 = loads; tile = S samples; lanes per sample; the block, the grid and
// the dynamic shared memory (for bulk, kStages stages of a multiple of 16 B
// each; for loads, the buffer, or 0 to sum one sample a tile in place).
extern "C" int repro_fused_fm(const void* emb, int dtype, void* out,
                              long long batch, int fields, int dim,
                              int branch, int tile, int lanes, int threads,
                              int blocks, int smem_bytes, void* stream) {
  if (batch < 1 || tile < 1 || blocks < 1 || !pow2_at_most_32(lanes) ||
      threads < kWarp || threads > kMaxThreads || threads % kWarp ||
      smem_bytes < 0 || smem_bytes > kMaxSmem ||
      (branch == 0 && (smem_bytes < 16 * kStages ||
                       smem_bytes % (16 * kStages))) ||
      (branch == 1 && (smem_bytes == 0 ? tile != 1 : smem_bytes < 16)) ||
      (branch != 0 && branch != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(emb, out, batch, fields, dim, branch, tile, lanes,
                         threads, blocks, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(emb, out, batch, fields, dim, branch, tile,
                                 lanes, threads, blocks, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of repro_fused_fm: emb [B, F, D] (dtype as above), g [B]
// fp32 -> grad [B, F, D] of emb's type.  batch, fields, dim >= 1.  The rest
// is the wrapper's plan (kernels/fused_fm.py, backward_plan()): tiles of
// `tile` samples, one a block, `blocks` of them covering the batch;
// `threads` a block; dynamic shared memory of `sums_bytes` (tile * D fp32,
// rounded up to 16 B) plus, when staged, the tile's span rounded up to
// 16 B; at most 48 KB less 16 B, beside the kernel's static barrier.
extern "C" int repro_fused_fm_backward(const void* emb, int dtype,
                                       const void* g, void* grad,
                                       long long batch, int fields, int dim,
                                       int tile, int threads, int blocks,
                                       int sums_bytes, int smem_bytes,
                                       int staged, void* stream) {
  if (batch < 1 || fields < 1 || dim < 1 || tile < 1 || blocks < 1 ||
      static_cast<long long>(blocks) * tile < batch ||
      static_cast<long long>(tile) * fields * dim >= (1ll << 31) ||
      threads < kWarp || threads > kMaxThreads || threads % kWarp ||
      sums_bytes < 4ll * tile * dim || sums_bytes % 16 ||
      smem_bytes < sums_bytes || smem_bytes > kMaxSmem - 16 ||
      (staged != 0 && staged != 1) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    fused_fm_backward_kernel<float><<<blocks, threads, smem_bytes, s>>>(
        static_cast<const float*>(emb), static_cast<const float*>(g),
        static_cast<float*>(grad), batch, fields, dim, tile,
        static_cast<uint32_t>(sums_bytes), staged != 0);
  else
    fused_fm_backward_kernel<__nv_bfloat16>
        <<<blocks, threads, smem_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(emb),
            static_cast<const float*>(g), static_cast<__nv_bfloat16*>(grad),
            batch, fields, dim, tile, static_cast<uint32_t>(sums_bytes),
            staged != 0);
  return static_cast<int>(cudaGetLastError());
}
