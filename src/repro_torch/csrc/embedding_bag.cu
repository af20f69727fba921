// EmbeddingBag on Hopper (sm_90a): the kernel behind
// repro_torch.kernels.embedding_bag, the port of the JAX package's Pallas
// kernel src/repro/kernels/embedding_bag.py::embedding_bag (_bag_kernel).
// Built with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libembedding_bag.so embedding_bag.cu
//
// and bound with ctypes: a plain C interface, pointers and the stream as
// void*, no PyTorch headers.  The entry point returns cudaGetLastError().
//
// For each bag b of indices [B, L] (int32, negative = padding) over a table
// [V, D] (fp32 or bf16, contiguous), with optional fp32 weights [B, L]:
//
//   sum:  out[b, :] = sum_{j: idx >= 0} w[b, j] * table[idx[b, j], :]
//   mean: the same divided by max(count of valid entries, 1)
//
// accumulated in fp32 registers and written once as fp32 [B, D].  A fully
// padded bag (or L = 0) gives zeros; an id >= V makes its whole bag NaN, as
// jnp.take's fill mode does in the JAX package's oracle (the row itself is
// never read).
//
// Bound: bytes.  Every valid entry reads one row of D elements and does D
// fused multiply-adds on it, so the arithmetic is nothing beside the
// reads.  At two-tower's serve_p99 request ([512, 50] over 10M x 256 fp32,
// ~13k valid entries, zipf ids) the rows are ~13 MB, a few microseconds at
// the 3.35 TB/s of an H100 SXM's data sheet (700 W): the kernel is
// latency-bound.  At serve_bulk ([262144, 50]) it reads gigabytes and the
// memory rate is the limit.
//
// Layout: one block per bag, its threads striding over D with 16-byte
// loads of 4 fp32 (8 bytes of 4 bf16) when D % 4 == 0 and the table is
// aligned for them, else one element a thread.  Each thread walks the bag's
// ids kUnroll at a time, issuing those rows' loads before it adds any of
// them, so several independent reads are in flight per thread: this stands
// in for the TPU kernel's 2-slot DMA ring.  Row offsets are 64-bit
// (int64_t(row) * D): the published item table has 2.56e9 elements, past
// what a 32-bit index reaches.  Unlike the TPU kernel, which tiles
// bags_per_block bags per grid step and needs B % bags_per_block == 0, a
// grid of B blocks takes any B with no padding copy.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kUnroll = 4;          // rows in flight per thread
constexpr int kMaxThreads = 256;

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

template <typename T>
void dispatch(const void* table, long long vocab, int dim,
              const void* indices, const void* weights, long long batch,
              int bag_len, int mean, void* out, cudaStream_t stream) {
  // vector loads need D % 4 == 0 and the table aligned to 4 elements
  const bool vec = dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % (4 * sizeof(T)) == 0;
  if (vec) {
    launch<T, 4>(table, vocab, dim, indices, weights, batch, bag_len, mean,
                 out, stream);
  } else {
    launch<T, 1>(table, vocab, dim, indices, weights, batch, bag_len, mean,
                 out, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 = sum, 1 = mean.  weights may
// be null.  batch in [1, 2^31 - 1], dim >= 1, bag_len >= 0.
extern "C" int repro_embedding_bag(const void* table, int dtype,
                                   long long vocab, int dim,
                                   const void* indices, const void* weights,
                                   long long batch, int bag_len, int mode,
                                   void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch<float>(table, vocab, dim, indices, weights, batch, bag_len,
                    mode, out, s);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16>(table, vocab, dim, indices, weights, batch,
                            bag_len, mode, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
