// The GraphSAGE neighbour sum on Hopper (sm_90a): the kernel behind
// repro_torch.kernels.segment_sum, used forward and backward by the
// neighbour mean of models/gnn.py.  It replaces no TPU kernel: the JAX
// package computes the mean in plain jnp outside any Pallas kernel,
// jnp.take(h, src) then jax.ops.segment_sum(msgs, dst) / deg
// (src/repro/models/gnn.py::sage_full_graph) and a per-graph .at[gi, dst]
// .add (sage_molecule), which XLA lowers to a gather and a scatter-add.
// Ported word for word (index_select, index_add_) that builds an [E, D]
// message tensor a layer (61,859,140 x 128 fp32 = 31.7 GB at ogbn-products)
// and sums by float atomics in an order that changes from run to run.
// Built with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsegment_sum.so segment_sum.cu
//
// and bound with ctypes: a plain C interface, pointers and the stream as
// void*, no PyTorch headers.  The entry point returns cudaGetLastError().
//
// For each row r of a CSR (indptr [R + 1] int64, indices [nnz] int32) over
// x [N, D] (fp32, contiguous):
//
//   out[r, :] = sum_{j in [indptr[r], indptr[r + 1])} x[indices[j], :]
//
// summed from +0.0f in j order, one __fadd_rn a term, and written once as
// fp32 [R, D]; an empty segment gives 0.  The wrapper builds the CSR by a
// stable sort of the destinations, so within a segment j runs in edge
// order, the order in which a sequential scatter adds; the backward runs
// the same kernel over the transposed CSR.  No atomics and no [E, D]
// intermediate, so two launches on the same inputs give the same bits,
// and kernels/ref.csr_sum (the same adds, a position of every segment at a
// time) gives them too.
//
// Bound: bytes.  Every term reads a row of D floats and adds it, so the
// adds (nnz x D, 6.2e9 at ogbn-products' first layer) are far below the
// bytes (the distinct rows of x, the indices, indptr and out: ~2.2 GB
// there, ~0.66 ms at the 3.35 TB/s of an H100 SXM's data sheet).
//
// Design, a simple one: one warp a row, its lanes splitting the D columns
// (16 bytes of 4 floats a lane where D % 4 == 0 and x and out are 16 B
// aligned, else 4 floats a lane at a 32-column stride), 128 columns a pass
// (D = 100 and 128 in one pass, 1,433 in twelve).  The warp reads 32 of the
// segment's indices at once, one a lane, broadcasts each by a shuffle and
// issues kUnroll rows' loads before it adds any of them, in order.  Row
// offsets are 64-bit.  Not yet done (later work): staging hub rows,
// cp.async, balancing the transposed CSR's long source segments.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;           // warps (rows) a block
constexpr int kUnroll = 4;          // rows in flight a lane
constexpr int kCols = 4;            // floats a lane a pass
constexpr int kPass = 32 * kCols;   // columns a pass

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
csr_sum_kernel(const float* __restrict__ x, int dim,
               const int64_t* __restrict__ indptr,
               const int32_t* __restrict__ indices, long long n_rows,
               float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;                  // warp-uniform
  const int64_t begin = indptr[row], end = indptr[row + 1];
  for (int c0 = 0; c0 < dim; c0 += kPass) {
    // this lane's columns: kVec, c0 + 4 lane .. + 3; else c0 + lane + 32 k
    const int cv = c0 + kCols * lane;
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t base = begin; base < end; base += 32) {
      const int64_t rest = end - base;
      const int n = rest < 32 ? static_cast<int>(rest) : 32;
      const int32_t mine = lane < n ? indices[base + lane] : 0;
      for (int t = 0; t < n; t += kUnroll) {
        float v[kUnroll][kCols];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int src = __shfl_sync(0xffffffffu, mine, (t + u) & 31);
          const float* rowp = x + static_cast<int64_t>(src) * dim;
#pragma unroll
          for (int k = 0; k < kCols; ++k) v[u][k] = 0.f;
          if (t + u < n) {
            if (kVec) {
              if (cv < dim) {
                const float4 f = *reinterpret_cast<const float4*>(rowp + cv);
                v[u][0] = f.x; v[u][1] = f.y; v[u][2] = f.z; v[u][3] = f.w;
              }
            } else {
#pragma unroll
              for (int k = 0; k < kCols; ++k) {
                const int c = c0 + lane + 32 * k;
                if (c < dim) v[u][k] = rowp[c];
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u < n) {            // warp-uniform: the same n everywhere
#pragma unroll
            for (int k = 0; k < kCols; ++k)
              acc[k] = __fadd_rn(acc[k], v[u][k]);
          }
        }
      }
    }
    float* o = out + row * static_cast<int64_t>(dim);
    if (kVec) {
      if (cv < dim)
        *reinterpret_cast<float4*>(o + cv) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < dim) o[c] = acc[k];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// out [n_rows, dim] (fp32) = the CSR sums of x [.., dim] (fp32), on
// `stream`; indptr int64 [n_rows + 1], indices int32 [indptr[n_rows]],
// each in [0, rows of x).  n_rows in [1, (2^31 - 1) * kWarps], dim >= 1.
// *vec is set to 1 when the 16-byte branch ran.
extern "C" int repro_csr_sum(const void* x, int dim, const void* indptr,
                             const void* indices, long long n_rows,
                             void* out, void* stream, int* vec) {
  if (dim < 1 || n_rows < 1 ||
      (n_rows + kWarps - 1) / kWarps > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v = dim % 4 == 0 && aligned16(x) && aligned16(out);
  const unsigned grid =
      static_cast<unsigned>((n_rows + kWarps - 1) / kWarps);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto ip = static_cast<const int64_t*>(indptr);
  auto jp = static_cast<const int32_t*>(indices);
  auto op = static_cast<float*>(out);
  if (v)
    csr_sum_kernel<true><<<grid, kWarps * 32, 0, s>>>(xp, dim, ip, jp,
                                                      n_rows, op);
  else
    csr_sum_kernel<false><<<grid, kWarps * 32, 0, s>>>(xp, dim, ip, jp,
                                                       n_rows, op);
  *vec = v ? 1 : 0;
  return static_cast<int>(cudaGetLastError());
}
