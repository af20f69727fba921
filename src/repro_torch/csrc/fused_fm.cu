// Factorization-machine second-order term on Hopper (sm_90a): the kernel
// behind repro_torch.kernels.fused_fm, the port of the JAX package's Pallas
// kernel src/repro/kernels/fused_fm.py::fused_fm (_fm_kernel).  Built with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_fm.so fused_fm.cu
//
// and bound with ctypes: a plain C interface, pointers and the stream as
// void*, no PyTorch headers.  The entry point returns cudaGetLastError().
//
// For each sample b of emb [B, F, D] (fp32 or bf16, contiguous):
//
//   out[b] = 0.5 * sum_d [ (sum_f x[b,f,d])^2 - sum_f x[b,f,d]^2 ]
//
// accumulated in fp32 whatever the input type.  The squares and the [B, D]
// sums stay in registers; only out [B] fp32 is written.
//
// Bound: bytes.  Each input element is read once and used for one add and
// one fused multiply-add, so at DeepFM's [512, 39, 10] fp32 the kernel moves
// 800,768 B (0.24 us at the 3.35 TB/s of an H100 SXM's data sheet, 700 W)
// and is launch-bound; at [262144, 39, 10] it reads 409 MB and the memory
// rate is the limit.
//
// Layout: one warp per sample.  Lane l owns d = l, l + 32, ... and walks the
// F fields in order, keeping (sum, sum of squares) for its d in registers;
// the lanes' partial terms meet in a warp-shuffle reduction.  Unlike the TPU
// kernel, which tiles the batch into block_b rows and needs B % block_b == 0,
// a warp past B returns at once, so any B, F and D are taken.  For D = 10
// only 10 of 32 lanes load; packing several samples into a warp is for a
// later change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;          // 8 samples per 256-thread block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
fused_fm_kernel(const T* __restrict__ emb, float* __restrict__ out,
                int64_t batch, int fields, int dim) {
  const int lane = threadIdx.x % kWarp;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  if (b >= batch) return;                  // the whole warp leaves together
  const T* x = emb + b * fields * dim;
  float part = 0.f;
  for (int d = lane; d < dim; d += kWarp) {
    float s = 0.f, ss = 0.f;
#pragma unroll 4
    for (int f = 0; f < fields; ++f) {
      const float v = to_f32(x[static_cast<int64_t>(f) * dim + d]);
      s += v;
      ss = fmaf(v, v, ss);
    }
    part += s * s - ss;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if (lane == 0) out[b] = 0.5f * part;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  batch >= 1; fields, dim >= 0.
extern "C" int repro_fused_fm(const void* emb, int dtype, void* out,
                              long long batch, int fields, int dim,
                              void* stream) {
  const int threads = kWarp * kWarpsPerBlock;
  const long long blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (dtype == 0) {
    fused_fm_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const float*>(emb), o, batch, fields, dim);
  } else if (dtype == 1) {
    fused_fm_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), threads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(emb), o, batch, fields, dim);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
