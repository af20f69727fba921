// NeighborHash batch probe on Hopper (sm_90a): the two hand-written kernels
// behind repro_torch.kernels.neighbor_lookup.  Built with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libprobe.so probe.cu
//
// and bound with ctypes: a plain C interface, pointers and the stream as
// void*, no PyTorch headers.  Each entry point returns cudaGetLastError().
//
// Both kernels compute exactly repro_torch.core.lookup.lookup (the masked
// advance in kernels/ref.py): hash the key to its home bucket; hit if both
// key halves match a non-empty home; miss on an empty home or, with
// host_check, on a lodger (a resident homed elsewhere); else follow the
// chain — the 12-bit signed inline offset in val_hi, or next_idx[] when the
// table keeps a side array — for at most max_probes steps.  Indices are
// clamped into [0, capacity) at each read (the reference's mode="clip"),
// while the chain position itself is carried unclamped, as the reference
// carries it.
//
// A table lives on the card in the line-packed layout of pack_lines:
// uint32 [n_lines, 4, 8], one 128 B line holding key_hi / key_lo / val_hi /
// val_lo of 8 consecutive buckets, so one probe step touches one line.
//
// A launch probes a group of tables (one engine shard) at once: a device
// array of TableDesc, uploaded once per group, gives each table's base
// pointers and statics; the ends of the tables' query segments come by value
// in the launch's parameters, so a launch copies nothing to the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBpl = 8;                    // buckets per 128 B line
constexpr int kLineWords = 4 * kBpl;       // uint32 words per line
constexpr uint32_t kEmpty = 0xFFFFFFFFu;   // both halves of EMPTY_KEY
constexpr uint32_t kPayloadHiMask = 0xFFFFFu;
constexpr int kLinesThreads = 256;
constexpr int kSmemThreads = 1024;
constexpr int kMaxTables = 64;             // MAX_TABLES in neighbor_lookup.py
constexpr int kSmemLimit = 232448;         // SMEM_LIMIT: 227 KB per block

// One row of the descriptor array; the field order is DESC_FIELDS in
// kernels/neighbor_lookup.py.
struct TableDesc {
  const uint32_t* lines;       // [n_lines, 4, kBpl] in device memory
  const int32_t* next_idx;     // [capacity], or null for inline offsets
  int64_t capacity;
  int64_t home_capacity;
  int64_t max_probes;
  int64_t host_check;          // 1: lodger check at the home bucket
  int64_t smem_lines;          // probe_smem: word offset of the lines
  int64_t smem_next;           // probe_smem: word offset of next_idx, or -1
  int64_t n_lines;
};
static_assert(sizeof(TableDesc) == 72, "TableDesc must be 9 words");

// Table t answers queries [end[t-1], end[t]) (end[-1] = 0); passed by value.
struct Segments {
  int64_t end[kMaxTables];
};

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash64(uint32_t hi, uint32_t lo) {
  return mix32(mix32(lo ^ 0x9E3779B9u) ^ hi);
}

struct Bucket {
  uint32_t khi, klo, vhi, vlo;
};

__device__ __forceinline__ int64_t clip(int64_t idx, int64_t capacity) {
  return idx < 0 ? 0 : (idx >= capacity ? capacity - 1 : idx);
}

// The four words of bucket `idx` (clamped) from a line-packed table, which
// may lie in device memory or in shared memory (generic addressing).
__device__ __forceinline__ Bucket read_bucket(const uint32_t* lines,
                                              int64_t idx, int64_t capacity) {
  const int64_t b = clip(idx, capacity);
  const uint32_t* w = lines + (b / kBpl) * kLineWords + (b % kBpl);
  return {w[0], w[kBpl], w[2 * kBpl], w[3 * kBpl]};
}

// One query against one table: writes found / payload_hi (20 bits) /
// payload_lo, all zero on a miss.
__device__ __forceinline__ void probe_one(
    const uint32_t* lines, const int32_t* next_idx, int64_t capacity,
    uint32_t home_capacity, int64_t max_probes, bool host_check,
    uint32_t qh, uint32_t ql, uint32_t* found, uint32_t* p_hi,
    uint32_t* p_lo) {
  const int64_t home = hash64(qh, ql) % home_capacity;
  Bucket k = read_bucket(lines, home, capacity);
  const bool empty = k.khi == kEmpty && k.klo == kEmpty;
  bool hit = !empty && k.khi == qh && k.klo == ql;
  bool active = !empty && !hit;
  if (active && host_check)
    active = hash64(k.khi, k.klo) % home_capacity == home;
  int64_t idx = home;
  for (int64_t step = 0; active && step < max_probes; ++step) {
    int64_t nxt;
    if (next_idx == nullptr) {
      const int32_t code = static_cast<int32_t>((k.vhi >> 20) & 0xFFFu);
      const int32_t off = (code ^ 0x800) - 0x800;   // sign-extend 12 bits
      if (off == 0) break;                          // end of chain
      nxt = idx + off;
    } else {
      nxt = next_idx[clip(idx, capacity)];
      if (nxt < 0) break;
    }
    idx = nxt;
    k = read_bucket(lines, idx, capacity);
    hit = k.khi == qh && k.klo == ql;
    active = !hit;
  }
  *found = hit ? 1u : 0u;
  *p_hi = hit ? (k.vhi & kPayloadHiMask) : 0u;
  *p_lo = hit ? k.vlo : 0u;
}

// Which table owns query i: the segments are contiguous and ascending.
__device__ __forceinline__ int table_of(const Segments& seg, int n_tables,
                                        int64_t i) {
  int t = 0;
  while (t < n_tables && i >= seg.end[t]) ++t;
  return t;
}

// ---------------------------------------------------------------------------
// probe_lines — replaces the TPU kernel lookup_amac
// (src/repro/kernels/neighbor_lookup.py:235, body _amac_kernel at :130).
//
// Bound: random 128 B line reads from HBM (or L2 for tables under 50 MB),
// one per probe step, each a dependent load: latency, not bandwidth, is what
// one query waits on.  The TPU kernel hid that latency with a ring of
// n_slots in-flight line DMAs per core.  Here each thread owns one query and
// the card keeps many warps resident on every SM, so the scheduler hides one
// warp's outstanding line behind other warps' independent probes — the
// hardware plays AMAC's ring.  Small blocks and no shared memory keep
// occupancy high, so as many lines as possible are in flight.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kLinesThreads) probe_lines_kernel(
    const TableDesc* __restrict__ desc, int n_tables, const Segments seg,
    const uint32_t* __restrict__ q_hi, const uint32_t* __restrict__ q_lo,
    uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  uint32_t* found = out + i;
  uint32_t* p_hi = out + n + i;
  uint32_t* p_lo = out + 2 * n + i;
  const int t = table_of(seg, n_tables, i);
  if (t == n_tables) {               // padding past the last segment
    *found = *p_hi = *p_lo = 0u;
    return;
  }
  const TableDesc& d = desc[t];
  probe_one(d.lines, d.next_idx, d.capacity,
            static_cast<uint32_t>(d.home_capacity), d.max_probes,
            d.host_check != 0, q_hi[i], q_lo[i], found, p_hi, p_lo);
}

// ---------------------------------------------------------------------------
// probe_smem — replaces the TPU kernel lookup_vec
// (src/repro/kernels/neighbor_lookup.py:106, body _vec_kernel at :59).
//
// Bound: the same dependent bucket reads, but from shared memory once the
// group's tables (at most 227 KB) are staged: each persistent block copies
// every table of the group into dynamic shared memory once, with 16 B
// vector loads, then strides over the batch.  Probe steps then cost
// shared-memory latency instead of an L2/HBM round trip; the staging copy
// (the group's bytes, once per block) is the price, so the grid stays at
// most one block per SM.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kSmemThreads) probe_smem_kernel(
    const TableDesc* __restrict__ desc, int n_tables, const Segments seg,
    const uint32_t* __restrict__ q_hi, const uint32_t* __restrict__ q_lo,
    uint32_t* __restrict__ out, int64_t n) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  for (int t = 0; t < n_tables; ++t) {
    const TableDesc& d = desc[t];
    const uint4* src = reinterpret_cast<const uint4*>(d.lines);
    uint4* dst = reinterpret_cast<uint4*>(smem + d.smem_lines);
    const int64_t n16 = d.n_lines * (kLineWords / 4);
    for (int64_t w = threadIdx.x; w < n16; w += blockDim.x) dst[w] = src[w];
    if (d.next_idx != nullptr) {
      int32_t* nd = reinterpret_cast<int32_t*>(smem + d.smem_next);
      for (int64_t w = threadIdx.x; w < d.capacity; w += blockDim.x)
        nd[w] = d.next_idx[w];
    }
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    uint32_t* found = out + i;
    uint32_t* p_hi = out + n + i;
    uint32_t* p_lo = out + 2 * n + i;
    const int t = table_of(seg, n_tables, i);
    if (t == n_tables) {
      *found = *p_hi = *p_lo = 0u;
      continue;
    }
    const TableDesc& d = desc[t];
    const int32_t* next = d.next_idx == nullptr
        ? nullptr
        : reinterpret_cast<const int32_t*>(smem + d.smem_next);
    probe_one(smem + d.smem_lines, next, d.capacity,
              static_cast<uint32_t>(d.home_capacity), d.max_probes,
              d.host_check != 0, q_hi[i], q_lo[i], found, p_hi, p_lo);
  }
}

Segments segments(const long long* seg_end, int n_tables) {
  Segments s{};
  for (int t = 0; t < n_tables && t < kMaxTables; ++t) s.end[t] = seg_end[t];
  return s;
}

}  // namespace

// desc: device TableDesc[n_tables]; seg_end: HOST int64[n_tables], the end
// of each table's query segment; out: uint32 [3, n] (found, payload_hi,
// payload_lo).  n_tables <= kMaxTables (the wrapper checks).
extern "C" int repro_probe_lines(const void* desc, int n_tables,
                                 const long long* seg_end, const void* q_hi,
                                 const void* q_lo, void* out, long long n,
                                 void* stream) {
  const long long blocks = (n + kLinesThreads - 1) / kLinesThreads;
  probe_lines_kernel<<<static_cast<unsigned>(blocks), kLinesThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TableDesc*>(desc), n_tables,
      segments(seg_end, n_tables), static_cast<const uint32_t*>(q_hi),
      static_cast<const uint32_t*>(q_lo), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Once per device, before probe_smem's first launch there: lets the kernel
// take up to kSmemLimit bytes of dynamic shared memory and returns the
// device's SM count (the grid bound) in *n_sm, so a launch queries nothing.
extern "C" int repro_probe_init(int* n_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(probe_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
  return static_cast<int>(err);
}

// smem_bytes <= kSmemLimit: the group's staged size; n_sm from
// repro_probe_init on this device.
extern "C" int repro_probe_smem(const void* desc, int n_tables,
                                const long long* seg_end,
                                long long smem_bytes, int n_sm,
                                const void* q_hi, const void* q_lo, void* out,
                                long long n, void* stream) {
  long long blocks = (n + kSmemThreads - 1) / kSmemThreads;
  if (blocks > n_sm) blocks = n_sm;
  probe_smem_kernel<<<static_cast<unsigned>(blocks), kSmemThreads,
                      static_cast<size_t>(smem_bytes),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TableDesc*>(desc), n_tables,
      segments(seg_end, n_tables), static_cast<const uint32_t*>(q_hi),
      static_cast<const uint32_t*>(q_lo), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
