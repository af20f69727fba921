// NeighborHash batch probe on Hopper (sm_90a): the two hand-written kernels
// behind repro_torch.kernels.neighbor_lookup, the RA gather that the paper
// holds the probe's throughput against, and the paper's two baselines: the
// linear-probing lookup (Table 1) and the sequential, one-query-at-a-time
// probe (Fig. 9).  Built with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libprobe.so probe.cu
//
// and bound with ctypes: a plain C interface, pointers and the stream as
// void*, no PyTorch headers (async_copy.cuh holds the PTX of the async
// copies and barriers).  Each entry point returns cudaGetLastError().
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

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBpl = 8;                    // buckets per 128 B line
constexpr int kLineWords = 4 * kBpl;       // uint32 words per line
constexpr uint32_t kEmpty = 0xFFFFFFFFu;   // both halves of EMPTY_KEY
constexpr uint32_t kPayloadHiMask = 0xFFFFFu;
constexpr int kLinesThreads = 256;
constexpr int kSmemThreads = 256;
constexpr int kMaxTables = 64;             // MAX_TABLES in neighbor_lookup.py
constexpr int kCluster = 8;                // CLUSTER: the portable maximum
// a block's slice of a group of at most SMEM_LIMIT (227 KB) bytes
constexpr int kSliceWordsMax = 232448 / 4 / kCluster;

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

// A table as probe_lines reads it with one thread a query: line-packed in
// device memory, a bucket's four words read one by one (four 32 B sectors
// of its line).  probe_smem reads its first home bucket this way too.
struct GlobalTable {
  const uint32_t* lines;
  const int32_t* next_idx;               // null: inline offsets

  __device__ __forceinline__ bool has_next() const {
    return next_idx != nullptr;
  }
  // The four words of bucket b (in range): one line.
  __device__ __forceinline__ Bucket bucket(int64_t b) const {
    const uint32_t* w = lines + (b / kBpl) * kLineWords + (b % kBpl);
    return {w[0], w[kBpl], w[2 * kBpl], w[3 * kBpl]};
  }
  __device__ __forceinline__ int64_t next(int64_t b) const {
    return next_idx[b];
  }
};

// A table as probe_lines reads it with a group of kGroupLanes lanes a query
// (a tiled partition of the warp): the group reads the whole 128 B line a
// step, lane j holding words 4j .. 4j+3 (one 16 B load).  Word w of the
// line's [4, 8] layout is row w / 8 (key_hi, key_lo, val_hi, val_lo),
// bucket w % 8, so bucket c's word of row r is word c % 4 of lane
// 2r + c / 4.  Every lane of the group calls bucket() and next() with the
// same index, so the group stays converged and each lane assembles the same
// bucket.
constexpr int kGroupLanes = 8;           // LINE_LANES in neighbor_lookup.py
static_assert(kLineWords == 4 * kGroupLanes, "16 B a lane");

struct LineGroupTable {
  cg::thread_block_tile<kGroupLanes> group;
  const uint32_t* lines;
  const int32_t* next_idx;               // null: inline offsets
  int64_t held = -1;                     // the line the lanes hold
  uint4 words = {};                      // this lane's 16 B of it

  __device__ __forceinline__ bool has_next() const {
    return next_idx != nullptr;
  }
  // A bucket in the line held takes no load; another line, one coalesced
  // 128 B request by the group.
  __device__ __forceinline__ Bucket bucket(int64_t b) {
    const int64_t line = b / kBpl;
    if (line != held) {
      words = __ldg(reinterpret_cast<const uint4*>(lines + line * kLineWords) +
                    group.thread_rank());
      held = line;
    }
    const int c = static_cast<int>(b % kBpl);
    const int q = c & 3;                 // the same word for every row
    const uint32_t mine = q == 0   ? words.x
                          : q == 1 ? words.y
                          : q == 2 ? words.z
                                   : words.w;
    const int lane = c / 4;
    return {group.shfl(mine, lane), group.shfl(mine, 2 + lane),
            group.shfl(mine, 4 + lane), group.shfl(mine, 6 + lane)};
  }
  // One 4 B load by one lane, broadcast to the group.
  __device__ __forceinline__ int64_t next(int64_t b) {
    int32_t v = 0;
    if (group.thread_rank() == 0) v = __ldg(next_idx + b);
    return group.shfl(v, 0);
  }
};

// A table as probe_smem reads it: in the group's staged image, whose word
// w lies in the shared memory of cluster rank w / slice_words at offset
// w % slice_words.  A slice boundary falls on a line boundary, so one
// bucket's four words share a rank; map_shared_rank gives a generic
// pointer into that block's shared memory (distributed shared memory).
struct ClusterTable {
  uint32_t* slice;                       // this block's slice
  uint32_t slice_words;
  uint32_t inverse;                      // ceil(2^32 / slice_words)
  uint32_t lines_at;                     // image word offset of the lines
  int64_t next_at;                       // of next_idx, or -1

  // w / slice_words by a multiply: exact for w < 2^16 (an image holds at
  // most 58,112 words) and slice_words < 2^13
  __device__ __forceinline__ const uint32_t* word(uint32_t w) const {
    const uint32_t rank = __umulhi(w, inverse);
    return cg::this_cluster().map_shared_rank(
        slice + (w - rank * slice_words), rank);
  }
  __device__ __forceinline__ bool has_next() const { return next_at >= 0; }
  __device__ __forceinline__ Bucket bucket(int64_t b) const {
    const uint32_t* w = word(lines_at + static_cast<uint32_t>(
        (b / kBpl) * kLineWords + (b % kBpl)));
    return {w[0], w[kBpl], w[2 * kBpl], w[3 * kBpl]};
  }
  __device__ __forceinline__ int64_t next(int64_t b) const {
    return *reinterpret_cast<const int32_t*>(
        word(static_cast<uint32_t>(next_at + b)));
  }
};

// What one query's probe answers: found, payload_hi (20 bits), payload_lo,
// all zero on a miss.
struct Answer {
  uint32_t found, p_hi, p_lo;
};

// One query against one table, from its home bucket k (read wherever the
// table lies).  Every kernel's probe goes through here; a Table gives
// has_next(), bucket(b) and next(b) for an index b in range.
template <typename Table>
__device__ __forceinline__ Answer probe_from(
    Table& table, int64_t home, Bucket k, int64_t capacity,
    uint32_t home_capacity, int64_t max_probes, bool host_check,
    uint32_t qh, uint32_t ql) {
  const bool empty = k.khi == kEmpty && k.klo == kEmpty;
  bool hit = !empty && k.khi == qh && k.klo == ql;
  bool active = !empty && !hit;
  if (active && host_check)
    active = hash64(k.khi, k.klo) % home_capacity == home;
  int64_t idx = home;
  for (int64_t step = 0; active && step < max_probes; ++step) {
    int64_t nxt;
    if (!table.has_next()) {
      const int32_t code = static_cast<int32_t>((k.vhi >> 20) & 0xFFFu);
      const int32_t off = (code ^ 0x800) - 0x800;   // sign-extend 12 bits
      if (off == 0) break;                          // end of chain
      nxt = idx + off;
    } else {
      nxt = table.next(clip(idx, capacity));
      if (nxt < 0) break;
    }
    idx = nxt;
    k = table.bucket(clip(idx, capacity));
    hit = k.khi == qh && k.klo == ql;
    active = !hit;
  }
  return {hit ? 1u : 0u, hit ? (k.vhi & kPayloadHiMask) : 0u,
          hit ? k.vlo : 0u};
}

__device__ __forceinline__ int64_t home_of(uint32_t qh, uint32_t ql,
                                           uint32_t home_capacity) {
  return hash64(qh, ql) % home_capacity;
}

// One query against one table, from the start.
template <typename Table>
__device__ __forceinline__ Answer probe_one(
    Table& table, int64_t capacity, uint32_t home_capacity,
    int64_t max_probes, bool host_check, uint32_t qh, uint32_t ql) {
  const int64_t home = home_of(qh, ql, home_capacity);
  return probe_from(table, home, table.bucket(clip(home, capacity)),
                    capacity, home_capacity, max_probes, host_check, qh, ql);
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
// n_slots in-flight line DMAs per core.  Here the card keeps many warps
// resident on every SM, so the scheduler hides one query's outstanding line
// behind other queries' independent probes — the hardware plays AMAC's
// ring.  No shared memory keeps occupancy high.
//
// A small batch leaves most SMs idle and each query waits on a chain of
// dependent line reads, so there a query is probed by a group of 8 lanes
// (a tiled partition of the warp; LineGroupTable).  In each probe step
// the group loads the whole 128 B line with 16 B loads, one coalesced
// request, where a thread of its own issues four scalar loads,
// one per 32 B sector of the bucket's words; the lanes assemble the bucket
// by shuffles within the group.  A chain step to a bucket of the line
// already held takes no load at all: the paper's cacheline-aware chains put
// a home's chained keys in its line for just this.  A step to another line
// is one more request; a next_idx read is one 4 B load by the group's first
// lane, broadcast.  The group spreads the batch over 8 times as many
// blocks, so its misses queue on most SMs' load units and not on a few.
// The group's lanes share one query, so they agree on its table (table_of)
// and on every step; its first lane writes the answer.  But every lane also
// runs the query's hash, compares and chain arithmetic, so a group issues
// 8 times the instructions of one thread a query for the same loads, and
// once the batch's groups fill about 5/8 of the card's thread slots the
// probe is issue-bound: there each thread probes one query (kLanes = 1,
// GlobalTable), which keeps the most queries' lines in flight.  The
// wrapper picks kLanes, 1 or kGroupLanes, from the batch
// (neighbor_lookup.lines_lanes, set where the two forms were measured to
// cross).  Both forms run probe_from, the same
// semantics as probe_smem's.
// ---------------------------------------------------------------------------
template <int kLanes>                // 1 or kGroupLanes
__global__ void __launch_bounds__(kLinesThreads) probe_lines_kernel(
    const TableDesc* __restrict__ desc, int n_tables, const Segments seg,
    const uint32_t* __restrict__ q_hi, const uint32_t* __restrict__ q_lo,
    uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / kLanes;
  if (i >= n) return;                // the whole group leaves together
  const int t = table_of(seg, n_tables, i);
  Answer a{0u, 0u, 0u};              // padding past the last segment: zeros
  if (t < n_tables) {
    const TableDesc& d = desc[t];
    const uint32_t home_capacity = static_cast<uint32_t>(d.home_capacity);
    if constexpr (kLanes == 1) {
      GlobalTable table{d.lines, d.next_idx};
      a = probe_one(table, d.capacity, home_capacity, d.max_probes,
                    d.host_check != 0, q_hi[i], q_lo[i]);
    } else {
      LineGroupTable table{
          cg::tiled_partition<kGroupLanes>(cg::this_thread_block()),
          d.lines, d.next_idx};
      a = probe_one(table, d.capacity, home_capacity, d.max_probes,
                    d.host_check != 0, q_hi[i], q_lo[i]);
    }
  }
  if (threadIdx.x % kLanes == 0) {
    out[i] = a.found;
    out[n + i] = a.p_hi;
    out[2 * n + i] = a.p_lo;
  }
}

// ---------------------------------------------------------------------------
// probe_smem — replaces the TPU kernel lookup_vec
// (src/repro/kernels/neighbor_lookup.py:106, body _vec_kernel at :59).
//
// The same dependent bucket reads, from shared memory once the group's
// tables (at most 227 KB) are staged.  The probe is a few shared-memory
// reads; staging is what bounds the kernel.  A design that stages the whole
// group into each block through registers (every thread a dozen 16 B loads
// in a row, each stored before the next issues) spends its time on that
// copy and loses to probe_lines on the same group.
//
// So a thread-block cluster of kCluster blocks shares ONE staged copy of the
// group: the image TableGroup lays out (every array 128 B aligned) is cut
// into kCluster slices of slice_words words, a multiple of one line, and rank
// r stages slice r only (at most 29 KB). One thread a block issues 1-D bulk
// async copies (cp.async.bulk) for the pieces of the tables' line arrays and
// next_idx arrays that fall in its slice, all at once, completing on one
// mbarrier: one round of copies from HBM instead of a dozen. Where those
// arrays lie comes by value in the launch's parameters (Image), so no block
// reads a descriptor before it copies. A next_idx array's last < 16 B (its
// length is any count of 4 B entries) is copied by that thread with plain
// loads. After the barrier and a cluster barrier every slice is visible to
// every block, and each chain step reads its line from the owning block's
// shared memory through distributed shared memory (ClusterTable). Each thread
// loads its first query, its table's descriptor and its home bucket (from
// device memory, the same words) before it waits, so those reads overlap the
// copies and a query that ends at home reads no peer's memory. The blocks of
// a cluster split the queries; more clusters, each staging its own copy,
// stride over larger batches, at most one block per SM. A second cluster
// barrier keeps every block, and so its slice, alive until no peer reads it.
// What is left is the round trip for the slices and the cluster barrier,
// which the home reads only partly hide: for a batch of a thousand queries
// that touches about half of a 200 KB group, probe_lines's reads of just
// those lines are still a little faster from a cold L2, and more so from a
// warm one. It should pay as a batch touches more of its group.
// ---------------------------------------------------------------------------

// The arrays of a group's staged image (each table's lines, then its
// next_idx when it has one), passed by value so that a block issues its
// copies without first reading the descriptors from device memory.
struct ImageArray {
  const uint32_t* src;
  int32_t at;                        // image word offset, a multiple of 32
  int32_t words;
};
struct Image {
  ImageArray array[2 * kMaxTables];
};

// Calls fn(dst, src, words) for the piece of every image array that falls
// in this block's slice [lo, lo + slice_words); dst is the piece's offset
// there, src where it starts in the array.
template <typename Fn>
__device__ void for_each_piece(const Image& image, int n_arrays, int lo,
                               int slice_words, Fn&& fn) {
  for (int k = 0; k < n_arrays; ++k) {
    const ImageArray& x = image.array[k];
    const int a = x.at > lo ? x.at : lo;
    const int b = x.at + x.words < lo + slice_words ? x.at + x.words
                                                    : lo + slice_words;
    if (a < b) fn(a - lo, x.src + (a - x.at), b - a);
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kSmemThreads) probe_smem_kernel(
        const TableDesc* __restrict__ desc, int n_tables, const Segments seg,
        const Image image, int n_arrays, int slice_words,
        const uint32_t* __restrict__ q_hi,
        const uint32_t* __restrict__ q_lo, uint32_t* __restrict__ out,
        int64_t n) {
  extern __shared__ __align__(128) uint32_t slice[];
  __shared__ __align__(8) uint64_t staged;
  cg::cluster_group cluster = cg::this_cluster();
  const int lo = static_cast<int>(cluster.block_rank()) * slice_words;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the first query and its table's row, loaded while the slices stage
  uint32_t qh = 0, ql = 0;
  int t = n_tables;
  TableDesc d{};
  if (i < n) {
    qh = q_hi[i];
    ql = q_lo[i];
    t = table_of(seg, n_tables, i);
    if (t < n_tables) d = desc[t];
  }
  if (threadIdx.x == 0) bulk::barrier_init(&staged, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    // whole 16 B of every piece by bulk copy, announced before issued
    uint32_t bytes = 0;
    for_each_piece(image, n_arrays, lo, slice_words,
                   [&](int, const uint32_t*, int w) {
                     bytes += static_cast<uint32_t>(w / 4 * 16);
                   });
    bulk::arrive_expect_tx(&staged, bytes);  // 0 bytes: an empty slice
    for_each_piece(image, n_arrays, lo, slice_words,
                   [&](int dst, const uint32_t* src, int w) {
                     const int whole = w / 4 * 4;
                     if (whole > 0)
                       bulk::copy(slice + dst, src,
                                  static_cast<uint32_t>(whole * 4), &staged);
                     for (int k = whole; k < w; ++k)   // next_idx tail
                       slice[dst + k] = src[k];
                   });
  }
  // the first query's home bucket from device memory, read while the
  // slices land: the chain goes on in shared memory
  int64_t home = 0;
  Bucket home_k{};
  if (t < n_tables) {
    home = home_of(qh, ql, static_cast<uint32_t>(d.home_capacity));
    home_k = GlobalTable{d.lines, nullptr}.bucket(clip(home, d.capacity));
  }
  bulk::wait(&staged, 0);
  cluster.sync();                    // every rank's slice has landed
  const uint32_t inverse = 0xFFFFFFFFu / slice_words + 1;
  for (bool first = true; i < n; i += stride, first = false) {
    if (!first) {
      qh = q_hi[i];
      ql = q_lo[i];
      t = table_of(seg, n_tables, i);
      if (t < n_tables) d = desc[t];
    }
    Answer a{0u, 0u, 0u};            // padding past the last segment
    if (t < n_tables) {
      ClusterTable table{slice, static_cast<uint32_t>(slice_words), inverse,
                         static_cast<uint32_t>(d.smem_lines),
                         d.next_idx == nullptr ? -1 : d.smem_next};
      a = first ? probe_from(table, home, home_k, d.capacity,
                             static_cast<uint32_t>(d.home_capacity),
                             d.max_probes, d.host_check != 0, qh, ql)
                : probe_one(table, d.capacity,
                            static_cast<uint32_t>(d.home_capacity),
                            d.max_probes, d.host_check != 0, qh, ql);
    }
    out[i] = a.found;
    out[n + i] = a.p_hi;
    out[2 * n + i] = a.p_lo;
  }
  // No slice goes while a peer reads it.  The reads above have returned
  // (their values are used), so the arrival needs no release.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// random_access — the paper's RA yardstick, not a TPU kernel: the function
// of src/repro/core/lookup.py::random_access (and of the port's
// core/lookup.random_access) on the table probe_lines reads.  Each key
// hashes to its home bucket (hash64 % capacity, as the reference's RA
// hashes over the table's capacity) and gathers both value words there, in
// the timed call, so that probe/RA holds the probe against the function
// the paper names: hash plus one random read.
//
// Bound: bytes.  A key reads its 8 B and writes 8 B; its bucket's val_hi
// and val_lo lie in two 32 B sectors of one 128 B line, so a key whose
// line is cold moves 64 B from memory.  The hash is a dozen integer
// operations, far below that.  One thread a key, as many keys in flight as
// the card holds resident threads: the two loads are independent, so a
// key waits on one memory latency.
// ---------------------------------------------------------------------------
constexpr int kRaThreads = 256;

__global__ void __launch_bounds__(kRaThreads) random_access_kernel(
    const uint32_t* __restrict__ lines, uint32_t capacity,
    const uint32_t* __restrict__ q_hi, const uint32_t* __restrict__ q_lo,
    uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t b = home_of(q_hi[i], q_lo[i], capacity);
  const uint32_t* w = lines + (b / kBpl) * kLineWords + (b % kBpl);
  out[i] = __ldg(w + 2 * kBpl);          // val_hi
  out[n + i] = __ldg(w + 3 * kBpl);      // val_lo
}

// ---------------------------------------------------------------------------
// probe_linear — the T1 baseline, not a TPU kernel: the function of
// src/repro/core/lookup.py::lookup_linear (and of the port's
// core/lookup.lookup_linear), linear probing over the same line-packed
// layout.  Hash to home = hash64 % capacity; hit if both key halves match a
// non-empty bucket; miss on an empty bucket; else step to (idx + 1) %
// capacity, at most max_probes steps past home (a query still going at the
// bound reports not found, as the reference's while_loop leaves it).
//
// Bound: the bytes of the lines a query's run covers, 128 B a line; but
// each line's read waits on the compare of the line before, so a query
// waits on a chain of dependent loads.  The design makes that chain one
// load a line, not one a bucket: a query reads its line's 8 key_hi and 8
// key_lo words at once and resolves every step of its run that falls in
// that line in registers (the first hit or empty bucket at or after its
// slot, among the buckets its remaining steps reach), reads the value
// words of the bucket it hit alone, and only then goes on to the next
// line.  The run wraps at capacity, not at the end of the last line, where
// capacity % 8 != 0: a line's buckets past capacity are never read.
//
// One thread a query: the line's 64 B of keys come by four independent
// 16 B loads.  (A group of 8 lanes a query, one 16 B load a lane and a
// ballot, ran slower at T1's 2^16 queries, the batch the port runs this
// kernel at.)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kLinesThreads) probe_linear_kernel(
    const uint32_t* __restrict__ lines, uint32_t capacity, int64_t max_probes,
    const uint32_t* __restrict__ q_hi, const uint32_t* __restrict__ q_lo,
    uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const uint32_t qh = q_hi[i], ql = q_lo[i];
  int64_t idx = hash64(qh, ql) % capacity;
  int64_t left = max_probes + 1;     // buckets the run may still read
  Answer a{0u, 0u, 0u};
  for (;;) {
    const int64_t line = idx / kBpl;
    const int c = static_cast<int>(idx % kBpl);
    const int64_t line_end = line * kBpl + kBpl < capacity
                                 ? line * kBpl + kBpl
                                 : static_cast<int64_t>(capacity);
    const int take = static_cast<int>(line_end - idx < left ? line_end - idx
                                                             : left);
    const uint32_t* w = lines + line * kLineWords;
    const uint4* v = reinterpret_cast<const uint4*>(w);
    const uint4 h0 = __ldg(v), h1 = __ldg(v + 1);      // key_hi
    const uint4 l0 = __ldg(v + 2), l1 = __ldg(v + 3);  // key_lo
    const uint32_t kh[kBpl] = {h0.x, h0.y, h0.z, h0.w,
                               h1.x, h1.y, h1.z, h1.w};
    const uint32_t kl[kBpl] = {l0.x, l0.y, l0.z, l0.w,
                               l1.x, l1.y, l1.z, l1.w};
    unsigned eq = 0u, em = 0u;         // one bit a bucket of the line
#pragma unroll
    for (int b = 0; b < kBpl; ++b) {
      eq |= static_cast<unsigned>(kh[b] == qh && kl[b] == ql) << b;
      em |= static_cast<unsigned>(kh[b] == kEmpty && kl[b] == kEmpty) << b;
    }
    const unsigned hit = eq & ~em;
    // the buckets in [c, c + take): the steps this line holds
    const unsigned stop = (hit | em) & (((1u << take) - 1u) << c);
    if (stop != 0u) {                  // the run ends in this line
      const int b = __ffs(stop) - 1;
      if ((hit >> b) & 1u)
        a = {1u, __ldg(w + 2 * kBpl + b) & kPayloadHiMask,
             __ldg(w + 3 * kBpl + b)};
      break;
    }
    left -= take;
    if (left == 0) break;              // max_probes steps taken: not found
    idx = line_end == capacity ? 0 : line_end;
  }
  out[i] = a.found;
  out[n + i] = a.p_hi;
  out[2 * n + i] = a.p_lo;
}

// ---------------------------------------------------------------------------
// probe_sequential — the Fig. 9 baseline, not a TPU kernel: the card's
// counterpart of src/repro/core/lookup.py::lookup_sequential (lax.map over
// one-query lookups).  One thread resolves the queries one after another,
// each through probe_one over GlobalTable, the per-query function of
// probe_lines's one-thread form (inline offsets or next_idx, and the lodger
// check), so no query's loads overlap another's.  Bound: the chain of
// dependent loads, queries x lines a query x the card's load latency.
// ---------------------------------------------------------------------------
__global__ void probe_sequential_kernel(
    const uint32_t* __restrict__ lines, const int32_t* __restrict__ next_idx,
    int64_t capacity, uint32_t home_capacity, int64_t max_probes,
    bool host_check, const uint32_t* __restrict__ q_hi,
    const uint32_t* __restrict__ q_lo, uint32_t* __restrict__ out,
    int64_t n) {
  GlobalTable table{lines, next_idx};
  for (int64_t i = 0; i < n; ++i) {
    const Answer a = probe_one(table, capacity, home_capacity, max_probes,
                               host_check, q_hi[i], q_lo[i]);
    out[i] = a.found;
    out[n + i] = a.p_hi;
    out[2 * n + i] = a.p_lo;
  }
}

// ---------------------------------------------------------------------------
// load_chain — a yardstick, not a TPU kernel: the card's dependent-load
// latency, which bounds probe_sequential, measured apart from it.  One
// thread follows a chain of 128 B lines: word 0 of each line holds the
// index of the next, so each load's address is the load before it, with no
// hash or compare between them.  The loads are plain global loads, as
// GlobalTable's; an index past the last line is clipped to it (one integer
// min a load, a few cycles against the load's hundreds), so a bad chain
// reads nothing outside the buffer.  out[0] = the line reached after
// `steps` loads.
// ---------------------------------------------------------------------------
__global__ void load_chain_kernel(const int32_t* words, uint32_t last,
                                  uint32_t start, int64_t steps,
                                  int64_t* out) {
  uint32_t line = start;
  for (int64_t s = 0; s < steps; ++s)
    line = min(static_cast<uint32_t>(words[static_cast<int64_t>(line) *
                                           kLineWords]),
               last);
  *out = line;
}

Segments segments(const long long* seg_end, int n_tables) {
  Segments s{};
  for (int t = 0; t < n_tables && t < kMaxTables; ++t) s.end[t] = seg_end[t];
  return s;
}

}  // namespace

// desc: device TableDesc[n_tables]; seg_end: HOST int64[n_tables], the end
// of each table's query segment; out: uint32 [3, n] (found, payload_hi,
// payload_lo); lanes a query: 1 or 8 (the wrapper's lines_lanes).
// n_tables <= kMaxTables (the wrapper checks).
extern "C" int repro_probe_lines(const void* desc, int n_tables,
                                 const long long* seg_end, const void* q_hi,
                                 const void* q_lo, void* out, long long n,
                                 int lanes, void* stream) {
  if (lanes != 1 && lanes != kGroupLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = kLinesThreads / lanes;        // queries
  const auto blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const TableDesc*>(desc);
  const Segments seg = segments(seg_end, n_tables);
  const auto* qh = static_cast<const uint32_t*>(q_hi);
  const auto* ql = static_cast<const uint32_t*>(q_lo);
  auto* o = static_cast<uint32_t*>(out);
  if (lanes == 1)
    probe_lines_kernel<1><<<blocks, kLinesThreads, 0, s>>>(d, n_tables, seg,
                                                           qh, ql, o, n);
  else
    probe_lines_kernel<kGroupLanes><<<blocks, kLinesThreads, 0, s>>>(
        d, n_tables, seg, qh, ql, o, n);
  return static_cast<int>(cudaGetLastError());
}

// Once per device: the device's SM count (probe_smem's grid bound) in
// *n_sm and its resident threads an SM in *threads_per_sm (probe_lines's
// lanes), so a launch queries nothing.
extern "C" int repro_probe_init(int* n_sm, int* threads_per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(threads_per_sm,
                                 cudaDevAttrMaxThreadsPerMultiProcessor,
                                 device);
  return static_cast<int>(err);
}

// desc_rows: the same TableDesc rows on the HOST (int64 [n_tables, 9]),
// read here into the launch's parameters; slice_words: TableGroup.
// slice_words, a multiple of 32 words (one line) and at most
// kSliceWordsMax; n_sm from repro_probe_init on this device.
extern "C" int repro_probe_smem(const void* desc, const long long* desc_rows,
                                int n_tables, const long long* seg_end,
                                int slice_words, int n_sm, const void* q_hi,
                                const void* q_lo, void* out, long long n,
                                void* stream) {
  if (slice_words <= 0 || slice_words % kLineWords != 0 ||
      slice_words > kSliceWordsMax || n_tables > kMaxTables)
    return static_cast<int>(cudaErrorInvalidValue);
  Image image{};
  int n_arrays = 0;
  for (int t = 0; t < n_tables; ++t) {
    const long long* row = desc_rows + 9 * t;   // DESC_FIELDS order
    const TableDesc d{reinterpret_cast<const uint32_t*>(row[0]),
                      reinterpret_cast<const int32_t*>(row[1]), row[2],
                      row[3], row[4], row[5], row[6], row[7], row[8]};
    image.array[n_arrays++] = {d.lines, static_cast<int32_t>(d.smem_lines),
                               static_cast<int32_t>(d.n_lines * kLineWords)};
    if (d.next_idx != nullptr)
      image.array[n_arrays++] = {
          reinterpret_cast<const uint32_t*>(d.next_idx),
          static_cast<int32_t>(d.smem_next), static_cast<int32_t>(d.capacity)};
  }
  const long long per_cluster = static_cast<long long>(kCluster) *
                                kSmemThreads;
  long long clusters = (n + per_cluster - 1) / per_cluster;
  const long long most = n_sm / kCluster > 0 ? n_sm / kCluster : 1;
  if (clusters > most) clusters = most;
  probe_smem_kernel<<<static_cast<unsigned>(clusters * kCluster),
                      kSmemThreads,
                      static_cast<size_t>(slice_words) * sizeof(uint32_t),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TableDesc*>(desc), n_tables,
      segments(seg_end, n_tables), image, n_arrays, slice_words,
      static_cast<const uint32_t*>(q_hi), static_cast<const uint32_t*>(q_lo),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// lines: uint32 [n_lines, 4, kBpl] of one table of `capacity` buckets,
// in [1, 2^32); out: uint32 [2, n] (val_hi, val_lo of each key's home
// bucket); n >= 1.
extern "C" int repro_random_access(const void* lines, long long capacity,
                                   const void* q_hi, const void* q_lo,
                                   void* out, long long n, void* stream) {
  if (capacity < 1 || capacity > 0xFFFFFFFFll || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto blocks = static_cast<unsigned>((n + kRaThreads - 1) /
                                            kRaThreads);
  random_access_kernel<<<blocks, kRaThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lines), static_cast<uint32_t>(capacity),
      static_cast<const uint32_t*>(q_hi),
      static_cast<const uint32_t*>(q_lo), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// lines: uint32 [n_lines, 4, kBpl] holding at least `capacity` buckets,
// 16 B aligned, capacity in [1, 2^32); out: uint32 [3, n] (found,
// payload_hi, payload_lo); n >= 1.
extern "C" int repro_probe_linear(const void* lines, long long capacity,
                                  long long max_probes, const void* q_hi,
                                  const void* q_lo, void* out, long long n,
                                  void* stream) {
  if (capacity < 1 || capacity > 0xFFFFFFFFll || max_probes < 0 || n < 1 ||
      max_probes > (1LL << 62))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto blocks = static_cast<unsigned>((n + kLinesThreads - 1) /
                                            kLinesThreads);
  probe_linear_kernel<<<blocks, kLinesThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lines), static_cast<uint32_t>(capacity),
      max_probes, static_cast<const uint32_t*>(q_hi),
      static_cast<const uint32_t*>(q_lo), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// lines as above, `capacity` buckets; next_idx: int32 [capacity] or null
// (inline offsets); home_capacity in [1, capacity]; out as above; n >= 1.
// One block of one thread.
extern "C" int repro_probe_sequential(const void* lines, const void* next_idx,
                                      long long capacity,
                                      long long home_capacity,
                                      long long max_probes, int host_check,
                                      const void* q_hi, const void* q_lo,
                                      void* out, long long n, void* stream) {
  if (home_capacity < 1 || home_capacity > capacity ||
      capacity > 0xFFFFFFFFll || max_probes < 0 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_sequential_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lines),
      static_cast<const int32_t*>(next_idx), capacity,
      static_cast<uint32_t>(home_capacity), max_probes, host_check != 0,
      static_cast<const uint32_t*>(q_hi), static_cast<const uint32_t*>(q_lo),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// words: int32 [n_lines, kLineWords], word 0 of each line the index of the
// next; n_lines in [1, 2^32); out: int64 [1]; start in [0, n_lines),
// steps >= 0.  One block of one thread.
extern "C" int repro_load_chain(const void* words, long long n_lines,
                                long long start, long long steps, void* out,
                                void* stream) {
  if (n_lines < 1 || n_lines > 0xFFFFFFFFll || start < 0 ||
      start >= n_lines || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  load_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), static_cast<uint32_t>(n_lines - 1),
      static_cast<uint32_t>(start), steps, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
