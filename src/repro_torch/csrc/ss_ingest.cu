// Fused flush and fused COMBINE for Hopper (sm_90a): the whole merge of one
// tenant's pending window, or of one pair of summaries, in one thread block.
//
// Replaces the Pallas TPU kernels repro/kernels/ss_ingest.py:
// fused_ingest_pallas (_ingest_kernel) and fused_combine_pallas
// (_combine_kernel). For each batch entry b:
//
//   fused_ingest:   update_chunk(summary_b, window_b)   (sorted matcher)
//   fused_combine:  combine(s1_b, s2_b)                 (sorted matcher)
//
// that is: match the candidates (the window's exact histogram, or s2's
// counters) against the summary, apply the Cafaro COMBINE offsets, and keep
// the k largest counters of the pool [k summary slots | candidates] in the
// order of a stable descending sort on count (on ties the lower pool index
// first, as lax.top_k), a winner with a negative count becoming
// (EMPTY, 0, 0). Sums are taken in the count type T (int32 or int64) with
// wrap-around, so the result equals the plain PyTorch version bit for bit.
//
// What bounds it on the H100: the function moves little (7.3 MB for a flush
// of 64 tenants at k = 2048, W = 16384: 2.2 us at 3.35 TB/s) and its
// operations are a hash (or sort) of W ids and a few passes over the k + W
// pool per tenant. The plain version is ~40 PyTorch ops per flush, each a
// launch and a round trip of the window or the pool through device memory.
// What the design does about it: one launch per flush or COMBINE round, one
// block of 1024 threads per batch entry, and everything between reading the
// inputs once and writing the outputs once stays in shared memory.
//
// The shared-memory flush (fused_ingest_kernel) sorts no window ids: the
// result depends only on the k-th largest count, on which entries win ties
// there, and on the order of the k winners, so it builds an unordered
// histogram and sorts only the winners:
//   1. the summary is loaded and an open-addressing hash table of
//      table_slots(W) >= 1.5 W slots emptied (int32 keys, 16-bit weights two
//      a 32-bit word; ss_hash.cuh's keyed hash under a salt the wrapper
//      draws for each launch, so that no window chosen in advance piles its
//      ids onto one probe chain: the result does not depend on where an id
//      sits in the table); m1 by a block reduction;
//   2. the window is streamed from device memory in 16-byte loads, 4 ids a
//      lane a round: each id's home slot is loaded, a free slot claimed by
//      atomicCAS where the id is new, and 1 added to its weight by a
//      shared-memory atomicAdd (grouping a warp's equal ids first with
//      __match_any_sync cost more on the H100 than the atomics it saved).
//      EMPTY is dropped. The table holds W distinct ids at a load of 2/3,
//      so it cannot overflow;
//   3. the match: each summary slot finds its id in the table, adds its
//      weight and zeroes it (the id leaves the pool); valid summary ids are
//      distinct, so no atomics are needed;
//   4. the unmatched ids are compacted to the table's front in place, in
//      order, 8 slots a lane a round; the pool is [k slots | these ids], a
//      candidate's count its weight + m1;
//   5. a radix select (8 bits a pass from the top, a shared-memory
//      histogram) finds the k-th largest count thr, skipping the digits on
//      which every valid count agrees;
//   6. ties at thr go to the summary slots first, in slot order (a block
//      scan), then to the tied candidates with the lowest ids (signed
//      order), found by a second radix select over their ids: merge_pool's
//      stable sort puts the summary first and chunk_histogram's ids in
//      ascending order;
//   7. only the winners are sorted, each as one key that holds the whole
//      entry (count descending, then summary slot, then id): those above
//      thr in one buffer; the tied candidates' ids in a second, sorted
//      after it; the summary's ties need no sort, the scan ranks them. A
//      bitonic network, by shuffles below a stride of 32 and through
//      shared memory above, sorts each buffer.
// The shared-memory COMBINE (fused_combine_kernel) sorts no ids either: it
// builds a hash table of s2's ids under the same keyed hash (each id with its
// lowest slot in s2, the (id, slot) order's match for a summary that holds
// an id twice), looks each s1 id up there, takes m1 and m2 in one block
// reduction, radix-selects the k-th largest count of the pool [k updated s1
// slots | s2's unmatched slots] with the digits that every count shares
// skipped, gives ties to the lowest pool ranks (the pool rank is the tie
// order: no second select) by one block scan, and sorts only the k
// winners, one key each (count descending, then pool rank), by the same
// bitonic network. The cluster and workspace paths sort instead:
//   1. the window is sorted by a block-wide LSD radix sort (8 bits a pass,
//      signed order: EMPTY = -1 first), ping-ponging between the window's
//      buffer and the run-start buffer, which is free until step 2; a digit
//      on which every id agrees costs no pass (3 for ids below 2^24);
//   2. its runs are the exact histogram: a block scan writes each run's
//      start, so run r is candidate r, its weight pos[r+1] - pos[r], and its
//      rank in the pool that of chunk_histogram's layout (the EMPTY run
//      included, as an invalid candidate);
//   3. m1 (and m2) by block reductions, before the update;
//   4. the match: each summary slot binary-searches its id among the sorted
//      candidate ids (for COMBINE, s2's slot numbers sorted stably by id);
//      ids are distinct, so a slot matches at most one candidate and no
//      atomics are needed; a matched candidate is then marked invalid;
//   5. top-k without sorting the pool: a radix select (8 bits a pass,
//      warp-aggregated shared-memory histograms) finds the k-th largest
//      count; every entry above it and the lowest-ranked ties up to k are
//      compacted in pool order by a block scan, and only those k are sorted
//      by (count descending, rank ascending) before they are written out:
//      the same radix sort, stable, on the key ~count of each winner's rank
//      (winners are compacted in rank order, and no winner is negative).
// The cluster path's radix sort ranks without atomics: each warp owns a
// contiguous slice of the keys, __match_any_sync gives each lane its peers
// on the digit within a round of 32, and the lowest peer adds the group to
// its warp's counter and hands each peer its rank, kept in a register; one
// block scan over the counters, digit-major and warp-minor, gives every
// (digit, warp) its base, and the scatter writes each key to base + rank,
// which keeps slice, round and lane order, so the sort is stable. The sort
// costs instructions, not bytes: W/1024 keys a thread a pass, with 32 warps
// sharing an SM's four schedulers.
// One block per tenant fills 64 of the 132 SMs at B = 64.
//
// Three paths run that algorithm; the wrapper picks one by shape
// (kernels/ss_ingest.py path_for). The shared-memory path above takes
// k <= kSmemK and W <= kSmemW: its 16-bit weights, the winners' sort (two
// keys a thread), and one block's 227 KB bound it there. The cluster path
// takes a shape that a
// thread-block cluster of C blocks (C in 2, 4, 8, 16; the wrapper's
// cluster_for) holds, each block a 1/C slice of the window and of the
// summary's slots in its own shared memory, at most kSmemW of each, where
// the card runs all the batch's clusters at once or W is above kSmemW: the
// same algorithm spread over the cluster through distributed shared memory
// (the sort in (digit, block, warp) order, a block's runs after the
// previous block's, the match by the block that holds an id's first
// window entry, the select's histograms summed over the cluster, the
// winners compacted by a cluster scan; see "The cluster path" below). It is
// one launch a flush or round, like the others; on the H100 it takes the
// planned flush (B 64, k 2048, W 65 536) on clusters of 4 in 0.37 ms
// against the workspace path's 0.52, and W 65 536 at B 2 on clusters of
// 16 in 0.11 ms against 0.46 (tools/cluster_sizes.py on NVIDIA H100 80GB
// HBM3, 700.00 W). The workspace path takes every other shape: the updated
// summary channels, the window and run starts, the selection's k-rank
// buffers and, for COMBINE, s2's slots sorted by id live in a
// device-memory workspace that the wrapper allocates (bytes a tenant:
// ingest_workspace, combine_workspace), and only the sort's counters and
// the block's scratch in shared memory. Its radix sort has 32-bit counters
// and keeps no ranks: a pass counts each warp's slice, scans the counters
// into bases, and counts again while it scatters, each group of peers
// taking the running base of its (digit, warp). COMBINE sorts s2's slot
// numbers stably by id with it, which is the (id, slot) order. The match
// keeps each slot's matched candidate in the first selection buffer until
// every slot has searched. Offsets into the batch are 64-bit.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ss_hash.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int32_t kEmpty = -1;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemK = 2048;                // counters per summary, shared-memory path
constexpr int kSmemW = 16384;               // window ids per tenant, shared-memory path
constexpr int kSlots = kSmemK / kThreads;   // summary slots per thread
constexpr int kMaxPool = INT_MAX / 2;       // k + W of the workspace path: int indices
constexpr int kMaxSmem = 232448;            // shared memory a block may opt in to
constexpr unsigned kAll = 0xffffffffu;

static_assert(kWarps == 32, "the block scan keeps one warp total per lane");

constexpr int kDigits = 256;               // radix of the sort: 8 bits a pass
constexpr int kCounters = kDigits * kWarps; // per-warp digit counters
constexpr int kRounds = kSmemW / kThreads;  // rounds of 32 keys a warp, at most

static_assert(kCounters == 8 * kThreads, "each thread scans 8 digit counters");
static_assert(kSmemW < 65536, "digit counters, bases and ranks are 16 bits");
static_assert(kRounds % 2 == 0, "two 16-bit ranks a register");

template <typename T>
struct Limits;
template <>
struct Limits<int32_t> {
  static constexpr int32_t kMax = INT_MAX;
};
template <>
struct Limits<int64_t> {
  static constexpr int64_t kMax = LLONG_MAX;
};

template <typename T>
__device__ __forceinline__ T wrap_add(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  return static_cast<T>(static_cast<U>(a) + static_cast<U>(b));
}

template <typename T>
__device__ __forceinline__ T wrap_sub(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  return static_cast<T>(static_cast<U>(a) - static_cast<U>(b));
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

struct Scratch {
  unsigned long long scan[kWarps];
  long long red[kWarps];
  unsigned long long key_and[kWarps];
  unsigned long long key_or[kWarps];
  int hist[256];
  int bin;
  int want;
  int total;
};

// Exclusive prefix sum of v over the block's threads in thread order; the
// block's sum goes to `total`. Every thread calls it; it ends synchronised.
__device__ unsigned long long block_exclusive_scan(unsigned long long v, Scratch& sh,
                                                   unsigned long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh.scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long s = sh.scan[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kAll, s, o);
      if (lane >= o) s += y;
    }
    sh.scan[lane] = s;
  }
  __syncthreads();
  total = sh.scan[kWarps - 1];
  const unsigned long long excl = (warp ? sh.scan[warp - 1] : 0ull) + x - v;
  __syncthreads();
  return excl;
}

// min_frequency: the minimum count if every slot holds an item, else 0.
template <typename T>
__device__ T min_frequency(const int32_t* items, const T* counts, int k, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool full = true;
  T m = Limits<T>::kMax;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    full = full && items[i] != kEmpty;
    m = counts[i] < m ? counts[i] : m;
  }
  full = __syncthreads_and(full);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(kAll, m, o);
    m = y < m ? y : m;
  }
  if (lane == 0) sh.red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = static_cast<T>(sh.red[lane]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T y = __shfl_xor_sync(kAll, m, o);
      m = y < m ? y : m;
    }
    if (lane == 0) sh.red[0] = m;
  }
  __syncthreads();
  const T least = static_cast<T>(sh.red[0]);
  __syncthreads();
  return full ? least : T(0);
}

// The bits on which the keys of the block's threads differ: a block AND and
// OR of (all, any), each thread's own AND and OR, which it leaves in all
// and any. Ends synchronised.
template <typename U>
__device__ U varying_bits(U& all, U& any, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    all &= __shfl_xor_sync(kAll, all, o);
    any |= __shfl_xor_sync(kAll, any, o);
  }
  if (lane == 0) {
    sh.key_and[warp] = all;
    sh.key_or[warp] = any;
  }
  __syncthreads();
  all = ~U(0);
  any = 0;
#pragma unroll 8
  for (int w = 0; w < kWarps; ++w) {
    all &= static_cast<U>(sh.key_and[w]);
    any |= static_cast<U>(sh.key_or[w]);
  }
  __syncthreads();
  return all ^ any;
}

// Stable LSD radix sort of n int32 values in shared or device memory by the
// unsigned key key_of(value), 8 bits a pass, ping-ponging between a and b;
// returns the buffer that holds the result (a after an even number of
// passes). A digit on which every key agrees is skipped. `count` is
// kCounters 32-bit counters in shared memory, those of warp w at
// count[w * kDigits + digit]; no ranks are kept between steps: each pass
// counts its warps' slices by digit, scans the counters into bases, and
// counts again while it scatters, the lowest of a group of peers taking the
// running base of its (digit, warp) for the group and advancing it. Slice,
// round and lane order are kept, so it is stable. Every thread calls it; it
// ends synchronised.
template <typename U, typename KeyOf>
__device__ int32_t* radix_sort(const KeyOf& key_of, int32_t* a, int32_t* b, int n,
                               uint32_t* count, Scratch& sh) {
  if (n <= 1) return a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  U all = ~U(0), any = 0;
  for (int i = tid; i < n; i += kThreads) {
    const U key = key_of(a[i]);
    all &= key;
    any |= key;
  }
  const U vary = varying_bits(all, any, sh);
  const int slice = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(n, warp * slice), hi = min(n, lo + slice);
  const unsigned below = (1u << lane) - 1u;
  uint32_t* mine = count + warp * kDigits;
  for (int shift = 0; shift < 8 * static_cast<int>(sizeof(U)); shift += 8) {
    if (((vary >> shift) & 0xFF) == 0) continue;
    for (int j = tid; j < kCounters; j += kThreads) count[j] = 0;
    __syncthreads();
    // 1. each warp counts its slice's keys by digit, round by round
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const int d = i < hi ? static_cast<int>((key_of(a[i]) >> shift) & 0xFF) : -1;
      const unsigned peers = __match_any_sync(kAll, d);
      if (d >= 0 && lane == __ffs(peers) - 1) mine[d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // 2. bases: exclusive scan over (digit, warp), digit-major and warp-minor
    const int digit = tid >> 2, w0 = (tid & 3) * 8;
    uint32_t c[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = count[(w0 + j) * kDigits + digit];
      sum += c[j];
    }
    unsigned long long total;
    uint32_t at = static_cast<uint32_t>(block_exclusive_scan(sum, sh, total));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      count[(w0 + j) * kDigits + digit] = at;
      at += c[j];
    }
    __syncthreads();
    // 3. scatter, counting again from each (digit, warp)'s base
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      int32_t v = 0;
      int d = -1;
      if (i < hi) {
        v = a[i];
        d = static_cast<int>((key_of(v) >> shift) & 0xFF);
      }
      const unsigned peers = __match_any_sync(kAll, d);
      const int leader = __ffs(peers) - 1;
      uint32_t first = 0;
      if (d >= 0 && lane == leader) {
        first = mine[d];
        mine[d] = first + __popc(peers);
      }
      const uint32_t place = __shfl_sync(kAll, first, leader) + __popc(peers & below);
      if (d >= 0) b[place] = v;
      __syncwarp();
    }
    __syncthreads();
    int32_t* t = a;
    a = b;
    b = t;
  }
  return a;
}

// The window's sort key: signed order as unsigned (EMPTY = -1 first).
struct IdKey {
  __device__ uint32_t operator()(int32_t id) const {
    return static_cast<uint32_t>(id) ^ 0x80000000u;
  }
};

// A winner's sort key: merge_pool's order is count descending, then pool
// rank ascending; winners are non-negative and compacted in rank order, so
// a stable ascending sort on ~count gives that order.
template <typename T, typename Pool>
struct WinnerKey {
  const Pool& pool;
  __device__ typename std::make_unsigned<T>::type operator()(int32_t rank) const {
    T c = 0;
    pool.count(rank, c);
    return ~static_cast<typename std::make_unsigned<T>::type>(c);
  }
};

template <typename K>
__device__ int lower_bound(const K* a, int n, K x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename K>
__device__ int upper_bound(const K* a, int n, K x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Keep the k largest entries of the pool [0, n_total), in merge_pool's order.
// Pool::count(v, c) gives entry v's count and whether it may win (a valid
// entry with count >= 0: a negative winner is written as (EMPTY, 0, 0), so
// leaving every negative entry out gives the same k outputs).
// Pool::entry(v, item, count, error) gives the entry itself. sel_rank and
// sel_tmp hold k ranks each; count is radix_sort's 32-bit counters.
template <typename T, typename Pool, typename Count>
__device__ void keep_top_k(const Pool& pool, int n_total, int k, int32_t* sel_rank,
                           int32_t* sel_tmp, Count* count, Scratch& sh,
                           int32_t* out_items, T* out_counts, T* out_errors) {
  using U = typename std::make_unsigned<T>::type;
  const int tid = threadIdx.x, lane = tid & 31;
  const int per = (n_total + kThreads - 1) / kThreads;

  // 1. radix-select the k-th largest count, 8 bits a pass from the top
  U prefix = 0, mask = 0;
  int want = k;                 // rank, from the top, among entries under prefix
  bool take_all = false;
  for (int shift = 8 * static_cast<int>(sizeof(T)) - 8; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += kThreads) sh.hist[b] = 0;
    __syncthreads();
    for (int it = 0; it < per; ++it) {
      const int v = it * kThreads + tid;
      int bin = -1;
      T c;
      if (v < n_total && pool.count(v, c)) {
        const U u = static_cast<U>(c);
        if ((u & mask) == prefix) bin = static_cast<int>((u >> shift) & 0xFF);
      }
      const unsigned peers = __match_any_sync(kAll, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {               // warp 0: the bin that holds the want-th largest
      int s = 0;
      for (int q = 0; q < 8; ++q) s += sh.hist[8 * lane + q];
      int suffix = s;             // entries in bins >= 8 * lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_down_sync(kAll, suffix, o);
        if (lane + o < 32) suffix += y;
      }
      if (lane == 0) sh.total = suffix;
      const int above = suffix - s;
      if (above < want && want <= suffix) {
        int w = want - above, b = 8 * lane + 7;
        for (int q = 0; q < 7 && w > sh.hist[b]; ++q) {
          w -= sh.hist[b];
          --b;
        }
        sh.bin = b;
        sh.want = w;
      }
    }
    __syncthreads();
    if (mask == 0 && sh.total <= k) {   // the first pass counts every entry
      take_all = true;
      break;
    }
    prefix |= static_cast<U>(sh.bin) << shift;
    mask |= static_cast<U>(0xFF) << shift;
    want = sh.want;
    __syncthreads();
  }
  const T thr = take_all ? T(-1) : static_cast<T>(prefix);
  const int ties = take_all ? 0 : want;    // entries equal to thr that win

  // 2. the winners, compacted in pool order: each thread a contiguous range
  const int lo = min(n_total, tid * per), hi = min(n_total, lo + per);
  unsigned gt = 0, eq = 0;
  for (int v = lo; v < hi; ++v) {
    T c;
    if (!pool.count(v, c)) continue;
    if (c > thr) ++gt; else if (c == thr) ++eq;
  }
  unsigned long long total;
  const unsigned long long before = block_exclusive_scan(
      (static_cast<unsigned long long>(gt) << 32) | eq, sh, total);
  const int ex_gt = static_cast<int>(before >> 32);
  const int ex_eq = static_cast<int>(before & 0xffffffffu);
  const int n_sel = static_cast<int>(total >> 32) +
                    min(static_cast<int>(total & 0xffffffffu), ties);
  int out = ex_gt + min(ex_eq, ties), tie = ex_eq;
  for (int v = lo; v < hi; ++v) {
    T c;
    if (!pool.count(v, c)) continue;
    if (c > thr || (c == thr && tie++ < ties)) sel_rank[out++] = v;
  }
  __syncthreads();

  // 3. order the winners, 4. write them out; slots past them are empty
  const int32_t* order = radix_sort<U>(WinnerKey<T, Pool>{pool}, sel_rank, sel_tmp,
                                       n_sel, count, sh);
  for (int i = tid; i < k; i += kThreads) {
    int32_t item = kEmpty;
    T c = 0, e = 0;
    if (i < n_sel) pool.entry(order[i], item, c, e);
    out_items[i] = item;
    out_counts[i] = c;
    out_errors[i] = e;
  }
}

// The flush pool: k updated summary slots, then one candidate per run of
// the sorted window (the exact histogram, in chunk_histogram's layout).
template <typename T>
struct IngestPool {
  const int32_t* items;
  const T* counts;
  const T* errors;
  const int32_t* ids;   // the sorted window; a matched run's first id is EMPTY
  const int32_t* pos;   // run r is ids[pos[r] .. pos[r + 1])
  int k;
  T m1;

  __device__ bool count(int v, T& c) const {
    if (v < k) {
      c = counts[v];
      return c >= 0;
    }
    const int p = pos[v - k];
    if (ids[p] == kEmpty) return false;
    c = wrap_add(static_cast<T>(pos[v - k + 1] - p), m1);
    return c >= 0;
  }
  __device__ void entry(int v, int32_t& item, T& c, T& e) const {
    if (v < k) {
      item = items[v];
      c = counts[v];
      e = errors[v];
      return;
    }
    const int p = pos[v - k];
    item = ids[p];
    c = wrap_add(static_cast<T>(pos[v - k + 1] - p), m1);
    e = m1;
  }
};

// The exact histogram of the sorted window ids[0, w): writes pos[r] = start
// of the r-th run and pos[n_runs] = w, and returns n_runs. Every thread
// calls it; it ends synchronised.
__device__ int run_starts(const int32_t* ids, int32_t* pos, int w, Scratch& sh) {
  const int per = (w + kThreads - 1) / kThreads;
  const int lo = min(w, static_cast<int>(threadIdx.x) * per), hi = min(w, lo + per);
  unsigned long long starts = 0;
  for (int p = lo; p < hi; ++p) starts += p == 0 || ids[p] != ids[p - 1];
  unsigned long long n_runs;
  int r = static_cast<int>(block_exclusive_scan(starts, sh, n_runs));
  for (int p = lo; p < hi; ++p) {
    if (p == 0 || ids[p] != ids[p - 1]) pos[r++] = p;
  }
  if (threadIdx.x == 0) pos[n_runs] = w;
  __syncthreads();
  return static_cast<int>(n_runs);
}

// -- the shared-memory flush -------------------------------------------------

// Slots of the flush's hash table for a window of w ids: 1.5 w rounded up to
// a multiple of 8, at least 8. It holds every distinct id of the window at
// a load of at most 2/3 and always keeps a free slot, so a probe ends: it
// cannot overflow.
__host__ __device__ constexpr int table_slots(int w) {
  return w < 5 ? 8 : (w + ((w + 1) >> 1) + 7) & ~7;
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// A winner's place in merge_pool's order as one unsigned key, ascending:
// count descending, then the summary's slots in slot order, then the
// window's ids in signed order. The key holds the whole entry: a summary
// slot's item and error are read at its slot, a candidate's error is m1.
// NarrowCode: 64 bits, the 31 bits of top - count (top >= every winner's
// count and top - count < 2^31: always so at int32, where top is the OR of
// the valid counts), a candidate flag, and the slot or the id's IdKey.
// WideCode, for int64 winners whose counts span 2^31 or more: ~count, then
// (flag, slot or IdKey).
struct Key128 {
  unsigned long long hi, lo;
  __device__ bool operator<(const Key128& o) const {
    return hi < o.hi || (hi == o.hi && lo < o.lo);
  }
};

template <typename T>
struct NarrowCode {
  using Key = unsigned long long;
  unsigned long long top;
  __device__ static Key last() { return ~0ull; }
  __device__ Key encode(T c, bool cand, uint32_t sec) const {
    return (top - static_cast<unsigned long long>(c)) << 33 | static_cast<Key>(cand) << 32 | sec;
  }
  __device__ T count(Key key) const { return static_cast<T>(top - (key >> 33)); }
  __device__ static bool cand(Key key) { return (key >> 32) & 1; }
  __device__ static uint32_t sec(Key key) { return static_cast<uint32_t>(key); }
};

template <typename T>
struct WideCode {
  using Key = Key128;
  __device__ static Key last() { return {~0ull, ~0ull}; }
  __device__ Key encode(T c, bool cand, uint32_t sec) const {
    return {~static_cast<unsigned long long>(c), static_cast<unsigned long long>(cand) << 32 | sec};
  }
  __device__ T count(Key key) const { return static_cast<T>(~key.hi); }
  __device__ static bool cand(Key key) { return (key.lo >> 32) & 1; }
  __device__ static uint32_t sec(Key key) { return static_cast<uint32_t>(key.lo); }
};

// Bytes of the winners' sort buffer a slot: a narrow key and a tied
// candidate's IdKey, or a wide key (int64 counts).
template <typename T>
__host__ __device__ constexpr size_t key_bytes() {
  return sizeof(T) == 4 ? sizeof(unsigned long long) + sizeof(uint32_t) : sizeof(Key128);
}

__device__ __forceinline__ unsigned long long shfl_xor(unsigned long long v, int m) {
  return __shfl_xor_sync(kAll, v, m);
}
__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int m) {
  return __shfl_xor_sync(kAll, v, m);
}
__device__ __forceinline__ Key128 shfl_xor(Key128 v, int m) {
  return {__shfl_xor_sync(kAll, v.hi, m), __shfl_xor_sync(kAll, v.lo, m)};
}

// Entries of a winners' sort of n keys: a power of two, at least 64 (one
// warp's two registers a lane).
__host__ __device__ constexpr int sort_slots(int n) { return pow2_at_least(n < 64 ? 64 : n); }

// Dynamic shared memory of fused_ingest_kernel, in this order, each region
// 16-byte aligned: the winners' sort buffers (sort_slots(k) narrow keys and
// as many tied candidates' IdKeys, or sort_slots(k) wide keys); the
// summary's counts, errors and items; the hash table's int32 keys and its
// 16-bit weights (two a 32-bit word).
template <typename T>
__host__ __device__ constexpr size_t ingest_smem(int k, int w) {
  return align16(static_cast<size_t>(sort_slots(k)) * key_bytes<T>()) +
         2 * align16(static_cast<size_t>(k) * sizeof(T)) +
         align16(static_cast<size_t>(k) * sizeof(int32_t)) +
         static_cast<size_t>(table_slots(w)) * (sizeof(int32_t) + sizeof(uint16_t));
}

// The kernel's own static shared memory beside Scratch.
struct FlushScratch {
  int kept[2][kWarps];   // the compaction's kept entries a warp, two rounds in turn
  int n_above;           // candidate winners above thr placed so far
  int n_tied;            // candidate winners at thr placed so far
};

static_assert(align16(sizeof(Scratch)) + align16(sizeof(FlushScratch)) == 2336,
              "kernels/ss_ingest.py SMEM_STATIC mirrors the static shared memory");
static_assert(kSmemW < 32768, "a weight (at most W) fits in 16 bits and never carries");
static_assert(table_slots(kSmemW) > kSmemW, "the table holds W distinct ids and a free slot");
static_assert(sort_slots(kSmemK) <= 2 * kThreads, "the winners' sort: two keys a thread");
static_assert(ingest_smem<int64_t>(kSmemK, kSmemW) + 2336 <= kMaxSmem,
              "the largest flush fits one block's shared memory (kernels/ss_ingest.py mirrors it)");

// The flush pool: the k updated summary slots, then the window's unmatched
// distinct ids, compacted to the table's front in table order, candidate j
// (pool entry k + j) with weight weights[j] and count weight + m1. An entry
// may win if its count is >= 0, as IngestPool's.
template <typename T>
struct TablePool {
  const int32_t* items;
  const T* counts;
  const T* errors;
  const int32_t* keys;
  const uint16_t* weights;
  int k;
  T m1;

  __device__ bool count(int v, T& c) const {
    c = v < k ? counts[v] : wrap_add(static_cast<T>(weights[v - k]), m1);
    return c >= 0;
  }
};

// A pool entry's count as the select's key, for the entries that may win.
template <typename T>
struct CountOf {
  const TablePool<T>& pool;
  __device__ bool operator()(int v, typename std::make_unsigned<T>::type& u) const {
    T c;
    if (!pool.count(v, c)) return false;
    u = static_cast<typename std::make_unsigned<T>::type>(c);
    return true;
  }
};

// Candidate j's id, where its count is thr, as the select's key: ~IdKey, so
// that the largest keys are the lowest ids in signed order.
template <typename T>
struct TiedIdOf {
  const TablePool<T>& pool;
  T thr;
  __device__ bool operator()(int j, uint32_t& u) const {
    T c;
    if (!pool.count(pool.k + j, c) || c != thr) return false;
    u = ~IdKey{}(pool.keys[j]);
    return true;
  }
};

// One round of 4 window ids a lane into the table: each id's home slot is
// loaded, and where the id is not there a probe claims a free slot with
// atomicCAS (or finds the id, which another lane claimed); then each id adds
// 1 to its 16-bit weight in that weight's 32-bit word (no carry: a weight
// stays below 2^15). A lane's four loads and four adds are independent, so
// their latency is paid once for four ids. No lanes are grouped first: on
// the H100 __match_any_sync over a warp of distinct ids costs many times a
// shared-memory atomicAdd, conflicts included. EMPTY is not inserted, as
// chunk_histogram drops it. salt keys the hash (ss_hash::slot_in).
__device__ __forceinline__ void insert_ids(const int4& v, int32_t* keys, uint32_t* words,
                                           uint32_t n_slots, uint32_t salt) {
  const int32_t x[4] = {v.x, v.y, v.z, v.w};
  uint32_t p[4];
  int32_t seen[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = ss_hash::slot_in(x[j], n_slots, salt);
    seen[j] = x[j];
    if (x[j] != kEmpty) seen[j] = reinterpret_cast<volatile int32_t*>(keys)[p[j]];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (x[j] == kEmpty || seen[j] == x[j]) continue;
    for (int32_t s = seen[j];; p[j] = p[j] + 1 == n_slots ? 0 : p[j] + 1,
                 s = reinterpret_cast<volatile int32_t*>(keys)[p[j]]) {
      if (s == kEmpty) s = atomicCAS(&keys[p[j]], kEmpty, x[j]);
      if (s == kEmpty || s == x[j]) break;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (x[j] != kEmpty) atomicAdd(&words[p[j] >> 1], 1u << (16 * (p[j] & 1)));
  }
}

// The want-th largest (want >= 1) of the keys u of the entries v in [0, n)
// that key_of(v, u) accepts (at least want of them), radix-selected 8 bits a
// pass from the top with a shared-memory histogram (an atomicAdd an entry:
// cheaper on the H100 than grouping a warp's bins first). all and
// vary are the AND of a superset of the accepted keys and the bits on which
// that superset differs: a digit on which it agrees costs no pass. Returns
// the key; want becomes its rank, from the first, among the accepted
// entries equal to it, and n_equal (the number of accepted entries on
// entry) their number. Every thread calls it; it ends synchronised.
template <typename U, typename KeyOf>
__device__ U radix_select(const KeyOf& key_of, int n, U all, U vary, int& want, int& n_equal,
                          Scratch& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  U prefix = all & ~vary, mask = ~vary;
  for (int shift = 8 * static_cast<int>(sizeof(U)) - 8; shift >= 0; shift -= 8) {
    if (((vary >> shift) & 0xFF) == 0) continue;
    for (int b = tid; b < 256; b += kThreads) sh.hist[b] = 0;
    __syncthreads();
    for (int v = tid; v < n; v += kThreads) {
      U u;
      if (key_of(v, u) && (u & mask) == prefix) {
        atomicAdd(&sh.hist[static_cast<int>((u >> shift) & 0xFF)], 1);
      }
    }
    __syncthreads();
    if (tid < 32) {               // warp 0: the bin that holds the want-th largest
      int s = 0;
      for (int q = 0; q < 8; ++q) s += sh.hist[8 * lane + q];
      int suffix = s;             // entries in bins >= 8 * lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_down_sync(kAll, suffix, o);
        if (lane + o < 32) suffix += y;
      }
      const int above = suffix - s;
      if (above < want && want <= suffix) {
        int w = want - above, b = 8 * lane + 7;
        for (int q = 0; q < 7 && w > sh.hist[b]; ++q) {
          w -= sh.hist[b];
          --b;
        }
        sh.bin = b;
        sh.want = w;
      }
    }
    __syncthreads();
    prefix = (prefix & ~(static_cast<U>(0xFF) << shift)) | static_cast<U>(sh.bin) << shift;
    mask |= static_cast<U>(0xFF) << shift;
    want = sh.want;
    n_equal = sh.hist[sh.bin];   // the digits below agree: these entries equal the key
    __syncthreads();
  }
  return prefix;
}

// Sorts buf[0, n) ascending, n a power of two, 64 <= n <= 2 kThreads: a
// bitonic network (the stages before the last sort alternate runs up and
// down), warp w holding entries 64 w + lane and 64 w + 32 + lane in
// registers; strides below 32 are exchanged by shuffles, stride 32 within a
// lane, and larger strides through buf between barriers. Every thread calls
// it; it ends synchronised.
template <typename Key>
__device__ void bitonic_sort_keys(Key* buf, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool active = warp < n / 64;
  const int i0 = warp * 64 + lane, i1 = i0 + 32;
  Key e0{}, e1{};
  if (active) {
    e0 = buf[i0];
    e1 = buf[i1];
  }
  for (int size = 2; size <= n; size <<= 1) {
    int stride = size >> 1;
    if (stride >= 64) {
      if (active) {
        buf[i0] = e0;
        buf[i1] = e1;
      }
      __syncthreads();
      for (; stride >= 64; stride >>= 1) {
        if (tid < n / 2) {
          const int i = 2 * tid - (tid & (stride - 1)), j = i + stride;
          const Key a = buf[i], b = buf[j];
          if (size == n || (i & size) == 0 ? b < a : a < b) {
            buf[i] = b;
            buf[j] = a;
          }
        }
        __syncthreads();
      }
      if (active) {
        e0 = buf[i0];
        e1 = buf[i1];
      }
    }
    if (!active) continue;
    // the pair (i, i ^ stride): the lower index keeps the smaller key where
    // the run ascends, the larger where it descends
    const bool up0 = size == n || (i0 & size) == 0;
    const bool up1 = size == n || (i1 & size) == 0;
    if (stride == 32) {
      if (up0 ? e1 < e0 : e0 < e1) {
        const Key t = e0;
        e0 = e1;
        e1 = t;
      }
      stride = 16;
    }
    for (; stride > 0; stride >>= 1) {
      const bool lower = (lane & stride) == 0;
      const Key o0 = shfl_xor(e0, stride), o1 = shfl_xor(e1, stride);
      if (lower == up0 ? o0 < e0 : e0 < o0) e0 = o0;
      if (lower == up1 ? o1 < e1 : e1 < o1) e1 = o1;
    }
  }
  if (active) {
    buf[i0] = e0;
    buf[i1] = e1;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_ingest_kernel(const int32_t* __restrict__ s_items, const T* __restrict__ s_counts,
                    const T* __restrict__ s_errors, const int32_t* __restrict__ window,
                    int32_t* __restrict__ o_items, T* __restrict__ o_counts,
                    T* __restrict__ o_errors, int k, int w, uint32_t salt) {
  using U = typename std::make_unsigned<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch sh;
  __shared__ FlushScratch fs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int n_slots = table_slots(w);
  unsigned char* at = smem + align16(static_cast<size_t>(sort_slots(k)) * key_bytes<T>());
  T* counts = reinterpret_cast<T*>(at);
  at += align16(static_cast<size_t>(k) * sizeof(T));
  T* errors = reinterpret_cast<T*>(at);
  at += align16(static_cast<size_t>(k) * sizeof(T));
  int32_t* items = reinterpret_cast<int32_t*>(at);
  at += align16(static_cast<size_t>(k) * sizeof(int32_t));
  int32_t* keys = reinterpret_cast<int32_t*>(at);
  uint16_t* weights = reinterpret_cast<uint16_t*>(keys + n_slots);

  const int64_t b = blockIdx.x;
  s_items += b * k;
  s_counts += b * k;
  s_errors += b * k;
  const int32_t* row = window + b * w;

  // 1. load the summary; empty the table (keys EMPTY, weights 0)
  for (int i = tid; i < k; i += kThreads) {
    items[i] = s_items[i];
    counts[i] = s_counts[i];
    errors[i] = s_errors[i];
  }
  for (int p = tid; p < n_slots / 4; p += kThreads) {
    reinterpret_cast<int4*>(keys)[p] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  }
  for (int p = tid; p < n_slots / 8; p += kThreads) {
    reinterpret_cast<uint4*>(weights)[p] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) fs.n_above = fs.n_tied = 0;
  __syncthreads();
  const T m1 = min_frequency(items, counts, k, sh);   // before the update

  // 2. the window's exact histogram, streamed from device memory in 16-byte
  //    loads (each warp 32 of them a round, the next round's loaded first);
  //    the up to 3 ids before the row's first 16-byte boundary and the up to
  //    3 after its last whole int4 go in one round of warp 0
  uint32_t* words = reinterpret_cast<uint32_t*>(weights);
  const int misaligned = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = min(w, ((16 - misaligned) & 15) >> 2);
  const int n4 = (w - head) >> 2;
  const int4* body = reinterpret_cast<const int4*>(row + head);
  const int4 none = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  int4 ids = warp * 32 + lane < n4 ? body[warp * 32 + lane] : none;
  for (int base = warp * 32; base < n4; base += kThreads) {
    const int q = base + kThreads + lane;
    const int4 next = q < n4 ? body[q] : none;
    insert_ids(ids, keys, words, n_slots, salt);
    ids = next;
  }
  if (warp == 0) {
    const int tail = head + 4 * n4;
    const int4 rest = make_int4(lane < head ? row[lane] : kEmpty,
                                tail + lane < w ? row[tail + lane] : kEmpty, kEmpty, kEmpty);
    insert_ids(rest, keys, words, n_slots, salt);
  }
  __syncthreads();

  // 3. match + offsets (m2 = 0, no candidate errors): each summary slot
  //    looks its id up in the table; a matched slot gains the id's weight,
  //    and the id leaves the pool (its weight becomes 0); an EMPTY slot
  //    becomes (EMPTY, 0, 0). Valid summary ids are distinct, so no two
  //    slots touch one weight. The pool's valid counts are counted and
  //    their AND and OR taken, here and in step 4.
  unsigned n_valid = 0;
  U all = ~U(0), any = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = tid + s * kThreads;
    if (i >= k) break;
    const int32_t id = items[i];
    T c = 0;
    if (id == kEmpty) {
      errors[i] = 0;
    } else {
      c = counts[i];
      const int p = ss_hash::find_in(keys, id, n_slots, salt);
      if (p >= 0) {
        c = wrap_add(c, static_cast<T>(weights[p]));
        weights[p] = 0;
      }
    }
    counts[i] = c;
    if (c >= 0) {
      ++n_valid;
      all &= static_cast<U>(c);
      any |= static_cast<U>(c);
    }
  }
  __syncthreads();

  // 4. the unmatched ids move to the table's front, in order, in rounds of
  //    8 kThreads slots (8 in a row a lane, read as two int4 and two uint2;
  //    n_slots is a multiple of 8): a round writes only below its own end,
  //    after a barrier that follows every read of the round, and later
  //    rounds read only above it. A lane's place comes from 4 ballots of its
  //    count's bits, its warp's from one add-reduction. The candidates'
  //    ~IdKey AND and OR are taken for step 6.
  constexpr int kRound = 8 * kThreads;
  int n_cand = 0;
  uint32_t id_all = ~0u, id_any = 0;
  for (int r0 = 0; r0 < n_slots; r0 += kRound) {
    int32_t key[8];
    uint16_t weight[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = r0 + 8 * tid + 4 * h;
      int4 kq = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
      uint2 wq = make_uint2(0, 0);
      if (p < n_slots) {
        kq = reinterpret_cast<const int4*>(keys)[p >> 2];
        wq = reinterpret_cast<const uint2*>(weights)[p >> 2];
      }
      key[4 * h] = kq.x;
      key[4 * h + 1] = kq.y;
      key[4 * h + 2] = kq.z;
      key[4 * h + 3] = kq.w;
      weight[4 * h] = static_cast<uint16_t>(wq.x);
      weight[4 * h + 1] = static_cast<uint16_t>(wq.x >> 16);
      weight[4 * h + 2] = static_cast<uint16_t>(wq.y);
      weight[4 * h + 3] = static_cast<uint16_t>(wq.y >> 16);
    }
    int mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) mine += key[j] != kEmpty && weight[j] != 0;
    int before = 0, total = 0;           // kept entries of the lanes below, of the warp
#pragma unroll
    for (int bit = 0; bit < 4; ++bit) {
      const unsigned set = __ballot_sync(kAll, (mine >> bit) & 1);
      before += __popc(set & below) << bit;
      total += __popc(set) << bit;
    }
    int* kept = fs.kept[(r0 / kRound) & 1];
    if (lane == 0) kept[warp] = total;
    __syncthreads();
    const int theirs = kept[lane];
    int to = n_cand + __reduce_add_sync(kAll, lane < warp ? theirs : 0) + before;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (key[j] == kEmpty || weight[j] == 0) continue;
      keys[to] = key[j];
      weights[to] = weight[j];
      ++to;
      const uint32_t u = ~IdKey{}(key[j]);
      id_all &= u;
      id_any |= u;
      const T c = wrap_add(static_cast<T>(weight[j]), m1);
      if (c >= 0) {
        ++n_valid;
        all &= static_cast<U>(c);
        any |= static_cast<U>(c);
      }
    }
    n_cand += __reduce_add_sync(kAll, theirs);
  }
  __syncthreads();
  const int n_pool = k + n_cand;
  const TablePool<T> pool{items, counts, errors, keys, weights, k, m1};

  // 5. the k-th largest count thr: k or fewer valid entries all win (thr =
  //    -1); else `ties` of the n_equal entries equal to thr win
  unsigned long long n_valid_all;
  block_exclusive_scan(n_valid, sh, n_valid_all);
  const U vary = varying_bits(all, any, sh);
  const bool take_all = n_valid_all <= static_cast<unsigned long long>(k);
  T thr = T(-1);
  int ties = 0, n_equal = static_cast<int>(n_valid_all);
  if (!take_all) {
    ties = k;
    thr = static_cast<T>(radix_select<U>(CountOf<T>{pool}, n_pool, all, vary, ties, n_equal,
                                         sh));
  }

  // 6. the summary's winners in slot order (a block scan of (above thr, at
  //    thr) over contiguous slot ranges): ties go to the summary slots
  //    first, the rest of them to the tied candidates with the lowest ids,
  //    those whose ~IdKey is at least id_min (the ties_c-th largest; ids
  //    are distinct)
  const int per = (k + kThreads - 1) / kThreads;
  const int lo = min(k, tid * per), hi = min(k, lo + per);
  unsigned gt = 0, eq = 0;
  for (int v = lo; v < hi; ++v) {
    T c;
    if (!pool.count(v, c)) continue;
    if (c > thr) ++gt; else if (c == thr) ++eq;
  }
  unsigned long long total;
  const unsigned long long ex = block_exclusive_scan(
      (static_cast<unsigned long long>(gt) << 32) | eq, sh, total);
  const int eq_s = static_cast<int>(total & 0xffffffffu);
  const int ties_s = min(ties, eq_s);
  const int ties_c = ties - ties_s;
  uint32_t id_min = 0;
  if (ties_c > 0 && ties_c < n_equal - eq_s) {
    const uint32_t id_vary = varying_bits(id_all, id_any, sh);
    int want = ties_c, unused;
    id_min = radix_select<uint32_t>(TiedIdOf<T>{pool, thr}, n_cand, id_all, id_vary, want,
                                    unused, sh);
  }

  // 7. the winners: those above thr as keys into the sort buffer (the
  //    summary's from their scan places, the candidates' after them in any
  //    order; Code::last() in the rest of its power of two); where the keys
  //    are narrow (split), the tied candidates that win as their IdKeys into
  //    a second buffer, else every winner into the first. 8. A sort of each
  //    buffer: the keys in merge_pool's order, the tied ids ascending. 9.
  //    The winners written out: those above thr, the summary's ties in slot
  //    order (no sort: the scan ranks them), the tied candidates by id; the
  //    slots past them empty.
  const int above_s = static_cast<int>(total >> 32);
  const auto finish = [&](const auto& code) {
    using Code = std::decay_t<decltype(code)>;
    using Key = typename Code::Key;
    constexpr bool split = sizeof(Key) == sizeof(unsigned long long);
    Key* buf = reinterpret_cast<Key*>(smem);
    uint32_t* tied = reinterpret_cast<uint32_t*>(buf + sort_slots(k));
    const int ties_first = split ? 0 : ties_s;      // summary ties sorted too, if not split
    int out = static_cast<int>(ex >> 32) + min(static_cast<int>(ex & 0xffffffffu), ties_first);
    int tie = static_cast<int>(ex & 0xffffffffu);
    for (int v = lo; v < hi; ++v) {
      T c;
      if (!pool.count(v, c)) continue;
      if (c > thr || (c == thr && tie++ < ties_first)) buf[out++] = code.encode(c, false, v);
    }
    for (int j0 = 0; j0 < n_cand; j0 += kThreads) {
      const int j = j0 + tid;
      bool above = false, at = false;
      T c;
      uint32_t id_key = 0;
      if (j < n_cand && pool.count(k + j, c)) {
        id_key = IdKey{}(keys[j]);
        above = c > thr;
        at = c == thr && ties_c > 0 && ~id_key >= id_min;
      }
      unsigned set = __ballot_sync(kAll, above || (!split && at));
      int first = 0;
      if (lane == 0 && set) first = atomicAdd(&fs.n_above, __popc(set));
      first = __shfl_sync(kAll, first, 0);
      if (above || (!split && at)) {
        buf[above_s + ties_first + first + __popc(set & below)] = code.encode(c, true, id_key);
      }
      if (split) {
        set = __ballot_sync(kAll, at);
        first = 0;
        if (lane == 0 && set) first = atomicAdd(&fs.n_tied, __popc(set));
        first = __shfl_sync(kAll, first, 0);
        if (at) tied[first + __popc(set & below)] = id_key;
      }
    }
    __syncthreads();
    const int n_above = above_s + ties_first + fs.n_above;   // all winners unless split
    const int n_tied = fs.n_tied;                             // 0 unless split
    const int n_sort = sort_slots(n_above), n_sort_tied = sort_slots(n_tied);
    for (int i = n_above + tid; i < n_sort; i += kThreads) buf[i] = Code::last();
    for (int i = n_tied + tid; n_tied > 1 && i < n_sort_tied; i += kThreads) tied[i] = ~0u;
    __syncthreads();
    if (n_above > 1) bitonic_sort_keys(buf, n_sort);
    if (n_tied > 1) bitonic_sort_keys(tied, n_sort_tied);

    const int tied_at = n_above + ties_s - ties_first, n_sel = tied_at + n_tied;
    for (int i = tid; i < k; i += kThreads) {
      if (i >= n_above && i < tied_at) continue;     // a summary tie, written below
      int32_t item = kEmpty;
      T c = 0, e = 0;
      if (i < n_above) {
        const Key key = buf[i];
        const uint32_t sec = Code::sec(key);
        c = code.count(key);
        if (Code::cand(key)) {
          item = static_cast<int32_t>(sec ^ 0x80000000u);
          e = m1;
        } else {
          item = items[sec];
          e = errors[sec];
        }
      } else if (i < n_sel) {
        item = static_cast<int32_t>(tied[i - tied_at] ^ 0x80000000u);
        c = thr;
        e = m1;
      }
      o_items[b * k + i] = item;
      o_counts[b * k + i] = c;
      o_errors[b * k + i] = e;
    }
    tie = static_cast<int>(ex & 0xffffffffu);
    for (int v = lo; v < hi && split && tie < ties_s; ++v) {
      T c;
      if (!pool.count(v, c) || c != thr) continue;
      o_items[b * k + n_above + tie] = items[v];
      o_counts[b * k + n_above + tie] = c;
      o_errors[b * k + n_above + tie] = errors[v];
      ++tie;
    }
  };
  // any is the OR of the valid counts, so at least each winner's count
  const U lowest = thr < 0 ? U(0) : static_cast<U>(thr);
  if (sizeof(T) == 4 || any - lowest < (U(1) << 31)) {
    finish(NarrowCode<T>{static_cast<unsigned long long>(any)});
  } else {
    finish(WideCode<T>{});
  }
}

// The workspace of one tenant (16-byte aligned bytes): the updated counts
// and errors (k each), two k-rank buffers of the selection, and two
// (w + 1)-entry buffers, the window's and the run starts'.
template <typename T>
__host__ __device__ size_t ingest_workspace(int k, int w) {
  const size_t bytes = 2 * static_cast<size_t>(k) * sizeof(T) +
      (2 * static_cast<size_t>(k) + 2 * (static_cast<size_t>(w) + 1)) * sizeof(int32_t);
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// fused_ingest_kernel for any k and w, its large buffers in the workspace.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_ingest_workspace_kernel(const int32_t* __restrict__ s_items,
                              const T* __restrict__ s_counts, const T* __restrict__ s_errors,
                              const int32_t* __restrict__ window,
                              int32_t* __restrict__ o_items, T* __restrict__ o_counts,
                              T* __restrict__ o_errors, unsigned char* __restrict__ workspace,
                              int k, int w) {
  __shared__ uint32_t count[kCounters];
  __shared__ Scratch sh;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  T* counts = reinterpret_cast<T*>(workspace + b * ingest_workspace<T>(k, w));
  T* errors = counts + k;
  int32_t* sel_rank = reinterpret_cast<int32_t*>(errors + k);
  int32_t* sel_tmp = sel_rank + k;
  int32_t* ids = sel_tmp + k;
  int32_t* pos = ids + w + 1;

  s_items += b * k;
  s_counts += b * k;
  s_errors += b * k;
  window += b * w;
  for (int i = tid; i < k; i += kThreads) {
    counts[i] = s_counts[i];
    errors[i] = s_errors[i];
  }
  for (int p = tid; p < w; p += kThreads) ids[p] = window[p];
  __syncthreads();

  const T m1 = min_frequency(s_items, s_counts, k, sh);   // before the update
  if (radix_sort<uint32_t>(IdKey{}, ids, pos, w, count, sh) == pos) {
    int32_t* t = ids;   // an odd number of passes left the window in pos
    ids = pos;
    pos = t;
  }
  const int n_runs = run_starts(ids, pos, w, sh);

  // match + offsets as fused_ingest_kernel; each slot's matched run start
  // waits in sel_rank until every slot has searched the window
  for (int i = tid; i < k; i += kThreads) {
    int matched = -1;
    const int32_t id = s_items[i];
    if (id == kEmpty) {
      counts[i] = 0;
      errors[i] = 0;
    } else {
      const int p = lower_bound(ids, w, id);
      if (p < w && ids[p] == id) {
        counts[i] = wrap_add(counts[i], static_cast<T>(upper_bound(ids, w, id) - p));
        matched = p;
      }
    }
    sel_rank[i] = matched;
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads) {
    if (sel_rank[i] >= 0) ids[sel_rank[i]] = kEmpty;   // a matched candidate leaves the pool
  }
  __syncthreads();

  keep_top_k(IngestPool<T>{s_items, counts, errors, ids, pos, k, m1}, k + n_runs, k,
             sel_rank, sel_tmp, count, sh, o_items + b * k, o_counts + b * k,
             o_errors + b * k);
}

// The COMBINE pool: k updated slots of s1, then s2's k slots in slot order.
template <typename T>
struct CombinePool {
  const int32_t* items1;
  const T* counts1;
  const T* errors1;
  const int32_t* items2;   // a matched slot's item is EMPTY
  const T* counts2;
  const T* errors2;
  int k;
  T m1;

  __device__ bool count(int v, T& c) const {
    if (v < k) {
      c = counts1[v];
      return c >= 0;
    }
    if (items2[v - k] == kEmpty) return false;
    c = wrap_add(counts2[v - k], m1);
    return c >= 0;
  }
  __device__ void entry(int v, int32_t& item, T& c, T& e) const {
    if (v < k) {
      item = items1[v];
      c = counts1[v];
      e = errors1[v];
      return;
    }
    item = items2[v - k];
    c = wrap_add(counts2[v - k], m1);
    e = wrap_add(errors2[v - k], m1);
  }
};

// -- the shared-memory COMBINE -----------------------------------------------

static_assert(kSmemK * sizeof(int64_t) / 16 <= kThreads, "a row: one 16-byte vector a thread");

// The block's totals of each thread's count n of valid pool entries and the
// AND and OR of their counts (all and any, replaced by the totals), in one
// barrier where block_exclusive_scan and varying_bits take four: ~2 000 SM
// cycles a COMBINE on the H100 (tools/smem_phases.py --kernel combine, the
// pool phase). It leaves sh.red, sh.key_and and sh.key_or to be read by
// every warp: no thread may write them again before a barrier.
template <typename U>
__device__ unsigned pool_totals(unsigned n, U& all, U& any, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  n = __reduce_add_sync(kAll, n);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    all &= __shfl_xor_sync(kAll, all, o);
    any |= __shfl_xor_sync(kAll, any, o);
  }
  if (lane == 0) {
    sh.red[warp] = n;
    sh.key_and[warp] = all;
    sh.key_or[warp] = any;
  }
  __syncthreads();
  n = __reduce_add_sync(kAll, static_cast<unsigned>(sh.red[lane]));
  all = static_cast<U>(sh.key_and[lane]);
  any = static_cast<U>(sh.key_or[lane]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    all &= __shfl_xor_sync(kAll, all, o);
    any |= __shfl_xor_sync(kAll, any, o);
  }
  return n;
}

// The COMBINE pool's count of entry v as the select's key, for the entries
// that may win (count >= 0).
template <typename T>
struct PoolCount {
  const T* counts;
  __device__ bool operator()(int v, typename std::make_unsigned<T>::type& u) const {
    const T c = counts[v];
    u = static_cast<typename std::make_unsigned<T>::type>(c);
    return c >= 0;
  }
};

// A COMBINE winner's key, ascending in merge_pool's order: count
// descending, then pool rank. RankCode: (top - count) << 12 | rank in one
// word K, where top >= every winner's count and top - count < 2^19 (K 32
// bits) or < 2^51 (K 64 bits, always so at int32), so that no key is
// last(); WideCode's 128 bits (~count, rank) otherwise. sec is the rank,
// which is below 2 kSmemK.
template <typename T, typename K>
struct RankCode {
  using Key = K;
  unsigned long long top;
  __device__ static Key last() { return ~K(0); }
  __device__ Key encode(T c, bool, uint32_t sec) const {
    return static_cast<K>((top - static_cast<unsigned long long>(c)) << 12 | sec);
  }
  __device__ static uint32_t sec(Key key) { return static_cast<uint32_t>(key & 0xFFF); }
};

static_assert(2 * kSmemK <= 4096, "a pool rank fits in 12 bits");

// Bytes of the COMBINE's winners' sort buffer a slot: a RankCode key, or a
// wide key (int64 counts).
template <typename T>
__host__ __device__ constexpr size_t combine_key_bytes() {
  return sizeof(T) == 4 ? sizeof(unsigned long long) : sizeof(Key128);
}

// Slots of the COMBINE's hash table for s2's k ids: 4 k rounded up to a
// multiple of 8. Its load is at most 1/4: the block waits at a barrier for
// its longest probe chain, which at the flush table's load of 2/3 made the
// build of 2 048 ids cost 12 000-21 000 cycles on the H100
// (tools/smem_phases.py --kernel combine).
__host__ __device__ constexpr int join_slots(int k) { return (4 * k + 7) & ~7; }

// Dynamic shared memory of fused_combine_kernel, in this order, each region
// 16-byte aligned: the winners' sort buffer (sort_slots(k) keys); the
// pool's 2k counts, errors and items (s1's k slots, then s2's); the hash
// table's join_slots(k) int32 keys and as many s2 slot numbers.
template <typename T>
__host__ __device__ constexpr size_t combine_smem(int k) {
  return align16(static_cast<size_t>(sort_slots(k)) * combine_key_bytes<T>()) +
         2 * align16(2 * static_cast<size_t>(k) * sizeof(T)) +
         align16(2 * static_cast<size_t>(k) * sizeof(int32_t)) +
         2 * static_cast<size_t>(join_slots(k)) * sizeof(int32_t);
}

static_assert(align16(sizeof(Scratch)) == 2064,
              "kernels/ss_ingest.py COMBINE_SMEM_STATIC mirrors the COMBINE's static scratch");
static_assert(combine_smem<int32_t>(kSmemK) == 131072 && combine_smem<int64_t>(kSmemK) == 180224,
              "kernels/ss_ingest.py combine_smem_bytes mirrors combine_smem");
static_assert(combine_smem<int64_t>(kSmemK) + 2064 <= kMaxSmem,
              "the largest COMBINE fits one block's shared memory");

// Inserts s2's valid id x at slot j into the table: its home slot is
// loaded (seen) before the call, a free slot is claimed by atomicCAS where
// the id is not there yet, and the slot field keeps the lowest slot that
// holds the id (atomicMin), as the (id, slot) order did for a summary that
// holds an id twice.
__device__ __forceinline__ void insert_slot(int32_t x, int32_t seen, uint32_t p, int j,
                                            int32_t* keys, int32_t* where, uint32_t n_slots) {
  for (int32_t s = seen;; p = p + 1 == n_slots ? 0 : p + 1,
               s = reinterpret_cast<volatile int32_t*>(keys)[p]) {
    if (s == kEmpty) s = atomicCAS(&keys[p], kEmpty, x);
    if (s == kEmpty || s == x) break;
  }
  atomicMin(&where[p], j);
}

// The COMBINE of one pair (s1, s2) a block: combine(s1, s2) with the sorted
// matcher, bitwise. Every step between reading the inputs once and writing
// the outputs once works in shared memory:
//   1. both summaries are loaded, in 16-byte loads where k is a multiple of
//      4, into the pool's arrays (s1's k slots, then s2's), and the table
//      emptied; each warp takes the least count of each summary and whether
//      it holds an EMPTY slot;
//   2. s2's valid ids go into an open-addressing table of join_slots(k)
//      slots under ss_hash's keyed hash (the salt drawn by the wrapper for
//      each launch), with their slot numbers; m1 and m2 from the warps'
//      partials;
//   3. each s1 slot looks its id up: a hit adds s2's count and error and
//      takes that s2 slot out of the pool (its item becomes EMPTY), a miss
//      adds m2; an EMPTY slot becomes (EMPTY, 0, 0);
//   4. s2's remaining slots join the pool at count + m1 and error + m1, a
//      taken or EMPTY slot at count -1 (it may not win); the pool's valid
//      entries are counted and the AND and OR of their counts taken;
//   5. a radix select finds the k-th largest count thr, skipping the
//      digits on which every valid count agrees;
//   6. one block scan of (above thr, at thr) over contiguous ranges of the
//      pool gives the ties to the lowest pool ranks (s1 in slot order, then
//      s2), as lax.top_k, and each winner its place in a buffer;
//   7. each winner is written there as one key, count descending then pool
//      rank, and only those keys are sorted (a bitonic network);
//   8. the winners are written out, (EMPTY, 0, 0) in the slots past them.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_combine_kernel(const int32_t* __restrict__ a_items, const T* __restrict__ a_counts,
                     const T* __restrict__ a_errors, const int32_t* __restrict__ b_items,
                     const T* __restrict__ b_counts, const T* __restrict__ b_errors,
                     int32_t* __restrict__ o_items, T* __restrict__ o_counts,
                     T* __restrict__ o_errors, int k, uint32_t salt) {
  using U = typename std::make_unsigned<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_pool = 2 * k, n_slots = join_slots(k);
  unsigned char* at = smem + align16(static_cast<size_t>(sort_slots(k)) * combine_key_bytes<T>());
  T* counts = reinterpret_cast<T*>(at);
  at += align16(static_cast<size_t>(n_pool) * sizeof(T));
  T* errors = reinterpret_cast<T*>(at);
  at += align16(static_cast<size_t>(n_pool) * sizeof(T));
  int32_t* items = reinterpret_cast<int32_t*>(at);
  at += align16(static_cast<size_t>(n_pool) * sizeof(int32_t));
  int32_t* keys = reinterpret_cast<int32_t*>(at);
  int32_t* where = keys + n_slots;   // the lowest s2 slot of each key

  // 1. load: where k is a multiple of 4 and the six tensors start on
  //    16-byte boundaries, every row does too, and each thread loads at most
  //    one 16-byte vector of each row, all six before its stores; a ragged
  //    k or an offset tensor is loaded element by element. Empty the table.
  const int64_t off = static_cast<int64_t>(blockIdx.x) * k;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a_items) |
                          reinterpret_cast<uintptr_t>(b_items) |
                          reinterpret_cast<uintptr_t>(a_counts) |
                          reinterpret_cast<uintptr_t>(b_counts) |
                          reinterpret_cast<uintptr_t>(a_errors) |
                          reinterpret_cast<uintptr_t>(b_errors);
  if (k % 4 == 0 && (bases & 15) == 0) {
    const int n_ids = k / 4, n_counts = k * static_cast<int>(sizeof(T)) / 16;
    int4 i1, i2, c1, c2, e1, e2;
    if (tid < n_ids) {
      i1 = reinterpret_cast<const int4*>(a_items + off)[tid];
      i2 = reinterpret_cast<const int4*>(b_items + off)[tid];
    }
    if (tid < n_counts) {
      c1 = reinterpret_cast<const int4*>(a_counts + off)[tid];
      c2 = reinterpret_cast<const int4*>(b_counts + off)[tid];
      e1 = reinterpret_cast<const int4*>(a_errors + off)[tid];
      e2 = reinterpret_cast<const int4*>(b_errors + off)[tid];
    }
    if (tid < n_ids) {
      reinterpret_cast<int4*>(items)[tid] = i1;
      reinterpret_cast<int4*>(items + k)[tid] = i2;
    }
    if (tid < n_counts) {
      reinterpret_cast<int4*>(counts)[tid] = c1;
      reinterpret_cast<int4*>(counts + k)[tid] = c2;
      reinterpret_cast<int4*>(errors)[tid] = e1;
      reinterpret_cast<int4*>(errors + k)[tid] = e2;
    }
  } else {
    for (int i = tid; i < k; i += kThreads) {
      const int32_t i1 = a_items[off + i], i2 = b_items[off + i];
      const T c1 = a_counts[off + i], c2 = b_counts[off + i];
      const T e1 = a_errors[off + i], e2 = b_errors[off + i];
      items[i] = i1;
      items[k + i] = i2;
      counts[i] = c1;
      counts[k + i] = c2;
      errors[i] = e1;
      errors[k + i] = e2;
    }
  }
  for (int p = tid; p < n_slots / 4; p += kThreads) {
    reinterpret_cast<int4*>(keys)[p] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    reinterpret_cast<int4*>(where)[p] = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  }
  __syncthreads();
  {
    // min_frequency of both summaries, a warp's share: its least counts and
    // which summaries it saw an EMPTY slot in
    T least1 = Limits<T>::kMax, least2 = Limits<T>::kMax;
    bool empty1 = false, empty2 = false;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = tid + s * kThreads;
      if (i >= k) break;
      least1 = counts[i] < least1 ? counts[i] : least1;
      least2 = counts[k + i] < least2 ? counts[k + i] : least2;
      empty1 = empty1 || items[i] == kEmpty;
      empty2 = empty2 || items[k + i] == kEmpty;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T y1 = __shfl_xor_sync(kAll, least1, o), y2 = __shfl_xor_sync(kAll, least2, o);
      least1 = y1 < least1 ? y1 : least1;
      least2 = y2 < least2 ? y2 : least2;
    }
    const unsigned empties = (__any_sync(kAll, empty1) ? 1u : 0u) |
                             (__any_sync(kAll, empty2) ? 2u : 0u);
    if (lane == 0) {
      sh.red[warp] = least1;
      sh.key_and[warp] = static_cast<unsigned long long>(static_cast<long long>(least2));
      sh.key_or[warp] = empties;
    }
  }

  // 2. build: s2's valid ids into the table, every home slot loaded first
  {
    int32_t x[kSlots], seen[kSlots];
    uint32_t p[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = tid + s * kThreads;
      x[s] = kEmpty;
      if (j < k) x[s] = items[k + j];
      p[s] = ss_hash::slot_in(x[s], n_slots, salt);
      seen[s] = x[s];
      if (x[s] != kEmpty) seen[s] = reinterpret_cast<volatile int32_t*>(keys)[p[s]];
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (x[s] != kEmpty) {
        insert_slot(x[s], seen[s], p[s], tid + s * kThreads, keys, where, n_slots);
      }
    }
  }
  __syncthreads();
  T m1, m2;
  {
    T least1 = static_cast<T>(sh.red[lane]);
    T least2 = static_cast<T>(static_cast<long long>(sh.key_and[lane]));
    const unsigned empties = __reduce_or_sync(kAll, static_cast<unsigned>(sh.key_or[lane]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T y1 = __shfl_xor_sync(kAll, least1, o), y2 = __shfl_xor_sync(kAll, least2, o);
      least1 = y1 < least1 ? y1 : least1;
      least2 = y2 < least2 ? y2 : least2;
    }
    m1 = empties & 1u ? T(0) : least1;
    m2 = empties & 2u ? T(0) : least2;
  }

  // 3. probe + offsets: both (c1 + c2, e1 + e2), s1 only (c1 + m2, e1 + m2);
  //    valid s1 ids are distinct, so a slot of s2 is taken by one s1 slot
  //    at most, and no atomics are needed. The pool's valid counts are
  //    counted and their AND and OR taken, here and in step 4.
  unsigned n_valid = 0;
  U all = ~U(0), any = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = tid + s * kThreads;
    if (i >= k) break;
    const int32_t id = items[i];
    T c = 0, e = 0;
    if (id != kEmpty) {
      c = counts[i];
      e = errors[i];
      const int p = ss_hash::find_in(keys, id, n_slots, salt);
      if (p >= 0) {
        const int j = k + where[p];
        c = wrap_add(c, counts[j]);
        e = wrap_add(e, errors[j]);
        items[j] = kEmpty;
      } else {
        c = wrap_add(c, m2);
        e = wrap_add(e, m2);
      }
    }
    counts[i] = c;
    errors[i] = e;
    if (c >= 0) {
      ++n_valid;
      all &= static_cast<U>(c);
      any |= static_cast<U>(c);
    }
  }
  __syncthreads();

  // 4. s2's slots as pool entries k .. 2k - 1
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int v = k + tid + s * kThreads;
    if (v >= n_pool) break;
    T c = T(-1);
    if (items[v] != kEmpty) {
      c = wrap_add(counts[v], m1);
      errors[v] = wrap_add(errors[v], m1);
    }
    counts[v] = c;
    if (c >= 0) {
      ++n_valid;
      all &= static_cast<U>(c);
      any |= static_cast<U>(c);
    }
  }
  n_valid = pool_totals(n_valid, all, any, sh);

  // 5. the k-th largest count thr: k or fewer valid entries all win
  //    (thr = -1); else `ties` of the entries equal to thr win
  T thr = T(-1);
  int ties = 0;
  if (n_valid > static_cast<unsigned>(k)) {
    ties = k;
    int n_equal = 0;
    thr = static_cast<T>(radix_select<U>(PoolCount<T>{counts}, n_pool, all, all ^ any, ties,
                                         n_equal, sh));
  }

  // 6. each thread's contiguous range of the pool: its winners' places
  const int per = (n_pool + kThreads - 1) / kThreads;
  const int lo = min(n_pool, tid * per), hi = min(n_pool, lo + per);
  unsigned gt = 0, eq = 0;
  for (int v = lo; v < hi; ++v) {
    const T c = counts[v];
    if (c < 0) continue;
    if (c > thr) ++gt; else if (c == thr) ++eq;
  }
  unsigned long long total;
  const unsigned long long ex = block_exclusive_scan(
      (static_cast<unsigned long long>(gt) << 32) | eq, sh, total);
  const int n_sel = static_cast<int>(total >> 32) +
                    min(static_cast<int>(total & 0xffffffffu), ties);

  // 7. the winners' keys at their places (Code::last() in the rest of the
  //    buffer's power of two), sorted; 8. the winners written out
  const auto finish = [&](const auto& code) {
    using Code = std::decay_t<decltype(code)>;
    using Key = typename Code::Key;
    Key* buf = reinterpret_cast<Key*>(smem);
    int tie = static_cast<int>(ex & 0xffffffffu);
    int out = static_cast<int>(ex >> 32) + min(tie, ties);
    for (int v = lo; v < hi; ++v) {
      const T c = counts[v];
      if (c < 0) continue;
      if (c > thr || (c == thr && tie++ < ties)) buf[out++] = code.encode(c, false, v);
    }
    const int n_sort = sort_slots(n_sel);
    for (int i = n_sel + tid; i < n_sort; i += kThreads) buf[i] = Code::last();
    __syncthreads();
    if (n_sel > 1) bitonic_sort_keys(buf, n_sort);
    for (int i = tid; i < k; i += kThreads) {
      int32_t item = kEmpty;
      T c = 0, e = 0;
      if (i < n_sel) {
        const int v = static_cast<int>(Code::sec(buf[i]));
        item = items[v];
        c = counts[v];
        e = errors[v];
      }
      o_items[off + i] = item;
      o_counts[off + i] = c;
      o_errors[off + i] = e;
    }
  };
  // any is the OR of the valid counts, so at least each winner's count
  const U lowest = thr < 0 ? U(0) : static_cast<U>(thr);
  const unsigned long long top = static_cast<unsigned long long>(any);
  if (any - lowest < (U(1) << 19)) {
    finish(RankCode<T, uint32_t>{top});
  } else if (sizeof(T) == 4 || static_cast<unsigned long long>(any - lowest) < (1ull << 51)) {
    finish(RankCode<T, unsigned long long>{top});
  } else if constexpr (sizeof(T) == 8) {
    finish(WideCode<T>{});
  }
}

// A slot's sort key in s2: its id's signed order as unsigned.
struct SlotIdKey {
  const int32_t* ids;
  __device__ uint32_t operator()(int32_t slot) const { return IdKey{}(ids[slot]); }
};

// The workspace of one pair (16-byte aligned bytes): s1's updated counts and
// errors (k each), s2's items with its matched slots marked EMPTY, s2's slot
// numbers sorted by id and the ids in that order (the sort's two buffers),
// and two k-rank buffers of the selection.
template <typename T>
__host__ __device__ size_t combine_workspace(int k) {
  const size_t bytes = 2 * static_cast<size_t>(k) * sizeof(T) +
                       5 * static_cast<size_t>(k) * sizeof(int32_t);
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// The COMBINE for any k, its buffers in the workspace; s2's keys are its
// slot numbers, radix-sorted stably by id: (id, slot) order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_combine_workspace_kernel(const int32_t* __restrict__ a_items,
                               const T* __restrict__ a_counts, const T* __restrict__ a_errors,
                               const int32_t* __restrict__ b_items,
                               const T* __restrict__ b_counts, const T* __restrict__ b_errors,
                               int32_t* __restrict__ o_items, T* __restrict__ o_counts,
                               T* __restrict__ o_errors, unsigned char* __restrict__ workspace,
                               int k) {
  __shared__ uint32_t count[kCounters];
  __shared__ Scratch sh;
  const int tid = threadIdx.x;
  const int64_t off = static_cast<int64_t>(blockIdx.x) * k;
  T* counts1 = reinterpret_cast<T*>(workspace + blockIdx.x * combine_workspace<T>(k));
  T* errors1 = counts1 + k;
  int32_t* items2 = reinterpret_cast<int32_t*>(errors1 + k);
  int32_t* slots = items2 + k;
  int32_t* sorted = slots + k;
  int32_t* sel_rank = sorted + k;
  int32_t* sel_tmp = sel_rank + k;

  a_items += off;
  a_counts += off;
  a_errors += off;
  b_items += off;
  b_counts += off;
  b_errors += off;
  for (int i = tid; i < k; i += kThreads) {
    counts1[i] = a_counts[i];
    errors1[i] = a_errors[i];
    items2[i] = b_items[i];
    slots[i] = i;
  }
  __syncthreads();

  const T m1 = min_frequency(a_items, a_counts, k, sh);   // before the update
  const T m2 = min_frequency(b_items, b_counts, k, sh);
  const int32_t* by_id = radix_sort<uint32_t>(SlotIdKey{b_items}, slots, sorted, k, count, sh);
  int32_t* ids2 = by_id == slots ? sorted : slots;
  for (int q = tid; q < k; q += kThreads) ids2[q] = b_items[by_id[q]];
  __syncthreads();

  // match + offsets (both: c1 + c2, e1 + e2; s1 only: c1 + m2, e1 + m2; an
  // EMPTY slot of s1: (EMPTY, 0, 0)); each slot's matched s2 slot waits in
  // sel_rank until every slot has searched
  for (int i = tid; i < k; i += kThreads) {
    int matched = -1;
    const int32_t id = a_items[i];
    if (id == kEmpty) {
      counts1[i] = 0;
      errors1[i] = 0;
    } else {
      const int q = lower_bound(ids2, k, id);
      if (q < k && ids2[q] == id) {
        const int j = by_id[q];
        counts1[i] = wrap_add(counts1[i], b_counts[j]);
        errors1[i] = wrap_add(errors1[i], b_errors[j]);
        matched = j;
      } else {
        counts1[i] = wrap_add(counts1[i], m2);
        errors1[i] = wrap_add(errors1[i], m2);
      }
    }
    sel_rank[i] = matched;
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads) {
    if (sel_rank[i] >= 0) items2[sel_rank[i]] = kEmpty;   // a matched s2 slot leaves the pool
  }
  __syncthreads();

  keep_top_k(CombinePool<T>{a_items, counts1, errors1, items2, b_counts, b_errors, k, m1},
             2 * k, k, sel_rank, sel_tmp, count, sh, o_items + off, o_counts + off,
             o_errors + off);
}

// ---------------------------------------------------------------------------
// The cluster path: one tenant (or pair) on a thread-block cluster of C
// blocks (C in 2, 4, 8, 16), each block owning a contiguous 1/C slice of the
// window (S = ceil(W / C) ids) and of the summary's slots (ks = ceil(k / C))
// in its own shared memory. What one block of the shared-memory path keeps
// in shared memory, the cluster keeps in its C blocks' shared memory, and
// what crosses blocks goes through distributed shared memory (DSMEM):
// map_shared_rank reads and writes a peer's buffer, and cluster.sync(),
// release/acquire over the cluster, orders those accesses (a block's first
// DSMEM access follows one, and its last precedes the final one, so no
// block leaves while a peer may still read it).
// Replaces, with the other two paths, fused_ingest_pallas and
// fused_combine_pallas (repro/kernels/ss_ingest.py). What bounds it on the
// H100: not bytes (a flush reads its inputs once from device memory and
// writes its outputs once) but the serial steps of one tenant's merge, and
// how many SMs a batch keeps busy. One block a tenant (the workspace path)
// leaves most SMs idle at small B and waits on L2 in every step; the
// cluster spreads a tenant over C SMs with every buffer on chip. Its costs
// are a cluster.sync (about 1 400 cycles; two a sort pass, about 20 a
// flush) and the ranking of the radix sorts, as in the shared-memory path;
// the design keeps remote traffic to coalesced copies (each sort pass
// scatters locally, then copies each digit's run of keys to its place in
// the peers' slices, neighbouring threads to neighbouring places) and a
// few values a block (digit totals, histograms, counts). The match runs
// where the data is: every block looks every slot's id up in its own
// sorted slice, and the block that holds the id's first entry updates the
// slot in whichever block it lives.


// A winner: its entry, sorted on ~count (stable: pool order on ties).
template <typename T>
struct Winner {
  T count;
  T error;
  int32_t item;
};

// COMBINE: one slot of s2 with its id, sorted stably by id: (id, slot) order.
struct IdSlot {
  int32_t id;
  int32_t slot;
};

template <typename T>
struct WinnerOrder {
  __device__ typename std::make_unsigned<T>::type operator()(const Winner<T>& v) const {
    return ~static_cast<typename std::make_unsigned<T>::type>(v.count);
  }
};

struct IdSlotKey {
  __device__ uint32_t operator()(const IdSlot& v) const { return IdKey{}(v.id); }
};

// Each block's cross-block scratch, at the start of its dynamic shared
// memory; a peer reads it through DSMEM. The arrays with a [2] are written
// in turn, so that a write never meets a peer's read of the previous round
// (every round ends with a cluster.sync between the two).
struct ClusterScratch {
  Scratch sh;                        // the block's own scans and reductions
  unsigned long long pub[2][2];      // two values a block publishes to the cluster
  uint32_t dtot[2][kDigits];         // a sort pass: the block's count of each digit
  int hist[2][256];                  // a select pass: the block's histogram
  int hsum[256];                     // a select pass: the cluster's histogram
  int32_t goff[kDigits];             // a sort pass: global position of the digit's keys
                                     // less the block's local start of that digit
};
static_assert(sizeof(ClusterScratch) == 8240, "kernels/ss_ingest.py mirrors the layout");

// Length of slice r of n entries cut in slices of len.
__device__ __forceinline__ int slice_len(int n, int len, int r) {
  return max(0, min(len, n - r * len));
}

struct Cluster {
  cg::cluster_group g;
  int rank;
  int size;
  ClusterScratch* cs;
  int par;                            // the turn of the next publication

  // The address in block q of the cluster of this block's `local`.
  template <typename P>
  __device__ P* at(P* local, int q) const {
    return g.map_shared_rank(const_cast<typename std::remove_const<P>::type*>(local), q);
  }
  __device__ void sync() const { g.sync(); }

  // Thread 0 of each block publishes two block-uniform values; every
  // thread calls it. Returns this block's row (read a peer's with at(row, q))
  // after the cluster has synchronised.
  __device__ unsigned long long* publish(unsigned long long v0, unsigned long long v1) {
    unsigned long long* row = cs->pub[par];
    par ^= 1;
    if (threadIdx.x == 0) {
      row[0] = v0;
      row[1] = v1;
    }
    g.sync();
    return row;
  }
};

// min_frequency over the cluster: the summary's slots are the blocks'
// slices (n of them here). Every thread calls it; it ends synchronised.
template <typename T>
__device__ T cluster_min_frequency(Cluster& cl, const int32_t* items, const T* counts, int n) {
  Scratch& sh = cl.cs->sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool full = true;
  T m = Limits<T>::kMax;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    full = full && items[i] != kEmpty;
    m = counts[i] < m ? counts[i] : m;
  }
  full = __syncthreads_and(full);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(kAll, m, o);
    m = y < m ? y : m;
  }
  if (lane == 0) sh.red[warp] = m;
  __syncthreads();
  m = static_cast<T>(sh.red[lane]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(kAll, m, o);
    m = y < m ? y : m;
  }
  const unsigned long long* row =
      cl.publish(full, static_cast<unsigned long long>(static_cast<long long>(m)));
  // every lane of every warp folds the C blocks' values
  bool all_full = true;
  T least = Limits<T>::kMax;
  if (lane < cl.size) {
    const unsigned long long* peer = cl.at(row, lane);
    all_full = peer[0] != 0;
    least = static_cast<T>(static_cast<long long>(peer[1]));
  }
  all_full = __all_sync(kAll, all_full);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(kAll, least, o);
    least = y < least ? y : least;
  }
  return all_full ? least : T(0);
}

// Stable LSD radix sort of n records over the cluster, in place in a, 8
// bits a pass of the unsigned key key_of(record), b the block's scratch of
// as many records: block r holds records [r L, r L + L) of the sequence
// (slice_len(n, L, r) of them), with L <= kSmemW. Each block ranks its
// slice's keys by (digit, warp) (16-bit counters; each key's place among
// its digit's keys in its warp's slice found by __match_any_sync while
// counting and kept in a register) and scatters them into b, which leaves
// each digit's keys contiguous in the block's order; every block then reads
// every block's digit totals through DSMEM, so that the bases run in
// (digit, block, warp) order, and copies b, in order, to the places of the
// keys' positions in the blocks' a: neighbouring threads store to
// neighbouring places of one peer. The order of the sequence is kept among equal keys, so the sort is
// stable. A digit on which every key of the cluster agrees costs no pass.
// Every thread of every block calls it; it ends with a cluster.sync.
template <typename U, typename Rec, typename KeyOf>
__device__ void cluster_radix_sort(Cluster& cl, const KeyOf& key_of, Rec* a, Rec* b, int n,
                                   int L, uint16_t* count) {
  if (n <= 1) return;
  Scratch& sh = cl.cs->sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = slice_len(n, L, cl.rank);
  U all = ~U(0), any = 0;
  for (int i = tid; i < m; i += kThreads) {
    const U key = key_of(a[i]);
    all &= key;
    any |= key;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    all &= __shfl_xor_sync(kAll, all, o);
    any |= __shfl_xor_sync(kAll, any, o);
  }
  if (lane == 0) {
    sh.key_and[warp] = all;
    sh.key_or[warp] = any;
  }
  __syncthreads();
  all = static_cast<U>(sh.key_and[lane]);
  any = static_cast<U>(sh.key_or[lane]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    all &= __shfl_xor_sync(kAll, all, o);
    any |= __shfl_xor_sync(kAll, any, o);
  }
  const unsigned long long* row = cl.publish(all, any);
  all = ~U(0);
  any = 0;
  if (lane < cl.size) {   // lane q reads block q's; every warp folds the same
    const unsigned long long* peer = cl.at(row, lane);
    all = static_cast<U>(peer[0]);
    any = static_cast<U>(peer[1]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    all &= __shfl_xor_sync(kAll, all, o);
    any |= __shfl_xor_sync(kAll, any, o);
  }
  const U vary = all ^ any;

  const int slice = ((m + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(m, warp * slice), hi = min(m, lo + slice);
  const unsigned below = (1u << lane) - 1u;
  uint16_t* mine = count + warp * kDigits;
  const int digit = tid >> 2, quarter = tid & 3, w0 = quarter * 8;
  int turn = 0;
  for (int shift = 0; shift < 8 * static_cast<int>(sizeof(U)); shift += 8) {
    if (((vary >> shift) & 0xFF) == 0) continue;
    reinterpret_cast<uint4*>(count)[tid] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    // 1. each warp ranks its slice's keys by digit, round by round
    unsigned rank[kRounds / 2];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (lo + 32 * r >= hi) break;
      const int i = lo + 32 * r + lane;
      const int d = i < hi ? static_cast<int>((key_of(a[i]) >> shift) & 0xFF) : -1;
      const unsigned peers = __match_any_sync(kAll, d);
      const int leader = __ffs(peers) - 1;
      unsigned before = 0;
      if (d >= 0 && lane == leader) {
        before = mine[d];
        mine[d] = static_cast<uint16_t>(before + __popc(peers));
      }
      const unsigned place = __shfl_sync(kAll, before, leader) + __popc(peers & below);
      rank[r / 2] = r % 2 ? rank[r / 2] | place << 16 : place;
      __syncwarp();
    }
    __syncthreads();
    // 2. the block's bases over (digit, warp), digit-major; thread t holds
    //    digit t / 4 of warps 8 (t % 4) .. 8 (t % 4) + 7
    unsigned c[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = count[(w0 + j) * kDigits + digit];
      sum += c[j];
    }
    unsigned long long total;
    unsigned at = static_cast<unsigned>(block_exclusive_scan(sum, sh, total));
    unsigned dsum = sum + __shfl_xor_sync(kAll, sum, 1);
    dsum += __shfl_xor_sync(kAll, dsum, 2);
    uint32_t* dtot = cl.cs->dtot[turn];
    if (quarter == 0) {
      dtot[digit] = dsum;
      cl.cs->goff[digit] = -static_cast<int32_t>(at);   // less the block's start of the digit
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      count[(w0 + j) * kDigits + digit] = static_cast<uint16_t>(at);
      at += c[j];
    }
    __syncthreads();
    // 3. scatter into b at the block's base of (digit, warp) plus the rank
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (lo + 32 * r >= hi) break;
      const int i = lo + 32 * r + lane;
      if (i < hi) {
        const Rec v = a[i];
        b[mine[(key_of(v) >> shift) & 0xFF] + ((rank[r / 2] >> 16 * (r % 2)) & 0xFFFF)] = v;
      }
    }
    cl.sync();   // the digit totals are out, and no block reads its a again
    // 4. the cluster's bases: the keys of every block of lower digits, and
    //    of this digit in the blocks before this one
    unsigned all_d = 0, before_d = 0;
    for (int q = quarter; q < cl.size; q += 4) {
      const unsigned v = cl.at(dtot, q)[digit];
      all_d += v;
      before_d += q < cl.rank ? v : 0;
    }
    all_d += __shfl_xor_sync(kAll, all_d, 1);
    all_d += __shfl_xor_sync(kAll, all_d, 2);
    before_d += __shfl_xor_sync(kAll, before_d, 1);
    before_d += __shfl_xor_sync(kAll, before_d, 2);
    const unsigned lower = static_cast<unsigned>(
        block_exclusive_scan(quarter == 0 ? all_d : 0u, sh, total));
    if (quarter == 0) cl.cs->goff[digit] += static_cast<int32_t>(lower + before_d);
    __syncthreads();
    // 5. copy b in order to the blocks that hold its positions
    for (int i = tid; i < m; i += kThreads) {
      const Rec v = b[i];
      const int p = cl.cs->goff[(key_of(v) >> shift) & 0xFF] + i;
      const int q = p / L;
      cl.at(a, q)[p - q * L] = v;
    }
    cl.sync();
    turn ^= 1;
  }
}

// Exclusive prefix, in the block's order of n entries, of the entries that
// flag(i) sets: warp w owns a contiguous slice, taken 32 entries at a time,
// lane i the i-th of them. Pass 1 counts each warp's; pass 2 calls
// emit(i, before) for each flagged entry, in order, with the count of the
// flagged entries before it. Returns the block's count. Every thread calls
// it; it ends synchronised.
template <typename Flag, typename Emit>
__device__ int ordered_compact(int n, Scratch& sh, const Flag& flag, const Emit& emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(n, warp * slice), hi = min(n, lo + slice);
  const unsigned below = (1u << lane) - 1u;
  unsigned count = 0;
  for (int r = lo; r < hi; r += 32) {
    count += __popc(__ballot_sync(kAll, r + lane < hi && flag(r + lane)));
  }
  unsigned long long total;
  unsigned at = static_cast<unsigned>(block_exclusive_scan(lane == 0 ? count : 0u, sh, total));
  at = __shfl_sync(kAll, at, 0);
  for (int r = lo; r < hi; r += 32) {
    const bool f = r + lane < hi && flag(r + lane);
    const unsigned set = __ballot_sync(kAll, f);
    if (f) emit(r + lane, at + __popc(set & below));
    at += __popc(set);
  }
  __syncthreads();
  return static_cast<int>(total);
}

// keep_top_k over the cluster. The pool is two lists in pool order: every
// block's list 0 (its summary slots), then every block's list 1 (its
// candidates); Pool::count(list, i, c) and Pool::entry(list, i, ...) as
// keep_top_k's. A first exchange counts the cluster's valid entries (k or
// fewer all win) and ORs their counts, so that the bytes above the largest
// count cost no pass; the k-th largest count is then radix-selected with
// the blocks' histograms summed through DSMEM each pass. The winners are
// compacted in pool order by a cluster scan of (gt, eq) into win0's slices
// of ks, sorted there on ~count by the cluster sort, and block r writes
// outputs [r ks, r ks + n0): its slots' share. Every thread calls it; it
// ends with a cluster.sync.
template <typename T, typename Pool>
__device__ void cluster_keep_top_k(Cluster& cl, const Pool& pool, int n0, int n1, int k, int ks,
                                   Winner<T>* win0, Winner<T>* win1, uint16_t* count,
                                   int32_t* out_items, T* out_counts, T* out_errors) {
  using U = typename std::make_unsigned<T>::type;
  Scratch& sh = cl.cs->sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = n0 + n1;      // the block's entries: list 0, then list 1
  auto valid = [&pool, n0](int v, T& c) {
    return v < n0 ? pool.count(0, v, c) : pool.count(1, v - n0, c);
  };

  // 0. the cluster's valid entries and the OR of their counts
  unsigned long long n_valid = 0;
  U bits = 0;
  for (int v = tid; v < n; v += kThreads) {
    T c;
    if (valid(v, c)) {
      ++n_valid;
      bits |= static_cast<U>(c);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n_valid += __shfl_xor_sync(kAll, n_valid, o);
    bits |= __shfl_xor_sync(kAll, bits, o);
  }
  if (lane == 0) {
    sh.scan[warp] = n_valid;
    sh.key_or[warp] = bits;
  }
  __syncthreads();
  n_valid = sh.scan[lane];
  bits = static_cast<U>(sh.key_or[lane]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n_valid += __shfl_xor_sync(kAll, n_valid, o);
    bits |= __shfl_xor_sync(kAll, bits, o);
  }
  const unsigned long long* row = cl.publish(n_valid, bits);
  n_valid = 0;
  bits = 0;
  if (lane < cl.size) {   // lane q reads block q's; every warp folds the same
    const unsigned long long* peer = cl.at(row, lane);
    n_valid = peer[0];
    bits = static_cast<U>(peer[1]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n_valid += __shfl_xor_sync(kAll, n_valid, o);
    bits |= __shfl_xor_sync(kAll, bits, o);
  }
  const bool take_all = n_valid <= static_cast<unsigned long long>(k);

  // 1. radix-select the k-th largest count, 8 bits a pass from the highest
  //    byte that some count sets (winners are never negative)
  U prefix = 0, mask = 0;
  int want = k;
  if (!take_all) {
    int top = 8 * static_cast<int>(sizeof(T)) - 8;
    while (top > 0 && ((bits >> top) & 0xFF) == 0) {
      mask |= static_cast<U>(0xFF) << top;
      top -= 8;
    }
    int turn = 0;
    for (int shift = top; shift >= 0; shift -= 8) {
      int* hist = cl.cs->hist[turn];
      turn ^= 1;
      for (int b = tid; b < 256; b += kThreads) hist[b] = 0;
      __syncthreads();
      for (int base = 0; base < n; base += kThreads) {
        const int v = base + tid;
        int bin = -1;
        T c;
        if (v < n && valid(v, c)) {
          const U u = static_cast<U>(c);
          if ((u & mask) == prefix) bin = static_cast<int>((u >> shift) & 0xFF);
        }
        const unsigned peers = __match_any_sync(kAll, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
      cl.sync();
      {   // the cluster's histogram: thread t sums bin t / 4 over a quarter of the blocks
        const int bin = tid >> 2;
        int s = 0;
        for (int q = tid & 3; q < cl.size; q += 4) s += cl.at(hist, q)[bin];
        s += __shfl_xor_sync(kAll, s, 1);
        s += __shfl_xor_sync(kAll, s, 2);
        if ((tid & 3) == 0) cl.cs->hsum[bin] = s;
      }
      __syncthreads();
      if (tid < 32) {             // warp 0: the bin that holds the want-th largest
        const int* h = cl.cs->hsum;
        int s = 0;
        for (int q = 0; q < 8; ++q) s += h[8 * lane + q];
        int suffix = s;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_down_sync(kAll, suffix, o);
          if (lane + o < 32) suffix += y;
        }
        const int above = suffix - s;
        if (above < want && want <= suffix) {
          int w = want - above, b = 8 * lane + 7;
          for (int q = 0; q < 7 && w > h[b]; ++q) {
            w -= h[b];
            --b;
          }
          sh.bin = b;
          sh.want = w;
        }
      }
      __syncthreads();
      prefix |= static_cast<U>(sh.bin) << shift;
      mask |= static_cast<U>(0xFF) << shift;
      want = sh.want;
      __syncthreads();
    }
  }
  const T thr = take_all ? T(-1) : static_cast<T>(prefix);
  const unsigned ties = take_all ? 0u : static_cast<unsigned>(want);

  // 2. the winners, compacted in pool order. The block's entries in warp
  //    slices of 32-entry rounds; each warp counts (gt, eq) of each list,
  //    16-bit fields (a block holds at most 2 kSmemW entries), and one block
  //    scan gives every warp its base in each list; the cluster's scan of
  //    the blocks' totals gives each block its bases in pool order
  const int slice = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(n, warp * slice), hi = min(n, lo + slice);
  const unsigned below = (1u << lane) - 1u;
  auto round_flags = [&](int r, bool& in0, unsigned& gt_set, unsigned& eq_set,
                         unsigned& list0) {
    const int v = r + lane;
    bool g = false, e = false;
    T c;
    if (v < hi && valid(v, c)) {
      g = c > thr;
      e = c == thr;
    }
    in0 = v < n0;
    gt_set = __ballot_sync(kAll, g);
    eq_set = __ballot_sync(kAll, e);
    list0 = __ballot_sync(kAll, in0);
  };
  unsigned gt0 = 0, eq0 = 0, gt1 = 0, eq1 = 0;
  for (int r = lo; r < hi; r += 32) {
    bool in0;
    unsigned gs, es, l0;
    round_flags(r, in0, gs, es, l0);
    gt0 += __popc(gs & l0);
    eq0 += __popc(es & l0);
    gt1 += __popc(gs & ~l0);
    eq1 += __popc(es & ~l0);
  }
  unsigned long long total;
  const unsigned long long at = __shfl_sync(kAll, block_exclusive_scan(
      lane == 0 ? (static_cast<unsigned long long>(gt1) << 48) |
                  (static_cast<unsigned long long>(eq1) << 32) | (gt0 << 16) | eq0
                : 0ull, sh, total), 0);
  auto field = [](unsigned long long x, int i) {
    return static_cast<unsigned>((x >> (16 * i)) & 0xFFFF);
  };
  row = cl.publish((static_cast<unsigned long long>(field(total, 1)) << 32) | field(total, 0),
                   (static_cast<unsigned long long>(field(total, 3)) << 32) | field(total, 2));
  unsigned long long base0 = 0, base1 = 0, all0 = 0, all1 = 0;
  if (lane < cl.size) {   // lane q reads block q's; every warp folds the same
    const unsigned long long* peer = cl.at(row, lane);
    all0 = peer[0];
    all1 = peer[1];
    base0 = lane < cl.rank ? all0 : 0;
    base1 = lane < cl.rank ? all1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    all0 += __shfl_xor_sync(kAll, all0, o);
    all1 += __shfl_xor_sync(kAll, all1, o);
    base0 += __shfl_xor_sync(kAll, base0, o);
    base1 += __shfl_xor_sync(kAll, base1, o);
  }
  base1 += all0;
  const unsigned long long all = all0 + all1;
  const int n_sel = static_cast<int>(all >> 32) +
                    static_cast<int>(min(static_cast<unsigned>(all), ties));
  // (gt, eq) before this warp's next round, in pool order, of each list
  unsigned gt_at[2] = {static_cast<unsigned>(base0 >> 32) + field(at, 1),
                       static_cast<unsigned>(base1 >> 32) + field(at, 3)};
  unsigned eq_at[2] = {static_cast<unsigned>(base0) + field(at, 0),
                       static_cast<unsigned>(base1) + field(at, 2)};
  for (int r = lo; r < hi; r += 32) {
    bool in0;
    unsigned gs, es, l0;
    round_flags(r, in0, gs, es, l0);
    const int list = in0 ? 0 : 1;
    const unsigned mine = in0 ? l0 : ~l0;
    const bool g = (gs >> lane) & 1, e = (es >> lane) & 1;
    const unsigned eq_before = eq_at[list] + __popc(es & mine & below);
    if (g || (e && eq_before < ties)) {
      const int o = static_cast<int>(gt_at[list] + __popc(gs & mine & below) +
                                     min(eq_before, ties));
      const int v = r + lane;
      Winner<T> x;
      pool.entry(list, in0 ? v : v - n0, x.item, x.count, x.error);
      const int q = o / ks;
      cl.at(win0, q)[o - q * ks] = x;
    }
    gt_at[0] += __popc(gs & l0);
    eq_at[0] += __popc(es & l0);
    gt_at[1] += __popc(gs & ~l0);
    eq_at[1] += __popc(es & ~l0);
  }
  cl.sync();

  // 3. order the winners, 4. write this block's slice; slots past them empty
  cluster_radix_sort<U>(cl, WinnerOrder<T>{}, win0, win1, n_sel, ks, count);
  const int first = cl.rank * ks;
  for (int i = tid; i < n0; i += kThreads) {
    int32_t item = kEmpty;
    T c = 0, e = 0;
    if (first + i < n_sel) {
      item = win0[i].item;
      c = win0[i].count;
      e = win0[i].error;
    }
    out_items[first + i] = item;
    out_counts[first + i] = c;
    out_errors[first + i] = e;
  }
}

// The flush pool of one block: list 0 its summary slots (updated), list 1
// the runs that start in its slice of the sorted window (run j is
// [pos[j], pos[j + 1]) in window positions), less the runs a slot matched
// (bit j of taken) and the EMPTY run.
template <typename T>
struct IngestClusterPool {
  const int32_t* items;
  const T* counts;
  const T* errors;
  const int32_t* ids;      // the block's slice of the sorted window
  const int32_t* pos;      // global start of each of its runs, then the next start
  const uint32_t* taken;
  int first;               // the slice's first window position
  T m1;

  __device__ bool count(int list, int v, T& c) const {
    if (list == 0) {
      c = counts[v];
      return c >= 0;
    }
    const int p = pos[v];
    if (((taken[v >> 5] >> (v & 31)) & 1) || ids[p - first] == kEmpty) return false;
    c = wrap_add(static_cast<T>(pos[v + 1] - p), m1);
    return c >= 0;
  }
  __device__ void entry(int list, int v, int32_t& item, T& c, T& e) const {
    if (list == 0) {
      item = items[v];
      c = counts[v];
      e = errors[v];
      return;
    }
    const int p = pos[v];
    item = ids[p - first];
    c = wrap_add(static_cast<T>(pos[v + 1] - p), m1);
    e = m1;
  }
};

// Dynamic shared memory of a block of the cluster flush (16-byte aligned
// regions): the scratch, the sort's counters, the first Winner buffer of
// ks, then the merge's buffers: the slice's updated counts and errors, its
// items, and two (S + 1)-entry buffers, the window slice's and its run
// starts' (the sort's scratch before that). The winners' sort, which comes
// after the merge, takes the merge's buffers for its second Winner buffer.
template <typename T>
__host__ __device__ size_t ingest_cluster_smem(int k, int w, int c) {
  const size_t ks = (k + c - 1) / c, s = w > 0 ? (w + c - 1) / c : 1;
  const size_t merge = 2 * align16(ks * sizeof(T)) + align16(ks * sizeof(int32_t)) +
                       2 * align16((s + 1) * sizeof(int32_t));
  const size_t win = align16(ks * sizeof(Winner<T>));
  return align16(sizeof(ClusterScratch)) + align16(kCounters * sizeof(uint16_t)) + win +
         (merge > win ? merge : win);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_ingest_cluster_kernel(const int32_t* __restrict__ s_items, const T* __restrict__ s_counts,
                            const T* __restrict__ s_errors, const int32_t* __restrict__ window,
                            int32_t* __restrict__ o_items, T* __restrict__ o_counts,
                            T* __restrict__ o_errors, int k, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  Cluster cl{cg::this_cluster(), 0, 0, reinterpret_cast<ClusterScratch*>(smem), 0};
  cl.rank = static_cast<int>(cl.g.block_rank());
  cl.size = static_cast<int>(cl.g.num_blocks());
  const int C = cl.size, r = cl.rank, tid = threadIdx.x;
  const int ks = (k + C - 1) / C, S = max(1, (w + C - 1) / C);
  const int nk = slice_len(k, ks, r), nw = slice_len(w, S, r);
  unsigned char* p = smem + align16(sizeof(ClusterScratch));
  uint16_t* count = reinterpret_cast<uint16_t*>(p);
  p += align16(kCounters * sizeof(uint16_t));
  Winner<T>* win0 = reinterpret_cast<Winner<T>*>(p);
  p += align16(ks * sizeof(Winner<T>));
  Winner<T>* win1 = reinterpret_cast<Winner<T>*>(p);   // over the merge's buffers
  T* counts = reinterpret_cast<T*>(p);
  p += align16(ks * sizeof(T));
  T* errors = reinterpret_cast<T*>(p);
  p += align16(ks * sizeof(T));
  int32_t* items = reinterpret_cast<int32_t*>(p);
  p += align16(ks * sizeof(int32_t));
  int32_t* ids = reinterpret_cast<int32_t*>(p);
  p += align16((S + 1) * sizeof(int32_t));
  int32_t* pos = reinterpret_cast<int32_t*>(p);

  const int64_t b = blockIdx.x / C;
  const int64_t slot0 = b * k + static_cast<int64_t>(r) * ks;
  const int64_t id0 = b * w + static_cast<int64_t>(r) * S;
  for (int i = tid; i < nk; i += kThreads) {
    items[i] = s_items[slot0 + i];
    counts[i] = s_counts[slot0 + i];
    errors[i] = s_errors[slot0 + i];
  }
  for (int q = tid; q < nw; q += kThreads) ids[q] = window[id0 + q];
  __syncthreads();

  const T m1 = cluster_min_frequency(cl, items, counts, nk);   // before the update
  cluster_radix_sort<uint32_t>(cl, IdKey{}, ids, pos, w, S, count);

  // run starts: position q starts a run where its id differs from the one
  // before it (the previous block's last, for a slice's first); each
  // block lists its runs' global starts in order, then the next block's
  // first start (or w)
  const int first = r * S;
  const int32_t prev = r > 0 && nw > 0 ? cl.at(ids, r - 1)[S - 1] : 0;
  const int n_runs = ordered_compact(
      nw, cl.cs->sh,
      [&](int q) { return first + q == 0 || ids[q] != (q ? ids[q - 1] : prev); },
      [&](int q, unsigned before) { pos[before] = first + q; });
  const unsigned long long* row = cl.publish(n_runs, n_runs ? pos[0] : 0);
  if (tid == 0) {
    int next = w;
    for (int q = r + 1; q < C; ++q) {
      const unsigned long long* peer = cl.at(row, q);
      if (peer[0]) {
        next = static_cast<int>(peer[1]);
        break;
      }
    }
    pos[n_runs] = next;
  }

  // match + offsets (m2 = 0, no candidate errors): an EMPTY slot becomes
  // (EMPTY, 0, 0). Every block looks up every slot's id in its own slice;
  // the block that holds the first id of the id's run adds the run's
  // weight to the slot, in whichever block the slot lives, and takes the
  // run out of its candidates (a bit of taken, in the sort's counters)
  uint32_t* taken = reinterpret_cast<uint32_t*>(count);
  for (int j = tid; j < (n_runs + 31) / 32; j += kThreads) taken[j] = 0;
  for (int i = tid; i < nk; i += kThreads) {
    if (items[i] == kEmpty) {
      counts[i] = 0;
      errors[i] = 0;
    }
  }
  __syncthreads();
  if (nw > 0) {
    const int32_t lowest = ids[0], highest = ids[nw - 1];
    int32_t next = tid < k ? s_items[b * k + tid] : kEmpty;
    for (int i = tid; i < k; i += kThreads) {
      const int32_t id = next;   // the next slot's id is on its way meanwhile
      next = i + kThreads < k ? s_items[b * k + i + kThreads] : kEmpty;
      if (id == kEmpty || id < lowest || id > highest) continue;
      const int l = lower_bound(ids, nw, id);
      if (ids[l] != id || (l == 0 && r > 0 && prev == id)) continue;
      const int v = lower_bound(pos, n_runs, first + l);
      const int owner = i / ks;
      T* c = cl.at(counts, owner) + (i - owner * ks);
      *c = wrap_add(*c, static_cast<T>(pos[v + 1] - pos[v]));
      atomicOr(&taken[v >> 5], 1u << (v & 31));
    }
  }
  cl.sync();

  cluster_keep_top_k<T>(cl, IngestClusterPool<T>{items, counts, errors, ids, pos, taken, first,
                                                 m1},
                        nk, n_runs, k, ks, win0, win1, count, o_items + b * k,
                        o_counts + b * k, o_errors + b * k);
  cl.sync();   // no block leaves while a peer may read its shared memory
}

// The COMBINE pool of one block: list 0 its slots of s1 (updated), list 1
// its slots of s2 (a matched slot's item is EMPTY).
template <typename T>
struct CombineClusterPool {
  const int32_t* items1;
  const T* counts1;
  const T* errors1;
  const int32_t* items2;
  const T* counts2;
  const T* errors2;
  T m1;

  __device__ bool count(int list, int v, T& c) const {
    if (list == 0) {
      c = counts1[v];
      return c >= 0;
    }
    if (items2[v] == kEmpty) return false;
    c = wrap_add(counts2[v], m1);
    return c >= 0;
  }
  __device__ void entry(int list, int v, int32_t& item, T& c, T& e) const {
    if (list == 0) {
      item = items1[v];
      c = counts1[v];
      e = errors1[v];
      return;
    }
    item = items2[v];
    c = wrap_add(counts2[v], m1);
    e = wrap_add(errors2[v], m1);
  }
};

// Dynamic shared memory of a block of the cluster COMBINE: the scratch, the
// sort's counters, the first Winner buffer of ks, then the merge's buffers:
// the slices' counts and errors of s1 and s2, two IdSlot buffers of ks, and
// the slices' items of s1 and s2; the winners' sort takes the merge's
// buffers for its second Winner buffer.
template <typename T>
__host__ __device__ size_t combine_cluster_smem(int k, int c) {
  const size_t ks = (k + c - 1) / c;
  const size_t merge = 4 * align16(ks * sizeof(T)) + 2 * align16(ks * sizeof(IdSlot)) +
                       2 * align16(ks * sizeof(int32_t));
  const size_t win = align16(ks * sizeof(Winner<T>));
  return align16(sizeof(ClusterScratch)) + align16(kCounters * sizeof(uint16_t)) + win +
         (merge > win ? merge : win);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_combine_cluster_kernel(const int32_t* __restrict__ a_items, const T* __restrict__ a_counts,
                             const T* __restrict__ a_errors, const int32_t* __restrict__ b_items,
                             const T* __restrict__ b_counts, const T* __restrict__ b_errors,
                             int32_t* __restrict__ o_items, T* __restrict__ o_counts,
                             T* __restrict__ o_errors, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  Cluster cl{cg::this_cluster(), 0, 0, reinterpret_cast<ClusterScratch*>(smem), 0};
  cl.rank = static_cast<int>(cl.g.block_rank());
  cl.size = static_cast<int>(cl.g.num_blocks());
  const int C = cl.size, r = cl.rank, tid = threadIdx.x;
  const int ks = (k + C - 1) / C, nk = slice_len(k, ks, r);
  unsigned char* p = smem + align16(sizeof(ClusterScratch));
  uint16_t* count = reinterpret_cast<uint16_t*>(p);
  p += align16(kCounters * sizeof(uint16_t));
  Winner<T>* win0 = reinterpret_cast<Winner<T>*>(p);
  p += align16(ks * sizeof(Winner<T>));
  Winner<T>* win1 = reinterpret_cast<Winner<T>*>(p);   // over the merge's buffers
  T* chan[4];
  for (int j = 0; j < 4; ++j) {
    chan[j] = reinterpret_cast<T*>(p);
    p += align16(ks * sizeof(T));
  }
  T *counts1 = chan[0], *errors1 = chan[1], *counts2 = chan[2], *errors2 = chan[3];
  IdSlot* keys0 = reinterpret_cast<IdSlot*>(p);
  p += align16(ks * sizeof(IdSlot));
  IdSlot* keys1 = reinterpret_cast<IdSlot*>(p);
  p += align16(ks * sizeof(IdSlot));
  int32_t* items1 = reinterpret_cast<int32_t*>(p);
  p += align16(ks * sizeof(int32_t));
  int32_t* items2 = reinterpret_cast<int32_t*>(p);

  const int64_t b = blockIdx.x / C;
  const int first = r * ks;
  const int64_t off = b * k + first;
  for (int i = tid; i < nk; i += kThreads) {
    items1[i] = a_items[off + i];
    counts1[i] = a_counts[off + i];
    errors1[i] = a_errors[off + i];
    items2[i] = b_items[off + i];
    counts2[i] = b_counts[off + i];
    errors2[i] = b_errors[off + i];
    keys0[i] = IdSlot{items2[i], first + i};
  }
  __syncthreads();

  const T m1 = cluster_min_frequency(cl, items1, counts1, nk);   // before the update
  const T m2 = cluster_min_frequency(cl, items2, counts2, nk);
  cluster_radix_sort<uint32_t>(cl, IdSlotKey{}, keys0, keys1, k, ks, count);

  // match + offsets as fused_combine_kernel: both (c1 + c2, e1 + e2); s1
  // only (c1 + m2, e1 + m2); an EMPTY slot of s1 becomes (EMPTY, 0, 0).
  // Each block first gives its own slots of s1 the offsets of "s1 only";
  // then every block looks up every id of s1 in its own slice of s2's
  // (id, slot) keys, and the block that holds the id's first key adds
  // (c2 - m2, e2 - m2) to the slot of s1, in whichever block it lives (the
  // same sums, modulo 2^bits), and marks the s2 slot matched
  for (int i = tid; i < nk; i += kThreads) {
    const bool empty = items1[i] == kEmpty;
    counts1[i] = empty ? T(0) : wrap_add(counts1[i], m2);
    errors1[i] = empty ? T(0) : wrap_add(errors1[i], m2);
  }
  const IdSlot prev = r > 0 && nk > 0 ? cl.at(keys0, r - 1)[ks - 1] : IdSlot{kEmpty, -1};
  cl.sync();   // no slot of s1 gains a match before its offsets
  if (nk > 0) {
    const int32_t lowest = keys0[0].id, highest = keys0[nk - 1].id;
    int32_t next = tid < k ? a_items[b * k + tid] : kEmpty;
    for (int i = tid; i < k; i += kThreads) {
      const int32_t id = next;   // the next slot's id is on its way meanwhile
      next = i + kThreads < k ? a_items[b * k + i + kThreads] : kEmpty;
      if (id == kEmpty || id < lowest || id > highest) continue;
      int l = 0, h = nk;
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (keys0[mid].id < id) l = mid + 1; else h = mid;
      }
      if (keys0[l].id != id || (l == 0 && r > 0 && prev.id == id)) continue;
      const int j = keys0[l].slot, oj = j / ks, oi = i / ks;
      T* c = cl.at(counts1, oi) + (i - oi * ks);
      T* e = cl.at(errors1, oi) + (i - oi * ks);
      *c = wrap_add(*c, wrap_sub(cl.at(counts2, oj)[j - oj * ks], m2));
      *e = wrap_add(*e, wrap_sub(cl.at(errors2, oj)[j - oj * ks], m2));
      cl.at(items2, oj)[j - oj * ks] = kEmpty;   // a matched s2 slot leaves the pool
    }
  }
  cl.sync();

  cluster_keep_top_k<T>(cl, CombineClusterPool<T>{items1, counts1, errors1, items2, counts2,
                                                  errors2, m1},
                        nk, nk, k, ks, win0, win1, count, o_items + b * k,
                        o_counts + b * k, o_errors + b * k);
  cl.sync();   // no block leaves while a peer may read its shared memory
}

template <typename T>
int launch_ingest(const void* s_items, const void* s_counts, const void* s_errors,
                  const void* window, void* o_items, void* o_counts, void* o_errors,
                  int batch, int k, int w, uint32_t salt, void* stream) {
  if (batch < 1 || k < 1 || k > kSmemK || w < 0 || w > kSmemW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = ingest_smem<T>(k, w);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_ingest_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ingest_kernel<T><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_items), static_cast<const T*>(s_counts),
      static_cast<const T*>(s_errors), static_cast<const int32_t*>(window),
      static_cast<int32_t*>(o_items), static_cast<T*>(o_counts),
      static_cast<T*>(o_errors), k, w, salt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ingest_workspace(const void* s_items, const void* s_counts, const void* s_errors,
                            const void* window, void* o_items, void* o_counts,
                            void* o_errors, void* workspace, size_t workspace_bytes,
                            int batch, int k, int w, void* stream) {
  if (batch < 1 || k < 1 || w < 0 || k > kMaxPool - w ||
      workspace_bytes < static_cast<size_t>(batch) * ingest_workspace<T>(k, w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fused_ingest_workspace_kernel<T><<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_items), static_cast<const T*>(s_counts),
      static_cast<const T*>(s_errors), static_cast<const int32_t*>(window),
      static_cast<int32_t*>(o_items), static_cast<T*>(o_counts),
      static_cast<T*>(o_errors), static_cast<unsigned char*>(workspace), k, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_combine(const void* a_items, const void* a_counts, const void* a_errors,
                   const void* b_items, const void* b_counts, const void* b_errors,
                   void* o_items, void* o_counts, void* o_errors, int batch, int k,
                   uint32_t salt, void* stream) {
  if (batch < 1 || k < 1 || k > kSmemK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = combine_smem<T>(k);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_combine_kernel<T><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_items), static_cast<const T*>(a_counts),
      static_cast<const T*>(a_errors), static_cast<const int32_t*>(b_items),
      static_cast<const T*>(b_counts), static_cast<const T*>(b_errors),
      static_cast<int32_t*>(o_items), static_cast<T*>(o_counts),
      static_cast<T*>(o_errors), k, salt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_combine_workspace(const void* a_items, const void* a_counts, const void* a_errors,
                             const void* b_items, const void* b_counts, const void* b_errors,
                             void* o_items, void* o_counts, void* o_errors, void* workspace,
                             size_t workspace_bytes, int batch, int k, void* stream) {
  if (batch < 1 || k < 1 || k > kMaxPool / 2 ||
      workspace_bytes < static_cast<size_t>(batch) * combine_workspace<T>(k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fused_combine_workspace_kernel<T><<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_items), static_cast<const T*>(a_counts),
      static_cast<const T*>(a_errors), static_cast<const int32_t*>(b_items),
      static_cast<const T*>(b_counts), static_cast<const T*>(b_errors),
      static_cast<int32_t*>(o_items), static_cast<T*>(o_counts),
      static_cast<T*>(o_errors), static_cast<unsigned char*>(workspace), k);
  return static_cast<int>(cudaGetLastError());
}

bool cluster_size_ok(int c) { return c == 2 || c == 4 || c == 8 || c == 16; }

// One kernel's launch configuration for batch entries of a cluster of c
// blocks: its dynamic shared memory opted in, and c = 16, the size the card
// does not promise, allowed.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, size_t smem, int c, int grid, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && c > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

// The shape checks of the cluster path: slices of at most kSmemW keys (the
// sort's 16-bit counters and register ranks), the blocks' shared memory.
bool cluster_shape_ok(int batch, int k, int w, int c, size_t smem) {
  if (batch < 1 || k < 1 || w < 0 || !cluster_size_ok(c)) return false;
  if (static_cast<long long>(batch) * c > INT_MAX) return false;
  return (k + c - 1) / c <= kSmemW && (w + c - 1) / c <= kSmemW && smem <= kMaxSmem;
}

template <typename T>
int launch_ingest_cluster(const void* s_items, const void* s_counts, const void* s_errors,
                          const void* window, void* o_items, void* o_counts, void* o_errors,
                          int batch, int k, int w, int c, void* stream) {
  const size_t smem = cluster_size_ok(c) ? ingest_cluster_smem<T>(k, w, c) : 0;
  if (!cluster_shape_ok(batch, k, w, c, smem) || k > kMaxPool - w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(fused_ingest_cluster_kernel<T>, smem, c, batch * c,
                                   static_cast<cudaStream_t>(stream), cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fused_ingest_cluster_kernel<T>,
                           static_cast<const int32_t*>(s_items), static_cast<const T*>(s_counts),
                           static_cast<const T*>(s_errors), static_cast<const int32_t*>(window),
                           static_cast<int32_t*>(o_items), static_cast<T*>(o_counts),
                           static_cast<T*>(o_errors), k, w);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_combine_cluster(const void* a_items, const void* a_counts, const void* a_errors,
                           const void* b_items, const void* b_counts, const void* b_errors,
                           void* o_items, void* o_counts, void* o_errors, int batch, int k,
                           int c, void* stream) {
  const size_t smem = cluster_size_ok(c) ? combine_cluster_smem<T>(k, c) : 0;
  if (!cluster_shape_ok(batch, k, 0, c, smem) || k > kMaxPool / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(fused_combine_cluster_kernel<T>, smem, c, batch * c,
                                   static_cast<cudaStream_t>(stream), cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fused_combine_cluster_kernel<T>,
                           static_cast<const int32_t*>(a_items), static_cast<const T*>(a_counts),
                           static_cast<const T*>(a_errors), static_cast<const int32_t*>(b_items),
                           static_cast<const T*>(b_counts), static_cast<const T*>(b_errors),
                           static_cast<int32_t*>(o_items), static_cast<T*>(o_counts),
                           static_cast<T*>(o_errors), k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters of one cluster kernel at one shape.
template <typename Kernel>
int cluster_occupancy(Kernel kernel, size_t smem, int c, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, smem, c, c, nullptr, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

}  // namespace

// Plain C entries for ctypes. Every tensor is contiguous and on the device of
// `stream`: summaries (batch, k) — items int32, counts/errors of the entry's
// count type — and the window (batch, w) int32, EMPTY-padded. The outputs
// are fresh (batch, k) tensors. The shared-memory entries take
// 1 <= k <= 2048 and 0 <= w <= 16384; the workspace entries any k >= 1 and
// w >= 0 with k + w <= INT_MAX / 2 (k + k for COMBINE), and a device buffer
// of at least batch times ingest_workspace(k, w) or combine_workspace(k)
// bytes, 16-byte aligned, which they overwrite. The shared-memory entries
// take the salt that keys their hash table's hash: a fresh random word each
// launch, so that no window or summary can be chosen to collide.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ss_fused_ingest_i32(const void* s_items, const void* s_counts,
                                   const void* s_errors, const void* window,
                                   void* o_items, void* o_counts, void* o_errors,
                                   int batch, int k, int w, unsigned salt, void* stream) {
  return launch_ingest<int32_t>(s_items, s_counts, s_errors, window, o_items, o_counts,
                                o_errors, batch, k, w, salt, stream);
}

extern "C" int ss_fused_ingest_i64(const void* s_items, const void* s_counts,
                                   const void* s_errors, const void* window,
                                   void* o_items, void* o_counts, void* o_errors,
                                   int batch, int k, int w, unsigned salt, void* stream) {
  return launch_ingest<int64_t>(s_items, s_counts, s_errors, window, o_items, o_counts,
                                o_errors, batch, k, w, salt, stream);
}

extern "C" int ss_fused_ingest_workspace_i32(const void* s_items, const void* s_counts,
                                             const void* s_errors, const void* window,
                                             void* o_items, void* o_counts, void* o_errors,
                                             void* workspace, size_t workspace_bytes,
                                             int batch, int k, int w, void* stream) {
  return launch_ingest_workspace<int32_t>(s_items, s_counts, s_errors, window, o_items,
                                          o_counts, o_errors, workspace, workspace_bytes,
                                          batch, k, w, stream);
}

extern "C" int ss_fused_ingest_workspace_i64(const void* s_items, const void* s_counts,
                                             const void* s_errors, const void* window,
                                             void* o_items, void* o_counts, void* o_errors,
                                             void* workspace, size_t workspace_bytes,
                                             int batch, int k, int w, void* stream) {
  return launch_ingest_workspace<int64_t>(s_items, s_counts, s_errors, window, o_items,
                                          o_counts, o_errors, workspace, workspace_bytes,
                                          batch, k, w, stream);
}

extern "C" int ss_fused_combine_i32(const void* a_items, const void* a_counts,
                                    const void* a_errors, const void* b_items,
                                    const void* b_counts, const void* b_errors,
                                    void* o_items, void* o_counts, void* o_errors,
                                    int batch, int k, unsigned salt, void* stream) {
  return launch_combine<int32_t>(a_items, a_counts, a_errors, b_items, b_counts, b_errors,
                                 o_items, o_counts, o_errors, batch, k, salt, stream);
}

extern "C" int ss_fused_combine_i64(const void* a_items, const void* a_counts,
                                    const void* a_errors, const void* b_items,
                                    const void* b_counts, const void* b_errors,
                                    void* o_items, void* o_counts, void* o_errors,
                                    int batch, int k, unsigned salt, void* stream) {
  return launch_combine<int64_t>(a_items, a_counts, a_errors, b_items, b_counts, b_errors,
                                 o_items, o_counts, o_errors, batch, k, salt, stream);
}

extern "C" int ss_fused_combine_workspace_i32(const void* a_items, const void* a_counts,
                                              const void* a_errors, const void* b_items,
                                              const void* b_counts, const void* b_errors,
                                              void* o_items, void* o_counts, void* o_errors,
                                              void* workspace, size_t workspace_bytes,
                                              int batch, int k, void* stream) {
  return launch_combine_workspace<int32_t>(a_items, a_counts, a_errors, b_items, b_counts,
                                           b_errors, o_items, o_counts, o_errors, workspace,
                                           workspace_bytes, batch, k, stream);
}

extern "C" int ss_fused_combine_workspace_i64(const void* a_items, const void* a_counts,
                                              const void* a_errors, const void* b_items,
                                              const void* b_counts, const void* b_errors,
                                              void* o_items, void* o_counts, void* o_errors,
                                              void* workspace, size_t workspace_bytes,
                                              int batch, int k, void* stream) {
  return launch_combine_workspace<int64_t>(a_items, a_counts, a_errors, b_items, b_counts,
                                           b_errors, o_items, o_counts, o_errors, workspace,
                                           workspace_bytes, batch, k, stream);
}

// The cluster path: batch entries of a cluster of c blocks (c in 2, 4, 8,
// 16), each block a slice of at most 16384 window ids and summary slots,
// within 232448 bytes of shared memory (ingest_cluster_smem,
// combine_cluster_smem); w >= 0 and k + w <= INT_MAX / 2 (k + k for
// COMBINE). Returns cudaErrorInvalidValue for any other shape, or the
// launch's error.
extern "C" int ss_fused_ingest_cluster_i32(const void* s_items, const void* s_counts,
                                           const void* s_errors, const void* window,
                                           void* o_items, void* o_counts, void* o_errors,
                                           int batch, int k, int w, int c, void* stream) {
  return launch_ingest_cluster<int32_t>(s_items, s_counts, s_errors, window, o_items, o_counts,
                                        o_errors, batch, k, w, c, stream);
}

extern "C" int ss_fused_ingest_cluster_i64(const void* s_items, const void* s_counts,
                                           const void* s_errors, const void* window,
                                           void* o_items, void* o_counts, void* o_errors,
                                           int batch, int k, int w, int c, void* stream) {
  return launch_ingest_cluster<int64_t>(s_items, s_counts, s_errors, window, o_items, o_counts,
                                        o_errors, batch, k, w, c, stream);
}

extern "C" int ss_fused_combine_cluster_i32(const void* a_items, const void* a_counts,
                                            const void* a_errors, const void* b_items,
                                            const void* b_counts, const void* b_errors,
                                            void* o_items, void* o_counts, void* o_errors,
                                            int batch, int k, int c, void* stream) {
  return launch_combine_cluster<int32_t>(a_items, a_counts, a_errors, b_items, b_counts,
                                         b_errors, o_items, o_counts, o_errors, batch, k, c,
                                         stream);
}

extern "C" int ss_fused_combine_cluster_i64(const void* a_items, const void* a_counts,
                                            const void* a_errors, const void* b_items,
                                            const void* b_counts, const void* b_errors,
                                            void* o_items, void* o_counts, void* o_errors,
                                            int batch, int k, int c, void* stream) {
  return launch_combine_cluster<int64_t>(a_items, a_counts, a_errors, b_items, b_counts,
                                         b_errors, o_items, o_counts, o_errors, batch, k, c,
                                         stream);
}

// How many clusters of c blocks of one cluster kernel the card holds at
// once (cudaOccupancyMaxActiveClusters) at k and w (combine != 0: the
// COMBINE kernel, w unused; wide != 0: int64 counts), into *clusters.
// Returns the query's error.
extern "C" int ss_fused_cluster_occupancy(int combine, int wide, int k, int w, int c,
                                          int* clusters) {
  if (!cluster_size_ok(c) || k < 1 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (combine) {
    return wide ? cluster_occupancy(fused_combine_cluster_kernel<int64_t>,
                                    combine_cluster_smem<int64_t>(k, c), c, clusters)
                : cluster_occupancy(fused_combine_cluster_kernel<int32_t>,
                                    combine_cluster_smem<int32_t>(k, c), c, clusters);
  }
  return wide ? cluster_occupancy(fused_ingest_cluster_kernel<int64_t>,
                                  ingest_cluster_smem<int64_t>(k, w, c), c, clusters)
              : cluster_occupancy(fused_ingest_cluster_kernel<int32_t>,
                                  ingest_cluster_smem<int32_t>(k, w, c), c, clusters);
}
