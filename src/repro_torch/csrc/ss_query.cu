// Batched point queries against Space Saving summaries for Hopper (sm_90a):
// the read side of the QueryFrontend (point estimates, the bound audit).
//
// Replaces the Pallas TPU kernel repro/kernels/ss_query.py: query_pallas
// (_query_kernel). For each batch entry b and query q:
//
//   f[b,q]   = sum_i [s[b,i] == queries[b,q]] * s_counts[b,i]
//   eps[b,q] = sum_i [s[b,i] == queries[b,q]] * s_errors[b,i]
//   mon[b,q] = exists i [s[b,i] == queries[b,q]]
//
// EMPTY (-1) never matches; duplicate summary ids are summed. The Pallas
// kernel summed as an f32 dot, exact only below 2^24; here the sums are
// taken in the count type T (int32 or int64) with wrap-around, equal bit for
// bit to the plain PyTorch version.
//
// What bounds it on the H100: the function is an equi-join of a row's k
// summary ids with its q query ids. A hash join needs one insert per valid
// summary id and one probe per query, and the bytes are the row and the
// queries read once and the three outputs written once. At the frontend's
// shapes (B 1, k 2048, 16 to a few thousand queries: ~30-60 KB) that is
// far below the launch's own latency; at many small rows (B 65 537,
// k = q = 16: 26 MB) it is the bytes. A compare of every query with a
// fixed 2048-id tile costs O(q * 2048) a row whatever k is.
//
// Two kernels, chosen from the shape by the wrapper (kernels/ss_query.py:
// kernel_for), which also sizes the hash table and owns the launch
// geometry of both (threads a block, queries a block). Each puts the batch
// entry and its slice of queries on grid.x (up to 2^31 - 1 blocks, so the
// batch has no 65 535 limit), and both return the same bits:
//
// query_hash_kernel, the rule where the table fits one block's shared
// memory: the block builds an open-addressing table of the row's distinct
// valid ids in dynamic shared memory (load <= 1/2, linear probing, atomicCAS
// insert); each summary slot adds its count and error into its id's slot
// with wrap-around atomics (integer addition is associative, so any order of
// the atomics gives the same bits). After one barrier every query of the
// block's slice probes the table once, read-only. The wrapper gives a block
// at least max(k, 1024) queries, so that the k inserts are no more than its
// probes, and a block size that grows with k.
//
// query_dense_kernel, above the table's limit: one query per thread, its
// id and sums in registers; the block stages the summary ids in shared
// memory, kTile at a time, read as int4 broadcasts (four compares a load and
// one branch, taken on a match), and each pass compares only the
// min(kTile, k - i0) ids of the row; counts and errors are read from global
// memory only on a match. Queries that are EMPTY skip the compares.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "ss_hash.cuh"

namespace {

constexpr int32_t kEmpty = -1;

template <typename T>
__device__ __forceinline__ T wrap_add(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  return static_cast<T>(static_cast<U>(a) + static_cast<U>(b));
}

// -- the hash lookup -----------------------------------------------------------

constexpr int kHashMaxThreads = 1024;

using ss_hash::atomic_wrap_add;
using ss_hash::find;
using ss_hash::slot_of;

template <typename T>
__global__ void __launch_bounds__(kHashMaxThreads)
query_hash_kernel(const int32_t* __restrict__ s_items,
                  const T* __restrict__ s_counts, const T* __restrict__ s_errors,
                  const int32_t* __restrict__ queries, T* __restrict__ f_out,
                  T* __restrict__ eps_out, uint8_t* __restrict__ mon_out,
                  int k, int nq, int log_slots, int slice, int slices) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_slots = 1 << log_slots;
  const uint32_t mask = n_slots - 1;
  // the layout whose bytes kernels/ss_query.py:table_bytes counts
  T* acc_c = reinterpret_cast<T*>(smem);                    // n_slots sums
  T* acc_e = acc_c + n_slots;                               // n_slots sums
  int32_t* keys = reinterpret_cast<int32_t*>(acc_e + n_slots);

  // grid.x is (batch entry, slice of queries) folded, slices minor
  const int64_t b = blockIdx.x / slices;
  const int q0 = static_cast<int>(blockIdx.x % slices) * slice;
  const int64_t q_end = q0 + min(slice, nq - q0);
  const int32_t* si = s_items + b * k;
  const T* sc = s_counts + b * k;
  const T* se = s_errors + b * k;
  // this thread's first query is loaded before the build, which hides its
  // latency; each probe loads the next one before it looks up the table
  int64_t q = q0 + threadIdx.x;
  int32_t x = q < q_end ? queries[b * nq + q] : kEmpty;

  for (int p = threadIdx.x; p < n_slots; p += blockDim.x) {
    keys[p] = kEmpty;
    acc_c[p] = T(0);
    acc_e[p] = T(0);
  }
  __syncthreads();

  // insert the distinct valid summary ids (a duplicate finds its own key)
  // and add every slot's count and error into its id's sums
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const int32_t id = si[i];
    const T c = sc[i];
    const T er = se[i];
    if (id == kEmpty) continue;
    uint32_t p = slot_of(id, log_slots);
    for (;; p = (p + 1) & mask) {
      const int32_t prev = atomicCAS(&keys[p], kEmpty, id);
      if (prev == kEmpty || prev == id) break;
    }
    atomic_wrap_add(&acc_c[p], c);
    atomic_wrap_add(&acc_e[p], er);
  }
  __syncthreads();

  // every query probes once; a miss (or an EMPTY query) answers 0
  for (; q < q_end; q += blockDim.x) {
    const int64_t next = q + blockDim.x;
    const int32_t x_next = next < q_end ? queries[b * nq + next] : kEmpty;
    const int found = x == kEmpty ? -1 : find(keys, x, log_slots);
    f_out[b * nq + q] = found < 0 ? T(0) : acc_c[found];
    eps_out[b * nq + q] = found < 0 ? T(0) : acc_e[found];
    mon_out[b * nq + q] = found < 0 ? 0 : 1;
    x = x_next;
  }
}

// -- the dense compare ---------------------------------------------------------

constexpr int kDenseMaxThreads = 128;  // queries per block, one per thread
constexpr int kTile = 2048;            // summary ids staged in shared memory per pass

// Compares query x with the first `words` int4 words of the staged tile. A
// query matches few ids of a row, so the four ids of a word are tested
// together and the rare match takes a branch; written as four predicated
// tests, each id issued its two loads and two adds whether it matched or not.
template <typename T>
__device__ __forceinline__ void compare_tile(const int4* tile, int words, int i0,
                                             int32_t x, const T* sc, const T* se,
                                             T& f, T& e, bool& m) {
#pragma unroll 8
  for (int i = 0; i < words; ++i) {
    const int4 v = tile[i];
    if (__builtin_expect(v.x == x || v.y == x || v.z == x || v.w == x, 0)) {
      const int base = i0 + 4 * i;
      const int32_t ids[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (ids[u] == x) {
          f = wrap_add(f, sc[base + u]);
          e = wrap_add(e, se[base + u]);
          m = true;
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kDenseMaxThreads)
query_dense_kernel(const int32_t* __restrict__ s_items,
                   const T* __restrict__ s_counts, const T* __restrict__ s_errors,
                   const int32_t* __restrict__ queries, T* __restrict__ f_out,
                   T* __restrict__ eps_out, uint8_t* __restrict__ mon_out,
                   int k, int nq, int slices) {
  __shared__ int4 tile[kTile / 4];
  int32_t* tile_ids = reinterpret_cast<int32_t*>(tile);

  // grid.x is (batch entry, block of queries) folded, queries minor
  const int64_t b = blockIdx.x / slices;
  // 32-bit indices (64-bit ones slowed the compare loop down on the H100);
  // the launch keeps q below 2^31 (nq <= INT_MAX - blockDim.x)
  const int q = static_cast<int>(blockIdx.x % slices) * blockDim.x + threadIdx.x;
  const int32_t* si = s_items + b * k;
  const T* sc = s_counts + b * k;
  const T* se = s_errors + b * k;
  const int32_t x = q < nq ? queries[b * nq + q] : kEmpty;
  T f = 0, e = 0;
  bool m = false;

  for (int i0 = 0; i0 < k; i0 += kTile) {
    __syncthreads();                      // the previous tile is consumed
    const int n = min(kTile, k - i0);
    // unrolled so that a thread's loads of the tile are in flight together
#pragma unroll 16
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      tile_ids[i] = i < n ? si[i0 + i] : kEmpty;
    }
    __syncthreads();
    if (x == kEmpty) continue;            // EMPTY never matches
    // a full tile with a fixed trip count; the last one only up to k
    const int words = (n + 3) / 4;
    if (words == kTile / 4) {
      compare_tile(tile, kTile / 4, i0, x, sc, se, f, e, m);
    } else {
      compare_tile(tile, words, i0, x, sc, se, f, e, m);
    }
  }
  if (q < nq) {
    f_out[b * nq + q] = f;
    eps_out[b * nq + q] = e;
    mon_out[b * nq + q] = m ? 1 : 0;
  }
}

// -- launches ------------------------------------------------------------------

constexpr int64_t kMaxBlocks = 0x7FFFFFFF;

template <typename T>
int setup_hash(int max_smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      query_hash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem));
}

template <typename T>
int launch_hash(const void* s_items, const void* s_counts, const void* s_errors,
                const void* queries, void* f_out, void* eps_out, void* mon_out,
                int batch, int k, int nq, int log_slots, int smem, int threads,
                int slice, void* stream) {
  // load <= 1/2 keeps an empty slot in every probe sequence
  if (batch < 1 || nq < 1 || k < 0 || slice < 1 || log_slots < 1 || log_slots > 30 ||
      (int64_t(1) << log_slots) < 2 * int64_t(k) ||
      int64_t(smem) < (int64_t(1) << log_slots) * int64_t(4 + 2 * sizeof(T)) ||
      threads < 32 || threads > kHashMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t slices = (int64_t(nq) + slice - 1) / slice;
  const int64_t blocks = int64_t(batch) * slices;
  if (blocks > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  query_hash_kernel<T><<<static_cast<unsigned>(blocks), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_items), static_cast<const T*>(s_counts),
      static_cast<const T*>(s_errors), static_cast<const int32_t*>(queries),
      static_cast<T*>(f_out), static_cast<T*>(eps_out),
      static_cast<uint8_t*>(mon_out), k, nq, log_slots, slice,
      static_cast<int>(slices));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dense(const void* s_items, const void* s_counts, const void* s_errors,
                 const void* queries, void* f_out, void* eps_out, void* mon_out,
                 int batch, int k, int nq, int threads, void* stream) {
  if (batch < 1 || nq < 1 || k < 0 || threads < 32 || threads > kDenseMaxThreads ||
      threads % 32 != 0 || nq > 0x7FFFFFFF - threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t slices = (int64_t(nq) + threads - 1) / threads;
  const int64_t blocks = int64_t(batch) * slices;
  if (blocks > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  query_dense_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_items), static_cast<const T*>(s_counts),
      static_cast<const T*>(s_errors), static_cast<const int32_t*>(queries),
      static_cast<T*>(f_out), static_cast<T*>(eps_out),
      static_cast<uint8_t*>(mon_out), k, nq, static_cast<int>(slices));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. Every tensor is contiguous, on the device of
// `stream`, with shapes (batch, k) for s_items/s_counts/s_errors and
// (batch, nq) for queries and the three outputs (mon one byte an entry);
// every entry writes every output. ss_query_<T> is the dense compare, with
// `threads` queries a block (a multiple of 32, at most 128);
// ss_query_hash_<T> the hash lookup, which takes the table's 2^log_slots
// slots (at least 2k), its `smem` bytes of shared memory (at most what the
// setup entry allowed once per device), the block's `threads` and the
// `slice` of queries a block takes. At most 2^31 - 1 blocks. Returns
// cudaGetLastError() after the launch (0 on success), or the error that
// refused it.
#define SS_QUERY_ENTRIES(suffix, T)                                              \
  extern "C" int ss_query_##suffix(                                              \
      const void* s_items, const void* s_counts, const void* s_errors,           \
      const void* queries, void* f_out, void* eps_out, void* mon_out, int batch, \
      int k, int nq, int threads, void* stream) {                                \
    return launch_dense<T>(s_items, s_counts, s_errors, queries, f_out, eps_out, \
                           mon_out, batch, k, nq, threads, stream);              \
  }                                                                              \
  extern "C" int ss_query_hash_setup_##suffix(int max_smem) {                    \
    return setup_hash<T>(max_smem);                                              \
  }                                                                              \
  extern "C" int ss_query_hash_##suffix(                                         \
      const void* s_items, const void* s_counts, const void* s_errors,           \
      const void* queries, void* f_out, void* eps_out, void* mon_out, int batch, \
      int k, int nq, int log_slots, int smem, int threads, int slice,            \
      void* stream) {                                                            \
    return launch_hash<T>(s_items, s_counts, s_errors, queries, f_out, eps_out,  \
                          mon_out, batch, k, nq, log_slots, smem, threads,       \
                          slice, stream);                                        \
  }

SS_QUERY_ENTRIES(i32, int32_t)
SS_QUERY_ENTRIES(i64, int64_t)
