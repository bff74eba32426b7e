// Batched combine-match for Hopper (sm_90a): the matcher inside every
// absorb_pool, so inside every engine flush and every COMBINE round.
//
// Replaces the Pallas TPU kernel repro/kernels/ss_combine.py:
// combine_match_pallas (_combine_kernel). For each batch entry b:
//
//   add_c[b,i]     = sum_j [s[b,i] == c[b,j]] * c_counts[b,j]
//   add_e[b,i]     = sum_j [s[b,i] == c[b,j]] * c_errors[b,j]   (if c_errors)
//   matched_s[b,i] = exists j  [s[b,i] == c[b,j]]
//   matched_c[b,j] = exists i  [s[b,i] == c[b,j]]
//
// EMPTY (-1) never matches. Duplicate ids on either side are summed: every
// summary slot holding an id gets that id's whole sum. Sums are taken in the
// count type T (int32 or int64) with wrap-around, so that the result equals
// the plain PyTorch version bit for bit.
//
// What bounds it on the H100: the function is an equi-join. Its bytes are
// the ids, counts and errors read once and the outputs written once (~10 MB
// at the engine's flush shape, B 64, k 2048, c 16 384), and a hash join
// needs one insert per summary id and one probe per candidate id, so it is
// bound by those bytes. The Pallas kernel compared every (summary,
// candidate) pair: 2.1e9 compares a flush, 2048 times the join's work.
//
// Two kernels, both one launch over the whole batch, the batch on grid.x
// (up to 2^31 - 1 blocks):
//
// combine_hash_kernel, the rule: one block of 1024 threads per batch entry
// builds an open-addressing table of the distinct valid summary ids in
// dynamic shared memory (load <= 1/2, linear probing, atomicCAS insert).
// Each table slot holds an id, an accumulator of type T for counts, one for
// errors when there is an errors channel, and a matched flag. Every
// candidate id is probed once: a hit atomicAdds its count (and error) into
// its slot, since integer addition with wrap-around is associative the
// result does not depend on the order of the atomics; it sets the slot's
// flag (the flag, not the sum, says "matched": a match may add 0) and
// writes matched_c. Then every summary slot reads its id's table slot. The
// caller sizes the table (log_slots) and its shared memory, and launches
// this kernel only where the table fits into one block's shared memory
// (kernels/ss_combine.py: table_slots, table_bytes, hash_fits). The same
// kernel with no errors channel serves match-weights (kernels/ss_match.py).
//
// combine_dense_kernel, above that limit: the dense compare. One summary
// row per thread keeps its id and sums in registers; the block stages
// candidate ids in shared memory, kTile at a time, read as int4 broadcasts
// (four compares a load); counts and errors are read from global memory
// only on a match. matched_c must be zero-filled: a matching thread stores
// 1, and racing writers store the same value.
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

// -- the hash join -------------------------------------------------------------

constexpr int kHashThreads = 1024;

using ss_hash::atomic_wrap_add;
using ss_hash::find;
using ss_hash::slot_of;

template <typename T>
__global__ void __launch_bounds__(kHashThreads)
combine_hash_kernel(const int32_t* __restrict__ s_items,
                    const int32_t* __restrict__ c_items,
                    const T* __restrict__ c_counts,
                    const T* __restrict__ c_errors,
                    T* __restrict__ add_c, T* __restrict__ add_e,
                    uint8_t* __restrict__ matched_s,
                    uint8_t* __restrict__ matched_c, int k, int c,
                    int log_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_slots = 1 << log_slots;
  // add_e, not c_errors, says whether there is an errors channel: c_errors
  // of a batch with c = 0 may be a null pointer
  const bool errors = add_e != nullptr;
  // the layout whose bytes kernels/ss_combine.py:table_bytes counts
  T* acc_c = reinterpret_cast<T*>(smem);                      // n_slots sums
  T* acc_e = acc_c + n_slots;                                 // n_slots, if errors
  int32_t* keys = reinterpret_cast<int32_t*>(acc_c + (errors ? 2 : 1) * n_slots);
  uint8_t* hit = reinterpret_cast<uint8_t*>(keys + n_slots);  // n_slots flags

  const int64_t b = blockIdx.x;
  const int32_t* s = s_items + b * k;
  const int32_t* ci = c_items + b * c;
  const T* cc = c_counts + b * c;
  const T* ce = errors ? c_errors + b * c : nullptr;
  const uint32_t mask = n_slots - 1;

  for (int p = threadIdx.x; p < n_slots; p += kHashThreads) {
    keys[p] = kEmpty;
    acc_c[p] = T(0);
    if (errors) acc_e[p] = T(0);
    hit[p] = 0;
  }
  __syncthreads();

  // insert the distinct valid summary ids (a duplicate finds its own key)
  for (int i = threadIdx.x; i < k; i += kHashThreads) {
    const int32_t x = s[i];
    if (x == kEmpty) continue;
    for (uint32_t p = slot_of(x, log_slots);; p = (p + 1) & mask) {
      const int32_t prev = atomicCAS(&keys[p], kEmpty, x);
      if (prev == kEmpty || prev == x) break;
    }
  }
  __syncthreads();

  // probe every candidate id once; a hit adds its count (and error) to the
  // id's sums and flags the id as matched
  for (int j = threadIdx.x; j < c; j += kHashThreads) {
    const int32_t x = ci[j];
    uint8_t m = 0;
    if (x != kEmpty) {
      const int p = find(keys, x, log_slots);
      if (p >= 0) {
        atomic_wrap_add(&acc_c[p], cc[j]);
        if (errors) atomic_wrap_add(&acc_e[p], ce[j]);
        hit[p] = 1;
        m = 1;
      }
    }
    matched_c[b * c + j] = m;
  }
  __syncthreads();

  // every summary slot reads the sums and the flag of its id
  for (int i = threadIdx.x; i < k; i += kHashThreads) {
    const int32_t x = s[i];
    const int p = x == kEmpty ? -1 : find(keys, x, log_slots);
    add_c[b * k + i] = p < 0 ? T(0) : acc_c[p];
    if (errors) add_e[b * k + i] = p < 0 ? T(0) : acc_e[p];
    matched_s[b * k + i] = p < 0 ? 0 : hit[p];
  }
}

// -- the dense compare ---------------------------------------------------------

constexpr int kDenseThreads = 256;  // summary rows per block, one per thread
constexpr int kTile = 2048;         // candidate ids staged in shared memory per pass

template <typename T>
struct Acc {
  T c = 0;
  T e = 0;
  bool m = false;

  __device__ __forceinline__ void take(int64_t j, const T* cc, const T* ce,
                                       uint8_t* mc) {
    c = wrap_add(c, cc[j]);
    if (ce != nullptr) e = wrap_add(e, ce[j]);
    m = true;
    mc[j] = 1;
  }
};

template <typename T>
__global__ void __launch_bounds__(kDenseThreads)
combine_dense_kernel(const int32_t* __restrict__ s_items,
                     const int32_t* __restrict__ c_items,
                     const T* __restrict__ c_counts,
                     const T* __restrict__ c_errors,
                     T* __restrict__ add_c, T* __restrict__ add_e,
                     uint8_t* __restrict__ matched_s, uint8_t* matched_c,
                     int k, int c, int row_blocks) {
  __shared__ int4 tile[kTile / 4];
  int32_t* tile_ids = reinterpret_cast<int32_t*>(tile);

  // grid.x is (batch entry, block of rows) folded, rows minor
  const int64_t b = blockIdx.x / row_blocks;
  const int i = static_cast<int>(blockIdx.x % row_blocks) * kDenseThreads + threadIdx.x;
  const int32_t* ci = c_items + b * c;
  const T* cc = c_counts + b * c;
  const T* ce = c_errors == nullptr ? nullptr : c_errors + b * c;
  uint8_t* mc = matched_c + b * c;
  const int32_t s = i < k ? s_items[b * k + i] : kEmpty;
  Acc<T> acc;

  for (int j0 = 0; j0 < c; j0 += kTile) {
    __syncthreads();                      // the previous tile is consumed
    for (int j = threadIdx.x; j < kTile; j += kDenseThreads) {
      tile_ids[j] = j0 + j < c ? ci[j0 + j] : kEmpty;
    }
    __syncthreads();
    if (s == kEmpty) continue;            // EMPTY never matches
#pragma unroll 8
    for (int j = 0; j < kTile / 4; ++j) {
      const int4 v = tile[j];
      const int64_t base = j0 + 4 * j;
      if (v.x == s) acc.take(base, cc, ce, mc);
      if (v.y == s) acc.take(base + 1, cc, ce, mc);
      if (v.z == s) acc.take(base + 2, cc, ce, mc);
      if (v.w == s) acc.take(base + 3, cc, ce, mc);
    }
  }
  if (i < k) {
    add_c[b * k + i] = acc.c;
    if (add_e != nullptr) add_e[b * k + i] = acc.e;
    matched_s[b * k + i] = acc.m ? 1 : 0;
  }
}

// -- launches ------------------------------------------------------------------

template <typename T>
int setup_hash(int max_smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      combine_hash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem));
}

template <typename T>
int launch_hash(const void* s_items, const void* c_items, const void* c_counts,
                const void* c_errors, void* add_c, void* add_e, void* matched_s,
                void* matched_c, int batch, int k, int c, int log_slots, int smem,
                void* stream) {
  // load <= 1/2 keeps an empty slot in every probe sequence
  if (batch < 1 || k < 0 || c < 0 || log_slots < 1 || log_slots > 30 ||
      (int64_t(1) << log_slots) < 2 * int64_t(k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  combine_hash_kernel<T><<<batch, kHashThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_items), static_cast<const int32_t*>(c_items),
      static_cast<const T*>(c_counts), static_cast<const T*>(c_errors),
      static_cast<T*>(add_c), static_cast<T*>(add_e),
      static_cast<uint8_t*>(matched_s), static_cast<uint8_t*>(matched_c), k, c,
      log_slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dense(const void* s_items, const void* c_items, const void* c_counts,
                 const void* c_errors, void* add_c, void* add_e, void* matched_s,
                 void* matched_c, int batch, int k, int c, void* stream) {
  const int row_blocks = (k + kDenseThreads - 1) / kDenseThreads;
  const int64_t blocks = int64_t(batch) * row_blocks;
  if (batch < 1 || k < 1 || c < 0 || blocks > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  combine_dense_kernel<T><<<static_cast<unsigned>(blocks), kDenseThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_items), static_cast<const int32_t*>(c_items),
      static_cast<const T*>(c_counts), static_cast<const T*>(c_errors),
      static_cast<T*>(add_c), static_cast<T*>(add_e),
      static_cast<uint8_t*>(matched_s), static_cast<uint8_t*>(matched_c), k, c,
      row_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. Every tensor is contiguous, on the device of
// `stream`, with shapes (batch, k) for s_items/add_c/add_e/matched_s and
// (batch, c) for c_items/c_counts/c_errors/matched_c; matched_s and
// matched_c one byte an entry. add_e is null when there is no errors
// channel, and c_errors then too. The hash entries take the table's
// 2^log_slots slots (at least 2k) and its `smem` bytes of shared memory, at
// most what the setup entry allowed once per device; they write every
// output. The dense entries need matched_c zero-filled. Returns
// cudaGetLastError() after the launch (0 on success), or the error that
// refused it.
#define SS_COMBINE_ENTRIES(suffix, T)                                            \
  extern "C" int ss_combine_hash_setup_##suffix(int max_smem) {                  \
    return setup_hash<T>(max_smem);                                              \
  }                                                                              \
  extern "C" int ss_combine_hash_##suffix(                                       \
      const void* s_items, const void* c_items, const void* c_counts,            \
      const void* c_errors, void* add_c, void* add_e, void* matched_s,           \
      void* matched_c, int batch, int k, int c, int log_slots, int smem,         \
      void* stream) {                                                            \
    return launch_hash<T>(s_items, c_items, c_counts, c_errors, add_c, add_e,    \
                          matched_s, matched_c, batch, k, c, log_slots, smem,    \
                          stream);                                               \
  }                                                                              \
  extern "C" int ss_combine_dense_##suffix(                                      \
      const void* s_items, const void* c_items, const void* c_counts,            \
      const void* c_errors, void* add_c, void* add_e, void* matched_s,           \
      void* matched_c, int batch, int k, int c, void* stream) {                  \
    return launch_dense<T>(s_items, c_items, c_counts, c_errors, add_c, add_e,   \
                           matched_s, matched_c, batch, k, c, stream);           \
  }

SS_COMBINE_ENTRIES(i32, int32_t)
SS_COMBINE_ENTRIES(i64, int64_t)
