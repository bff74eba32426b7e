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
// EMPTY (-1) never matches. Duplicate candidate ids are summed. Sums are
// taken in the count type T (int32 or int64) with wrap-around, so that the
// result equals the plain PyTorch version bit for bit.
//
// What bounds it on the H100: the dense formulation does k*c id compares
// per batch entry (2048 x 16384 x 64 tenants = 2.1e9 at the engine's flush
// shape) against ~10 MB of input and output, so it is bound by compare
// issue rate, not by the 3.35 TB/s of device memory.
// What the design does about it: one summary row per thread, its id and
// its three accumulators in registers; the block stages candidate ids in
// shared memory, kTile at a time, and every thread reads them as int4, so
// that one shared-memory load (a broadcast: all threads read one address)
// feeds four compares. Counts and errors are read from global memory only
// on a match, which is rare (at most one match per row for distinct ids).
// A thread that finds a match stores 1 into the zero-filled matched_c
// bytes; racing writers store the same value, so the result is
// deterministic. Rows whose id is EMPTY skip the compare loop.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int kThreads = 256;   // summary rows per block, one per thread
constexpr int kTile = 2048;     // candidate ids staged in shared memory per pass

template <typename T>
__device__ __forceinline__ T wrap_add(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  return static_cast<T>(static_cast<U>(a) + static_cast<U>(b));
}

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
__global__ void __launch_bounds__(kThreads)
combine_match_kernel(const int32_t* __restrict__ s_items,
                     const int32_t* __restrict__ c_items,
                     const T* __restrict__ c_counts,
                     const T* __restrict__ c_errors,
                     T* __restrict__ add_c, T* __restrict__ add_e,
                     uint8_t* __restrict__ matched_s, uint8_t* matched_c,
                     int k, int c) {
  __shared__ int4 tile[kTile / 4];
  int32_t* tile_ids = reinterpret_cast<int32_t*>(tile);

  const int64_t b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int32_t* ci = c_items + b * c;
  const T* cc = c_counts + b * c;
  const T* ce = c_errors == nullptr ? nullptr : c_errors + b * c;
  uint8_t* mc = matched_c + b * c;
  const int32_t s = i < k ? s_items[b * k + i] : kEmpty;
  Acc<T> acc;

  for (int j0 = 0; j0 < c; j0 += kTile) {
    __syncthreads();                      // the previous tile is consumed
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
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

template <typename T>
int launch(const void* s_items, const void* c_items, const void* c_counts,
           const void* c_errors, void* add_c, void* add_e, void* matched_s,
           void* matched_c, int batch, int k, int c, void* stream) {
  const dim3 grid((k + kThreads - 1) / kThreads, batch);
  combine_match_kernel<T><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_items), static_cast<const int32_t*>(c_items),
      static_cast<const T*>(c_counts), static_cast<const T*>(c_errors),
      static_cast<T*>(add_c), static_cast<T*>(add_e),
      static_cast<uint8_t*>(matched_s), static_cast<uint8_t*>(matched_c), k, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. Every tensor is contiguous, on the device of
// `stream`, with shapes (batch, k) for s_items/add_c/add_e/matched_s and
// (batch, c) for c_items/c_counts/c_errors/matched_c. c_errors and add_e
// are both null when there is no errors channel. matched_c must be zeroed.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ss_combine_match_i32(const void* s_items, const void* c_items,
                                    const void* c_counts, const void* c_errors,
                                    void* add_c, void* add_e, void* matched_s,
                                    void* matched_c, int batch, int k, int c,
                                    void* stream) {
  return launch<int32_t>(s_items, c_items, c_counts, c_errors, add_c, add_e,
                         matched_s, matched_c, batch, k, c, stream);
}

extern "C" int ss_combine_match_i64(const void* s_items, const void* c_items,
                                    const void* c_counts, const void* c_errors,
                                    void* add_c, void* add_e, void* matched_s,
                                    void* matched_c, int batch, int k, int c,
                                    void* stream) {
  return launch<int64_t>(s_items, c_items, c_counts, c_errors, add_c, add_e,
                         matched_s, matched_c, batch, k, c, stream);
}
