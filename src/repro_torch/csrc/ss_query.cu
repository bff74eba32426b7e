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
// EMPTY (-1) never matches. The Pallas kernel summed as an f32 dot, exact
// only below 2^24; here the sums are taken in the count type T (int32 or
// int64) with wrap-around, equal bit for bit to the plain PyTorch version.
//
// What bounds it on the H100: at the frontend's shapes (k = 2048 counters,
// 16 to a few thousand queries) the work is small, 2048 compares a query
// and ~30 KB of input, so a call is bound by its launch and by one pass of
// each block over the k ids, not by memory or compare rate.
// What the design does about it: one query per thread, its id and
// accumulators in registers; the block stages the summary ids in shared
// memory, kTile at a time, read as int4 broadcasts (four compares a load);
// counts and errors are read from global memory only on a match. Queries
// that are EMPTY (the frontend's bucket padding) skip the loop. The batch and
// the blocks of queries share grid.x, so the batch has no 65 535 limit.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kTile = 2048;     // summary ids staged in shared memory per pass

template <typename T>
__device__ __forceinline__ T wrap_add(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  return static_cast<T>(static_cast<U>(a) + static_cast<U>(b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
query_kernel(const int32_t* __restrict__ s_items,
             const T* __restrict__ s_counts, const T* __restrict__ s_errors,
             const int32_t* __restrict__ queries, T* __restrict__ f_out,
             T* __restrict__ eps_out, uint8_t* __restrict__ mon_out,
             int k, int nq, int query_blocks) {
  __shared__ int4 tile[kTile / 4];
  int32_t* tile_ids = reinterpret_cast<int32_t*>(tile);

  // grid.x is (batch entry, block of queries) folded, queries minor
  const int64_t b = blockIdx.x / query_blocks;
  const int q = static_cast<int>(blockIdx.x % query_blocks) * kThreads + threadIdx.x;
  const int32_t* si = s_items + b * k;
  const T* sc = s_counts + b * k;
  const T* se = s_errors + b * k;
  const int32_t x = q < nq ? queries[b * nq + q] : kEmpty;
  T f = 0, e = 0;
  bool m = false;

  for (int i0 = 0; i0 < k; i0 += kTile) {
    __syncthreads();                      // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      tile_ids[i] = i0 + i < k ? si[i0 + i] : kEmpty;
    }
    __syncthreads();
    if (x == kEmpty) continue;            // EMPTY never matches
#pragma unroll 8
    for (int i = 0; i < kTile / 4; ++i) {
      const int4 v = tile[i];
      const int64_t base = i0 + 4 * i;
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
  if (q < nq) {
    f_out[b * nq + q] = f;
    eps_out[b * nq + q] = e;
    mon_out[b * nq + q] = m ? 1 : 0;
  }
}

template <typename T>
int launch(const void* s_items, const void* s_counts, const void* s_errors,
           const void* queries, void* f_out, void* eps_out, void* mon_out,
           int batch, int k, int nq, void* stream) {
  const int query_blocks = (nq + kThreads - 1) / kThreads;
  const int64_t blocks = int64_t(batch) * query_blocks;
  if (batch < 1 || nq < 1 || k < 0 || blocks > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  query_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_items), static_cast<const T*>(s_counts),
      static_cast<const T*>(s_errors), static_cast<const int32_t*>(queries),
      static_cast<T*>(f_out), static_cast<T*>(eps_out),
      static_cast<uint8_t*>(mon_out), k, nq, query_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. Every tensor is contiguous, on the device of
// `stream`, with shapes (batch, k) for s_items/s_counts/s_errors and
// (batch, nq) for queries and the three outputs; batch * ceil(nq / 128)
// blocks, at most 2^31 - 1. Returns cudaGetLastError() after the launch (0
// on success), or the error that refused it.
extern "C" int ss_query_i32(const void* s_items, const void* s_counts,
                            const void* s_errors, const void* queries,
                            void* f_out, void* eps_out, void* mon_out,
                            int batch, int k, int nq, void* stream) {
  return launch<int32_t>(s_items, s_counts, s_errors, queries, f_out, eps_out,
                         mon_out, batch, k, nq, stream);
}

extern "C" int ss_query_i64(const void* s_items, const void* s_counts,
                            const void* s_errors, const void* queries,
                            void* f_out, void* eps_out, void* mon_out,
                            int batch, int k, int nq, void* stream) {
  return launch<int64_t>(s_items, s_counts, s_errors, queries, f_out, eps_out,
                         mon_out, batch, k, nq, stream);
}
