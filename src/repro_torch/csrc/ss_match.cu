// Batched match-weights of a histogram against Space Saving summaries for
// Hopper (sm_90a): the `update` op of the plan's probes and the tune CLI.
//
// Replaces the Pallas TPU kernel repro/kernels/ss_match.py: match_weights_pallas
// (_match_kernel). For each batch entry b:
//
//   add_w[b,i]   = sum_j [s[b,i] == h[b,j]] * w[b,j]
//   matched[b,j] = exists i [s[b,i] == h[b,j]]
//
// EMPTY (-1) never matches; duplicate ids on either side are allowed (every
// summary slot holding an id receives the whole sum of its matches, and
// duplicate histogram ids add up). The Pallas kernel built the dense k x c
// equality matrix and summed it as an f32 dot, exact only below 2^24; here
// the sums are taken in the weight type T (int32 or int64) with wrap-around,
// equal bit for bit to the plain PyTorch version.
//
// What bounds it on the H100: the function is an equi-join. Its bytes are the
// ids and weights read once and the outputs written once (90 KB at k = 2048,
// c = 8192), and a hash join needs one insert per summary id and one probe per
// histogram id, so a single row is bound by its launch, and the dense k x c
// compare the TPU kernel did is 2048 times the join's work.
// What the design does about it: the paper's own hash-table probe in place of
// the dense matrix. One block per batch entry builds an open-addressing table
// of the distinct valid summary ids in shared memory (load <= 1/2, linear
// probing, atomicCAS insert), each id with an accumulator of type T; every
// histogram id is probed once and a hit atomicAdds its weight into that id's
// accumulator (integer addition with wrap-around is associative, so the
// result does not depend on the order of the atomics); then each summary
// slot reads its id's accumulator. Nothing is padded: k and c are any size.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int kThreads = 1024;
constexpr int kMinLogSlots = 6;     // at least 64 table slots
constexpr int kMaxLogSlots = 14;    // 16384 slots: k <= 8192 at load <= 1/2
constexpr int kMaxK = 1 << (kMaxLogSlots - 1);

__device__ __forceinline__ uint32_t slot_of(int32_t x, int log_slots) {
  return (static_cast<uint32_t>(x) * 0x9E3779B1u) >> (32 - log_slots);
}

// The slot of a valid id already in the table, or -1 if it is not there.
__device__ __forceinline__ int find(const int32_t* keys, int32_t x, int log_slots) {
  const uint32_t mask = (1u << log_slots) - 1;
  for (uint32_t p = slot_of(x, log_slots);; p = (p + 1) & mask) {
    const int32_t key = keys[p];
    if (key == x) return static_cast<int>(p);
    if (key == kEmpty) return -1;
  }
}

template <typename T>
__device__ __forceinline__ void atomic_wrap_add(T* addr, T v) {
  if constexpr (sizeof(T) == 8) {
    atomicAdd(reinterpret_cast<unsigned long long*>(addr),
              static_cast<unsigned long long>(v));
  } else {
    atomicAdd(reinterpret_cast<unsigned int*>(addr), static_cast<unsigned int>(v));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
match_kernel(const int32_t* __restrict__ s_items, const int32_t* __restrict__ h_items,
             const T* __restrict__ h_weights, T* __restrict__ add_w,
             uint8_t* __restrict__ matched, int k, int c, int log_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_slots = 1 << log_slots;
  T* acc = reinterpret_cast<T*>(smem);                      // n_slots sums
  int32_t* keys = reinterpret_cast<int32_t*>(acc + n_slots);  // n_slots ids

  const int64_t b = blockIdx.x;
  const int32_t* s = s_items + b * k;
  const int32_t* h = h_items + b * c;
  const T* w = h_weights + b * c;
  const uint32_t mask = n_slots - 1;

  for (int i = threadIdx.x; i < n_slots; i += kThreads) {
    keys[i] = kEmpty;
    acc[i] = T(0);
  }
  __syncthreads();

  // insert the distinct valid summary ids (a duplicate finds its own key)
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int32_t x = s[i];
    if (x == kEmpty) continue;
    for (uint32_t p = slot_of(x, log_slots);; p = (p + 1) & mask) {
      const int32_t prev = atomicCAS(&keys[p], kEmpty, x);
      if (prev == kEmpty || prev == x) break;
    }
  }
  __syncthreads();

  // probe every histogram id once; a hit adds its weight to the id's sum
  for (int j = threadIdx.x; j < c; j += kThreads) {
    const int32_t x = h[j];
    uint8_t m = 0;
    if (x != kEmpty) {
      const int p = find(keys, x, log_slots);
      if (p >= 0) {
        atomic_wrap_add(&acc[p], w[j]);
        m = 1;
      }
    }
    matched[b * c + j] = m;
  }
  __syncthreads();

  // every summary slot reads the sum of its id
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int32_t x = s[i];
    add_w[b * k + i] = x == kEmpty ? T(0) : acc[find(keys, x, log_slots)];
  }
}

template <typename T>
int launch(const void* s_items, const void* h_items, const void* h_weights,
           void* add_w, void* matched, int batch, int k, int c, void* stream) {
  if (batch < 1 || k < 0 || k > kMaxK || c < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int log_slots = kMinLogSlots;
  while ((1 << log_slots) < 2 * k) ++log_slots;
  const size_t smem = (size_t(1) << log_slots) * (sizeof(T) + sizeof(int32_t));
  const cudaError_t err = cudaFuncSetAttribute(
      match_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  match_kernel<T><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s_items), static_cast<const int32_t*>(h_items),
      static_cast<const T*>(h_weights), static_cast<T*>(add_w),
      static_cast<uint8_t*>(matched), k, c, log_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. Every tensor is contiguous and on the device of
// `stream`: s_items and add_w (batch, k), h_items, h_weights and matched
// (batch, c); ids int32, weights and add_w of the entry's type, matched one
// byte per entry. batch >= 1, 0 <= k <= 8192, c >= 0. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ss_match_i32(const void* s_items, const void* h_items,
                            const void* h_weights, void* add_w, void* matched,
                            int batch, int k, int c, void* stream) {
  return launch<int32_t>(s_items, h_items, h_weights, add_w, matched, batch, k, c,
                         stream);
}

extern "C" int ss_match_i64(const void* s_items, const void* h_items,
                            const void* h_weights, void* add_w, void* matched,
                            int batch, int k, int c, void* stream) {
  return launch<int64_t>(s_items, h_items, h_weights, add_w, matched, batch, k, c,
                         stream);
}
