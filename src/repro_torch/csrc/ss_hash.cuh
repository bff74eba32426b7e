// The open-addressing hash tables in shared memory that the hash kernels of
// ss_combine.cu, ss_query.cu and ss_ingest.cu build: int32 keys, EMPTY (-1)
// for a free slot, linear probing. slot_of / find: Fibonacci hashing (the
// high bits of x * 0x9E3779B1) in a table of 2^log_slots slots. slot_in /
// find_in: a keyed hash (murmur3's finaliser of x ^ salt, the salt drawn
// afresh for every launch) reduced to a table of any size, so that no set
// of ids chosen in advance lands on one probe chain. kernels/build.py names
// each library by the hash of its .cu file together with every csrc/*.cuh,
// so an edit here rebuilds all three.
#pragma once

#include <cstdint>

namespace ss_hash {

constexpr int32_t kFree = -1;              // EMPTY: the key of a free slot
constexpr uint32_t kMul = 0x9E3779B1u;     // 2^32 / golden ratio, odd

// The home slot of id x in a table of 2^log_slots slots.
__device__ __forceinline__ uint32_t slot_of(int32_t x, int log_slots) {
  return (static_cast<uint32_t>(x) * kMul) >> (32 - log_slots);
}

// The slot of a valid id already in a table of 2^log_slots slots, or -1 if
// it is not there.
__device__ __forceinline__ int find(const int32_t* keys, int32_t x, int log_slots) {
  const uint32_t mask = (1u << log_slots) - 1;
  for (uint32_t p = slot_of(x, log_slots);; p = (p + 1) & mask) {
    const int32_t key = keys[p];
    if (key == x) return static_cast<int>(p);
    if (key == kFree) return -1;
  }
}

// murmur3's 32-bit finaliser: a bijection in which each bit of the input
// flips each bit of the output with a probability near 1/2.
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The home slot of id x in a table of n slots, n any size, under the key
// salt: the high half of the 32 x 32-bit product of mix32(x ^ salt) with n.
__device__ __forceinline__ uint32_t slot_in(int32_t x, uint32_t n, uint32_t salt) {
  return __umulhi(mix32(static_cast<uint32_t>(x) ^ salt), n);
}

// find for a table of n slots, n any size, built under the key salt; the
// table keeps a free slot.
__device__ __forceinline__ int find_in(const int32_t* keys, int32_t x, uint32_t n,
                                       uint32_t salt) {
  for (uint32_t p = slot_in(x, n, salt);; p = p + 1 == n ? 0 : p + 1) {
    const int32_t key = keys[p];
    if (key == x) return static_cast<int>(p);
    if (key == kFree) return -1;
  }
}

// *addr += v in T (int32 or int64) with wrap-around. Integer addition is
// associative, so any order of the atomics gives the same bits.
template <typename T>
__device__ __forceinline__ void atomic_wrap_add(T* addr, T v) {
  if constexpr (sizeof(T) == 8) {
    atomicAdd(reinterpret_cast<unsigned long long*>(addr),
              static_cast<unsigned long long>(v));
  } else {
    atomicAdd(reinterpret_cast<unsigned int*>(addr), static_cast<unsigned int>(v));
  }
}

}  // namespace ss_hash
