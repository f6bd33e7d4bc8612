// Counter-based random bits shared by the two kernels.
//
// rng_bits(seed, row, step, lane) is three rounds of the murmur3 32-bit
// finalizer over (seed, row, step) and one over the lane.  The same
// function is written in plain torch in ops/__init__.py (hash_bits), with
// int64 arithmetic masked to 32 bits, so a kernel and its plain version
// draw identical bits: their comparison holds with dropout and sampling on.
// Each draw depends only on its own (seed, row, step, lane).
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t rng_fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Key of one (seed, row, step): the per-lane draws below reuse it.
__device__ __forceinline__ uint32_t rng_key(uint32_t seed, uint32_t row, uint32_t step) {
  uint32_t k = rng_fmix32(seed ^ 0x9E3779B9u);
  k = rng_fmix32(k ^ row);
  return rng_fmix32(k ^ step);
}

__device__ __forceinline__ uint32_t rng_bits_from_key(uint32_t key, uint32_t lane) {
  return rng_fmix32(key + lane * 0x9E3779B9u);
}

__device__ __forceinline__ uint32_t rng_bits(uint32_t seed, uint32_t row, uint32_t step, uint32_t lane) {
  return rng_bits_from_key(rng_key(seed, row, step), lane);
}

// uint32 bits -> standard Gumbel noise: the high 23 bits become a uniform in
// [1, 2) through the exponent trick, then (0, 1].  logf, not __logf: the
// plain version's torch.log must give the same values.
__device__ __forceinline__ float rng_gumbel(uint32_t bits) {
  float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  float u = fmaxf(f, 1e-9f);
  return -logf(-logf(u));
}
