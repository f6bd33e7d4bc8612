// Block-level building blocks shared by the two sample-loop kernels.
//
// matvec_rows: y[r][n] = act(bias[n] + sum_k x[r][k] * W[n][k]) for a few
// rows r at once.  W is stored transposed ([N, Kp] row-major, Kp a multiple
// of 4, zero-padded), so one warp owns COLS output columns at a time and
// its 32 lanes read those columns' weights as contiguous float4s; each
// weight read from L2 is used for every row in registers.  The sum over k
// is a per-lane partial followed by a butterfly warp reduction.
#pragma once
#include <math.h>

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

enum { ACT_NONE = 0, ACT_RELU = 1 };

// R: the most rows one pass handles (registers); nrows <= R rows are used.
// Each warp works on COLS adjacent output columns at once, so COLS weight
// loads per lane are in flight together (one column at a time left the
// loop bound by L2 latency, not bandwidth).  x rows are ldx floats apart,
// y rows ldy floats apart.  x may be in shared or global memory; it is read
// with plain loads (it may have been written by this block before the
// preceding __syncthreads()).
constexpr int COLS = 4;

template <int R>
__device__ void matvec_rows(const float* __restrict__ W, const float* __restrict__ bias,
                            int N, int Kp, const float* x, int ldx, int nrows,
                            float* y, int ldy, int act) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int K4 = Kp >> 2;
  for (int n0 = warp * COLS; n0 < N; n0 += nwarps * COLS) {
    float acc[COLS][R];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][r] = 0.0f;
#pragma unroll 1
    for (int k4 = lane; k4 < K4; k4 += 32) {
      float4 w[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        w[c] = n0 + c < N ? __ldg(reinterpret_cast<const float4*>(W + (size_t)(n0 + c) * Kp) + k4)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nrows) {
          const float4 v = reinterpret_cast<const float4*>(x + (size_t)r * ldx)[k4];
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            acc[c][r] = fmaf(w[c].x, v.x, acc[c][r]);
            acc[c][r] = fmaf(w[c].y, v.y, acc[c][r]);
            acc[c][r] = fmaf(w[c].z, v.z, acc[c][r]);
            acc[c][r] = fmaf(w[c].w, v.w, acc[c][r]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][r] = warp_sum(acc[c][r]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int n = n0 + c;
        if (n < N) {
          const float b = bias ? __ldg(bias + n) : 0.0f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < nrows) {
              float v = acc[c][r] + b;
              if (act == ACT_RELU) v = fmaxf(v, 0.0f);
              y[(size_t)r * ldy + n] = v;
            }
          }
        }
      }
    }
  }
}
