// WaveRNN RAW sample loop: one launch runs every step of the serial loop.
//
// Replaces the TPU kernel tacotronv2_wavernn_chinese_tpu/ops/wavernn_kernel.py
// (generate_pallas, _kernel): per step and fold, the I projection of
// [x, mel, a1] -> GRU1 + residual -> GRU2 on [x, a2] + residual -> fc1 ReLU
// on [x, a3] -> fc2 ReLU on [x, a4] -> fc3 logits -> Gumbel-argmax (or
// greedy argmax) -> feed back 2*l/(n-1) - 1.
//
// What bounds it on the card: the dependence chain I -> GRU1 -> GRU2 ->
// fc1 -> fc2 -> fc3 -> argmax -> x is serial, and every link is a
// matrix-vector product over f32 weights (~4.3 M parameters, ~17 MB) that
// must be read again at every step.  The weights fit the 50 MB L2 but not
// an SM's shared memory, so one step costs at least one pass over 17 MB of
// L2 by each block: the kernel is bound by the L2 bandwidth one SM can
// draw, not by device memory and not by arithmetic (~9.8 MFLOP per fold
// per step).
//
// What the design does about it: one block owns a tile of FT folds for the
// whole loop and keeps h1, h2, x and every intermediate in shared memory,
// so the only traffic per step is the weights (from L2, each weight used
// for all FT folds in registers) and 208 floats of conditioning per fold.
// Weights are stored transposed ([out, in]) so a warp reads four outputs'
// weights as contiguous float4s, four loads in flight per lane (with one
// output per warp the loop was bound by L2 latency: 567 vs 338 us per step
// at 16 folds on the H100, PERF.md).  Folds scale across blocks; the per-step
// latency does not.  Splitting the weights across SMs (a cluster or a
// cooperative grid with a barrier per layer), bf16 storage and wgmma are
// the redesign this first version leaves to later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "rng.cuh"

namespace {

constexpr int FT = 4;        // folds per block
constexpr int THREADS = 1024;
constexpr int NMEL = 80;
constexpr int AUX = 32;
constexpr int COND = NMEL + 4 * AUX;  // 208: mel | a1 | a2 | a3 | a4
constexpr int XI = 116;               // [x, mel, a1] padded to a multiple of 4
constexpr int A2 = NMEL + AUX, A3 = NMEL + 2 * AUX, A4 = NMEL + 3 * AUX;

struct Weights {
  const float *w_i, *b_i, *wi1, *bi1, *wh1, *bh1, *wi2, *bi2, *wh2, *bh2;
  const float *wfc1, *bfc1, *wfc2, *bfc2, *wfc3, *bfc3;
};

// fc3 logits (+ Gumbel noise) reduced to one running argmax per fold and
// warp; the first occurrence wins ties, like torch.argmax.  Columns are
// taken COLS at a time, as in matvec_rows.
__device__ void logits_argmax(const float* __restrict__ W, const float* __restrict__ bias,
                              int NC, int Kp, const float* y, int ldy,
                              const uint32_t* keys, bool greedy,
                              float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int K4 = Kp >> 2;
  float best_v[FT];
  int best_i[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) { best_v[f] = -INFINITY; best_i[f] = 0x7fffffff; }
  for (int n0 = warp * COLS; n0 < NC; n0 += nwarps * COLS) {
    float acc[COLS][FT];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int f = 0; f < FT; ++f) acc[c][f] = 0.0f;
#pragma unroll 1
    for (int k4 = lane; k4 < K4; k4 += 32) {
      float4 w[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        w[c] = n0 + c < NC ? __ldg(reinterpret_cast<const float4*>(W + (size_t)(n0 + c) * Kp) + k4)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float4 v = reinterpret_cast<const float4*>(y + (size_t)f * ldy)[k4];
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          acc[c][f] = fmaf(w[c].x, v.x, acc[c][f]);
          acc[c][f] = fmaf(w[c].y, v.y, acc[c][f]);
          acc[c][f] = fmaf(w[c].z, v.z, acc[c][f]);
          acc[c][f] = fmaf(w[c].w, v.w, acc[c][f]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int f = 0; f < FT; ++f) acc[c][f] = warp_sum(acc[c][f]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int n = n0 + c;
        if (n < NC) {
          const float b = __ldg(bias + n);
#pragma unroll
          for (int f = 0; f < FT; ++f) {
            float v = acc[c][f] + b;
            if (!greedy) v += rng_gumbel(rng_bits_from_key(keys[f], (uint32_t)n));
            if (v > best_v[f]) { best_v[f] = v; best_i[f] = n; }
          }
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < FT; ++f) { red_v[warp * FT + f] = best_v[f]; red_i[warp * FT + f] = best_i[f]; }
  }
}

__device__ __forceinline__ float gru_h(const float* gi, const float* gh, float h, int j, int H) {
  const float r = sigmoidf_(gi[j] + gh[j]);
  const float z = sigmoidf_(gi[H + j] + gh[H + j]);
  const float n = tanhf(gi[2 * H + j] + r * gh[2 * H + j]);
  return (1.0f - z) * n + z * h;
}

__global__ void __launch_bounds__(THREADS)
wavernn_sample_kernel(const float* __restrict__ cond, Weights w, int* __restrict__ labels,
                      int T, int B, int H, int FC, int NC, int greedy, uint32_t seed) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int KA = (H > FC ? H : FC) + AUX;  // stride of the [vec | aux] inputs
  float* s_cond = sm;                  sm += FT * COND;
  float* s_xi = sm;                    sm += FT * XI;
  float* s_h1 = sm;                    sm += FT * H;
  float* s_h2 = sm;                    sm += FT * H;
  float* s_xt = sm;                    sm += FT * H;
  float* s_gi = sm;                    sm += FT * 3 * H;
  float* s_gh1 = sm;                   sm += FT * 3 * H;
  float* s_gh2 = sm;                   sm += FT * 3 * H;
  float* s_xa = sm;                    sm += FT * KA;
  float* s_xb = sm;                    sm += FT * (FC + AUX);
  float* s_y = sm;                     sm += FT * FC;
  float* s_x = sm;                     sm += 4;
  float* s_redv = sm;                  sm += 32 * FT;
  int* s_redi = reinterpret_cast<int*>(sm);

  const int tid = threadIdx.x;
  const int fold0 = blockIdx.x * FT;
  for (int i = tid; i < FT * H; i += blockDim.x) { s_h1[i] = 0.0f; s_h2[i] = 0.0f; }
  for (int i = tid; i < FT * KA; i += blockDim.x) s_xa[i] = 0.0f;
  for (int i = tid; i < FT * (FC + AUX); i += blockDim.x) s_xb[i] = 0.0f;
  if (tid < 4) s_x[tid] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // conditioning of this step; folds past B read zeros
    for (int i = tid; i < FT * COND; i += blockDim.x) {
      const int f = i / COND, c = i - f * COND, fold = fold0 + f;
      s_cond[i] = fold < B ? cond[((size_t)t * B + fold) * COND + c] : 0.0f;
    }
    for (int i = tid; i < FT * XI; i += blockDim.x) {
      const int f = i / XI, k = i - f * XI, fold = fold0 + f;
      float v = 0.0f;
      if (k == 0) v = s_x[f];
      else if (k <= NMEL + AUX && fold < B) v = cond[((size_t)t * B + fold) * COND + (k - 1)];
      s_xi[i] = v;
    }
    __syncthreads();
    // I projection, and both GRUs' hidden-side gates (they need only the
    // previous step's state)
    matvec_rows<FT>(w.w_i, w.b_i, H, XI, s_xi, XI, FT, s_xt, H, ACT_NONE);
    matvec_rows<FT>(w.wh1, w.bh1, 3 * H, H, s_h1, H, FT, s_gh1, 3 * H, ACT_NONE);
    matvec_rows<FT>(w.wh2, w.bh2, 3 * H, H, s_h2, H, FT, s_gh2, 3 * H, ACT_NONE);
    __syncthreads();
    matvec_rows<FT>(w.wi1, w.bi1, 3 * H, H, s_xt, H, FT, s_gi, 3 * H, ACT_NONE);
    __syncthreads();
    // GRU1 + residual; stage [xt, a2] for GRU2 and a4 behind fc1's output
    for (int i = tid; i < FT * H; i += blockDim.x) {
      const int f = i / H, j = i - f * H;
      const float h = gru_h(s_gi + f * 3 * H, s_gh1 + f * 3 * H, s_h1[i], j, H);
      s_h1[i] = h;
      const float xt = s_xt[i] + h;
      s_xt[i] = xt;
      s_xa[f * KA + j] = xt;
    }
    for (int i = tid; i < FT * AUX; i += blockDim.x) {
      const int f = i / AUX, c = i - f * AUX;
      s_xa[f * KA + H + c] = s_cond[f * COND + A2 + c];
      s_xb[f * (FC + AUX) + FC + c] = s_cond[f * COND + A4 + c];
    }
    __syncthreads();
    matvec_rows<FT>(w.wi2, w.bi2, 3 * H, H + AUX, s_xa, KA, FT, s_gi, 3 * H, ACT_NONE);
    __syncthreads();
    // GRU2 + residual; stage [xt, a3] for fc1
    for (int i = tid; i < FT * H; i += blockDim.x) {
      const int f = i / H, j = i - f * H;
      const float h = gru_h(s_gi + f * 3 * H, s_gh2 + f * 3 * H, s_h2[i], j, H);
      s_h2[i] = h;
      const float xt = s_xt[i] + h;
      s_xt[i] = xt;
      s_xa[f * KA + j] = xt;
    }
    for (int i = tid; i < FT * AUX; i += blockDim.x) {
      const int f = i / AUX, c = i - f * AUX;
      s_xa[f * KA + H + c] = s_cond[f * COND + A3 + c];
    }
    __syncthreads();
    matvec_rows<FT>(w.wfc1, w.bfc1, FC, H + AUX, s_xa, KA, FT, s_xb, FC + AUX, ACT_RELU);
    __syncthreads();
    matvec_rows<FT>(w.wfc2, w.bfc2, FC, FC + AUX, s_xb, FC + AUX, FT, s_y, FC, ACT_RELU);
    __syncthreads();
    uint32_t keys[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) keys[f] = rng_key(seed, (uint32_t)(fold0 + f), (uint32_t)t);
    logits_argmax(w.wfc3, w.bfc3, NC, FC, s_y, FC, keys, greedy != 0, s_redv, s_redi);
    __syncthreads();
    if (tid < FT) {
      const int f = tid;
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
        const float v = s_redv[k * FT + f];
        const int ix = s_redi[k * FT + f];
        if (v > bv || (v == bv && ix < bi)) { bv = v; bi = ix; }
      }
      if (bi == 0x7fffffff) bi = 0;  // all-NaN logits: nothing compared greater
      if (fold0 + f < B) labels[(size_t)t * B + fold0 + f] = bi;
      // label_2_float's op order (2*l, then / (n-1), then - 1)
      s_x[f] = 2.0f * (float)bi / ((float)NC - 1.0f) - 1.0f;
    }
    __syncthreads();
  }
}

int smem_bytes(int H, int FC) {
  const int KA = (H > FC ? H : FC) + AUX;
  const int floats = FT * (COND + XI + 3 * H + 9 * H + KA + (FC + AUX) + FC) + 4 + 2 * 32 * FT;
  return floats * 4;
}

}  // namespace

// Launches the whole sample loop on ``stream``.  cond: [T, B, 208] f32;
// weights transposed to [out, in] with in padded to a multiple of 4 (see
// ops/wavernn_kernel.py pack_weights); labels: [T, B] int32.
// Returns cudaGetLastError() after the launch.
extern "C" int wavernn_sample_launch(
    const float* cond,
    const float* w_i, const float* b_i,
    const float* wi1, const float* bi1, const float* wh1, const float* bh1,
    const float* wi2, const float* bi2, const float* wh2, const float* bh2,
    const float* wfc1, const float* bfc1, const float* wfc2, const float* bfc2,
    const float* wfc3, const float* bfc3,
    int* labels,
    int T, int B, int H, int FC, int NC, int greedy, uint32_t seed, void* stream) {
  Weights w{w_i, b_i, wi1, bi1, wh1, bh1, wi2, bi2, wh2, bh2, wfc1, bfc1, wfc2, bfc2, wfc3, bfc3};
  const int smem = smem_bytes(H, FC);
  cudaError_t err = cudaFuncSetAttribute(wavernn_sample_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + FT - 1) / FT;
  wavernn_sample_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      cond, w, labels, T, B, H, FC, NC, greedy, seed);
  return (int)cudaGetLastError();
}
