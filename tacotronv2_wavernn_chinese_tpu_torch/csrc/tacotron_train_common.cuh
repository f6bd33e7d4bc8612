// What the two teacher-forced trainer kernels share (tacotron_train_fwd.cu,
// tacotron_train_bwd.cu): the block size, the shared-memory layouts, block
// reductions, the LSTM gate recompute and the location features.
//
// Both kernels give each batch row its own block (rows are independent)
// and run every step of the sequence inside one launch; per-row state sits
// in shared memory, the gate matrices are streamed from L2 every step by
// matvec_rows (common.cuh).  The layouts below are mirrored term for term
// by ops/tacotron_trainer_kernel.py smem_floats; the T_in-length vectors
// are the only part that grows with the encoder length.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

constexpr int TR_THREADS = 1024;
constexpr int TR_WARPS = TR_THREADS / 32;
constexpr int TR_SMEM_LIMIT = 232448;

struct TrDims {
  int B, T, T_in, P, U, V, A, F, taps;
};

__host__ __device__ inline int tr_up4(int x) { return (x + 3) & ~3; }

// K3: offsets (floats) into dynamic shared memory.
struct FwdLayout {
  int x1;     // [P + V + U]  LSTM1 input [p_t | ctx | h1]
  int x2;     // [2U]         LSTM2 input [out1 | h2]
  int c1, c2; // [U] each     cell states
  int o2;     // [U]          out2 of this step
  int g;      // [4U]         gate pre-activations
  int pq;     // [A]          query projection
  int wconv;  // [taps, F]    location conv
  int wloc;   // [F, A]       location dense
  int fbuf;   // [warps, F]   one position's location features per warp
  int red;    // [64]         reduction scratch
  int alpha, cum, en, al;  // [T_in] each
  int total;
};

__host__ __device__ inline FwdLayout fwd_layout(const TrDims& d) {
  FwdLayout L;
  int o = 0;
  const int T4 = tr_up4(d.T_in);
  L.x1 = o;    o += tr_up4(d.P + d.V + d.U);
  L.x2 = o;    o += 2 * d.U;
  L.c1 = o;    o += d.U;
  L.c2 = o;    o += d.U;
  L.o2 = o;    o += d.U;
  L.g = o;     o += 4 * d.U;
  L.pq = o;    o += tr_up4(d.A);
  L.wconv = o; o += tr_up4(d.taps * d.F);
  L.wloc = o;  o += tr_up4(d.F * d.A);
  L.fbuf = o;  o += TR_WARPS * tr_up4(d.F);
  L.red = o;   o += 64;
  L.alpha = o; o += T4;
  L.cum = o;   o += T4;
  L.en = o;    o += T4;
  L.al = o;    o += T4;
  L.total = o;
  return L;
}

// K4: offsets (floats) into dynamic shared memory.
struct BwdLayout {
  int x1;          // [P + V + U]  [p_t | ctxp | h1p] (gate recompute)
  int x2;          // [2U]         [out1 | h2p]
  int o2;          // [U]          out2 of this step
  int g, dg;       // [4U] each    recomputed gates, gate adjoint
  int ac1, ah1, ac2, ah2;  // [U] each  carried state adjoints
  int actx, dctx;  // [V] each     carried context adjoint, d_ctx_tot
  int dout2;       // [U]
  int y1;          // [V + U]      l1 [ctx | h] rows times d_g1
  int y2;          // [2U]         l2 rows times d_g2
  int y3;          // [U]          wq rows times d_q
  int pq, dq, dv, dball;  // [A] each
  int wconv;       // [taps, F]
  int wloc;        // [F, A]
  int wlocT;       // [A, F]
  int fbuf;        // [warps, F]
  int dthbuf;      // [warps, A]   one position's d_th per warp
  int partq;       // [warps, A]   per-warp sums of d_th
  int partv;       // [warps, A]   per-warp sums of th * d_e
  int red;         // [64]
  int cum, aalpha, acum, bufA, bufE;  // [T_in] each
  int total;
};

__host__ __device__ inline BwdLayout bwd_layout(const TrDims& d) {
  BwdLayout L;
  int o = 0;
  const int T4 = tr_up4(d.T_in), A4 = tr_up4(d.A);
  L.x1 = o;     o += tr_up4(d.P + d.V + d.U);
  L.x2 = o;     o += 2 * d.U;
  L.o2 = o;     o += d.U;
  L.g = o;      o += 4 * d.U;
  L.dg = o;     o += 4 * d.U;
  L.ac1 = o;    o += d.U;
  L.ah1 = o;    o += d.U;
  L.ac2 = o;    o += d.U;
  L.ah2 = o;    o += d.U;
  L.actx = o;   o += d.V;
  L.dctx = o;   o += d.V;
  L.dout2 = o;  o += d.U;
  L.y1 = o;     o += tr_up4(d.V + d.U);
  L.y2 = o;     o += 2 * d.U;
  L.y3 = o;     o += d.U;
  L.pq = o;     o += A4;
  L.dq = o;     o += A4;
  L.dv = o;     o += A4;
  L.dball = o;  o += A4;
  L.wconv = o;  o += tr_up4(d.taps * d.F);
  L.wloc = o;   o += tr_up4(d.F * d.A);
  L.wlocT = o;  o += tr_up4(d.F * d.A);
  L.fbuf = o;   o += TR_WARPS * tr_up4(d.F);
  L.dthbuf = o; o += TR_WARPS * A4;
  L.partq = o;  o += TR_WARPS * A4;
  L.partv = o;  o += TR_WARPS * A4;
  L.red = o;    o += 64;
  L.cum = o;    o += T4;
  L.aalpha = o; o += T4;
  L.acum = o;   o += T4;
  L.bufA = o;   o += T4;
  L.bufE = o;   o += T4;
  L.total = o;
  return L;
}

// Sum of v over the block; every thread gets the result.  ``red`` is 64
// floats of shared scratch.  Contains two __syncthreads().
__device__ inline float tr_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();  // red may be reused right away
  return r;
}

// Two sums at once (one pass of barriers).
__device__ inline float2 tr_block_sum2(float a, float b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const bool ok = lane < (int)(blockDim.x >> 5);
    float s = warp_sum(ok ? red[lane] : 0.0f);
    float t = warp_sum(ok ? red[32 + lane] : 0.0f);
    __syncwarp();
    if (lane == 0) {
      red[0] = s;
      red[1] = t;
    }
  }
  __syncthreads();
  const float2 r = make_float2(red[0], red[1]);
  __syncthreads();
  return r;
}

// Gate activations of one unit from pre-activations g [i | j | f | o]
// (TF order, forget bias +1).
struct Gates {
  float si, tj, sf, so;
};

__device__ inline Gates tr_gates(const float* g, int U, int j) {
  Gates q;
  q.si = sigmoidf_(g[j]);
  q.tj = tanhf(g[U + j]);
  q.sf = sigmoidf_(g[2 * U + j] + 1.0f);
  q.so = sigmoidf_(g[3 * U + j]);
  return q;
}

// Location features of position t: f[k] = sum_j cum[t + j - padl] * wconv[j, k]
// for the lanes' filters k, into fb (one warp's buffer).
__device__ inline void tr_loc_features(const float* cum, const float* wconv, int t, int T_in,
                                       int taps, int F, float* fb) {
  const int lane = threadIdx.x & 31;
  const int padl = (taps - 1) / 2;
  for (int f = lane; f < F; f += 32) {
    float acc = 0.0f;
    for (int j = 0; j < taps; ++j) {
      const int tt = t + j - padl;
      if (tt >= 0 && tt < T_in) acc = fmaf(cum[tt], wconv[j * F + f], acc);
    }
    fb[f] = acc;
  }
  __syncwarp();
}

// The argument of the energy tanh at (t, a): keys + query + F->A dense of
// the location features + merged bias.
__device__ inline float tr_energy_arg(const float* fb, const float* wloc, int F, int A, int a,
                                      float key, float pq, float ball) {
  float loc = 0.0f;
  for (int f = 0; f < F; ++f) loc = fmaf(fb[f], wloc[f * A + a], loc);
  return key + pq + loc + ball;
}
