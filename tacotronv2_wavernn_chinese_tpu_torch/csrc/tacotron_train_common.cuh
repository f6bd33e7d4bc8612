// What the two teacher-forced trainer kernels share (tacotron_train_fwd.cu,
// tacotron_train_bwd.cu): the grid plan, the grid barrier, the cluster
// exchange and the products over a block's weight slice.  The decode kernel
// (tacotron_decode.cu) runs on the same grid with a plan of its own and
// uses the helpers below it.
//
// Both kernels are one grid of NC thread-block clusters of TR_CLUSTER
// blocks (about one block per SM; NC is what the card keeps resident,
// cudaOccupancyMaxActiveClusters), and run every step of the sequence in
// one launch.  The plan (tr_plan; mirrored term for term by
// ops/tacotron_trainer_kernel.py k34_plan, which the wrapper compares with
// the library before every launch):
//
//   * K-units.  Rank q of every cluster holds the gate-matrix entries of the
//     decoder units [q*Ku, (q+1)*Ku) on the reduction side of each product
//     (all four gates of those units in the backward, the units' inputs in
//     the forward), so the eight ranks of a cluster together cover the whole
//     reduction dimension once.  The LSTM epilogues that make a product's
//     input run for the rank's K-units and every batch row, in every
//     cluster (the same arithmetic in the same order, so the copies agree
//     bit for bit): the product's input never crosses the grid.
//   * Output units.  Cluster c owns the product outputs of the units
//     [c*uc, (c+1)*uc) (and context rows [c*vc, ...)); after the products,
//     the eight partial sums of an output are merged inside the cluster
//     through distributed shared memory, rank q taking the units
//     [c*uc + q*ub, ...).  Only these merged outputs cross the grid, through
//     global memory (L2) and one grid barrier.
//   * Rows.  The attention of batch row b runs on the bpr blocks
//     (rank/bpr == b - c*rpc) of cluster c = b / rpc, each on nT encoder
//     positions; the row-wide sums cross those blocks inside the cluster.
//
// Every block keeps its weight slices in shared memory for the whole loop:
// no gate weight is read from L2 after the prologue, and each product
// serves all B rows at once.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int TR_THREADS = 512;
constexpr int TR_WARPS = TR_THREADS / 32;
constexpr int TR_CLUSTER = 8;         // blocks of a cluster
constexpr int TR_TC = TR_WARPS;       // positions of one attention chunk (one per warp)
constexpr int TR_SMEM_LIMIT = 232448;
constexpr int TR_SMEM_ONE_PER_SM = 160 * 1024;  // more than half an SM's: one block per SM

struct TrDims {
  int B, T, T_in, P, U, V, A, F, taps;
};

__host__ __device__ inline int tr_up4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int tr_cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int tr_min(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int tr_max(int a, int b) { return a > b ? a : b; }
// Row stride of K4's per-position location features: a multiple of 8, so
// that a thread reads eight filters as two float4s.
__host__ __device__ inline int tr_fs(int F) { return (F + 7) & ~7; }

struct TrPlan {
  int NC, G;         // clusters, blocks
  int Ku;            // K-units of a rank
  int uc, ub;        // output units of a cluster, of a block
  int vc, vb;        // context rows of a cluster, of a block (K4's a_ctx)
  int Kp, Kv;        // K3: prenet and context inputs of a rank
  int rpc, bpr, nT;  // rows of a cluster, blocks of a row, positions of a block
};

// rpc is the smallest power of two with rpc * NC >= B; bpr = TR_CLUSTER /
// rpc is 0 when the rows do not fit (B > NC * TR_CLUSTER).
__host__ __device__ inline TrPlan tr_plan(const TrDims& d, int NC) {
  TrPlan p;
  p.NC = NC;
  p.G = NC * TR_CLUSTER;
  p.Ku = tr_cdiv(d.U, TR_CLUSTER);
  p.uc = tr_cdiv(d.U, NC);
  p.ub = tr_cdiv(p.uc, TR_CLUSTER);
  p.vc = tr_cdiv(d.V, NC);
  p.vb = tr_cdiv(p.vc, TR_CLUSTER);
  p.Kp = tr_cdiv(d.P, TR_CLUSTER);
  p.Kv = tr_cdiv(d.V, TR_CLUSTER);
  int rpc = 1;
  while (rpc * NC < d.B) rpc *= 2;
  p.rpc = rpc;
  p.bpr = rpc <= TR_CLUSTER ? TR_CLUSTER / rpc : 0;
  p.nT = p.bpr ? tr_cdiv(d.T_in, p.bpr) : 0;
  return p;
}

// The slice [lo, hi) of a ceil-division split: piece i of size ``per`` of
// [0, n), cut at n (empty past the end).
struct Range {
  int lo, hi;
  __device__ int n() const { return hi - lo; }
};
__device__ inline Range tr_range(int i, int per, int n) {
  const int lo = tr_min(i * per, n);
  return Range{lo, tr_min(lo + per, n)};
}

// What one block does under the plan.
struct TrRole {
  int c, q;       // cluster, rank
  Range ku;       // K-units (every cluster alike)
  Range cu, ou;   // the cluster's output units; this block's share of them
  Range cv, ov;   // K4: the cluster's context rows; this block's share
  int row, sl;    // attention row (-1: none) and slice of the row
  Range pos;      // attention positions (empty without a row)
};

__device__ inline TrRole tr_role(const TrDims& d, const TrPlan& p) {
  TrRole r;
  r.c = blockIdx.x / TR_CLUSTER;
  r.q = blockIdx.x % TR_CLUSTER;
  r.ku = tr_range(r.q, p.Ku, d.U);
  r.cu = tr_range(r.c, p.uc, d.U);
  const Range ou = tr_range(r.q, p.ub, r.cu.n());
  r.ou = Range{r.cu.lo + ou.lo, r.cu.lo + ou.hi};
  r.cv = tr_range(r.c, p.vc, d.V);
  const Range ov = tr_range(r.q, p.vb, r.cv.n());
  r.ov = Range{r.cv.lo + ov.lo, r.cv.lo + ov.hi};
  const int b = r.c * p.rpc + r.q / p.bpr;
  r.row = b < d.B ? b : -1;
  r.sl = r.q % p.bpr;
  r.pos = r.row >= 0 ? tr_range(r.sl, p.nT, d.T_in) : Range{0, 0};
  return r;
}

// Every block arrives once; the n-th barrier of the launch returns when the
// counter (zeroed by the wrapper) reads n * G.  The fence before the
// arrival publishes this block's global writes; the acquire load orders
// the reads after it.  Data written by other blocks during the launch is
// read with __ldcg (L2), never through L1.  (wavernn_sample.cu's barrier,
// plus a bound: a wait of more than ~2^35 SM cycles, some 17 s, traps, so
// a grid that can never meet fails its launch instead of hanging the card.)
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const long long start = clock64();
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
      if (clock64() - start > (1LL << 35)) __trap();
    } while (v < target);
  }
  __syncthreads();
}

// Sum of v over the block; every thread gets the result.  ``red`` is 64
// floats of shared scratch.
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
    const bool ok = lane < TR_WARPS;
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

// Maximum of v over the block; every thread gets the result.  ``red`` is
// 64 floats of shared scratch.
__device__ inline float tr_block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float m = warp_max(lane < TR_WARPS ? red[lane] : -INFINITY);
    if (lane == 0) red[32] = m;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

// The row-wide sum of two values: each of the row's bpr blocks has put its
// partials in slot[0..1] of its shared memory before the cluster barrier
// that precedes this call; they are added in rank order, so every block of
// the row gets the same sums.
__device__ inline float2 tr_row_sum2(cg::cluster_group& cl, float* slot, int rank0, int bpr) {
  float2 s = make_float2(0.0f, 0.0f);
  for (int j = 0; j < bpr; ++j) {
    const float* o = cl.map_shared_rank(slot, rank0 + j);
    s.x += o[0];
    s.y += o[1];
  }
  return s;
}

// Partial product of one block: out[b * ldo + o] = sum_k x[b * ldx + k] *
// W[o * ldw + k] for b < nb, o < no, over the block's K slice (k < K, a
// multiple of 4; ldx and ldw are K + 4, so the rows fall on other banks).
// Each thread takes 4 rows x 2 outputs: the threads of a warp share their
// rows (broadcast reads of x), and each weight read serves four rows.
__device__ inline void tr_partial(const float* x, int ldx, int nb, const float* W, int ldw, int no, int K,
                                  float* out, int ldo) {
  const int nob = (no + 1) >> 1, nbb = (nb + 3) >> 2, K4 = K >> 2;
  for (int t = threadIdx.x; t < nob * nbb; t += TR_THREADS) {
    const int o0 = 2 * (t % nob), b0 = 4 * (t / nob);
    const float4* w0 = reinterpret_cast<const float4*>(W + (size_t)o0 * ldw);
    const float4* w1 = reinterpret_cast<const float4*>(W + (size_t)tr_min(o0 + 1, no - 1) * ldw);
    const float4* xr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) xr[r] = reinterpret_cast<const float4*>(x + (size_t)tr_min(b0 + r, nb - 1) * ldx);
    float a0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, a1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int k = 0; k < K4; ++k) {
      const float4 u0 = w0[k], u1 = w1[k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v = xr[r][k];
        a0[r] = fmaf(v.x, u0.x, fmaf(v.y, u0.y, fmaf(v.z, u0.z, fmaf(v.w, u0.w, a0[r]))));
        a1[r] = fmaf(v.x, u1.x, fmaf(v.y, u1.y, fmaf(v.z, u1.z, fmaf(v.w, u1.w, a1[r]))));
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (b0 + r < nb) {
        out[(size_t)(b0 + r) * ldo + o0] = a0[r];
        if (o0 + 1 < no) out[(size_t)(b0 + r) * ldo + o0 + 1] = a1[r];
      }
    }
  }
}

// The merged output (b, o) of a cluster's product: the eight ranks'
// partials in rank order.
__device__ __forceinline__ float tr_merge(cg::cluster_group& cl, float* part, int idx) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < TR_CLUSTER; ++j) s += cl.map_shared_rank(part, j)[idx];
  return s;
}

// Gate activations of one unit from its pre-activations (TF order i, j, f,
// o; forget bias +1).
struct Gates {
  float si, tj, sf, so;
};

__device__ inline Gates tr_gates4(float gi, float gj, float gf, float go) {
  Gates q;
  q.si = sigmoidf_(gi);
  q.tj = tanhf(gj);
  q.sf = sigmoidf_(gf + 1.0f);
  q.so = sigmoidf_(go);
  return q;
}

// Fills a [rows, ld] shared slice from a global [*, ncol] matrix: entry
// (o, k) is src[row(o) * ncol + col(k)], zero where row or col is < 0.
template <class RowF, class ColF>
__device__ void tr_load_slice(float* dst, int rows, int ld, const float* src, int ncol, RowF row, ColF col) {
  for (int i = threadIdx.x; i < rows * ld; i += TR_THREADS) {
    const int o = i / ld, k = i - o * ld;
    const int r = row(o), cc = col(k);
    dst[i] = (r >= 0 && cc >= 0) ? __ldg(src + (size_t)r * ncol + cc) : 0.0f;
  }
}
