// Tacotron-2 encoder: the bidirectional zoneout LSTM over the convolution
// stack's output, forward (K5, tacotron_encoder_fwd_kernel) and the
// reverse-time adjoint of training (K6, tacotron_encoder_bwd_kernel), each
// the whole recurrence of both directions in one launch.
//
// Replaces no TPU kernel: the JAX package runs this recurrence as a
// ``lax.scan`` (tacotronv2_wavernn_chinese_tpu/models/layers.py
// ``unidir_lstm``) that XLA compiles into one loop.  The port's eager loop
// launched about 20 small operations a step and direction (the h @ W_h
// product, the gates, zoneout), about 3,200 launches a training forward
// and 5,600 more in autograd's replay, so it was bound by launches, not by
// its 5.4 GFLOP (B=32, T_in=160, both directions and the backward).
//
// Per step and row, as ops/tacotron_encoder_kernel.py ``encoder_fwd_plain``
// computes: z = zx + h @ W_h (zx = x @ W_x + b, all steps at once in one
// torch.matmul before the launch); TF LSTMCell gates (order i, j, f, o,
// forget bias +1); new_c = sf * c + si * tj, new_h = so * tanh(new_c); the
// output is the raw new_h; zoneout mixes only the carried state: in train
// mode where(keep, new - prev, 0) + prev with the given keep-masks, in eval
// mode (1 - z) * new + z * prev.  A row stops at its own length: positions
// past it are left alone (the wrapper zeroes the outputs).  The backward
// direction reads its inputs in each row's reversed order in place
// (loop step s of row b reads position len_b - 1 - s), as
// tf.nn.bidirectional_dynamic_rnn's reverse_sequence does, and writes its
// outputs back at the same positions.  Everything is f32.
//
// Geometry.  One cluster of EN_CLUSTER blocks (one block per SM) per
// (direction, group of rows); the directions and row groups never wait on
// each other, so the grid needs no grid barrier and may hold more clusters
// than the card keeps resident.  Rank q of a cluster owns the units
// [q*ub, (q+1)*ub) and keeps the f32 columns of W_h of the four gates of
// those units, all U rows, in shared memory for the whole loop (128 KiB
// at U = 256).  What bounds it: the serial steps, each one product of
// [rows, U] x [U, 4 ub] per block and one cluster barrier.
//
//   K5, a step: the product's partials over K slices (each thread two gate
//   columns and every row of the group) -> each (row, unit) sums its four
//   gates, applies the cell and zoneout, writes new_h (and, for training,
//   the saves) and pushes its carried h into every block's next h buffer
//   through distributed shared memory -> one cluster barrier.  The h
//   buffers are double: a step reads one and fills the other.
//
//   K6, a step (reverse time): each (row, unit) forms dz of its four gate
//   columns from the output's cotangent and the carried dh and dc, through
//   zoneout's two paths, and writes dz -> each thread forms the partial
//   dh_{t-1}[k] = dz[:, own columns] . W_h[k, own columns] of one unit k
//   and four rows, and pushes it to the block that owns k -> one cluster
//   barrier -> the owner adds the eight partials in rank order (the same
//   order in every run).  The weight gradients are products after the
//   launch (ops/tacotron_encoder_kernel.py ``encoder_grads``).
//
// Numbers: the product's sums run over K slices in another order than the
// plain version's, so values differ from it by rounding.
#include "tacotron_train_common.cuh"

namespace {

constexpr int EN_THREADS = 512;
constexpr int EN_CLUSTER = 8;
constexpr int EN_RMAX = 8;  // rows of a group

// Pointer-array slots (ops/tacotron_encoder_kernel.py ``_ptrs``): zx [B, T,
// 2, 4U], W_h [2, U, 4U], lengths int32 [B], the keep-masks (bool [T, B, U]:
// forward cell, forward hidden, backward cell, backward hidden), the output
// [B, T, 2U], the saves (gate activations [B, T, 2, 4U]; new_c, carried c
// and carried h before the step [B, T, 2U]), the output's cotangent
// [B, T, 2U] and dz [B, T, 2, 4U].
enum { P_ZX, P_WH, P_LENS, P_MFC, P_MFH, P_MBC, P_MBH, P_OUT, P_ACTS, P_NC, P_CP, P_HP, P_GOUT, P_DZ, N_PTRS };

struct EnArgs {
  const float* zx;
  const float* wh;
  const int* lens;
  const unsigned char* m[4];
  float* out;
  float* acts;
  float* nc;
  float* cp;
  float* hp;
  const float* gout;
  float* dz;
  int B, T, U;
  float zoneout;
};

// The launch plan; mirrored term for term by ops/tacotron_encoder_kernel.py
// ``enc_plan``, which the wrapper compares with the library before every
// launch.
struct EnPlan {
  int rows, groups;  // rows of a group, groups of a direction
  int r4;            // rows padded to a multiple of 4
  int ub, ncol, ldw; // units of a block, its gate columns, W row stride
  int np, ks, kc;    // K5: column pairs, K slices, K of a slice
};

__host__ __device__ inline EnPlan en_plan(int B, int U, int NC) {
  EnPlan p;
  const int per_dir = NC / 2 > 1 ? NC / 2 : 1;
  int rows = tr_up4(tr_cdiv(B, per_dir));
  rows = tr_min(rows, EN_RMAX);
  rows = tr_min(rows, B);
  p.rows = rows > 0 ? rows : 1;
  p.groups = tr_cdiv(B, p.rows);
  p.r4 = tr_up4(p.rows);
  p.ub = tr_cdiv(U, EN_CLUSTER);
  p.ncol = 4 * p.ub;
  p.ldw = p.ncol + 8;
  p.np = p.ncol / 2;
  p.ks = EN_THREADS / p.np;
  p.kc = p.ks > 0 ? tr_cdiv(U, p.ks) : 0;
  return p;
}

// Offsets (floats) into dynamic shared memory; ``enc_plan`` smem_floats.
struct EnLayout {
  int w;      // [U, ldw]  W_h of the block's gate columns (column g*ub + j: gate g of unit q*ub + j)
  int hs;     // K5: [2, U, r4]   h before the step, every unit, the group's rows (double)
  int part;   // K5: [ks, r4, ncol] partial gate pre-activations
  int dzs;    // K6: [ncol, r4]   this step's dz of the block's columns
  int pin;    // K6: [2, EN_CLUSTER, ub, r4] partial dh of the block's units, by source rank (double)
  int total;
};

__host__ __device__ inline EnLayout en_layout(int U, const EnPlan& p, bool bwd) {
  EnLayout L;
  int o = 0;
  L.w = o;    o += U * p.ldw;
  L.hs = L.part = L.dzs = L.pin = o;
  if (!bwd) {
    L.hs = o;   o += 2 * U * p.r4;
    L.part = o; o += p.ks * p.r4 * p.ncol;
  } else {
    L.dzs = o;  o += p.ncol * p.r4;
    L.pin = o;  o += 2 * EN_CLUSTER * p.ub * p.r4;
  }
  L.total = o;
  return L;
}

// W_h columns of rank q's units into shared memory: W[k][g*ub + j] =
// wh[k][g*U + q*ub + j], zero past the units and in the row padding.
__device__ void en_load_w(float* W, const float* wh, int U, const EnPlan& p, int u0, int nou) {
  for (int i = threadIdx.x; i < U * p.ldw; i += EN_THREADS) {
    const int k = i / p.ldw, c = i - k * p.ldw;
    float v = 0.0f;
    if (c < p.ncol) {
      const int g = c / p.ub, j = c - g * p.ub;
      if (j < nou) v = __ldg(wh + (size_t)k * 4 * U + (size_t)g * U + u0 + j);
    }
    W[i] = v;
  }
}

// What one thread is as a (row, unit) item of the block: row ir of the
// group (batch row ib), unit ij of the block (iu of the layer).
struct EnItem {
  bool own;  // a real row and a unit the block owns
  int ir, ij, ib, iu, len;
};

__device__ inline EnItem en_item(const EnArgs& a, const EnPlan& p, int b0, int nr, int u0, int nou) {
  EnItem it;
  const int tid = threadIdx.x;
  it.ir = tid / p.ub;
  it.ij = tid - it.ir * p.ub;
  it.own = it.ir < nr && it.ij < nou;
  it.ib = b0 + it.ir;
  it.iu = u0 + it.ij;
  it.len = it.own ? tr_max(0, tr_min(a.lens[it.ib], a.T)) : 0;
  return it;
}

// The group's longest row (every thread reads the same lengths, so every
// block of the cluster runs the same number of steps).
__device__ inline int en_tmax(const EnArgs& a, int b0, int nr) {
  int t = 0;
  for (int r = 0; r < nr; ++r) t = tr_max(t, tr_min(a.lens[b0 + r], a.T));
  return t;
}

template <int RQ>
__global__ void __launch_bounds__(EN_THREADS, 1) tacotron_encoder_fwd_kernel(EnArgs a, EnPlan p) {
  constexpr int R4 = 4 * RQ;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const EnLayout L = en_layout(a.U, p, false);
  const int tid = threadIdx.x, U = a.U, T = a.T, ub = p.ub, ncol = p.ncol, ldw = p.ldw;
  const int q = (int)cl.block_rank(), cid = blockIdx.x / EN_CLUSTER;
  const int dir = cid & 1, grp = cid >> 1;
  const int u0 = q * ub, nou = tr_max(0, tr_min(ub, U - u0));
  const int b0 = grp * p.rows, nr = tr_min(p.rows, a.B - b0);
  float* W = sm + L.w;
  float* hs = sm + L.hs;
  float* part = sm + L.part;
  en_load_w(W, a.wh + (size_t)dir * U * 4 * U, U, p, u0, nou);
  for (int i = tid; i < 2 * U * R4; i += EN_THREADS) hs[i] = 0.0f;
  const int tmax = en_tmax(a, b0, nr);
  const EnItem it = en_item(a, p, b0, nr, u0, nou);
  const bool train = a.m[0] != nullptr;
  const unsigned char* mc = a.m[2 * dir];
  const unsigned char* mh = a.m[2 * dir + 1];
  const float zr = a.zoneout;
  // product role: column pair cp, K slice ks
  const int cp = tid % p.np, ks = tid / p.np;
  const bool prod = ks < p.ks;
  const int k_lo = tr_min(ks * p.kc, U), k_hi = tr_min(k_lo + p.kc, U);
  float c_car = 0.0f, h_car = 0.0f;
  cl.sync();  // every block of the cluster runs before the first remote write
  for (int t = 0; t < tmax; ++t) {
    const int buf = t & 1;
    // the item's inputs, loaded before the product covers their latency
    const bool act = it.own && t < it.len;
    const int pos = dir == 0 ? t : it.len - 1 - t;
    float zx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool keep_c = false, keep_h = false;
    if (act) {
      const float* z = a.zx + ((size_t)it.ib * T + pos) * 8 * U + (size_t)dir * 4 * U + it.iu;
#pragma unroll
      for (int g = 0; g < 4; ++g) zx[g] = __ldg(z + (size_t)g * U);
      if (train) {
        const size_t mi = ((size_t)t * a.B + it.ib) * U + it.iu;
        keep_c = mc[mi] != 0;
        keep_h = mh[mi] != 0;
      }
    }
    if (prod) {
      float a0[R4], a1[R4];
#pragma unroll
      for (int r = 0; r < R4; ++r) a0[r] = a1[r] = 0.0f;
      const float* hb = hs + buf * U * R4;
#pragma unroll 4
      for (int k = k_lo; k < k_hi; ++k) {
        const float2 w = *reinterpret_cast<const float2*>(W + k * ldw + 2 * cp);
#pragma unroll
        for (int rq = 0; rq < RQ; ++rq) {
          const float4 h = reinterpret_cast<const float4*>(hb + k * R4)[rq];
          a0[4 * rq + 0] = fmaf(w.x, h.x, a0[4 * rq + 0]);
          a0[4 * rq + 1] = fmaf(w.x, h.y, a0[4 * rq + 1]);
          a0[4 * rq + 2] = fmaf(w.x, h.z, a0[4 * rq + 2]);
          a0[4 * rq + 3] = fmaf(w.x, h.w, a0[4 * rq + 3]);
          a1[4 * rq + 0] = fmaf(w.y, h.x, a1[4 * rq + 0]);
          a1[4 * rq + 1] = fmaf(w.y, h.y, a1[4 * rq + 1]);
          a1[4 * rq + 2] = fmaf(w.y, h.z, a1[4 * rq + 2]);
          a1[4 * rq + 3] = fmaf(w.y, h.w, a1[4 * rq + 3]);
        }
      }
      float* pp = part + (size_t)ks * R4 * ncol + 2 * cp;
#pragma unroll
      for (int r = 0; r < R4; ++r) *reinterpret_cast<float2*>(pp + r * ncol) = make_float2(a0[r], a1[r]);
    }
    __syncthreads();
    if (act) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* pg = part + it.ir * ncol + g * ub + it.ij;
        for (int s = 0; s < p.ks; ++s) zx[g] += pg[(size_t)s * R4 * ncol];
      }
      const Gates G = tr_gates4(zx[0], zx[1], zx[2], zx[3]);
      const float nc = G.sf * c_car + G.si * G.tj;
      const float nh = G.so * tanhf(nc);
      float cn, hn;
      if (train) {
        cn = keep_c ? (nc - c_car) + c_car : c_car;
        hn = keep_h ? (nh - h_car) + h_car : h_car;
      } else {
        cn = __fadd_rn(__fmul_rn(1.0f - zr, nc), __fmul_rn(zr, c_car));
        hn = __fadd_rn(__fmul_rn(1.0f - zr, nh), __fmul_rn(zr, h_car));
      }
      const size_t o = ((size_t)it.ib * T + pos) * 2 * U + (size_t)dir * U + it.iu;
      a.out[o] = nh;
      if (a.acts) {
        float* s = a.acts + ((size_t)it.ib * T + pos) * 8 * U + (size_t)dir * 4 * U + it.iu;
        s[0] = G.si;
        s[U] = G.tj;
        s[2 * U] = G.sf;
        s[3 * U] = G.so;
        a.nc[o] = nc;
        a.cp[o] = c_car;
        a.hp[o] = h_car;
      }
      c_car = cn;
      h_car = hn;
      const int dst = (buf ^ 1) * U * R4 + it.iu * R4 + it.ir;
#pragma unroll
      for (int j = 0; j < EN_CLUSTER; ++j) cl.map_shared_rank(hs, j)[dst] = hn;
    }
    cl.sync();  // the next h is complete in every block; this step's reads are done
  }
}

template <int RQ>
__global__ void __launch_bounds__(EN_THREADS, 1) tacotron_encoder_bwd_kernel(EnArgs a, EnPlan p) {
  constexpr int R4 = 4 * RQ;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const EnLayout L = en_layout(a.U, p, true);
  const int tid = threadIdx.x, U = a.U, T = a.T, ub = p.ub, ncol = p.ncol, ldw = p.ldw;
  const int q = (int)cl.block_rank(), cid = blockIdx.x / EN_CLUSTER;
  const int dir = cid & 1, grp = cid >> 1;
  const int u0 = q * ub, nou = tr_max(0, tr_min(ub, U - u0));
  const int b0 = grp * p.rows, nr = tr_min(p.rows, a.B - b0);
  float* W = sm + L.w;
  float* dzs = sm + L.dzs;
  float* pin = sm + L.pin;
  en_load_w(W, a.wh + (size_t)dir * U * 4 * U, U, p, u0, nou);
  // columns past the units and rows past the group stay zero
  for (int i = tid; i < ncol * R4; i += EN_THREADS) dzs[i] = 0.0f;
  const int tmax = en_tmax(a, b0, nr);
  const EnItem it = en_item(a, p, b0, nr, u0, nou);
  const bool train = a.m[0] != nullptr;
  const unsigned char* mc = a.m[2 * dir];
  const unsigned char* mh = a.m[2 * dir + 1];
  const float zr = a.zoneout;
  float ah = 0.0f, ac = 0.0f;  // dL/dh and dL/dc of the carried state after the step
  cl.sync();
  for (int t = tmax - 1; t >= 0; --t) {
    const int buf = t & 1;
    float ahd = 0.0f;  // the carried h's own path to the step before
    if (it.own) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (t < it.len) {
        const int pos = dir == 0 ? t : it.len - 1 - t;
        const size_t o = ((size_t)it.ib * T + pos) * 2 * U + (size_t)dir * U + it.iu;
        const size_t og = ((size_t)it.ib * T + pos) * 8 * U + (size_t)dir * 4 * U + it.iu;
        const float si = a.acts[og], tj = a.acts[og + U], sf = a.acts[og + 2 * U], so = a.acts[og + 3 * U];
        const float nc = a.nc[o], cprev = a.cp[o], g = a.gout[o];
        float kc, kh, zc, zh;
        if (train) {
          const size_t mi = ((size_t)t * a.B + it.ib) * U + it.iu;
          kc = mc[mi] ? 1.0f : 0.0f;
          kh = mh[mi] ? 1.0f : 0.0f;
          zc = 1.0f - kc;
          zh = 1.0f - kh;
        } else {
          kc = kh = 1.0f - zr;
          zc = zh = zr;
        }
        const float th = tanhf(nc);
        const float dnh = g + kh * ah;
        const float dnc = kc * ac + dnh * so * (1.0f - th * th);
        d[0] = dnc * tj * si * (1.0f - si);
        d[1] = dnc * si * (1.0f - tj * tj);
        d[2] = dnc * cprev * sf * (1.0f - sf);
        d[3] = dnh * th * so * (1.0f - so);
        ac = zc * ac + dnc * sf;
        ahd = zh * ah;
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) a.dz[og + (size_t)gg * U] = d[gg];
      } else {
        ac = 0.0f;
      }
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) dzs[(gg * ub + it.ij) * R4 + it.ir] = d[gg];
    }
    __syncthreads();
    // partial dh of unit k, rows [4 rq, 4 rq + 4), over the block's columns
    for (int idx = tid; idx < U * RQ; idx += EN_THREADS) {
      const int k = idx / RQ, rq = idx - k * RQ;
      const float* wr = W + k * ldw;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int c4 = 0; c4 < ncol / 4; ++c4) {
        const float4 w = *reinterpret_cast<const float4*>(wr + 4 * c4);
        const float4* dp = reinterpret_cast<const float4*>(dzs + 4 * c4 * R4) + rq;
        const float4 d0 = dp[0], d1 = dp[RQ], d2 = dp[2 * RQ], d3 = dp[3 * RQ];
        acc.x = fmaf(w.x, d0.x, fmaf(w.y, d1.x, fmaf(w.z, d2.x, fmaf(w.w, d3.x, acc.x))));
        acc.y = fmaf(w.x, d0.y, fmaf(w.y, d1.y, fmaf(w.z, d2.y, fmaf(w.w, d3.y, acc.y))));
        acc.z = fmaf(w.x, d0.z, fmaf(w.y, d1.z, fmaf(w.z, d2.z, fmaf(w.w, d3.z, acc.z))));
        acc.w = fmaf(w.x, d0.w, fmaf(w.y, d1.w, fmaf(w.z, d2.w, fmaf(w.w, d3.w, acc.w))));
      }
      const int owner = k / ub, kl = k - owner * ub;
      float* dst = cl.map_shared_rank(pin, owner) + ((buf * EN_CLUSTER + q) * ub + kl) * R4;
      reinterpret_cast<float4*>(dst)[rq] = acc;
    }
    cl.sync();  // every partial of this step has arrived
    if (it.own) {
      float s = ahd;
      const float* src = pin + (buf * EN_CLUSTER * ub + it.ij) * R4 + it.ir;
#pragma unroll
      for (int j = 0; j < EN_CLUSTER; ++j) s += src[j * ub * R4];
      ah = s;
    }
  }
}

void en_args(EnArgs& a, void* const* ptrs, int B, int T, int U, float zoneout) {
  a.zx = static_cast<const float*>(ptrs[P_ZX]);
  a.wh = static_cast<const float*>(ptrs[P_WH]);
  a.lens = static_cast<const int*>(ptrs[P_LENS]);
  for (int i = 0; i < 4; ++i) a.m[i] = static_cast<const unsigned char*>(ptrs[P_MFC + i]);
  a.out = static_cast<float*>(ptrs[P_OUT]);
  a.acts = static_cast<float*>(ptrs[P_ACTS]);
  a.nc = static_cast<float*>(ptrs[P_NC]);
  a.cp = static_cast<float*>(ptrs[P_CP]);
  a.hp = static_cast<float*>(ptrs[P_HP]);
  a.gout = static_cast<const float*>(ptrs[P_GOUT]);
  a.dz = static_cast<float*>(ptrs[P_DZ]);
  a.B = B;
  a.T = T;
  a.U = U;
  a.zoneout = zoneout;
}

template <class K>
int en_launch(K kernel, const EnArgs& a, const EnPlan& p, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = EN_CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * p.groups * EN_CLUSTER);
  cfg.blockDim = dim3(EN_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The plan a launch takes at (B, U, NC); 0 when it cannot run (more rows
// than the kernels' register tiles, widths whose items or columns do not
// fit a block, or a block's shared memory).
bool en_fits(int B, int U, const EnPlan& p) {
  return B >= 1 && U >= 1 && p.ks >= 1 && p.r4 <= EN_RMAX && p.rows * p.ub <= EN_THREADS &&
         tr_max(en_layout(U, p, false).total, en_layout(U, p, true).total) * (int)sizeof(float) <= TR_SMEM_LIMIT;
}

}  // namespace

// Bytes of shared memory per block of K5 (bwd 0) or K6 (bwd 1) at (B, U, NC);
// ops/tacotron_encoder_kernel.py ``enc_plan`` computes the same.
extern "C" int tacotron_encoder_smem_bytes(int B, int U, int NC, int bwd) {
  return en_layout(U, en_plan(B, U, NC), bwd != 0).total * (int)sizeof(float);
}

// Clusters of EN_CLUSTER blocks the card keeps resident at once with one
// block per SM (asked at TR_SMEM_ONE_PER_SM bytes), or a negative cudaError_t.
// The plan spreads the row groups so that both directions fill them.
extern "C" int tacotron_encoder_clusters() {
  cudaError_t err = cudaFuncSetAttribute(tacotron_encoder_fwd_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TR_SMEM_ONE_PER_SM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = EN_CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(EN_CLUSTER);
  cfg.blockDim = dim3(EN_THREADS);
  cfg.dynamicSmemBytes = TR_SMEM_ONE_PER_SM;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, tacotron_encoder_fwd_kernel<2>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// K5 on ``stream``: ``ptrs`` holds N_PTRS device pointers in the enum's
// order (the masks null in eval mode, the saves null when no backward
// follows; the cotangent and dz slots unused).  Returns a cudaError_t:
// cudaErrorInvalidValue when the plan does not fit, else the launch's own.
extern "C" int tacotron_encoder_fwd_launch(void* const* ptrs, int B, int T, int U, int NC, float zoneout,
                                           void* stream) {
  EnArgs a;
  en_args(a, ptrs, B, T, U, zoneout);
  const EnPlan p = en_plan(B, U, NC);
  if (!en_fits(B, U, p)) return (int)cudaErrorInvalidValue;
  const int smem = en_layout(U, p, false).total * (int)sizeof(float);
  return p.r4 == 4 ? en_launch(tacotron_encoder_fwd_kernel<1>, a, p, smem, stream)
                   : en_launch(tacotron_encoder_fwd_kernel<2>, a, p, smem, stream);
}

// K6 on ``stream``: the same pointer array with the saves, the output's
// cotangent and dz filled (the output and carried-h slots unused; zx too).
extern "C" int tacotron_encoder_bwd_launch(void* const* ptrs, int B, int T, int U, int NC, float zoneout,
                                           void* stream) {
  EnArgs a;
  en_args(a, ptrs, B, T, U, zoneout);
  const EnPlan p = en_plan(B, U, NC);
  if (!en_fits(B, U, p)) return (int)cudaErrorInvalidValue;
  const int smem = en_layout(U, p, true).total * (int)sizeof(float);
  return p.r4 == 4 ? en_launch(tacotron_encoder_bwd_kernel<1>, a, p, smem, stream)
                   : en_launch(tacotron_encoder_bwd_kernel<2>, a, p, smem, stream);
}
