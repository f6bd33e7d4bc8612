// Tacotron-2 teacher-forced decoder core, forward (training, K3): one
// launch runs every step of the sequence and writes the outputs and the
// residual saves the backward kernel (tacotron_train_bwd.cu) reads, as one
// grid of thread-block clusters (tacotron_train_common.cuh).
//
// Replaces the TPU kernel
// tacotronv2_wavernn_chinese_tpu/ops/tacotron_trainer_kernel.py
// (_fwd_call L689, _fwd_kernel).  Per step and row, in that kernel's order:
// save the pre-step state (c1, h1, c2, h2, ctx, alpha, mu) -> LSTM1 on
// [p_t | ctx | h1] -> LSTM2 on [out1 | h2] (TF gate order, forget bias +1;
// zoneout carry m*new + (1-m)*prev with the given keep-masks in train mode,
// (1-z)*new + z*prev in eval mode; out1/out2 are the raw new_h) -> query
// projection -> location conv at F width over the cumulated alignments and
// the F->A location dense (conv bias merged into ``ball`` by the wrapper)
// -> tanh energies against the keys, masked softmax (-1e9) -> cumulate ->
// forward recursion ((1-mu)*alpha + mu*shift(alpha) + 1e-10) * align_sm,
// normalised -> context -> next mu.  alpha and cum start one-hot at
// position 0, mu at 0.5.  All arithmetic is f32.  Besides the saves of
// FWD_OUTS it writes the gate pre-activations g1, g2 [T, B, 4U] (bias
// included, forget +1 not) and the query projection pq [T, B, A], so that
// the backward recomputes none of them.
//
// What bounds it: the serial steps, each three dependent products over the
// full batch (x1 l1, x2 l2, out2 wq: ~6.4 MB of f32 weights at the default
// widths) and the per-position energies (~5.1 K multiply-adds per position
// and row).  The first design (one block per row streaming every gate matrix
// from L2 each step) took 96 us per step at B=32.  In this design the
// row blocks' attention (energies of 80 positions per block at B=32) and
// the three grid barriers lead, the products follow (PERF.md has the split).
//
// Design: the weights live once on chip, split over the grid (rank q of a
// cluster holds its prenet, context and K-unit inputs against the four
// gates of its cluster's units, 9,504 + 4,896 floats of l1/l2 at NC = 15,
// and the wq rows of its K-units); no gate weight is read from L2 after the
// prologue, and each product serves all B rows.  A step is three phases,
// each ended by a grid barrier:
//
//   1. x1 = [p_t | ctx | h1] of the rank's slice for all rows -> partial
//      gate pre-activations of the cluster's units -> merged in the
//      cluster -> g1 (global).  Row blocks compute this step's mu.
//   2. LSTM1 of the rank's K-units, all rows (every cluster alike) -> x2
//      -> partials -> merged -> g2.
//   3. LSTM2 of the K-units -> out2 -> partial query projections of the
//      cluster's rows (the eight ranks hold all of wq, so the cluster
//      completes pq without the grid) -> the attention of the rows, bpr
//      blocks per row (softmax statistics, the normalisation and the
//      context cross the row's blocks through distributed shared memory)
//      -> ctx (global).
//
// Data exchange per step and block (choice (a): each block contracts its
// slice of the reduction dimension, the partials merge in the cluster):
// g1 and g2 of the K-units ([B, 4 x 32] each) and the context slice of x1
// [B, 64] from L2, ~40 KB at B=32, against ~130 KB for staging all of x1.
//
// Numbers: sums are taken in another order than the plain version's (a
// product's K split over eight ranks, the softmax and the context over a
// row's blocks), so values differ by rounding; the check is every output
// within 1e-3 of the eager loop.
#include "tacotron_train_common.cuh"

namespace {

// Pointer-array slots (ops/tacotron_trainer_kernel.py train_fwd).
enum {
  I_P, I_MC1, I_MH1, I_MC2, I_MH2, I_KEYS, I_VALUES, I_MASK,
  W_L1IO, W_L1B, W_L2IO, W_L2B, W_WQIO, W_WCONV, W_WLOC, W_BALL, W_V, W_MUC, W_MUQ, W_MUB,
  O_OUT2, O_CTX, O_ALIGN, O_ALIGN_SM, O_OUT1, O_C1P, O_H1P, O_C2P, O_H2P, O_CTXP, O_ALPHAP,
  O_MUP, O_G1, O_G2, O_PQ, N_PTRS
};

struct Ptrs {
  const float* c[O_OUT2];
  float* o[N_PTRS - O_OUT2];
};

__device__ __forceinline__ float* O(const Ptrs& p, int i) { return p.o[i - O_OUT2]; }

// Offsets (floats) into dynamic shared memory; mirrored term for term by
// ops/tacotron_trainer_kernel.py (k34_plan, kind "fwd").
struct FwdLayout {
  int w1;     // [4uc, LK1]  l1: the rank's [p | ctx | h1] inputs x the cluster's gate columns
  int w2;     // [4uc, LK2]  l2: the rank's [out1 | h2] inputs x the cluster's gate columns
  int wq;     // [Ku, A]     wq rows of the rank's K-units
  int wconv;  // [taps, F]
  int wloc;   // [F, A]
  int st;     // [4, B, Ku]  c1, h1, c2, h2 of the K-units
  int xs;     // [B, LK1]    product input (x1, then x2, then out2 [B, Ku])
  int part;   // [B, 4uc]    partial gate pre-activations (read by the cluster)
  int pqp;    // [rpc, A]    partial query projection of the cluster's rows (read by the cluster)
  int pq;     // [A]         this step's query projection + energy bias of the row
  int vsm;    // [A]         the energy vector v
  int fb;     // [warps, 2, F] two positions' location features per warp
  int cum;    // [nT + taps - 1]
  int alpha, en;  // [nT]
  int ctxp;   // [V]         this block's partial context (read by the row)
  int red;    // [16]
  int bred;   // [64]
  int total;
};

__host__ __device__ inline FwdLayout fwd_layout(const TrDims& d, const TrPlan& pl) {
  FwdLayout L;
  const int K1 = tr_up4(pl.Kp + pl.Kv + pl.Ku), LK1 = K1 + 4, LK2 = tr_up4(2 * pl.Ku) + 4;
  const int ng = 4 * pl.uc, nT4 = tr_up4(pl.nT);
  int o = 0;
  L.w1 = o;    o += ng * LK1;
  L.w2 = o;    o += ng * LK2;
  L.wq = o;    o += pl.Ku * d.A;
  L.wconv = o; o += tr_up4(d.taps * d.F);
  L.wloc = o;  o += d.F * d.A;
  L.st = o;    o += tr_up4(4 * d.B * pl.Ku);
  L.xs = o;    o += d.B * LK1;
  L.part = o;  o += tr_up4(d.B * ng);
  L.pqp = o;   o += pl.rpc * d.A;
  L.pq = o;    o += d.A;
  L.vsm = o;   o += d.A;
  L.fb = o;    o += 2 * TR_WARPS * tr_up4(d.F);
  L.cum = o;   o += tr_up4(pl.nT + d.taps - 1);
  L.alpha = o; o += nT4;
  L.en = o;    o += nT4;
  L.ctxp = o;  o += d.V;
  L.red = o;   o += 16;
  L.bred = o;  o += 64;
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(TR_THREADS, 1)
tacotron_train_fwd_kernel(Ptrs p, TrDims d, TrPlan pl, int use_masks, float zoneout, unsigned* counter) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const FwdLayout L = fwd_layout(d, pl);
  const TrRole R = tr_role(d, pl);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = d.B, T_in = d.T_in, P = d.P, U = d.U, V = d.V, A = d.A, F = d.F, taps = d.taps;
  const int padl = (taps - 1) / 2, Ku = pl.Ku, Kp = pl.Kp, Kv = pl.Kv, uc = pl.uc, ng = 4 * uc;
  const int K1 = tr_up4(Kp + Kv + Ku), LK1 = K1 + 4, K2 = tr_up4(2 * Ku), LK2 = K2 + 4;
  const int nku = R.ku.n(), nou = R.ou.n(), rpc = pl.rpc, bpr = pl.bpr, rank0 = (R.q / bpr) * bpr;
  const int b = R.row, t0 = R.pos.lo, n_own = R.pos.n();
  float *w1 = sm + L.w1, *w2 = sm + L.w2, *wq = sm + L.wq, *wconv = sm + L.wconv, *wloc = sm + L.wloc;
  float *c1 = sm + L.st, *h1 = c1 + B * Ku, *c2 = h1 + B * Ku, *h2 = c2 + B * Ku;
  float *xs = sm + L.xs, *part = sm + L.part, *pqp = sm + L.pqp, *pqv = sm + L.pq, *vsm = sm + L.vsm;
  float *cum = sm + L.cum, *alpha = sm + L.alpha, *en = sm + L.en, *ctxp = sm + L.ctxp;
  float *red = sm + L.red, *bred = sm + L.bred;
  const float* mu_c = p.c[W_MUC];
  const float* mu_q = p.c[W_MUQ];
  const float* ball = p.c[W_BALL];
  const float* vv = p.c[W_V];
  const float mu_b = __ldg(p.c[W_MUB]);
  const Range ku = R.ku, cu = R.cu;
  const Range vs = b >= 0 ? tr_range(R.sl, tr_cdiv(V, bpr), V) : Range{0, 0};  // context entries this block merges

  // prologue: the weight slices, for the whole loop
  auto gate_row = [=](int o) {  // output o: gate o / uc of the cluster's unit o % uc
    const int g = o / uc, j = cu.lo + o - g * uc;
    return j < cu.hi ? g * U + j : -1;
  };
  // the slices are loaded transposed ([out, in]) from [in, out] matrices
  for (int i = tid; i < ng * LK1; i += TR_THREADS) {
    const int o = i / LK1, k = i - o * LK1, col = gate_row(o);
    int row = -1;
    if (k < Kp) row = R.q * Kp + k < P ? R.q * Kp + k : -1;
    else if (k < Kp + Kv) row = R.q * Kv + k - Kp < V ? P + R.q * Kv + k - Kp : -1;
    else if (k < Kp + Kv + Ku) row = k - Kp - Kv < nku ? P + V + ku.lo + k - Kp - Kv : -1;
    w1[i] = (row >= 0 && col >= 0) ? __ldg(p.c[W_L1IO] + (size_t)row * 4 * U + col) : 0.0f;
  }
  for (int i = tid; i < ng * LK2; i += TR_THREADS) {
    const int o = i / LK2, k = i - o * LK2, col = gate_row(o);
    int row = -1;
    if (k < Ku) row = k < nku ? ku.lo + k : -1;
    else if (k < 2 * Ku) row = k - Ku < nku ? U + ku.lo + k - Ku : -1;
    w2[i] = (row >= 0 && col >= 0) ? __ldg(p.c[W_L2IO] + (size_t)row * 4 * U + col) : 0.0f;
  }
  tr_load_slice(wq, Ku, A, p.c[W_WQIO], A, [=](int i) { return i < nku ? ku.lo + i : -1; },
                [](int a) { return a; });
  for (int i = tid; i < taps * F; i += TR_THREADS) wconv[i] = p.c[W_WCONV][i];
  for (int i = tid; i < F * A; i += TR_THREADS) wloc[i] = p.c[W_WLOC][i];
  for (int a = tid; a < A; a += TR_THREADS) vsm[a] = vv[a];
  for (int i = tid; i < 4 * B * Ku; i += TR_THREADS) c1[i] = 0.0f;
  for (int i = tid; i < n_own; i += TR_THREADS) {
    alpha[i] = t0 + i == 0 ? 1.0f : 0.0f;
    O(p, O_ALPHAP)[(size_t)b * T_in + t0 + i] = alpha[i];
  }
  for (int e = tid; e < n_own + taps - 1; e += TR_THREADS) cum[e] = t0 - padl + e == 0 ? 1.0f : 0.0f;
  for (int v = vs.lo + tid; v < vs.hi; v += TR_THREADS) O(p, O_CTXP)[(size_t)b * V + v] = 0.0f;
  unsigned target = 0;
  __syncthreads();

  for (int s = 0; s < d.T; ++s) {
    // 1. x1 = [p_t | ctx | h1] slices of all rows; the saves; this step's mu
    const size_t rB = (size_t)s * B;
    const int np = tr_max(tr_min(Kp, P - R.q * Kp), 0), nv_ = tr_max(tr_min(Kv, V - R.q * Kv), 0);
#pragma unroll 4
    for (int k = tid; k < B * Kp; k += TR_THREADS) {  // the rank's prenet inputs
      const int bb = k / Kp, kk = k - bb * Kp;
      xs[bb * LK1 + kk] = kk < np ? p.c[I_P][(rB + bb) * P + R.q * Kp + kk] : 0.0f;
    }
#pragma unroll 4
    for (int k = tid; k < B * Kv; k += TR_THREADS) {  // the rank's context inputs (the previous step's)
      const int bb = k / Kv, kk = k - bb * Kv;
      xs[bb * LK1 + Kp + kk] = (s > 0 && kk < nv_) ? __ldcg(O(p, O_CTX) + (rB - B + bb) * V + R.q * Kv + kk) : 0.0f;
    }
    for (int k = tid; k < B * (LK1 - Kp - Kv); k += TR_THREADS) {  // h1 of the K-units, then zeros
      const int bb = k / (LK1 - Kp - Kv), kk = k - bb * (LK1 - Kp - Kv);
      xs[bb * LK1 + Kp + Kv + kk] = kk < nku ? h1[bb * Ku + kk] : 0.0f;
    }
    if (R.c == 0)
      for (int k = tid; k < B * nku; k += TR_THREADS) {
        const int bb = k / nku, i = k - bb * nku, kb = bb * Ku + i;
        const size_t ru = (rB + bb) * U + ku.lo + i;
        O(p, O_C1P)[ru] = c1[kb];
        O(p, O_H1P)[ru] = h1[kb];
        O(p, O_C2P)[ru] = c2[kb];
        O(p, O_H2P)[ru] = h2[kb];
      }
    float mu = 0.5f;
    if (b >= 0 && s > 0) {
      const size_t rp = rB - B + b;
      float part_mu = 0.0f;
      for (int i = tid; i < V + U; i += TR_THREADS)
        part_mu += i < V ? __ldcg(O(p, O_CTX) + rp * V + i) * __ldg(mu_c + i)
                         : __ldcg(O(p, O_OUT2) + rp * U + i - V) * __ldg(mu_q + i - V);
      mu = sigmoidf_(tr_block_sum2(part_mu, 0.0f, bred).x + mu_b);
    }
    if (b >= 0 && R.sl == 0 && tid == 0) O(p, O_MUP)[rB + b] = mu;
    __syncthreads();
    // 1b. g1 partials, merged in the cluster
    tr_partial(xs, LK1, B, w1, LK1, ng, K1, part, ng);
    cl.sync();
    for (int k = tid; k < B * nou * 4; k += TR_THREADS) {
      const int bb = k / (nou * 4), rest = k - bb * nou * 4, g = rest / nou, j = R.ou.lo + rest % nou;
      O(p, O_G1)[(rB + bb) * 4 * U + g * U + j] =
          tr_merge(cl, part, bb * ng + g * uc + j - cu.lo) + __ldg(p.c[W_L1B] + g * U + j);
    }
    // barrier 1
    grid_barrier(counter, target += pl.G);
    // 2. LSTM1 of the K-units, all rows; x2 = [out1 | h2]
    for (int k = tid; k < B * Ku; k += TR_THREADS) {
      const int bb = k / Ku, i = k - bb * Ku;
      float* x = xs + bb * LK2;
      if (i >= nku) {
        x[i] = x[Ku + i] = 0.0f;
        continue;
      }
      const int u = ku.lo + i;
      const size_t ru = (rB + bb) * U + u;
      const float* g1 = O(p, O_G1) + (rB + bb) * 4 * U + u;
      const Gates q = tr_gates4(__ldcg(g1), __ldcg(g1 + U), __ldcg(g1 + 2 * U), __ldcg(g1 + 3 * U));
      const float cp = c1[k], hp = h1[k];
      const float nc = q.sf * cp + q.si * q.tj;
      const float nh = q.so * tanhf(nc);
      float kc = 1.0f - zoneout, zc = zoneout, kh = kc, zh = zc;
      if (use_masks) {
        kc = p.c[I_MC1][ru];
        zc = 1.0f - kc;
        kh = p.c[I_MH1][ru];
        zh = 1.0f - kh;
      }
      c1[k] = kc * nc + zc * cp;
      h1[k] = kh * nh + zh * hp;
      x[i] = nh;
      x[Ku + i] = h2[k];
      if (R.c == 0) O(p, O_OUT1)[ru] = nh;
    }
    for (int k = tid; k < B * (LK2 - 2 * Ku); k += TR_THREADS) {
      const int bb = k / (LK2 - 2 * Ku);
      xs[bb * LK2 + 2 * Ku + k - bb * (LK2 - 2 * Ku)] = 0.0f;
    }
    __syncthreads();
    // 2b. g2 partials, merged in the cluster
    tr_partial(xs, LK2, B, w2, LK2, ng, K2, part, ng);
    cl.sync();
    for (int k = tid; k < B * nou * 4; k += TR_THREADS) {
      const int bb = k / (nou * 4), rest = k - bb * nou * 4, g = rest / nou, j = R.ou.lo + rest % nou;
      O(p, O_G2)[(rB + bb) * 4 * U + g * U + j] =
          tr_merge(cl, part, bb * ng + g * uc + j - cu.lo) + __ldg(p.c[W_L2B] + g * U + j);
    }
    // barrier 2
    grid_barrier(counter, target += pl.G);
    // 3. LSTM2 of the K-units, all rows; partial pq of the cluster's rows
    for (int k = tid; k < B * Ku; k += TR_THREADS) {
      const int bb = k / Ku, i = k - bb * Ku;
      if (i >= nku) {
        xs[k] = 0.0f;
        continue;
      }
      const int u = ku.lo + i;
      const size_t ru = (rB + bb) * U + u;
      const float* g2 = O(p, O_G2) + (rB + bb) * 4 * U + u;
      const Gates q = tr_gates4(__ldcg(g2), __ldcg(g2 + U), __ldcg(g2 + 2 * U), __ldcg(g2 + 3 * U));
      const float cp = c2[k], hp = h2[k];
      const float nc = q.sf * cp + q.si * q.tj;
      const float nh = q.so * tanhf(nc);
      float kc = 1.0f - zoneout, zc = zoneout, kh = kc, zh = zc;
      if (use_masks) {
        kc = p.c[I_MC2][ru];
        zc = 1.0f - kc;
        kh = p.c[I_MH2][ru];
        zh = 1.0f - kh;
      }
      c2[k] = kc * nc + zc * cp;
      h2[k] = kh * nh + zh * hp;
      xs[k] = nh;
      if (R.c == 0) O(p, O_OUT2)[ru] = nh;
    }
    __syncthreads();
    for (int k = tid; k < rpc * A; k += TR_THREADS) {
      const int rr = k / A, a = k - rr * A, bb = R.c * rpc + rr;
      float acc = 0.0f;
      if (bb < B)
        for (int i = 0; i < nku; ++i) acc = fmaf(xs[bb * Ku + i], wq[i * A + a], acc);
      pqp[k] = acc;
    }
    cl.sync();
    // 4. attention of the rows: energies and softmax statistics
    float2 st = make_float2(-INFINITY, 0.0f);
    if (b >= 0) {
      const int rr = R.q / bpr;
      const size_t r = rB + b;
      for (int a = tid; a < A; a += TR_THREADS) {
        float acc = 0.0f;
        for (int j = 0; j < TR_CLUSTER; ++j) acc += cl.map_shared_rank(pqp, j)[rr * A + a];
        pqv[a] = acc + __ldg(ball + a);
        if (R.sl == 0) O(p, O_PQ)[r * A + a] = acc;
      }
      __syncthreads();
      const float* keys = p.c[I_KEYS] + (size_t)b * T_in * A;
      const float* mask = p.c[I_MASK] + (size_t)b * T_in;
      float* fb = sm + L.fb + warp * 2 * tr_up4(F);  // two positions a warp: each weight read serves both
      float* fb2 = fb + tr_up4(F);
      for (int i = warp; i < n_own; i += 2 * TR_WARPS) {
        const int i2 = i + TR_WARPS < n_own ? i + TR_WARPS : i;
        const int t = t0 + i, t2 = t0 + i2;
        for (int f = lane; f < F; f += 32) {
          float acc = 0.0f, acc2 = 0.0f;
          for (int j = 0; j < taps; ++j) {
            const float w = wconv[j * F + f];
            acc = fmaf(cum[i + j], w, acc);
            acc2 = fmaf(cum[i2 + j], w, acc2);
          }
          fb[f] = acc;
          fb2[f] = acc2;
        }
        __syncwarp();
        float e = 0.0f, e2 = 0.0f;
        for (int a0 = lane; a0 < A; a0 += 128) {  // four columns per lane, four chains in flight
          float loc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, loc2[4] = {0.0f, 0.0f, 0.0f, 0.0f}, kv[4], kv2[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int a = tr_min(a0 + 32 * m, A - 1);
            kv[m] = keys[(size_t)t * A + a];
            kv2[m] = keys[(size_t)t2 * A + a];
          }
          for (int f = 0; f < F; ++f) {
            const float x = fb[f], x2 = fb2[f];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              if (a0 + 32 * m < A) {
                const float w = wloc[f * A + a0 + 32 * m];
                loc[m] = fmaf(x, w, loc[m]);
                loc2[m] = fmaf(x2, w, loc2[m]);
              }
            }
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int a = a0 + 32 * m;
            if (a < A) {
              e = fmaf(vsm[a], tanhf(kv[m] + pqv[a] + loc[m]), e);
              e2 = fmaf(vsm[a], tanhf(kv2[m] + pqv[a] + loc2[m]), e2);
            }
          }
        }
        e = warp_sum(e);
        e2 = warp_sum(e2);
        if (lane == 0) {
          en[i] = mask[t] > 0.0f ? e : -1e9f;
          en[i2] = mask[t2] > 0.0f ? e2 : -1e9f;  // i2 == i when the warp has one position left
        }
        __syncwarp();
      }
      __syncthreads();
      float m = -INFINITY;
      for (int i = tid; i < n_own; i += TR_THREADS) m = fmaxf(m, en[i]);
      m = tr_block_max(m, bred);
      float z = 0.0f;
      for (int i = tid; i < n_own; i += TR_THREADS) z += expf(en[i] - m);
      st = make_float2(m, tr_block_sum2(z, 0.0f, bred).x);
    }
    if (tid == 0) {
      red[0] = st.x;
      red[1] = st.y;
    }
    cl.sync();
    // 4b. softmax, forward recursion, context
    float s2 = 0.0f;
    if (b >= 0) {
      const size_t r = rB + b;
      if (tid == 0) {
        float M = -INFINITY, Zs = 0.0f;
        for (int j = 0; j < bpr; ++j) {
          const float* o = cl.map_shared_rank(red, rank0 + j);
          if (o[1] > 0.0f) M = fmaxf(M, o[0]);
        }
        for (int j = 0; j < bpr; ++j) {
          const float* o = cl.map_shared_rank(red, rank0 + j);
          if (o[1] > 0.0f) Zs += o[1] * expf(o[0] - M);
        }
        red[4] = M;
        red[5] = Zs;
        // alpha at the position before the slice: the previous step's alignment
        red[6] = t0 == 0 ? 0.0f : (s == 0 ? (t0 - 1 == 0 ? 1.0f : 0.0f)
                                          : __ldcg(O(p, O_ALPHAP) + r * T_in + t0 - 1));
      }
      __syncthreads();
      const float M = red[4], Zs = red[5], aprev = red[6];
      float part_s = 0.0f;
      for (int i = tid; i < n_own; i += TR_THREADS) {
        const int t = t0 + i;
        const float a_sm = expf(en[i] - M) / Zs;
        O(p, O_ALIGN_SM)[r * T_in + t] = a_sm;
        const float shifted = i > 0 ? alpha[i - 1] : aprev;
        const float pre = ((1.0f - mu) * alpha[i] + mu * shifted + 1e-10f) * a_sm;
        en[i] = pre;
        part_s += pre;
      }
      s2 = tr_block_sum2(part_s, 0.0f, bred).x;
    }
    if (tid == 0) red[2] = s2;
    cl.sync();
    if (b >= 0) {
      const size_t r = rB + b;
      if (tid == 0) {
        float S2 = 0.0f;
        for (int j = 0; j < bpr; ++j) S2 += cl.map_shared_rank(red, rank0 + j)[2];
        red[7] = S2;
      }
      __syncthreads();
      const float S2 = red[7];
      for (int i = tid; i < n_own; i += TR_THREADS) {
        const int t = t0 + i;
        const float a = en[i] / S2;
        alpha[i] = a;
        O(p, O_ALIGN)[r * T_in + t] = a;
        if (s + 1 < d.T) O(p, O_ALPHAP)[(r + B) * T_in + t] = a;
      }
      for (int e = tid; e < n_own + taps - 1; e += TR_THREADS) {
        const int t = t0 - padl + e;
        if (t >= 0 && t < T_in) cum[e] += __ldcg(O(p, O_ALIGN_SM) + r * T_in + t);
      }
      __syncthreads();
      const float* values = p.c[I_VALUES] + ((size_t)b * T_in + t0) * V;
      for (int v = tid; v < V; v += TR_THREADS) {
        float acc = 0.0f;
#pragma unroll 8
        for (int i = 0; i < n_own; ++i) acc = fmaf(alpha[i], values[(size_t)i * V + v], acc);
        ctxp[v] = acc;
      }
    }
    cl.sync();
    if (b >= 0) {
      const size_t r = rB + b;
      for (int v = vs.lo + tid; v < vs.hi; v += TR_THREADS) {
        float acc = 0.0f;
        for (int j = 0; j < bpr; ++j) acc += cl.map_shared_rank(ctxp, rank0 + j)[v];
        O(p, O_CTX)[r * V + v] = acc;
        if (s + 1 < d.T) O(p, O_CTXP)[(r + B) * V + v] = acc;
      }
    }
    // barrier 3
    grid_barrier(counter, target += pl.G);
  }
  cl.sync();  // no block leaves while a peer may still read its shared memory
}

}  // namespace

// Bytes of shared memory per block (ops/tacotron_trainer_kernel.py k34_plan
// computes the same; the wrapper checks before every launch).
extern "C" int tacotron_train_fwd_smem_bytes(int B, int T_in, int P, int U, int V, int A, int F, int taps,
                                             int NC) {
  const TrDims d{B, 1, T_in, P, U, V, A, F, taps};
  return fwd_layout(d, tr_plan(d, NC)).total * (int)sizeof(float);
}

static cudaLaunchConfig_t fwd_config(cudaLaunchAttribute* at, int G, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = TR_CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(TR_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of TR_CLUSTER blocks that the card keeps resident at once with
// one block per SM (asked at TR_SMEM_ONE_PER_SM bytes of shared memory), or a negative cudaError_t.
extern "C" int tacotron_train_fwd_clusters() {
  cudaError_t err = cudaFuncSetAttribute(tacotron_train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TR_SMEM_ONE_PER_SM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = fwd_config(at, TR_CLUSTER, TR_SMEM_ONE_PER_SM, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, tacotron_train_fwd_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Launches the forward on ``stream`` as NC clusters of TR_CLUSTER blocks.
// ``ptrs`` holds N_PTRS device pointers in enum order (mask slots may be
// null when use_masks is 0): p_seq [T, B, P], the four zoneout keep-masks
// [T, B, U], keys [B, T_in, A], values [B, T_in, V], mem_mask [B, T_in];
// l1 [P+V+U, 4U], l1_b [4U], l2 [2U, 4U], l2_b [4U], wq [U, A] (the
// [in, out] layout), w_conv [taps, F], w_loc [F, A], ball [A], v [A], mu_c
// [V], mu_q [U], mu_b [1]; then the outputs in FWD_OUTS order ([T, B, ...],
// mup [T, B]).  ``counter`` is one zeroed uint32.  Returns a cudaError_t:
// cudaErrorCooperativeLaunchTooLarge when NC clusters cannot be resident
// together or the rows do not fit, else the launch's own.
extern "C" int tacotron_train_fwd_launch(void* const* ptrs, unsigned* counter, int B, int T, int T_in, int P,
                                         int U, int V, int A, int F, int taps, int NC, int use_masks,
                                         float zoneout, void* stream) {
  Ptrs p;
  for (int i = 0; i < O_OUT2; ++i) p.c[i] = static_cast<const float*>(ptrs[i]);
  for (int i = O_OUT2; i < N_PTRS; ++i) p.o[i - O_OUT2] = static_cast<float*>(ptrs[i]);
  const TrDims d{B, T, T_in, P, U, V, A, F, taps};
  const TrPlan pl = tr_plan(d, NC);
  if (pl.bpr == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int smem = fwd_layout(d, pl).total * (int)sizeof(float);
  if (smem > TR_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tacotron_train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = fwd_config(at, pl.G, smem, (cudaStream_t)stream);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, tacotron_train_fwd_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n < NC) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchKernelEx(&cfg, tacotron_train_fwd_kernel, p, d, pl, use_masks, zoneout, counter);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
