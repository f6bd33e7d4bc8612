// Tacotron-2 teacher-forced decoder core, backward (training, K4): one
// launch runs the reverse-time adjoint of tacotron_train_fwd.cu over every
// step, as one grid of thread-block clusters (tacotron_train_common.cuh).
//
// Replaces the TPU kernel
// tacotronv2_wavernn_chinese_tpu/ops/tacotron_trainer_kernel.py
// (_bwd_call L761, _bwd_kernel) in its "stream" weight-gradient layout.
// Per step, last to first: rebuild cum_{t-1} = cum_t - align_sm_t (cum_T
// comes from the wrapper) -> recompute mu_t and add the mu adjoint ->
// context adjoint into the alignment adjoint -> normalisation and
// forward-recursion adjoints -> softmax adjoint -> energies (tanh, the F->A
// location dense and the location conv; the conv transpose adds into the
// carried cum adjoint) -> d_q -> LSTM2 and LSTM1 adjoints, with the gate
// pre-activations, query projection and states the forward saved (zoneout
// keep-masks in train mode, the EMA factors in eval mode).  Written per
// step: d_g1, d_g2 [T, B, 4U], d_q [T, B, A], d_mulin [T, B], d_ctx_tot
// [T, B, V]; the wrapper contracts them with the saves into the gate,
// query and mu weight gradients, the prenet cotangent and d_values (ops/
// tacotron_trainer_kernel.py weight_grads).  Kept in the kernel: d_keys
// [B, T_in, A] (each position by one block) and per-block partials of
// d_conv, d_wloc, d_v and d_ball [G, ...], which the wrapper sums.
//
// What bounds it: the steps are serial, and each holds three dependent
// matrix products over the full batch (d_q wq^T, d_g2 l2^T, d_g1 l1[ctx|h]^T:
// ~5.1 MB of f32 weights at the default widths) and the per-position
// attention adjoint (~15 K multiply-adds per position and row).  The
// arithmetic is ~5 us per step at B=32 on the card's f32 rate; the first
// design (one block per row, every block streaming every gate matrix from
// L2 each step, plus a recompute of the gates) took 470 us per step.  In
// this design the row blocks' attention adjoint is the critical path (at
// B=32 a row has 2 blocks of 80 positions; the per-position loops are
// bound by shared-memory reads of w_loc and the latency of 16 warps), then
// the products and the three grid barriers (PERF.md has the split).
//
// Design: the gate weights live once on chip, split over the grid (rank q
// of a cluster holds all four gates of its K-units against its cluster's
// output rows: 4,752 + 6,996 floats of l2/l1 and the 32 x 128 of wq at
// NC = 15 clusters), no gate weight is read from L2 after the prologue, and
// K3 saves the gate pre-activations and the query projection, so nothing
// is recomputed.  A step is three phases, each ended by a grid barrier:
//
//   1. attention adjoint, rows on their clusters (bpr blocks per row, nT
//      positions each; the row sums, the alignment adjoint's one neighbour
//      value and the d_q partials cross the row's blocks through
//      distributed shared memory, three cluster barriers; the conv
//      transpose crosses slice edges through a per-row global buffer Z);
//      then y3 = d_q wq^T of the cluster's rows for every rank's K-units.
//   2. the LSTM2 adjoint of the rank's K-units for all rows (each cluster
//      runs it, so d_g2's slice never crosses the grid) -> partial
//      [d_out1 | d_h2] of the cluster's units -> merged in the cluster.
//   3. the same for LSTM1 -> partial [a_ctx | d_h1] -> merged.
//
// Data exchange per step and block (choice (a) of the design: each block
// contracts only its slice of the reduction dimension; the partials merge
// inside the cluster): the product inputs are made in place, so a block
// reads only the merged outputs it needs from L2: y3, d_out1, d_h2 and d_h1
// of its K-units ([B, 32] each) and, for a row, a_ctx [V]; ~18 KB at B=32,
// against 128 KB for one staged copy of d_g [B, 4U].
//
// Numbers: f32 throughout.  Sums are taken in another order than the plain
// version's (a product's K split over eight ranks, position sums split over
// a row's blocks and chunks), so results differ by rounding; the check is
// every gradient within 1e-3 * max|g| of autograd of the eager loop.
#include "tacotron_train_common.cuh"

namespace {

// Pointer-array slots (ops/tacotron_trainer_kernel.py train_bwd).
enum {
  I_MC1, I_MH1, I_MC2, I_MH2, I_KEYS, I_VALUES, I_CUMT, I_GOUT2, I_GCTX, I_GALIGN,
  W_WCONV, W_WLOC, W_BALL, W_V, W_MUC, W_MUQ, W_MUB, W_L1IO, W_L2IO, W_WQIO,
  S_OUT2, S_CTX, S_ALIGN, S_ALIGN_SM, S_C1P, S_C2P, S_ALPHAP, S_MUP, S_G1, S_G2, S_PQ,
  O_DG1, O_DG2, O_DQ, O_DMULIN, O_DCTX, O_DKEYS, O_DCONV, O_DWLOC, O_DV, O_DBALL, O_SCRATCH,
  N_PTRS
};

struct Ptrs {
  const float* c[O_DG1];
  float* o[N_PTRS - O_DG1];
};

__device__ __forceinline__ float* O(const Ptrs& p, int i) { return p.o[i - O_DG1]; }

// Offsets (floats) into dynamic shared memory; mirrored term for term by
// ops/tacotron_trainer_kernel.py (k34_plan, kind "bwd").
struct BwdLayout {
  int w2;      // [2uc, L4]     l2 rows [out1 | h2] of the cluster's units x the rank's K-unit gates
  int w1;      // [vc + uc, L4] l1 rows [ctx | h] of the cluster x the rank's K-unit gates
  int wq;      // [Ku, A]       wq rows of the rank's K-units
  int wconv;   // [taps, F]
  int wloc;    // [F, A+1]      (rows one float apart in bank, so lanes may run over filters)
  int st;      // [4, B, Ku]    carried a_c1, a_h1, a_c2, a_h2 of the K-units
  int xs;      // [B, L4]       d_g of the K-units (product input)
  int p2;      // [B, 2uc]      partial [d_out1 | d_h2]
  int p1;      // [B, vc + uc]  partial [a_ctx | d_h1]
  int feat;    // [TC, FS]      one chunk's location features (aliases xs..)
  int df;      // [TC, F+1]     d_f
  int dth;     // [TC, A+1]     d_th
  int dfq;     // [4, TC, 32]   d_f partials over quarters of the columns
  int wsum;    // [2, warps, A] the warps' d_q and d_v columns (aliases the chunk)
  int cum;     // [nT + taps - 1] cum_{t-1} over the slice and its halo
  int aalpha, acum, bufA, dw;  // [nT] each
  int dctx;    // [V]
  int pqb;     // [A]           this step's query projection + energy bias of the row
  int vsm;     // [A]           the energy vector v
  int dq;      // [rpc, A]      merged d_q of the cluster's rows
  int dqb;     // [A]           this block's d_q partial (read by the row)
  int dv, dball;  // [A]        per-block partials, over all steps
  int dwloc;   // [F, A]
  int dconv;   // [taps, F]
  int red;     // [16]          row-sum slots (read by the row) and broadcast
  int bred;    // [64]          block reductions
  int total;
};

__host__ __device__ inline BwdLayout bwd_layout(const TrDims& d, const TrPlan& pl) {
  BwdLayout L;
  const int L4 = 4 * pl.Ku + 4, n2 = 2 * pl.uc, n1 = pl.vc + pl.uc, nT4 = tr_up4(pl.nT);
  int o = 0;
  L.w2 = o;     o += n2 * L4;
  L.w1 = o;     o += n1 * L4;
  L.wq = o;     o += pl.Ku * d.A;
  L.wconv = o;  o += tr_up4(d.taps * d.F);
  L.wloc = o;   o += tr_up4(d.F * (d.A + 1));
  L.st = o;     o += tr_up4(4 * d.B * pl.Ku);
  L.xs = o;
  L.p2 = L.xs + d.B * L4;
  L.p1 = L.p2 + tr_up4(d.B * n2);
  const int prod_end = L.p1 + tr_up4(d.B * n1);
  L.feat = o;
  L.df = L.feat + TR_TC * tr_fs(d.F);
  L.dth = L.df + tr_up4(TR_TC * (d.F + 1));
  L.dfq = L.dth + tr_up4(TR_TC * (d.A + 1));
  L.wsum = o;
  o = tr_max(tr_max(prod_end, L.dfq + 4 * TR_TC * 32), L.wsum + 2 * TR_WARPS * d.A);
  L.cum = o;    o += tr_up4(pl.nT + d.taps - 1);
  L.aalpha = o; o += nT4;
  L.acum = o;   o += nT4;
  L.bufA = o;   o += nT4;
  L.dw = o;     o += nT4;
  L.dctx = o;   o += d.V;
  L.pqb = o;    o += d.A;
  L.vsm = o;    o += d.A;
  L.dq = o;     o += pl.rpc * d.A;
  L.dqb = o;    o += d.A;
  L.dv = o;     o += d.A;
  L.dball = o;  o += d.A;
  L.dwloc = o;  o += d.F * d.A;
  L.dconv = o;  o += tr_up4(d.taps * d.F);
  L.red = o;    o += 16;
  L.bred = o;   o += 64;
  L.total = o;
  return L;
}

// Global scratch (floats, zeroed by the wrapper): a_ctx [B, V], y3 [B, U],
// [d_out1 | d_h2] [B, 2U], d_h1 [2, B, U] (by step parity), Z [B, T_in, taps]
// (per position: d_f . w_conv of each tap, the conv transpose's terms).
__host__ __device__ inline size_t bwd_scratch_floats(const TrDims& d) {
  return (size_t)d.B * ((size_t)d.V + 5 * (size_t)d.U + (size_t)d.T_in * d.taps);
}

__global__ void __launch_bounds__(TR_THREADS, 1)
tacotron_train_bwd_kernel(Ptrs p, TrDims d, TrPlan pl, int use_masks, float zoneout, unsigned* counter) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const BwdLayout L = bwd_layout(d, pl);
  const TrRole R = tr_role(d, pl);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = d.B, T_in = d.T_in, P = d.P, U = d.U, V = d.V, A = d.A, F = d.F, taps = d.taps;
  const int padl = (taps - 1) / 2, Ku = pl.Ku, L4 = 4 * Ku + 4, uc = pl.uc, vc = pl.vc, FS = tr_fs(F), LW = A + 1;
  const int n2 = 2 * uc, n1 = vc + uc, nku = R.ku.n(), nou = R.ou.n(), nov = R.ov.n();
  const int rpc = pl.rpc, bpr = pl.bpr, rank0 = (R.q / bpr) * bpr;
  const int b = R.row, t0 = R.pos.lo, n_own = R.pos.n();
  float *w2 = sm + L.w2, *w1 = sm + L.w1, *wq = sm + L.wq, *wconv = sm + L.wconv, *wloc = sm + L.wloc;
  float *ac1 = sm + L.st, *ah1 = ac1 + B * Ku, *ac2 = ah1 + B * Ku, *ah2 = ac2 + B * Ku;
  float *xs = sm + L.xs, *p2 = sm + L.p2, *p1 = sm + L.p1;
  float *feat = sm + L.feat, *df = sm + L.df, *dth = sm + L.dth, *dfq = sm + L.dfq, *wsum = sm + L.wsum;
  float *cum = sm + L.cum, *aalpha = sm + L.aalpha, *acum = sm + L.acum, *bufA = sm + L.bufA, *dw = sm + L.dw;
  float *dctx = sm + L.dctx, *pqb = sm + L.pqb, *vsm = sm + L.vsm, *dq = sm + L.dq, *dqb = sm + L.dqb, *dv = sm + L.dv, *dball = sm + L.dball;
  float *dwloc = sm + L.dwloc, *dconv = sm + L.dconv, *red = sm + L.red, *bred = sm + L.bred;
  const float* mu_c = p.c[W_MUC];
  const float* mu_q = p.c[W_MUQ];
  const float* ball = p.c[W_BALL];
  const float* vv = p.c[W_V];
  const float mu_b = __ldg(p.c[W_MUB]);
  float* actx = O(p, O_SCRATCH);          // [B, V]
  float* Y3 = actx + (size_t)B * V;       // [B, U]
  float* D2 = Y3 + (size_t)B * U;         // [B, 2U]
  float* DH1 = D2 + (size_t)2 * B * U;    // [2, B, U]
  float* Z = DH1 + (size_t)2 * B * U;     // [B, T_in, taps]

  // prologue: the weight slices, for the whole loop
  const Range ku = R.ku, cu = R.cu, cv = R.cv;
  auto gate_col = [=](int k) {  // column k of a K-unit slice: gate k / Ku of K-unit k % Ku
    const int g = k / Ku, i = k - g * Ku;
    return (g < 4 && i < nku) ? g * U + ku.lo + i : -1;
  };
  tr_load_slice(w2, n2, L4, p.c[W_L2IO], 4 * U, [=](int o) {
    const int j = cu.lo + (o < uc ? o : o - uc);
    return j < cu.hi ? (o < uc ? j : U + j) : -1;
  }, gate_col);
  tr_load_slice(w1, n1, L4, p.c[W_L1IO], 4 * U, [=](int o) {
    if (o < vc) return cv.lo + o < cv.hi ? P + cv.lo + o : -1;
    return cu.lo + o - vc < cu.hi ? P + V + cu.lo + o - vc : -1;
  }, gate_col);
  tr_load_slice(wq, Ku, A, p.c[W_WQIO], A, [=](int i) { return i < nku ? ku.lo + i : -1; },
                [](int a) { return a; });
  for (int i = tid; i < taps * F; i += TR_THREADS) wconv[i] = p.c[W_WCONV][i];
  for (int i = tid; i < F * A; i += TR_THREADS) {
    wloc[(i / A) * LW + i % A] = p.c[W_WLOC][i];
    dwloc[i] = 0.0f;
  }
  for (int i = tid; i < 4 * B * Ku; i += TR_THREADS) ac1[i] = 0.0f;
  for (int i = tid; i < taps * F; i += TR_THREADS) dconv[i] = 0.0f;
  for (int a = tid; a < A; a += TR_THREADS) {
    dv[a] = dball[a] = 0.0f;
    vsm[a] = vv[a];
  }
  for (int i = tid; i < n_own; i += TR_THREADS) aalpha[i] = acum[i] = 0.0f;
  for (int e = tid; e < n_own + taps - 1; e += TR_THREADS) {
    const int t = t0 - padl + e;
    cum[e] = (n_own > 0 && t >= 0 && t < T_in) ? p.c[I_CUMT][(size_t)b * T_in + t] : 0.0f;
  }
  float amu = 0.0f;  // the carried mu adjoint of the row
  unsigned target = 0;
  __syncthreads();

  for (int s = d.T - 1; s >= 0; --s) {
    // 1. attention adjoint of the rows: mu, context, alignment normalisation
    const size_t rB = (size_t)s * B;
    const size_t r = rB + (b >= 0 ? b : 0);
    const float* align_sm = p.c[S_ALIGN_SM] + r * T_in;
    const float* alphap = p.c[S_ALPHAP] + r * T_in;
    const float mup = b >= 0 ? p.c[S_MUP][r] : 0.0f;
    float2 ps = make_float2(0.0f, 0.0f);
    if (b >= 0) {
      float part = 0.0f;
      for (int i = tid; i < V + U; i += TR_THREADS)
        part += i < V ? p.c[S_CTX][r * V + i] * __ldg(mu_c + i) : p.c[S_OUT2][r * U + i - V] * __ldg(mu_q + i - V);
      const float mu_t = sigmoidf_(tr_block_sum2(part, 0.0f, bred).x + mu_b);
      const float d_lin = amu * mu_t * (1.0f - mu_t);
      for (int v = tid; v < V; v += TR_THREADS) {
        dctx[v] = p.c[I_GCTX][r * V + v] + __ldcg(actx + (size_t)b * V + v) + d_lin * __ldg(mu_c + v);
        if (R.sl == 0) O(p, O_DCTX)[r * V + v] = dctx[v];
      }
      if (R.sl == 0 && tid == 0) O(p, O_DMULIN)[r] = d_lin;
      for (int e = tid; e < n_own + taps - 1; e += TR_THREADS) {
        const int t = t0 - padl + e;
        if (t >= 0 && t < T_in) cum[e] -= align_sm[t];
      }
      __syncthreads();
      // 1a. the alignment adjoint g_align + a_alpha + values . d_ctx, and the normalisation sums
      for (int i = warp; i < n_own; i += 2 * TR_WARPS) {  // two positions a warp, loads in flight together
        const bool two = i + TR_WARPS < n_own;
        const int i2 = two ? i + TR_WARPS : i;
        const float* vr = p.c[I_VALUES] + ((size_t)b * T_in + t0 + i) * V;
        const float* vr2 = p.c[I_VALUES] + ((size_t)b * T_in + t0 + i2) * V;
        float acc = 0.0f, acc2 = 0.0f;
        for (int v = lane; v < V; v += 32) {
          acc = fmaf(vr[v], dctx[v], acc);
          acc2 = fmaf(vr2[v], dctx[v], acc2);
        }
        acc = warp_sum(acc);
        acc2 = warp_sum(acc2);
        if (lane == 0) {
          bufA[i] = p.c[I_GALIGN][r * T_in + t0 + i] + aalpha[i] + acc;
          if (two) bufA[i2] = p.c[I_GALIGN][r * T_in + t0 + i2] + aalpha[i2] + acc2;
        }
      }
      __syncthreads();
      float pa = 0.0f, pb = 0.0f;
      for (int i = tid; i < n_own; i += TR_THREADS) {
        const int t = t0 + i;
        const float w = (1.0f - mup) * alphap[t] + mup * (t > 0 ? alphap[t - 1] : 0.0f) + 1e-10f;
        pa += bufA[i] * p.c[S_ALIGN][r * T_in + t];
        pb += w * align_sm[t];
      }
      ps = tr_block_sum2(pa, pb, bred);
    }
    if (tid == 0) {
      red[0] = ps.x;
      red[1] = ps.y;
    }
    cl.sync();
    // 1b. normalisation and forward-recursion adjoints
    float2 pr = make_float2(0.0f, 0.0f);
    if (b >= 0) {
      if (tid == 0) {
        const float2 rs = tr_row_sum2(cl, red, rank0, bpr);
        red[4] = rs.x;
        red[5] = rs.y;
      }
      __syncthreads();
      const float r1 = red[4], S = red[5];
      float pa = 0.0f, pb = 0.0f;
      for (int i = tid; i < n_own; i += TR_THREADS) {
        const int t = t0 + i;
        const float prev = t > 0 ? alphap[t - 1] : 0.0f;
        const float w = (1.0f - mup) * alphap[t] + mup * prev + 1e-10f;
        const float d_pre = (bufA[i] - r1) / S;
        const float e = d_pre * w + acum[i];  // d_align_sm
        const float dwv = d_pre * align_sm[t];
        bufA[i] = e;
        dw[i] = dwv;
        pa += dwv * (prev - alphap[t]);
        pb += e * align_sm[t];
      }
      pr = tr_block_sum2(pa, pb, bred);
    }
    if (tid == 0) {
      red[2] = pr.x;
      red[3] = pr.y;
    }
    cl.sync();
    // 2. energies, location adjoints and reductions over positions, TR_TC at a time
    if (b >= 0) {
      if (tid == 0) {
        const float2 rs = tr_row_sum2(cl, red + 2, rank0, bpr);
        red[6] = rs.x;
        red[7] = rs.y;
        // d_w of the next position, the first of the next slice of the row
        red[8] = R.pos.hi < T_in ? cl.map_shared_rank(dw, R.q + 1)[0] : 0.0f;
      }
      __syncthreads();
      const float r2 = red[7], dwn = red[8];
      amu = red[6];
      for (int i = tid; i < n_own; i += TR_THREADS) {
        aalpha[i] = dw[i] * (1.0f - mup) + (i + 1 < n_own ? dw[i + 1] : dwn) * mup;
        bufA[i] = align_sm[t0 + i] * (bufA[i] - r2);  // d_e
      }
      for (int a = tid; a < A; a += TR_THREADS) pqb[a] = p.c[S_PQ][r * A + a] + __ldg(ball + a);
      __syncthreads();
    }
    const size_t bo = b >= 0 ? b : 0;
    const float* keys = p.c[I_KEYS] + bo * T_in * A;
    float* dkeys = O(p, O_DKEYS) + bo * T_in * A;
    float dq_r[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dv_r[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // lane's columns lane + 32m
    for (int i0 = 0; i0 < n_own; i0 += TR_TC) {
      // 2a. features, energies and d_th, a warp per position
      const int nv = tr_min(TR_TC, n_own - i0);
      if (warp >= nv)  // an empty row: 2b reads every row of the chunk
        for (int a = lane; a < A; a += 32) dth[warp * (A + 1) + a] = 0.0f;
      if (warp < nv) {
        const int i = i0 + warp, t = t0 + i;
        float* fb = feat + warp * FS;
        if (lane < F) {
          float acc = 0.0f;
          for (int j = 0; j < taps; ++j) acc = fmaf(cum[i + j], wconv[j * F + lane], acc);
          fb[lane] = acc;
        }
        __syncwarp();
        const float de = bufA[i];
        float loc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, kv[4], dk[4], g[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {  // global loads first, consumed after the dense
          const int a = tr_min(lane + 32 * m, A - 1);
          kv[m] = keys[(size_t)t * A + a];
          dk[m] = dkeys[(size_t)t * A + a];
        }
        for (int f = 0; f < F; ++f) {
          const float x = fb[f];
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (lane + 32 * m < A) loc[m] = fmaf(x, wloc[f * LW + lane + 32 * m], loc[m]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int a = lane + 32 * m;
          g[m] = 0.0f;
          if (a < A) {
            const float th = tanhf(kv[m] + pqb[a] + loc[m]);
            g[m] = de * vsm[a] * (1.0f - th * th);
            dq_r[m] += g[m];
            dv_r[m] = fmaf(th, de, dv_r[m]);
            dth[warp * (A + 1) + a] = g[m];
            dkeys[(size_t)t * A + a] = dk[m] + g[m];
          }
        }
      }
      __syncthreads();
      // 2b. d_f = d_th w_loc^T by column quarters, then Z = d_f w_conv^T
      // (lanes over filters; a warp takes four positions and a quarter of the columns)
      {
        const int f = lane, q4 = warp & 3, w0 = warp >> 2;  // positions w0, w0 + 4, w0 + 8, w0 + 12
        const int a0 = q4 * (A / 4), a1 = q4 == 3 ? A : a0 + A / 4;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (f < F) {
          for (int a = a0; a < a1; ++a) {
            const float x = wloc[f * LW + a];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r] = fmaf(dth[(w0 + 4 * r) * (A + 1) + a], x, acc[r]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) dfq[(q4 * TR_TC + w0 + 4 * r) * 32 + f] = acc[r];
        }
      }
      __syncthreads();
      for (int k = tid; k < TR_TC * F; k += TR_THREADS) {
        const int w = k / F, f = k - w * F;
        df[w * (F + 1) + f] = dfq[w * 32 + f] + dfq[(TR_TC + w) * 32 + f] + dfq[(2 * TR_TC + w) * 32 + f] +
                              dfq[(3 * TR_TC + w) * 32 + f];
      }
      __syncthreads();
      for (int k = tid; k < TR_TC * taps; k += TR_THREADS) {
        const int w = k % TR_TC, j = k / TR_TC;
        if (w < nv) {
          float acc = 0.0f;
          for (int f = 0; f < F; ++f) acc = fmaf(df[w * (F + 1) + f], wconv[j * F + f], acc);
          Z[(bo * T_in + t0 + i0 + w) * taps + j] = acc;
        }
      }
      // 2c. reductions over the chunk's positions: d_wloc (eight filters a thread), d_conv
      for (int k = tid; k < A * tr_cdiv(F, 8); k += TR_THREADS) {
        const int a = k % A, f0 = 8 * (k / A);
        float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int w = 0; w < nv; ++w) {
          const float d = dth[w * (A + 1) + a];
          const float4 x0 = *reinterpret_cast<const float4*>(feat + w * FS + f0);
          const float4 x1 = *reinterpret_cast<const float4*>(feat + w * FS + f0 + 4);
          acc[0] = fmaf(x0.x, d, acc[0]);
          acc[1] = fmaf(x0.y, d, acc[1]);
          acc[2] = fmaf(x0.z, d, acc[2]);
          acc[3] = fmaf(x0.w, d, acc[3]);
          acc[4] = fmaf(x1.x, d, acc[4]);
          acc[5] = fmaf(x1.y, d, acc[5]);
          acc[6] = fmaf(x1.z, d, acc[6]);
          acc[7] = fmaf(x1.w, d, acc[7]);
        }
#pragma unroll
        for (int ff = 0; ff < 8; ++ff)
          if (f0 + ff < F) dwloc[(f0 + ff) * A + a] += acc[ff];
      }
      for (int k = tid; k < taps * F; k += TR_THREADS) {
        const int j = k / F, f = k - j * F;
        float acc = 0.0f;
        for (int w = 0; w < nv; ++w) acc = fmaf(cum[i0 + w + j], df[w * (F + 1) + f], acc);
        dconv[k] += acc;
      }
      __syncthreads();
    }
    // the warps' d_q and d_v columns, summed over the warps in a fixed order
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (lane + 32 * m < A) {
        wsum[warp * A + lane + 32 * m] = dq_r[m];
        wsum[(TR_WARPS + warp) * A + lane + 32 * m] = dv_r[m];
      }
    }
    __syncthreads();
    for (int a = tid; a < A; a += TR_THREADS) {
      float q = 0.0f, vs = 0.0f;
      for (int w = 0; w < TR_WARPS; ++w) {
        q += wsum[w * A + a];
        vs += wsum[(TR_WARPS + w) * A + a];
      }
      dqb[a] = q;
      dv[a] += vs;
      dball[a] += q;
    }
    cl.sync();
    // 3. row merge: cum adjoint from the conv transpose, d_q, y3 = d_q wq^T
    for (int i = tid; i < n_own; i += TR_THREADS) {
      const int t = t0 + i;
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < taps; ++j) {
        const int tt = tr_min(tr_max(t + padl - j, 0), T_in - 1);
        const float z = __ldcg(Z + ((size_t)b * T_in + tt) * taps + j);
        acc += (t + padl - j == tt) ? z : 0.0f;
      }
      acum[i] += acc;
    }
    // 3b. d_q of the cluster's rows from the blocks' partials, then y3
    for (int k = tid; k < rpc * A; k += TR_THREADS) {
      const int rr = k / A, a = k - rr * A;
      float sum = 0.0f;
      for (int j = 0; j < bpr; ++j) sum += cl.map_shared_rank(dqb, rr * bpr + j)[a];
      dq[k] = sum;
    }
    __syncthreads();
    if (b >= 0 && R.sl == 0)
      for (int a = tid; a < A; a += TR_THREADS) O(p, O_DQ)[r * A + a] = dq[(R.q / bpr) * A + a];
    for (int k = warp; k < rpc * nku; k += TR_WARPS) {
      const int rr = k / nku, i = k - rr * nku, bb = R.c * rpc + rr;
      if (bb >= B) continue;
      float acc = 0.0f;
      for (int a = lane; a < A; a += 32) acc = fmaf(dq[rr * A + a], wq[i * A + a], acc);
      acc = warp_sum(acc);
      if (lane == 0) Y3[(size_t)bb * U + ku.lo + i] = acc;
    }
    // barrier 1
    grid_barrier(counter, target += pl.G);
    // 4. LSTM2 adjoint of the K-units, all rows
    for (int k = tid; k < B * Ku; k += TR_THREADS) {
      const int bb = k / Ku, i = k - bb * Ku;
      float* x = xs + bb * L4;
      if (i >= nku) {
        x[i] = x[Ku + i] = x[2 * Ku + i] = x[3 * Ku + i] = 0.0f;
        continue;
      }
      const int u = ku.lo + i;
      const size_t rb = rB + bb, ru = rb * U + u, rg = rb * 4 * U + u;
      const float* g2 = p.c[S_G2] + rg;
      const Gates q = tr_gates4(g2[0], g2[U], g2[2 * U], g2[3 * U]);
      const float d_o2 = p.c[I_GOUT2][ru] + __ldcg(O(p, O_DMULIN) + rb) * __ldg(mu_q + u) +
                         __ldcg(Y3 + (size_t)bb * U + u);
      const float cp = p.c[S_C2P][ru];
      const float thc = tanhf(q.sf * cp + q.si * q.tj);
      float kc = 1.0f - zoneout, zc = zoneout, kh = kc, zh = zc;
      if (use_masks) {
        kc = p.c[I_MC2][ru];
        zc = 1.0f - kc;
        kh = p.c[I_MH2][ru];
        zh = 1.0f - kh;
      }
      const float dnh = ah2[k] * kh + d_o2;
      const float dnc = ac2[k] * kc + dnh * q.so * (1.0f - thc * thc);
      ac2[k] = ac2[k] * zc + dnc * q.sf;
      ah2[k] = ah2[k] * zh;
      x[i] = dnc * q.tj * q.si * (1.0f - q.si);
      x[Ku + i] = dnc * q.si * (1.0f - q.tj * q.tj);
      x[2 * Ku + i] = dnc * cp * q.sf * (1.0f - q.sf);
      x[3 * Ku + i] = dnh * thc * q.so * (1.0f - q.so);
      if (R.c == 0)
        for (int g = 0; g < 4; ++g) O(p, O_DG2)[rb * 4 * U + g * U + u] = x[g * Ku + i];
    }
    for (int k = tid; k < B * 4; k += TR_THREADS) xs[(k >> 2) * L4 + 4 * Ku + (k & 3)] = 0.0f;
    __syncthreads();
    // 4b. [d_out1 | d_h2] = d_g2 l2^T: partials, merged in the cluster
    tr_partial(xs, L4, B, w2, L4, n2, 4 * Ku, p2, n2);
    cl.sync();
    for (int k = tid; k < B * nou; k += TR_THREADS) {
      const int bb = k / nou, j = R.ou.lo + k % nou, jl = j - cu.lo;
      D2[(size_t)bb * 2 * U + j] = tr_merge(cl, p2, bb * n2 + jl);
      D2[(size_t)bb * 2 * U + U + j] = tr_merge(cl, p2, bb * n2 + uc + jl);
    }
    // barrier 2
    grid_barrier(counter, target += pl.G);
    // 5. LSTM1 adjoint of the K-units, all rows
    for (int k = tid; k < B * Ku; k += TR_THREADS) {
      const int bb = k / Ku, i = k - bb * Ku;
      float* x = xs + bb * L4;
      if (i >= nku) {
        x[i] = x[Ku + i] = x[2 * Ku + i] = x[3 * Ku + i] = 0.0f;
        continue;
      }
      const int u = ku.lo + i;
      const size_t rb = rB + bb, ru = rb * U + u, rg = rb * 4 * U + u;
      ah2[k] += __ldcg(D2 + (size_t)bb * 2 * U + U + u);
      float a_h1 = ah1[k];
      if (s + 1 < d.T) a_h1 += __ldcg(DH1 + (size_t)((s + 1) & 1) * B * U + (size_t)bb * U + u);
      const float* g1 = p.c[S_G1] + rg;
      const Gates q = tr_gates4(g1[0], g1[U], g1[2 * U], g1[3 * U]);
      const float cp = p.c[S_C1P][ru];
      const float thc = tanhf(q.sf * cp + q.si * q.tj);
      float kc = 1.0f - zoneout, zc = zoneout, kh = kc, zh = zc;
      if (use_masks) {
        kc = p.c[I_MC1][ru];
        zc = 1.0f - kc;
        kh = p.c[I_MH1][ru];
        zh = 1.0f - kh;
      }
      const float dnh = a_h1 * kh + __ldcg(D2 + (size_t)bb * 2 * U + u);
      const float dnc = ac1[k] * kc + dnh * q.so * (1.0f - thc * thc);
      ac1[k] = ac1[k] * zc + dnc * q.sf;
      ah1[k] = a_h1 * zh;
      x[i] = dnc * q.tj * q.si * (1.0f - q.si);
      x[Ku + i] = dnc * q.si * (1.0f - q.tj * q.tj);
      x[2 * Ku + i] = dnc * cp * q.sf * (1.0f - q.sf);
      x[3 * Ku + i] = dnh * thc * q.so * (1.0f - q.so);
      if (R.c == 0)
        for (int g = 0; g < 4; ++g) O(p, O_DG1)[rb * 4 * U + g * U + u] = x[g * Ku + i];
    }
    for (int k = tid; k < B * 4; k += TR_THREADS) xs[(k >> 2) * L4 + 4 * Ku + (k & 3)] = 0.0f;
    __syncthreads();
    // 5b. [a_ctx | d_h1] = d_g1 l1[ctx | h]^T: partials, merged in the cluster
    tr_partial(xs, L4, B, w1, L4, n1, 4 * Ku, p1, n1);
    cl.sync();
    for (int k = tid; k < B * nov; k += TR_THREADS) {
      const int bb = k / nov, v = R.ov.lo + k % nov;
      actx[(size_t)bb * V + v] = tr_merge(cl, p1, bb * n1 + v - cv.lo);
    }
    for (int k = tid; k < B * nou; k += TR_THREADS) {
      const int bb = k / nou, j = R.ou.lo + k % nou;
      DH1[(size_t)(s & 1) * B * U + (size_t)bb * U + j] = tr_merge(cl, p1, bb * n1 + vc + j - cu.lo);
    }
    // barrier 3
    grid_barrier(counter, target += pl.G);
  }
  const size_t blk = blockIdx.x;
  for (int i = tid; i < taps * F; i += TR_THREADS) O(p, O_DCONV)[blk * taps * F + i] = dconv[i];
  for (int i = tid; i < F * A; i += TR_THREADS) O(p, O_DWLOC)[blk * F * A + i] = dwloc[i];
  for (int a = tid; a < A; a += TR_THREADS) {
    O(p, O_DV)[blk * A + a] = dv[a];
    O(p, O_DBALL)[blk * A + a] = dball[a];
  }
  cl.sync();  // no block leaves while a peer may still read its shared memory
}

}  // namespace

// Bytes of shared memory per block and floats of global scratch
// (ops/tacotron_trainer_kernel.py k34_plan computes the same; the wrapper
// checks before every launch).
extern "C" int tacotron_train_bwd_smem_bytes(int B, int T_in, int P, int U, int V, int A, int F, int taps,
                                             int NC) {
  const TrDims d{B, 1, T_in, P, U, V, A, F, taps};
  return bwd_layout(d, tr_plan(d, NC)).total * (int)sizeof(float);
}

extern "C" int tacotron_train_bwd_scratch_floats(int B, int T_in, int P, int U, int V, int A, int F, int taps) {
  const TrDims d{B, 1, T_in, P, U, V, A, F, taps};
  return (int)bwd_scratch_floats(d);
}

static cudaLaunchConfig_t bwd_config(cudaLaunchAttribute* at, int G, int smem, cudaStream_t stream) {
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
// one block per SM (asked at TR_SMEM_ONE_PER_SM bytes of shared memory), or a
// negative cudaError_t.
extern "C" int tacotron_train_bwd_clusters() {
  cudaError_t err = cudaFuncSetAttribute(tacotron_train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TR_SMEM_ONE_PER_SM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = bwd_config(at, TR_CLUSTER, TR_SMEM_ONE_PER_SM, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, tacotron_train_bwd_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Launches the backward on ``stream`` as NC clusters of TR_CLUSTER blocks.
// ``ptrs`` holds N_PTRS device pointers in enum order (mask slots may be
// null when use_masks is 0): the four zoneout keep-masks, keys, values,
// cum_T [B, T_in], the cotangents of out2, ctx and align; w_conv, w_loc,
// ball, v, mu_c, mu_q, mu_b, l1 [P+V+U, 4U], l2 [2U, 4U] and wq [U, A] in
// [in, out] layout; the saves out2, ctx, align, align_sm, c1p, c2p, alphap,
// mup, g1, g2, pq; the outputs in BWD_OUTS order (d_conv, d_wloc, d_v and
// d_ball per block); the zeroed scratch (bwd_scratch_floats).  ``counter``
// is one zeroed uint32.  Returns a cudaError_t:
// cudaErrorCooperativeLaunchTooLarge when NC clusters cannot be resident
// together or the rows do not fit, else the launch's own.
extern "C" int tacotron_train_bwd_launch(void* const* ptrs, unsigned* counter, int B, int T, int T_in, int P,
                                         int U, int V, int A, int F, int taps, int NC, int use_masks,
                                         float zoneout, void* stream) {
  Ptrs p;
  for (int i = 0; i < O_DG1; ++i) p.c[i] = static_cast<const float*>(ptrs[i]);
  for (int i = O_DG1; i < N_PTRS; ++i) p.o[i - O_DG1] = static_cast<float*>(ptrs[i]);
  const TrDims d{B, T, T_in, P, U, V, A, F, taps};
  const TrPlan pl = tr_plan(d, NC);
  if (pl.bpr == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (A > 128 || F > 32 || taps > 32) return (int)cudaErrorInvalidValue;  // a warp per position
  const int smem = bwd_layout(d, pl).total * (int)sizeof(float);
  if (smem > TR_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tacotron_train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = bwd_config(at, pl.G, smem, (cudaStream_t)stream);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, tacotron_train_bwd_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n < NC) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchKernelEx(&cfg, tacotron_train_bwd_kernel, p, d, pl, use_masks, zoneout, counter);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
