// Tacotron-2 autoregressive decode (K2): one launch runs every decoder step
// up to max_iters, with the batch-wide early exit, as one grid of
// thread-block clusters (tacotron_train_common.cuh).
//
// Replaces the TPU kernel
// tacotronv2_wavernn_chinese_tpu/ops/tacotron_decoder_kernel.py
// (decode_autoregressive_pallas, _kernel), every branch: forward attention
// with or without anti-repeat, LSA with or without its synthesis window,
// either with smoothing, GMM and Graves attention (_kernel's else branch),
// r = 1-6 frames a step.  Per step and row: prenet with always-on dropout
// (per-row seed, rng.cuh: lanes [0, P1) for layer 1, [P1, P1 + P2) for
// layer 2) on the last frame of the previous step -> LSTM1 on [prenet,
// context, h1] -> LSTM2 on [out1, h2] (TF gate order, forget bias +1,
// eval-mode zoneout (1-z)*new + z*prev on the carried state, out = the raw
// new_h) -> attention (forward and LSA: SAME location conv with the
// combined [taps, A] filter, tanh energy against the keys; GMM and Graves: a
// dense of their own and a mixture over the positions) -> context -> r
// frames, r stop logits and, for forward attention, mu.
//
// The attention branches are template parameters (K2Variant), so a branch
// adds no switch to the step loop:
//   * forward: conv over the cumulated softmax, softmax masked at -1e9,
//     the recursion ((1-mu)*alpha + mu*shift(alpha) + 1e-10) * softmax with
//     a zero-filled shift, renormalised; with ANTI the anti-repeat rule of
//     forward_attention.py:176-215 between recursion and renormalisation
//     (argmax kept monotonic, the dwell at one position capped, the
//     alignment windowed to [m-2, m+3) and its bin at clip(m) set to twice
//     the windowed sum).
//   * LSA: conv over the previous alignment (the running sum with
//     cumulative_weights: cw = 1), no recursion and no mu; with WIN the
//     energies outside [prev - back, prev + ahead) around the previous
//     argmax are -1e9 (both window types: back and ahead come from the
//     host).
//   * SMOOTH: sigmoid(energy) * mask normalised by its sum, instead of the
//     softmax.
//   * GMM (models/attention.py gmm_step): (alpha, beta, kappa increment) =
//     exp(dense([out2, previous context])) over N mixtures; kappa += the
//     increment; score[t] = sum_k alpha_k / beta_k * exp(-(kappa_k - t)^2 /
//     beta_k), softmax masked at -1e9; no keys, no conv.
//   * Graves (graves_step): gbk = layer2(relu(layer1(out2))) over N heads; g
//     = softmax + 1e-5, sig = softplus + 1e-5, mu += softplus; the row's
//     alignment is the difference of sum_h g_h / (1 + sigmoid((mu_h -
//     edge) / sig_h)) at neighbouring position edges t + 0.5, 1e-20 where
//     masked, not normalised.
//   Anti-repeat, smoothing and the window do not act under GMM and Graves,
//   as in the TPU kernel: each of the two is one instantiation.
//
// Semantics kept exactly: finished rows keep advancing with real outputs
// until every row is done; after that each step writes frames 0, stops 1e4
// and aligns 0.  Forward attention starts alpha and the cumulated
// alignments one-hot at position 0 and mu at 0.5; LSA starts at zeros.
// A row is done at the first step whose r stop flags (sigmoid > 0.5) number
// at least ``need`` (1: any frame, r: all frames).
//
// What bounds it: every step is a serial chain of small products over ~1.76
// M f32 weights (l1 1,048,576, l2 524,288, prenet 86,016, proj 82 x 768, wq
// 32,768: ~7.0 MB at r = 1) and the attention over T_in positions; at
// serving batch sizes (1-16 rows) the step is bound by latency (barriers,
// the chain of dependent products), not by bytes or operations.  The first
// design ran all rows on one block that streamed the weights from L2 every
// step (~35 GB/s through one SM, 195 us per step at B=4).
//
// Design: the grid of the trainer kernels (NC clusters of TR_CLUSTER blocks,
// one block per SM, the count the card keeps resident), with every weight
// that feeds the next step held once on chip for the whole decode: no such
// weight is read from L2 after the prologue, and each product serves all B
// rows at once.  The plan (k2_plan; mirrored term for term by
// ops/tacotron_decoder_kernel.py k2_plan, which the wrapper compares with
// the library before every launch):
//
//   * K-units, as in K3.  Rank q of every cluster holds its K-slice of l1
//     ([pre2 | ctx | h1] rows) and of l2 against the four gates of its
//     cluster's output units, and the wq rows of its K-units; the LSTM
//     epilogues run for the rank's K-units and every row in every cluster.
//   * Frame feedback inside the cluster.  Rank q also holds the projection
//     columns that feed the next step or decide the exit (the last frame,
//     the r stops and mu: NP = 80 + r + mu outputs) over its out2 K-units
//     and its ctx K-slice, its output slice of the first prenet layer and
//     the rows of the second that make its pre2 K-slice.  Every cluster
//     computes those NP outputs and the prenet for all rows; the partials
//     merge through distributed shared memory in rank order, so every block
//     of every cluster holds bit-identical frames, stop logits, mu and done
//     flags, and every block leaves the step loop at the same step without
//     a grid-wide vote.
//   * The other 80(r-1) frame columns only leave the kernel.  Cluster c
//     computes ec of them for all rows from the rank slices of the packed
//     weights in global memory (L2: wx, [TR_CLUSTER, 80(r-1), LKP]) and
//     writes them out; they are off the feedback chain.
//   * GMM's and Graves' denses.  Rank q holds the dense's columns over its
//     inputs (GMM: its out2 K-units and its ctx K-slice, as the projection;
//     Graves' layer1: its out2 K-units) and forms partials for its cluster's
//     rows, merged through distributed shared memory in rank order, so every
//     block of a row holds bit-identical mixture parameters and state (kappa
//     or mu, [N] in each block of the row).  GMM's slice stays on chip where
//     the plan fits (res = 1; at the default widths up to 68 mixtures at
//     B=4, T_in=32), else rank q reads it from its packed slice in global
//     memory (L2).
//     Graves' layer2 splits its 3N outputs over the ranks (c3 each), gathered
//     by the row's blocks over DSMEM: one cluster sync more than GMM.  Each
//     Graves block evaluates the head sum at its nT + 1 position edges and
//     differences neighbours; an edge shared by two blocks is computed alike
//     in both.
//   * Rows.  The attention of row b runs on bpr blocks of cluster b / rpc;
//     bpr grows with T_in (about K2_POS positions a block) up to
//     TR_CLUSTER / rpc, so a short input keeps its row in one block.  A
//     row's argmax (anti-repeat, the synthesis window) merges (max, index)
//     pairs of its blocks in rank order, the lowest index on ties as
//     jnp.argmax; every block of the row keeps the row's max_attention and
//     dwell counter.
//
// A step: [prenet 1 -> cluster gather -> prenet 2 -> x1 partials -> merged
// g1] barrier 1 [LSTM1 -> g2] barrier 2 [LSTM2 -> pq (the cluster holds all
// of wq) -> the rows' attention -> ctx] barrier 3 [projection partials ->
// merged frame, stops, mu, done flags; the other frame columns].  Three
// grid barriers; what lies between them crosses only the cluster.  Global
// memory carries g1, g2 and ctx ([B, 4U], [B, 4U], [B, V]) and the outputs.
//
// K1 (wavernn_sample.cu) and this kernel are both persistent grids that fill
// the card; the serve path launches them on one stream, one after the
// other, never side by side.
//
// Numbers: the products' sums are taken in another order than the plain
// version's (each K split over eight ranks and ks lanes), the softmax and
// the context over a row's blocks; values differ by rounding, and the check
// is every frame and alignment within 1e-3 of the plain loop (anti-repeat
// and the window: up to a step whose argmax the plain loop decides by less
// than 1e-5).
#include "rng.cuh"
#include "tacotron_train_common.cuh"

namespace {

constexpr int NMEL = 80;
constexpr int K2_POS = 32;  // attention positions a row block aims for

enum { K2_FORWARD = 0, K2_LSA = 1, K2_GMM = 2, K2_GRAVES = 3 };

struct K2Dims {
  int B, T_in, P1, P2, U, V, A, taps;
  int r, mu;    // frames a step; 1 when the projection has the mu column (forward attention)
  int mode, N;  // the attention (K2_*); GMM's mixtures or Graves' heads (0 otherwise)
};

struct K2Plan {
  int NC, G;         // clusters, blocks
  int Ku, uc, ub;    // K-units of a rank; output units of a cluster, of a block
  int K1p, Kp, Kv;   // a rank's prenet-1 outputs, prenet-2 outputs (its pre2 K-slice), ctx K-slice
  int rpc, bpr, nT;  // rows of a cluster, blocks of a row, positions of a block
  int NP, NX, ec;    // on-chip projection outputs (last frame | r stops | mu); the other frame
                     // columns; of those, a cluster's
  int H1, c3, res;   // Graves: layer1's width (U / 4), layer2's outputs of a rank; GMM: its dense
                     // slice on chip (1) or read from L2 (0)
};

// rpc is the smallest power of two with rpc * NC >= B; bpr = 0 when the
// rows do not fit (B > NC * TR_CLUSTER).  GMM's res is set by k2_plan.
__host__ __device__ inline K2Plan k2_plan_rows(const K2Dims& d, int NC) {
  K2Plan p;
  p.NC = NC;
  p.G = NC * TR_CLUSTER;
  p.Ku = tr_cdiv(d.U, TR_CLUSTER);
  p.uc = tr_cdiv(d.U, NC);
  p.ub = tr_cdiv(p.uc, TR_CLUSTER);
  p.K1p = tr_cdiv(d.P1, TR_CLUSTER);
  p.Kp = tr_cdiv(d.P2, TR_CLUSTER);
  p.Kv = tr_cdiv(d.V, TR_CLUSTER);
  int rpc = 1;
  while (rpc * NC < d.B) rpc *= 2;
  p.rpc = rpc;
  int bpr = 0;
  if (rpc <= TR_CLUSTER) {
    bpr = 1;
    while (bpr < TR_CLUSTER / rpc && bpr * K2_POS < d.T_in) bpr *= 2;
  }
  p.bpr = bpr;
  p.nT = bpr ? tr_cdiv(d.T_in, bpr) : 0;
  p.NP = NMEL + d.r + d.mu;
  p.NX = NMEL * (d.r - 1);
  p.ec = tr_cdiv(p.NX, NC);
  p.H1 = d.mode == K2_GRAVES ? d.U / 4 : 0;
  p.c3 = d.mode == K2_GRAVES ? tr_cdiv(3 * d.N, TR_CLUSTER) : 0;
  p.res = d.mode == K2_GMM;
  return p;
}

// Offsets (floats) into dynamic shared memory; mirrored term for term by
// ops/tacotron_decoder_kernel.py (K2Plan.smem_floats).
// A region a mode does not use has no floats: wq, wc, v, eb, pqp, pq, cum
// and alpha are forward's and LSA's; wd, wd2, dq, dh, dg, dr and mix GMM's
// and Graves'.
struct K2Layout {
  int w1;     // [4uc, LK1]  l1: the rank's [pre2 | ctx | h1] inputs x the cluster's gate rows
  int w2;     // [4uc, LK2]  l2: the rank's [out1 | h2] inputs x the cluster's gate rows
  int wq;     // [Ku, A]     wq columns of the rank's K-units
  int wd;     // GMM [3N, LKP] (res): its dense over the rank's [out2 | ctx] inputs; Graves [H1, LKQ]:
              //             layer1 over the rank's out2 K-units
  int wd2;    // Graves [c3, LKH]: layer2, the rank's outputs over all H1 inputs
  int wp;     // [NP, LKP]   proj: the rank's [out2 | ctx] inputs x last frame, stops, mu
  int wp1;    // [K1p, LKM]  prenet 1: the rank's outputs x the 80 mel inputs
  int wp2;    // [Kp, LKG]   prenet 2: the rank's outputs (its pre2 K-slice) x all P1 inputs
  int wc;     // [taps, A]   combined location conv
  int b1, b2; // [K1p], [Kp] the prenet biases of the rank's outputs
  int pb;     // [LDP]       projection bias
  int v, eb;  // [A]         energy vector v; energy bias (location conv bias + attention bias)
  int st;     // [4, B, Ku]  c1, h1, c2, h2 of the K-units
  int xs;     // [B, LK1]    x1; x2 [B, LK2] during LSTM1's product
  int gin;    // [B, LKG]    prenet-1 outputs gathered from the cluster; from LSTM2 on, the
              //             projection's inputs [B, LKP] (out2 K-units | ctx K-slice)
  int part;   // [B, max(4uc, LDX)] partial products read by the cluster
  int fr;     // [B, LDP]    merged last frame | stops | mu logits of the last step (the prenet's input)
  int mu, done;  // [B]
  int seed, key;  // [B]     each row's seed; this step's dropout key (rng_key of the seed, row 0, the step)
  int pqp;    // [rpc, A]    partial query projections of the cluster's rows (read by the cluster)
  int dq;     // GMM [rpc, LDG], Graves [rpc, LKH]: the dense's partials for the cluster's rows (read
              //             by the cluster)
  int dh;     // Graves [rpc, LKH]: relu(layer1) of the cluster's rows, merged
  int dg;     // Graves [rpc, LDG]: layer2 of the cluster's rows, the rank's c3 columns (read by the row)
  int dr;     // [LDG]       the row's mixture parameters: GMM alpha / beta, beta; Graves gbk, then g, sig
  int mix;    // [N]         the row's mixture state: GMM kappa, Graves mu
  int pq;     // [A]         the row's query projection + energy bias
  int cum;    // [nT + taps - 1] the conv's input over the slice and its halo: the cumulated softmax
              //             (forward), the previous or cumulated alignment (LSA)
  int alpha, en, asm_;  // [nT] forward state; energies then the recursion (Graves: [nT + 1] edges);
                        //      this step's softmax (the alignment but for forward attention)
  int ctxp;   // [V]         this block's partial context (read by the row)
  int red;    // [16]        the row's exchange: 0-1 statistics, 2 sum, 4-7 merged; 8-9 (max, index)
              //             of the block; 10-11 the row's max_attention and dwell counter
  int bred;   // [64]        block reductions; anti-repeat: the support of the alignment
  int total;
};

struct K2Ld {
  int LK1, LK2, LKP, LKM, LKG, LDP, LDX;
  int LKQ, LKH, LDG;  // Graves: layer1's and layer2's input strides; GMM and Graves: 3N outputs
};

__host__ __device__ inline K2Ld k2_ld(const K2Dims& d, const K2Plan& p) {
  const int LDP = tr_up4(p.NP + 2);
  return K2Ld{tr_up4(p.Kp + p.Kv + p.Ku) + 4, tr_up4(2 * p.Ku) + 4, tr_up4(p.Ku + p.Kv) + 4,
              tr_up4(NMEL) + 4, tr_up4(d.P1) + 4, LDP, LDP + tr_up4(p.ec),
              tr_up4(p.Ku) + 4, tr_up4(p.H1) + 4, tr_up4(3 * d.N)};
}

__host__ __device__ inline K2Layout k2_layout(const K2Dims& d, const K2Plan& p) {
  K2Layout L;
  const K2Ld ld = k2_ld(d, p);
  const bool loc = d.mode <= K2_LSA, gmm = d.mode == K2_GMM, graves = d.mode == K2_GRAVES;
  const int ng = 4 * p.uc, A4 = loc ? tr_up4(d.A) : 0;
  int o = 0;
  L.w1 = o;    o += ng * ld.LK1;
  L.w2 = o;    o += ng * ld.LK2;
  L.wq = o;    o += loc ? p.Ku * d.A : 0;
  L.wd = o;    o += gmm ? p.res * 3 * d.N * ld.LKP : p.H1 * ld.LKQ;
  L.wd2 = o;   o += p.c3 * ld.LKH;
  L.wp = o;    o += p.NP * ld.LKP;
  L.wp1 = o;   o += p.K1p * ld.LKM;
  L.wp2 = o;   o += p.Kp * ld.LKG;
  L.wc = o;    o += loc ? tr_up4(d.taps * d.A) : 0;
  L.b1 = o;    o += tr_up4(p.K1p);
  L.b2 = o;    o += tr_up4(p.Kp);
  L.pb = o;    o += ld.LDP;
  L.v = o;     o += A4;
  L.eb = o;    o += A4;
  L.st = o;    o += tr_up4(4 * d.B * p.Ku);
  L.xs = o;    o += d.B * ld.LK1;
  L.gin = o;   o += d.B * tr_max(ld.LKG, ld.LKP);
  L.part = o;  o += d.B * tr_max(ng, ld.LDX);
  L.fr = o;    o += d.B * ld.LDP;
  L.mu = o;    o += tr_up4(d.B);
  L.done = o;  o += tr_up4(d.B);
  L.seed = o;  o += tr_up4(d.B);
  L.key = o;   o += tr_up4(d.B);
  L.pqp = o;   o += loc ? p.rpc * d.A : 0;
  L.dq = o;    o += gmm ? p.rpc * ld.LDG : graves ? p.rpc * ld.LKH : 0;
  L.dh = o;    o += graves ? p.rpc * ld.LKH : 0;
  L.dg = o;    o += graves ? p.rpc * ld.LDG : 0;
  L.dr = o;    o += ld.LDG;
  L.mix = o;   o += tr_up4(d.N);
  L.pq = o;    o += A4;
  L.cum = o;   o += loc ? tr_up4(p.nT + d.taps - 1) : 0;
  L.alpha = o; o += loc ? tr_up4(p.nT) : 0;
  L.en = o;    o += tr_up4(graves ? p.nT + 1 : p.nT);
  L.asm_ = o;  o += tr_up4(p.nT);
  L.ctxp = o;  o += tr_up4(d.V);
  L.red = o;   o += 16;
  L.bred = o;  o += 64;
  L.total = o;
  return L;
}

// The plan: GMM keeps its dense slice on chip where the layout then fits a
// block's shared memory, else reads it from L2.
__host__ __device__ inline K2Plan k2_plan(const K2Dims& d, int NC) {
  K2Plan p = k2_plan_rows(d, NC);
  if (p.res && k2_layout(d, p).total * (int)sizeof(float) > TR_SMEM_LIMIT) p.res = 0;
  return p;
}

// What one block does under the plan.
struct K2Role {
  int c, q;          // cluster, rank
  Range ku, cu, ou;  // K-units; the cluster's output units; this block's share of them
  Range r1, r2, rv;  // prenet-1 outputs, prenet-2 outputs (= pre2 K-slice), ctx K-slice
  int row, sl, rank0;  // attention row (-1: none), slice of the row, the row's first rank
  Range pos;         // attention positions (empty without a row)
};

__device__ inline K2Role k2_role(const K2Dims& d, const K2Plan& p) {
  K2Role r;
  r.c = blockIdx.x / TR_CLUSTER;
  r.q = blockIdx.x % TR_CLUSTER;
  r.ku = tr_range(r.q, p.Ku, d.U);
  r.cu = tr_range(r.c, p.uc, d.U);
  const Range ou = tr_range(r.q, p.ub, r.cu.n());
  r.ou = Range{r.cu.lo + ou.lo, r.cu.lo + ou.hi};
  r.r1 = tr_range(r.q, p.K1p, d.P1);
  r.r2 = tr_range(r.q, p.Kp, d.P2);
  r.rv = tr_range(r.q, p.Kv, d.V);
  const int rr = r.q / p.bpr, b = r.c * p.rpc + rr;
  r.row = (rr < p.rpc && b < d.B) ? b : -1;
  r.sl = r.q % p.bpr;
  r.rank0 = rr * p.bpr;
  r.pos = r.row >= 0 ? tr_range(r.sl, p.nT, d.T_in) : Range{0, 0};
  return r;
}

// Where a product's sums go: out[b * ldo + o] = sum (STORE); PRENET:
// out[b * ldo + o] = relu(sum + bias[o]) with dropout (kept when
// rng_bits_from_key(key[b], lane0 + o) < thresh, then / keep; keep 1: no
// dropout), 0 for o >= valid.
enum { EPI_STORE = 0, EPI_PRENET = 1 };

struct K2Epi {
  int mode;
  float* out;
  int ldo;
  const float* bias;
  int valid;
  const uint32_t* key;
  uint32_t lane0, thresh;
  float keep;
};

// A block's product over its weight slice: epi(b, o, sum_k x[b * ldx + k] *
// W[o * ldw + k]) for b < nb, o < no, k < K (a multiple of 4; x and W rows
// 16-byte aligned).  A tile is 4 rows x 2 outputs, so each weight read
// serves four rows; the K range of a tile is split over ks adjacent lanes
// (a power of two, as many as the block's threads allow), whose sums meet
// by shuffles.  The trip count is the same for every thread of a warp.
__device__ __forceinline__ void k2_product(const float* x, int ldx, int nb, const float* W, int ldw, int no, int K,
                                        K2Epi e) {
  const int nob = (no + 1) >> 1, nbb = (nb + 3) >> 2, K4 = K >> 2, tiles = nob * nbb;
  int ks = 1;
  while (ks < 32 && 2 * ks <= K4 && 2 * ks * tiles <= TR_THREADS) ks *= 2;
  const int span = tiles * ks;
  for (int base = 0; base < span; base += TR_THREADS) {
    const int t = base + threadIdx.x;
    const bool live = t < span;
    const int tile = live ? t / ks : 0, kk = t % ks;
    const int o0 = 2 * (tile % nob), b0 = 4 * (tile / nob);
    const float4* w0 = reinterpret_cast<const float4*>(W + (size_t)o0 * ldw);
    const float4* w1 = reinterpret_cast<const float4*>(W + (size_t)tr_min(o0 + 1, no - 1) * ldw);
    const float4* xr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) xr[r] = reinterpret_cast<const float4*>(x + (size_t)tr_min(b0 + r, nb - 1) * ldx);
    float a[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    if (live) {
      for (int k = kk; k < K4; k += ks) {
        const float4 u0 = w0[k], u1 = w1[k];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v = xr[r][k];
          a[0][r] = fmaf(v.x, u0.x, fmaf(v.y, u0.y, fmaf(v.z, u0.z, fmaf(v.w, u0.w, a[0][r]))));
          a[1][r] = fmaf(v.x, u1.x, fmaf(v.y, u1.y, fmaf(v.z, u1.z, fmaf(v.w, u1.w, a[1][r]))));
        }
      }
    }
    for (int off = ks >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[0][r] += __shfl_xor_sync(0xffffffffu, a[0][r], off);
        a[1][r] += __shfl_xor_sync(0xffffffffu, a[1][r], off);
      }
    }
    if (live && kk == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = o0 + j;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int b = b0 + r;
          if (b >= nb || o >= no) continue;
          float* p = e.out + (size_t)b * e.ldo + o;
          float v = a[j][r];
          if (e.mode == EPI_PRENET) {
            v = o < e.valid ? fmaxf(v + e.bias[o], 0.0f) : 0.0f;
            if (e.keep < 1.0f) v = rng_bits_from_key(e.key[b], e.lane0 + (uint32_t)o) < e.thresh ? v / e.keep : 0.0f;
          }
          *p = v;
        }
      }
    }
  }
}

// softplus as torch computes it (threshold 20).
__device__ __forceinline__ float k2_softplus(float x) { return x > 20.0f ? x : log1pf(expf(x)); }

// (max, sum of exp(x - max)) of two sets of energies, merged; an empty set
// is (-inf, 0).
__device__ __forceinline__ float2 k2_stats_merge(float2 a, float2 b) {
  const float M = fmaxf(a.x, b.x);
  if (M == -INFINITY) return make_float2(M, 0.0f);
  return make_float2(M, a.y * expf(a.x - M) + b.y * expf(b.x - M));
}

// The softmax statistics of the block's energies, one reduction; every
// thread gets the result.  ``red`` is 64 floats of shared scratch.
__device__ inline float2 k2_block_stats(float2 v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = k2_stats_merge(v, make_float2(__shfl_xor_sync(0xffffffffu, v.x, o), __shfl_xor_sync(0xffffffffu, v.y, o)));
  if (lane == 0) {
    red[warp] = v.x;
    red[32 + warp] = v.y;
  }
  __syncthreads();
  if (warp == 0) {
    float2 u = lane < TR_WARPS ? make_float2(red[lane], red[32 + lane]) : make_float2(-INFINITY, 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      u = k2_stats_merge(u, make_float2(__shfl_xor_sync(0xffffffffu, u.x, o), __shfl_xor_sync(0xffffffffu, u.y, o)));
    __syncwarp();
    if (lane == 0) {
      red[0] = u.x;
      red[1] = u.y;
    }
  }
  __syncthreads();
  const float2 r = make_float2(red[0], red[1]);
  __syncthreads();
  return r;
}

// (max, first index) of the block's values, lowest index on ties (as
// jnp.argmax); an empty thread holds (-inf, INT_MAX).  Every thread gets the
// result.  ``red`` is 64 floats of shared scratch.
__device__ inline void k2_block_argmax(float& v, int& i, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto take = [](float& v, int& i, float v2, int i2) {
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  };
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) take(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
  if (lane == 0) {
    red[warp] = v;
    red[32 + warp] = __int_as_float(i);
  }
  __syncthreads();
  if (warp == 0) {
    float u = lane < TR_WARPS ? red[lane] : -INFINITY;
    int j = lane < TR_WARPS ? __float_as_int(red[32 + lane]) : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) take(u, j, __shfl_xor_sync(0xffffffffu, u, o), __shfl_xor_sync(0xffffffffu, j, o));
    __syncwarp();
    if (lane == 0) {
      red[0] = u;
      red[1] = __int_as_float(j);
    }
  }
  __syncthreads();
  v = red[0];
  i = __float_as_int(red[1]);
  __syncthreads();
}

// The branches' numbers, fixed for the launch.
struct K2Attn {
  float cw;                     // the conv input's carry: 1 (forward; LSA with cumulative_weights), else 0
  int back, ahead;              // LSA synthesis window [prev - back, prev + ahead)
  int dwell_first, dwell_rest;  // anti-repeat (cfg.dwell_limit_first, dwell_limit_rest)
  int need;                     // stop flags of a step that finish a row: 1 (any of r) or r (all)
};

// What the softmax (or, SMOOTH, the normalised sigmoid) takes at position t
// from energy e: -1e9 (or 0) outside the mask and, WIN, outside the window
// around the previous argmax pm (models/attention.py lsa_step).
template <bool SMOOTH, bool WIN>
__device__ __forceinline__ float k2_score(float e, float m, int t, int pm, const K2Attn& at) {
  const bool valid = !WIN || (t >= pm - at.back && t < pm + at.ahead);
  if (SMOOTH) return valid ? sigmoidf_(e) * m : 0.0f;
  return valid && m > 0.0f ? e : -1e9f;
}

// Anti-repeat, by thread 0 of each block of a row once the row's blocks
// have put their (max, index) of the recursion in red[8..9] and their
// recursion values in en[] (models/attention.py anti_repeat_constrain):
// the row's argmax (merged in rank order, the lowest index on ties), the
// new max_attention m and dwell counter (red[10..11], alike in every block
// of the row), and the support of the constrained alignment, at most six
// positions (the window [m-2, m+3) and the bin clip(m)), with its weights
// normalised: sup[0..5] positions, sup[8..13] weights, sup[16] the count.
// Every block of the row computes the same support from the same values in
// the same order.
__device__ void k2_anti_repeat(cg::cluster_group& cl, float* red, float* sup, float* en, int rank0, int bpr, int nT,
                               int T_in, const K2Attn& at) {
  float bv = -INFINITY;
  int arg = 0x7fffffff;
  for (int j = 0; j < bpr; ++j) {
    const float* o = cl.map_shared_rank(red, rank0 + j);
    if (o[8] > bv) {
      bv = o[8];
      arg = __float_as_int(o[9]);
    }
  }
  const int pm = __float_as_int(red[10]), pp = __float_as_int(red[11]);
  int m = arg <= pm ? pm : pm + 1;
  if (pp < at.dwell_first && m > 2) m = pm;
  int p = m == pm ? pp + 1 : 1;
  if (p >= at.dwell_rest) {
    m += 1;
    p = 1;
  }
  red[10] = __int_as_float(m);
  red[11] = __int_as_float(p);
  const int lo = tr_max(m - 2, 0), hi = tr_min(m + 3, T_in), cm = tr_min(tr_max(m, 0), T_in - 1);
  float s = 0.0f;
  for (int t = lo; t < hi; ++t) s += cl.map_shared_rank(en, rank0 + t / nT)[t % nT];
  const float boost = 2.0f * (s < 1e-10f ? 1.0f : s);
  int n = 0;
  float tot = 0.0f;
  for (int t = lo; t < hi; ++t) {
    const float v = t == cm ? boost : cl.map_shared_rank(en, rank0 + t / nT)[t % nT];
    sup[n] = __int_as_float(t);
    sup[8 + n] = v;
    tot += v;
    ++n;
  }
  if (cm < lo || cm >= hi) {
    sup[n] = __int_as_float(cm);
    sup[8 + n] = boost;
    tot += boost;
    ++n;
  }
  for (int k = 0; k < n; ++k) sup[8 + k] /= tot;
  sup[16] = __int_as_float(n);
}

struct K2Weights {  // all [out, in] (ops/tacotron_decoder_kernel.py pack_weights)
  const float *pre_w1, *pre_b1, *pre_w2, *pre_b2;   // [P1, 80], [P1], [P2, P1], [P2]
  const float *l1, *l1_b, *l2, *l2_b;               // [4U, P2 + V + U], [4U], [4U, 2U], [4U]
  const float *wq, *w_comb, *b_comb, *att_v, *att_b;  // [A, U], [taps, A], [A], [A], [A]
  const float *proj, *proj_b;                       // [NP, U + V], [NP]: last frame | stops | mu
  const float *wx, *wx_b;                           // [TR_CLUSTER, NX, LKP] rank slices, [NX]: the other frames
  // GMM: wd [TR_CLUSTER, 3N, LKP] rank slices of gmm_layer over [out2 | ctx], wd_b [3N]; Graves: wd
  // layer1 [H1, U], wd_b [H1], wd2 layer2 [3N, H1], wd2_b [3N]
  const float *wd, *wd_b, *wd2, *wd2_b;
};

struct K2Io {
  const float *keys, *values, *mask;  // [B, T_in, A] (forward and LSA), [B, T_in, V], [B, T_in]
  const int* seeds;                   // [B]
  float *frames, *stops, *aligns;     // [max_iters, B, 80r], [max_iters, B, r], [max_iters, B, T_in]
  float *g1, *g2, *ctx;               // exchange: [B, 4U], [B, 4U], [B, V]
};

// The layout arrives as a kernel parameter, in the constant bank: computed in
// the kernel and held in registers across the step loop, its offsets made
// the kernel spill (512 threads leave 128 registers a thread).
template <int MODE, bool ANTI, bool SMOOTH, bool WIN>
__global__ void __launch_bounds__(TR_THREADS, 1)
tacotron_decode_kernel(K2Weights w, K2Io io, K2Dims d, K2Plan pl, K2Layout L, K2Attn at, int max_iters, float zo,
                       float zo_keep, float drop_keep, uint32_t drop_thresh, unsigned* counter) {
  static_assert(MODE == K2_LSA || !WIN, "the synthesis window is LSA's");
  static_assert(MODE == K2_FORWARD || !ANTI, "anti-repeat is forward attention's");
  static_assert(MODE <= K2_LSA || !SMOOTH, "GMM and Graves do not smooth");
  constexpr bool LOC = MODE <= K2_LSA;  // location-sensitive: keys, the location conv, wq
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const K2Ld ld = k2_ld(d, pl);
  const K2Role R = k2_role(d, pl);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = d.B, T_in = d.T_in, P1 = d.P1, P2 = d.P2, U = d.U, V = d.V, A = d.A, taps = d.taps, r = d.r;
  const int padl = (taps - 1) / 2, Ku = pl.Ku, Kp = pl.Kp, Kv = pl.Kv, K1p = pl.K1p, uc = pl.uc, ng = 4 * uc;
  const int LK1 = ld.LK1, LK2 = ld.LK2, LKP = ld.LKP, LKM = ld.LKM, LKG = ld.LKG, LDP = ld.LDP, LDX = ld.LDX;
  const int K1 = LK1 - 4, K2 = LK2 - 4, KP = LKP - 4, NP = pl.NP, FR = NMEL * r, N = d.N;
  const int nku = R.ku.n(), nou = R.ou.n(), nv = R.rv.n(), bpr = pl.bpr, rank0 = R.rank0;
  const int b = R.row, t0 = R.pos.lo, n_own = R.pos.n(), nT = pl.nT;
  const Range ku = R.ku, cu = R.cu, r1 = R.r1, r2 = R.r2, rv = R.rv;
  float *w1 = sm + L.w1, *w2 = sm + L.w2, *wq = sm + L.wq, *wp = sm + L.wp, *wp1 = sm + L.wp1, *wp2 = sm + L.wp2;
  float *wc = sm + L.wc, *b1 = sm + L.b1, *b2 = sm + L.b2, *pb = sm + L.pb, *vsm = sm + L.v, *eb = sm + L.eb;
  float *c1 = sm + L.st, *h1 = c1 + B * Ku, *c2 = h1 + B * Ku, *h2 = c2 + B * Ku;
  float *xs = sm + L.xs, *gin = sm + L.gin, *part = sm + L.part, *fr = sm + L.fr, *mu = sm + L.mu;
  float *done = sm + L.done, *pqp = sm + L.pqp, *pqv = sm + L.pq, *cum = sm + L.cum, *alpha = sm + L.alpha;
  float *en = sm + L.en, *asm_ = sm + L.asm_, *ctxp = sm + L.ctxp, *red = sm + L.red, *bred = sm + L.bred;
  float *wd = sm + L.wd, *wd2 = sm + L.wd2, *dq = sm + L.dq, *dh = sm + L.dh, *dg = sm + L.dg, *dr = sm + L.dr;
  float* mix = sm + L.mix;
  uint32_t *seed = reinterpret_cast<uint32_t*>(sm + L.seed), *key = reinterpret_cast<uint32_t*>(sm + L.key);

  // prologue: the weight slices, for the whole decode
  auto gate_row = [=](int o) {  // output o: gate o / uc of the cluster's unit o % uc
    const int g = o / uc, j = cu.lo + o - g * uc;
    return j < cu.hi ? g * U + j : -1;
  };
  tr_load_slice(w1, ng, LK1, w.l1, P2 + V + U, gate_row, [=](int k) {
    if (k < Kp) return r2.lo + k < r2.hi ? r2.lo + k : -1;
    if (k < Kp + Kv) return rv.lo + k - Kp < rv.hi ? P2 + rv.lo + k - Kp : -1;
    if (k < Kp + Kv + Ku) return k - Kp - Kv < nku ? P2 + V + ku.lo + k - Kp - Kv : -1;
    return -1;
  });
  tr_load_slice(w2, ng, LK2, w.l2, 2 * U, gate_row, [=](int k) {
    if (k < Ku) return k < nku ? ku.lo + k : -1;
    if (k < 2 * Ku) return k - Ku < nku ? U + ku.lo + k - Ku : -1;
    return -1;
  });
  if (LOC)
    for (int i = tid; i < Ku * A; i += TR_THREADS) {  // wq is [A, U]: the slice is its K-units' columns, [Ku, A]
      const int u = i / A, a = i - u * A;
      wq[i] = u < nku ? __ldg(w.wq + (size_t)a * U + ku.lo + u) : 0.0f;
    }
  if (MODE == K2_GMM && pl.res)  // the rank's packed slice
    for (int i = tid; i < 3 * N * LKP; i += TR_THREADS) wd[i] = __ldg(w.wd + (size_t)R.q * 3 * N * LKP + i);
  if (MODE == K2_GRAVES) {
    const int H1 = pl.H1, c3 = pl.c3, LKQ = ld.LKQ, LKH = ld.LKH;
    tr_load_slice(wd, H1, LKQ, w.wd, U, [](int o) { return o; }, [=](int k) { return k < nku ? ku.lo + k : -1; });
    tr_load_slice(wd2, c3, LKH, w.wd2, H1, [=](int o) { return R.q * c3 + o < 3 * N ? R.q * c3 + o : -1; },
                  [=](int k) { return k < H1 ? k : -1; });
  }
  tr_load_slice(wp, NP, LKP, w.proj, U + V, [](int o) { return o; }, [=](int k) {
    if (k < Ku) return k < nku ? ku.lo + k : -1;
    return rv.lo + k - Ku < rv.hi ? U + rv.lo + k - Ku : -1;
  });
  tr_load_slice(wp1, K1p, LKM, w.pre_w1, NMEL, [=](int o) { return r1.lo + o < r1.hi ? r1.lo + o : -1; },
                [](int k) { return k < NMEL ? k : -1; });
  tr_load_slice(wp2, Kp, LKG, w.pre_w2, P1, [=](int o) { return r2.lo + o < r2.hi ? r2.lo + o : -1; },
                [=](int k) { return k < P1 ? k : -1; });
  if (LOC)
    for (int i = tid; i < taps * A; i += TR_THREADS) wc[i] = __ldg(w.w_comb + i);
  for (int i = tid; i < K1p; i += TR_THREADS) b1[i] = r1.lo + i < r1.hi ? __ldg(w.pre_b1 + r1.lo + i) : 0.0f;
  for (int i = tid; i < Kp; i += TR_THREADS) b2[i] = r2.lo + i < r2.hi ? __ldg(w.pre_b2 + r2.lo + i) : 0.0f;
  for (int i = tid; i < LDP; i += TR_THREADS) pb[i] = i < NP ? __ldg(w.proj_b + i) : 0.0f;
  if (LOC)
    for (int a = tid; a < A; a += TR_THREADS) {
      vsm[a] = __ldg(w.att_v + a);
      eb[a] = __ldg(w.b_comb + a) + __ldg(w.att_b + a);
    }
  // state: LSTMs at zero, the go frame, mu 0.5, nothing done; forward attention starts alpha and cum
  // one-hot at position 0, LSA its alignment at zeros, GMM kappa and Graves mu at zeros; max_attention
  // and the dwell counter at 0
  for (int i = tid; i < 4 * B * Ku; i += TR_THREADS) c1[i] = 0.0f;
  for (int i = tid; i < B * LK1; i += TR_THREADS) xs[i] = 0.0f;
  for (int i = tid; i < B * LDP; i += TR_THREADS) fr[i] = 0.0f;
  for (int i = tid; i < B; i += TR_THREADS) {
    mu[i] = 0.5f;
    done[i] = 0.0f;
    seed[i] = (uint32_t)__ldg(io.seeds + i);
    key[i] = rng_key(seed[i], 0u, 0u);
  }
  const float one0 = MODE == K2_FORWARD ? 1.0f : 0.0f;
  if (LOC) {
    for (int i = tid; i < n_own; i += TR_THREADS) alpha[i] = t0 + i == 0 ? one0 : 0.0f;
    for (int e = tid; e < n_own + taps - 1; e += TR_THREADS) cum[e] = t0 - padl + e == 0 ? one0 : 0.0f;
  }
  for (int k = tid; k < N; k += TR_THREADS) mix[k] = 0.0f;
  if (tid == 0) red[10] = red[11] = __int_as_float(0);
  unsigned target = 0;
  int n_run = max_iters;  // steps run before every row was done
  __syncthreads();

  for (int s = 0; s < max_iters; ++s) {
    // 1. prenet 1: the rank's outputs for all rows, from the last frame
    k2_product(fr, LDP, B, wp1, LKM, K1p, NMEL,
               K2Epi{EPI_PRENET, gin + r1.lo, LKG, b1, r1.n(), key, (uint32_t)r1.lo, drop_thresh, drop_keep});
    cl.sync();
    // 1b. gather the other ranks' prenet-1 outputs; prenet 2 of the rank's pre2 K-slice
    for (int k = tid; k < B * P1; k += TR_THREADS) {
      const int bb = k / P1, i = k - bb * P1, j = i / K1p;
      if (j != R.q) gin[bb * LKG + i] = cl.map_shared_rank(gin, j)[bb * LKG + i];
    }
    __syncthreads();
    k2_product(gin, LKG, B, wp2, LKG, Kp, P1,
               K2Epi{EPI_PRENET, xs, LK1, b2, r2.n(), key, (uint32_t)(P1 + r2.lo), drop_thresh, drop_keep});
    for (int k = tid; k < B * (LK1 - Kp - Kv); k += TR_THREADS) {  // h1 of the K-units, then zeros
      const int bb = k / (LK1 - Kp - Kv), i = k - bb * (LK1 - Kp - Kv);
      xs[bb * LK1 + Kp + Kv + i] = i < nku ? h1[bb * Ku + i] : 0.0f;
    }
    __syncthreads();
    // 1c. g1 partials over x1 = [pre2 | ctx | h1] slices, merged in the cluster
    k2_product(xs, LK1, B, w1, LK1, ng, K1, K2Epi{EPI_STORE, part, ng});
    cl.sync();
    for (int k = tid; k < B * nou * 4; k += TR_THREADS) {
      const int bb = k / (nou * 4), rest = k - bb * nou * 4, g = rest / nou, j = R.ou.lo + rest % nou;
      io.g1[(size_t)bb * 4 * U + g * U + j] = tr_merge(cl, part, bb * ng + g * uc + j - cu.lo) + __ldg(w.l1_b + g * U + j);
    }
    // barrier 1
    grid_barrier(counter, target += pl.G);
    // 2. LSTM1 of the K-units, all rows; x2 = [out1 | h2]; g2 partials, merged in the cluster
    for (int k = tid; k < B * Ku; k += TR_THREADS) {
      const int bb = k / Ku, i = k - bb * Ku;
      float* x = xs + bb * LK2;
      if (i >= nku) {
        x[i] = x[Ku + i] = 0.0f;
        continue;
      }
      const float* g1 = io.g1 + (size_t)bb * 4 * U + ku.lo + i;
      const Gates q = tr_gates4(__ldcg(g1), __ldcg(g1 + U), __ldcg(g1 + 2 * U), __ldcg(g1 + 3 * U));
      const float cp = c1[k], hp = h1[k];
      const float nc = q.sf * cp + q.si * q.tj;
      const float nh = q.so * tanhf(nc);
      c1[k] = zo_keep * nc + zo * cp;
      h1[k] = zo_keep * nh + zo * hp;
      x[i] = nh;
      x[Ku + i] = h2[k];
    }
    for (int k = tid; k < B * (LK2 - 2 * Ku); k += TR_THREADS) {
      const int bb = k / (LK2 - 2 * Ku);
      xs[bb * LK2 + 2 * Ku + k - bb * (LK2 - 2 * Ku)] = 0.0f;
    }
    __syncthreads();
    k2_product(xs, LK2, B, w2, LK2, ng, K2, K2Epi{EPI_STORE, part, ng});
    cl.sync();
    for (int k = tid; k < B * nou * 4; k += TR_THREADS) {
      const int bb = k / (nou * 4), rest = k - bb * nou * 4, g = rest / nou, j = R.ou.lo + rest % nou;
      io.g2[(size_t)bb * 4 * U + g * U + j] = tr_merge(cl, part, bb * ng + g * uc + j - cu.lo) + __ldg(w.l2_b + g * U + j);
    }
    // barrier 2
    grid_barrier(counter, target += pl.G);
    // 3. LSTM2 of the K-units -> out2 (the projection's first inputs)
    for (int k = tid; k < B * Ku; k += TR_THREADS) {
      const int bb = k / Ku, i = k - bb * Ku;
      if (i >= nku) {
        gin[bb * LKP + i] = 0.0f;
        continue;
      }
      const float* g2 = io.g2 + (size_t)bb * 4 * U + ku.lo + i;
      const Gates q = tr_gates4(__ldcg(g2), __ldcg(g2 + U), __ldcg(g2 + 2 * U), __ldcg(g2 + 3 * U));
      const float cp = c2[k], hp = h2[k];
      const float nc = q.sf * cp + q.si * q.tj;
      const float nh = q.so * tanhf(nc);
      c2[k] = zo_keep * nc + zo * cp;
      h2[k] = zo_keep * nh + zo * hp;
      gin[bb * LKP + i] = nh;
    }
    if (MODE == K2_GMM) {  // the previous context's K-slice beside out2 (this cluster's rows wrote it)
      const int row0 = R.c * pl.rpc, nr = tr_max(0, tr_min(pl.rpc, B - row0));
      for (int k = tid; k < nr * (LKP - Ku); k += TR_THREADS) {
        const int bb = row0 + k / (LKP - Ku), i = k % (LKP - Ku);
        gin[bb * LKP + Ku + i] = s > 0 && i < nv ? __ldcg(io.ctx + (size_t)bb * V + rv.lo + i) : 0.0f;
      }
    }
    __syncthreads();
    // 3b. partial pq (GMM: gmm_layer; Graves: layer1 -> relu -> layer2) of the cluster's rows
    if (LOC) {
      for (int k = tid; k < pl.rpc * A; k += TR_THREADS) {
        const int rr = k / A, a = k - rr * A, bb = R.c * pl.rpc + rr;
        float acc = 0.0f;
        if (bb < B)
          for (int i = 0; i < nku; ++i) acc = fmaf(gin[bb * LKP + i], wq[i * A + a], acc);
        pqp[k] = acc;
      }
    } else {
      const int row0 = R.c * pl.rpc, nr = tr_max(0, tr_min(pl.rpc, B - row0));
      if (MODE == K2_GMM && pl.res) {  // two calls: each product reads one memory space
        k2_product(gin + row0 * LKP, LKP, nr, wd, LKP, 3 * N, KP, K2Epi{EPI_STORE, dq, ld.LDG});
      } else if (MODE == K2_GMM) {
        k2_product(gin + row0 * LKP, LKP, nr, w.wd + (size_t)R.q * 3 * N * LKP, LKP, 3 * N, KP,
                   K2Epi{EPI_STORE, dq, ld.LDG});
      } else {
        const int LKH = ld.LKH, c3 = pl.c3;
        k2_product(gin + row0 * LKP, LKP, nr, wd, ld.LKQ, pl.H1, ld.LKQ - 4, K2Epi{EPI_STORE, dq, LKH});
        cl.sync();
        for (int k = tid; k < nr * LKH; k += TR_THREADS) {  // relu(layer1), merged in rank order
          const int j = k % LKH;
          dh[k] = j < pl.H1 ? fmaxf(tr_merge(cl, dq, k) + __ldg(w.wd_b + j), 0.0f) : 0.0f;
        }
        __syncthreads();
        const Range o3 = tr_range(R.q, c3, 3 * N);  // the rank's layer2 outputs
        k2_product(dh, LKH, nr, wd2, LKH, o3.n(), LKH - 4, K2Epi{EPI_STORE, dg + o3.lo, ld.LDG});
      }
    }
    cl.sync();
    // 4. attention of the rows: energies (scores; Graves: the head sums at the edges) and their
    // statistics over the slice
    float2 st = make_float2(-INFINITY, 0.0f);
    if (b >= 0 && !LOC) {
      const int rr = R.q / bpr;
      if (MODE == K2_GMM) {  // alpha / beta, beta and kappa of the row, merged in rank order
        for (int k = tid; k < N; k += TR_THREADS) {
          const float al = expf(tr_merge(cl, dq, rr * ld.LDG + k) + __ldg(w.wd_b + k));
          const float be = expf(tr_merge(cl, dq, rr * ld.LDG + N + k) + __ldg(w.wd_b + N + k));
          mix[k] += expf(tr_merge(cl, dq, rr * ld.LDG + 2 * N + k) + __ldg(w.wd_b + 2 * N + k));
          dr[k] = al / be;
          dr[N + k] = be;
        }
      } else {  // gbk of the row from the ranks' layer2 columns; g, sig and mu by warp 0, in one order
        for (int j = tid; j < 3 * N; j += TR_THREADS)
          dr[j] = cl.map_shared_rank(dg, j / pl.c3)[rr * ld.LDG + j] + __ldg(w.wd2_b + j);
        __syncthreads();
        if (warp == 0) {
          float m = -INFINITY, z = 0.0f;
          for (int h = lane; h < N; h += 32) m = fmaxf(m, dr[h]);
          m = warp_max(m);
          for (int h = lane; h < N; h += 32) z += expf(dr[h] - m);
          z = warp_sum(z);
          for (int h = lane; h < N; h += 32) {
            dr[h] = expf(dr[h] - m) / z + 1e-5f;
            dr[N + h] = k2_softplus(dr[N + h]) + 1e-5f;
            mix[h] += k2_softplus(dr[2 * N + h]);
          }
        }
      }
      __syncthreads();
      const float* mask = io.mask + (size_t)b * T_in;
      if (MODE == K2_GMM) {
        for (int i = tid; i < n_own; i += TR_THREADS) {
          const float t = (float)(t0 + i);
          float sc = 0.0f;
#pragma unroll 1
          for (int k = 0; k < N; ++k) {
            const float dd = mix[k] - t;
            sc += dr[k] * expf(-(dd * dd) / dr[N + k]);
          }
          en[i] = __ldg(mask + t0 + i) > 0.0f ? sc : -1e9f;
        }
      } else {
        for (int e = tid; e <= n_own; e += TR_THREADS) {
          const float edge = (float)(t0 + e) + 0.5f;
          float sc = 0.0f;
#pragma unroll 1
          for (int h = 0; h < N; ++h) sc += dr[h] * (1.0f / (1.0f + sigmoidf_((mix[h] - edge) / dr[N + h])));
          en[e] = sc;
        }
      }
      __syncthreads();
      if (MODE == K2_GMM) {
        float2 ms = make_float2(-INFINITY, 0.0f);
        for (int i = tid; i < n_own; i += TR_THREADS) ms = k2_stats_merge(ms, make_float2(en[i], 1.0f));
        st = k2_block_stats(ms, bred);
      }
    }
    if (b >= 0 && LOC) {
      const int rr = R.q / bpr;
      for (int a = tid; a < A; a += TR_THREADS) {
        float acc = 0.0f;
        for (int j = 0; j < TR_CLUSTER; ++j) acc += cl.map_shared_rank(pqp, j)[rr * A + a];
        pqv[a] = acc + eb[a];
      }
      __syncthreads();
      const float* keys = io.keys + (size_t)b * T_in * A;
      const float* mask = io.mask + (size_t)b * T_in;
      const int pm = __float_as_int(red[10]);  // the row's previous argmax (the window's centre)
      for (int i = warp; i < n_own; i += 2 * TR_WARPS) {  // two positions a warp: each filter read serves both
        const int i2 = i + TR_WARPS < n_own ? i + TR_WARPS : i;
        const int t = t0 + i, t2 = t0 + i2;
        float e = 0.0f, e2 = 0.0f;
        for (int a0 = lane; a0 < A; a0 += 128) {  // four columns per lane
          float loc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, loc2[4] = {0.0f, 0.0f, 0.0f, 0.0f}, kv[4], kv2[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int a = tr_min(a0 + 32 * m, A - 1);
            kv[m] = __ldg(keys + (size_t)t * A + a);
            kv2[m] = __ldg(keys + (size_t)t2 * A + a);
          }
          for (int j = 0; j < taps; ++j) {
            const float x = cum[i + j], x2 = cum[i2 + j];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              if (a0 + 32 * m < A) {
                const float wv = wc[j * A + a0 + 32 * m];
                loc[m] = fmaf(x, wv, loc[m]);
                loc2[m] = fmaf(x2, wv, loc2[m]);
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
          en[i] = k2_score<SMOOTH, WIN>(e, __ldg(mask + t), t, pm, at);
          en[i2] = k2_score<SMOOTH, WIN>(e2, __ldg(mask + t2), t2, pm, at);  // i2 == i when one position is left
        }
      }
      __syncthreads();
      if (SMOOTH) {  // the normaliser is the plain sum of the scores
        float ps = 0.0f;
        for (int i = tid; i < n_own; i += TR_THREADS) ps += en[i];
        st = make_float2(0.0f, tr_block_sum2(ps, 0.0f, bred).x);
      } else {
        float2 ms = make_float2(-INFINITY, 0.0f);
        for (int i = tid; i < n_own; i += TR_THREADS) ms = k2_stats_merge(ms, make_float2(en[i], 1.0f));
        st = k2_block_stats(ms, bred);
      }
    }
    if (tid == 0) {
      red[0] = st.x;
      red[1] = st.y;
    }
    if (bpr > 1 && MODE != K2_GRAVES) cl.sync(); else __syncthreads();
    // 4b. the row's softmax; forward: the recursion; LSA, GMM: the alignment itself; Graves: the
    // differences of the edges
    float s2 = 0.0f;
    if (b >= 0) {
      if (tid == 0 && MODE != K2_GRAVES) {
        float2 M = make_float2(-INFINITY, 0.0f);
        for (int j = 0; j < bpr; ++j) {
          const float* o = cl.map_shared_rank(red, rank0 + j);
          M = SMOOTH ? make_float2(0.0f, M.y + o[1]) : k2_stats_merge(M, make_float2(o[0], o[1]));
        }
        red[4] = M.x;
        red[5] = M.y;
        // alpha at the position before the slice: the last step's, held by the previous slice's block
        if (MODE == K2_FORWARD) red[6] = (t0 == 0 || n_own == 0) ? 0.0f : cl.map_shared_rank(alpha, rank0 + R.sl - 1)[nT - 1];
      }
      __syncthreads();
      const float M = red[4], Zs = red[5];
      float* al_out = io.aligns + ((size_t)s * B + b) * T_in +
                      (MODE == K2_GMM ? (size_t)(unsigned)t0 : (size_t)t0);  // GMM: a signed t0's sign word spilled
      float bv = -INFINITY, part_s = 0.0f;
      int bi = 0x7fffffff;
      if (MODE == K2_FORWARD) {
        const float aprev = red[6], mb = mu[b];
        for (int i = tid; i < n_own; i += TR_THREADS) {
          const float a_sm = SMOOTH ? en[i] / Zs : expf(en[i] - M) / Zs;
          asm_[i] = a_sm;
          const float shifted = i > 0 ? alpha[i - 1] : aprev;
          const float pre = ((1.0f - mb) * alpha[i] + mb * shifted + 1e-10f) * a_sm;
          en[i] = pre;
          if (ANTI) {
            if (pre > bv) {
              bv = pre;
              bi = t0 + i;
            }
          } else {
            part_s += pre;
          }
        }
      } else if (MODE == K2_GRAVES) {
        const float* mask = io.mask + (size_t)b * T_in + t0;
        for (int i = tid; i < n_own; i += TR_THREADS) {
          const float a = __ldg(mask + i) > 0.0f ? en[i + 1] - en[i] : 1e-20f;
          asm_[i] = a;
          al_out[i] = a;
        }
      } else {
        for (int i = tid; i < n_own; i += TR_THREADS) {
          const float a = SMOOTH ? en[i] / Zs : expf(en[i] - M) / Zs;
          asm_[i] = a;
          al_out[i] = a;
          if (WIN && a > bv) {
            bv = a;
            bi = t0 + i;
          }
        }
      }
      if (ANTI || WIN) {  // the block's (max, index): anti-repeat's recursion, the window's alignment
        k2_block_argmax(bv, bi, bred);
        if (tid == 0) {
          red[8] = bv;
          red[9] = __int_as_float(bi);
        }
      }
      if (MODE == K2_FORWARD && !ANTI) s2 = tr_block_sum2(part_s, 0.0f, bred).x;  // also publishes en[]
      if (MODE != K2_FORWARD && !WIN) __syncthreads();                          // publishes asm_[]
      if (!ANTI) {  // the context before (forward) or after (the others) the row's normalisation
        const float* src = MODE == K2_FORWARD ? en : asm_;
        const float* values = io.values + ((size_t)b * T_in + t0) * V;
        for (int v = tid; v < V; v += TR_THREADS) {
          float acc = 0.0f;
#pragma unroll 8
          for (int i = 0; i < n_own; ++i) acc = fmaf(src[i], __ldg(values + (size_t)i * V + v), acc);
          ctxp[v] = acc;
        }
      }
    }
    if (tid == 0) red[2] = s2;
    if (bpr > 1) cl.sync(); else __syncthreads();
    // 4c. normalise (forward), constrain (anti-repeat), cumulate, merge the context
    if (b >= 0) {
      const Range vs = tr_range(R.sl, tr_cdiv(V, bpr), V);  // context entries this block merges
      float* al_out = io.aligns + ((size_t)s * B + b) * T_in + t0;
      if (ANTI) {
        if (tid == 0) k2_anti_repeat(cl, red, bred, en, rank0, bpr, nT, T_in, at);
        __syncthreads();
        const int ns = __float_as_int(bred[16]);
        for (int i = tid; i < n_own; i += TR_THREADS) {
          float a = 0.0f;
#pragma unroll 1
          for (int k = 0; k < ns; ++k)
            if (__float_as_int(bred[k]) == t0 + i) a = bred[8 + k];
          alpha[i] = a;
          al_out[i] = a;
        }
        const float* values = io.values + (size_t)b * T_in * V;
        for (int v = vs.lo + tid; v < vs.hi; v += TR_THREADS) {
          float acc = 0.0f;
#pragma unroll 1
          for (int k = 0; k < ns; ++k) acc = fmaf(bred[8 + k], __ldg(values + (size_t)__float_as_int(bred[k]) * V + v), acc);
          io.ctx[(size_t)b * V + v] = acc;
        }
      } else {
        float S2 = 1.0f;  // LSA, GMM, Graves: the alignment as it is
        if (MODE == K2_FORWARD) {
          if (tid == 0) {
            float sum = 0.0f;
            for (int j = 0; j < bpr; ++j) sum += cl.map_shared_rank(red, rank0 + j)[2];
            red[7] = sum;
          }
          __syncthreads();
          S2 = red[7];
          for (int i = tid; i < n_own; i += TR_THREADS) {
            const float a = en[i] / S2;
            alpha[i] = a;
            al_out[i] = a;
          }
        }
        if (WIN && tid == 0) {  // the row's argmax, the next step's window centre
          float mv = -INFINITY;
          int mi = 0x7fffffff;
          for (int j = 0; j < bpr; ++j) {
            const float* o = cl.map_shared_rank(red, rank0 + j);
            if (o[8] > mv) {
              mv = o[8];
              mi = __float_as_int(o[9]);
            }
          }
          red[10] = __int_as_float(mi);
        }
        for (int v = vs.lo + tid; v < vs.hi; v += TR_THREADS) {
          float acc = 0.0f;
          for (int j = 0; j < bpr; ++j) acc += cl.map_shared_rank(ctxp, rank0 + j)[v];
          io.ctx[(size_t)b * V + v] = MODE == K2_FORWARD ? acc / S2 : acc;
        }
      }
      if (LOC)
        for (int e = tid; e < n_own + taps - 1; e += TR_THREADS) {  // the slice and its halo
          const int t = t0 - padl + e;
          if (t >= 0 && t < T_in) {
            const int owner = t / nT, li = t - owner * nT;
            cum[e] = at.cw * cum[e] + (owner == R.sl ? asm_[li] : cl.map_shared_rank(asm_, rank0 + owner)[li]);
          }
        }
    }
    // barrier 3
    grid_barrier(counter, target += pl.G);
    // 5. projection partials over [out2 | ctx] slices (the ctx slice is also x1's next input): the
    // on-chip outputs, and this cluster's share of the other frame columns from L2
    for (int k = tid; k < B * (LKP - Ku); k += TR_THREADS) {
      const int bb = k / (LKP - Ku), i = k - bb * (LKP - Ku);
      const float c = i < nv ? __ldcg(io.ctx + (size_t)bb * V + rv.lo + i) : 0.0f;
      gin[bb * LKP + Ku + i] = c;
      if (i < Kv) xs[bb * LK1 + Kp + i] = c;
    }
    __syncthreads();
    k2_product(gin, LKP, B, wp, LKP, NP, KP, K2Epi{EPI_STORE, part, LDX});
    const Range xc = tr_range(R.c, pl.ec, pl.NX);  // the other frame columns this cluster computes
    if (xc.n() > 0)
      k2_product(gin, LKP, B, w.wx + ((size_t)R.q * pl.NX + xc.lo) * LKP, LKP, xc.n(), KP,
                 K2Epi{EPI_STORE, part + LDP, LDX});
    cl.sync();
    for (int k = tid; k < B * NP; k += TR_THREADS) {
      const int bb = k / NP, o = k - bb * NP;
      fr[bb * LDP + o] = tr_merge(cl, part, bb * LDX + o) + pb[o];
    }
    for (int k = R.q * TR_THREADS + tid; k < B * xc.n(); k += TR_CLUSTER * TR_THREADS) {
      const int bb = k / xc.n(), j = k - bb * xc.n();
      io.frames[((size_t)s * B + bb) * FR + xc.lo + j] = tr_merge(cl, part, bb * LDX + LDP + j) + __ldg(w.wx_b + xc.lo + j);
    }
    __syncthreads();
    // 6. outputs, mu and the done flags (every block alike)
    if (R.c == 0) {
      for (int k = R.q * TR_THREADS + tid; k < B * NMEL; k += TR_CLUSTER * TR_THREADS) {
        const int bb = k / NMEL, m = k - bb * NMEL;
        io.frames[((size_t)s * B + bb) * FR + FR - NMEL + m] = fr[bb * LDP + m];
      }
      if (R.q == 0)
        for (int k = tid; k < B * r; k += TR_THREADS) {
          const int bb = k / r;
          io.stops[(size_t)s * B * r + k] = fr[bb * LDP + NMEL + k - bb * r];
        }
    }
    for (int bb = tid; bb < B; bb += TR_THREADS) {
      if (MODE == K2_FORWARD) mu[bb] = sigmoidf_(fr[bb * LDP + NMEL + r]);
      int fired = 0;
      for (int j = 0; j < r; ++j) fired += sigmoidf_(fr[bb * LDP + NMEL + j]) > 0.5f;
      if (fired >= at.need) done[bb] = 1.0f;
      key[bb] = rng_key(seed[bb], 0u, (uint32_t)(s + 1));
    }
    __syncthreads();
    bool all = true;
    for (int bb = 0; bb < B; ++bb) all = all && done[bb] > 0.5f;
    if (all) {
      n_run = s + 1;
      break;
    }
  }
  // every row is done: the remaining steps hold frames 0, stops 1e4 and aligns 0 (the whole grid writes them)
  const size_t s0 = (size_t)n_run, n_left = (size_t)(max_iters - n_run);
  const size_t gi = (size_t)blockIdx.x * TR_THREADS + tid, gs = (size_t)gridDim.x * TR_THREADS;
  for (size_t i = gi; i < n_left * B * FR; i += gs) io.frames[s0 * B * FR + i] = 0.0f;
  for (size_t i = gi; i < n_left * B * r; i += gs) io.stops[s0 * B * r + i] = 1e4f;
  for (size_t i = gi; i < n_left * B * T_in; i += gs) io.aligns[s0 * B * T_in + i] = 0.0f;
  cl.sync();  // no block leaves while a peer may still read its shared memory
}

using K2Kernel = void (*)(K2Weights, K2Io, K2Dims, K2Plan, K2Layout, K2Attn, int, float, float, float, uint32_t,
                          unsigned*);

// The instantiation of a variant: bit 0 LSA, bit 1 anti-repeat, bit 2
// smoothing, bit 3 the synthesis window; 16 GMM, 32 Graves
// (ops/tacotron_decoder_kernel.py k2_variant); nullptr for a combination the
// kernel does not take.
K2Kernel k2_kernel(int variant) {
  switch (variant) {
    case 16: return tacotron_decode_kernel<K2_GMM, false, false, false>;
    case 32: return tacotron_decode_kernel<K2_GRAVES, false, false, false>;
    case 0: return tacotron_decode_kernel<K2_FORWARD, false, false, false>;
    case 2: return tacotron_decode_kernel<K2_FORWARD, true, false, false>;
    case 4: return tacotron_decode_kernel<K2_FORWARD, false, true, false>;
    case 6: return tacotron_decode_kernel<K2_FORWARD, true, true, false>;
    case 1: return tacotron_decode_kernel<K2_LSA, false, false, false>;
    case 5: return tacotron_decode_kernel<K2_LSA, false, true, false>;
    case 9: return tacotron_decode_kernel<K2_LSA, false, false, true>;
    case 13: return tacotron_decode_kernel<K2_LSA, false, true, true>;
    default: return nullptr;
  }
}

// The attention mode (K2_*) of a variant.
int k2_mode(int variant) {
  return variant == 16 ? K2_GMM : variant == 32 ? K2_GRAVES : (variant & 1) ? K2_LSA : K2_FORWARD;
}

}  // namespace

// Bytes of shared memory per block (ops/tacotron_decoder_kernel.py k2_plan
// computes the same; the wrapper checks before every launch).  ``mu`` is 1
// for forward attention (the projection's mu column), else 0; ``mode`` the
// attention (0 forward, 1 LSA, 2 GMM, 3 Graves), ``N`` GMM's mixtures or
// Graves' heads (0 for forward and LSA).
extern "C" int tacotron_decode_smem_bytes(int B, int T_in, int P1, int P2, int U, int V, int A, int taps, int r,
                                          int mu, int mode, int N, int NC) {
  const K2Dims d{B, T_in, P1, P2, U, V, A, taps, r, mu, mode, N};
  return k2_layout(d, k2_plan(d, NC)).total * (int)sizeof(float);
}

// Floats of the global exchange: g1 [B, 4U], g2 [B, 4U], ctx [B, V].
extern "C" int tacotron_decode_scratch_floats(int B, int T_in, int P1, int P2, int U, int V, int A, int taps, int r,
                                              int mu, int mode, int N, int NC) {
  return B * (8 * U + V);
}

static cudaLaunchConfig_t decode_config(cudaLaunchAttribute* at, int G, int smem, cudaStream_t stream) {
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
// one block per SM (asked at TR_SMEM_ONE_PER_SM bytes of shared memory), or
// a negative cudaError_t.  Every variant has the same launch bounds.
extern "C" int tacotron_decode_clusters() {
  const K2Kernel fn = k2_kernel(0);
  cudaError_t err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TR_SMEM_ONE_PER_SM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = decode_config(at, TR_CLUSTER, TR_SMEM_ONE_PER_SM, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Launches the whole decode on ``stream`` as NC clusters of TR_CLUSTER
// blocks.  ``ptrs`` holds 29 device pointers: keys [B, T_in, A] (any
// pointer for GMM and Graves), values [B, T_in, V], mask [B, T_in] (f32),
// seeds [B] (int32); the 21 weights in WEIGHT_ORDER of
// ops/tacotron_decoder_kernel.py (pack_weights: [out, in]; a weight the
// branch does not read, and wx and wx_b at r = 1, may be any pointer);
// frames [max_iters, B, 80r], stops [max_iters, B, r], aligns [max_iters,
// B, T_in]; the exchange [tacotron_decode_scratch_floats(...)].  ``counter``
// is one zeroed uint32.  ``variant`` picks the attention branch (k2_kernel)
// and must be of ``mode``, ``mu`` is 1 when the projection has forward
// attention's mu column, ``N`` GMM's mixtures or Graves' heads (1-128),
// ``need`` the stop policy (1: any of the r flags, r: all),
// ``back``/``ahead`` the LSA window, ``cw`` the LSA carry.  Returns a
// cudaError_t: cudaErrorCooperativeLaunchTooLarge when NC clusters cannot be
// resident together or the rows do not fit, cudaErrorInvalidValue when the
// plan exceeds a block's shared memory or the variant does not exist or
// does not match mode, mu and N, else the launch's own.
extern "C" int tacotron_decode_launch(void* const* ptrs, unsigned* counter, int B, int T_in, int P1, int P2,
                                      int U, int V, int A, int taps, int r, int mu, int mode, int N, int variant,
                                      int max_iters, int NC, int need, int back, int ahead, int dwell_first,
                                      int dwell_rest, float cw, float zoneout, float zoneout_keep, float drop_keep,
                                      uint32_t drop_thresh, void* stream) {
  const K2Kernel fn = k2_kernel(variant);
  if (fn == nullptr || r < 1 || k2_mode(variant) != mode || mu != (mode == K2_FORWARD)) return (int)cudaErrorInvalidValue;
  if (mode <= K2_LSA ? N != 0 : N < 1 || N > 128) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  const K2Weights w{f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11], f[12], f[13], f[14], f[15], f[16],
                    f[17], f[18], f[19], f[20], f[21], f[22], f[23], f[24]};
  float* scratch = static_cast<float*>(ptrs[28]);
  const K2Io io{f[0], f[1], f[2], static_cast<const int*>(ptrs[3]),
                static_cast<float*>(ptrs[25]), static_cast<float*>(ptrs[26]), static_cast<float*>(ptrs[27]),
                scratch, scratch + (size_t)B * 4 * U, scratch + (size_t)B * 8 * U};
  const K2Dims d{B, T_in, P1, P2, U, V, A, taps, r, mu, mode, N};
  const K2Plan pl = k2_plan(d, NC);
  if (pl.bpr == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int smem = k2_layout(d, pl).total * (int)sizeof(float);
  if (smem > TR_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = decode_config(at, pl.G, smem, (cudaStream_t)stream);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n < NC) return (int)cudaErrorCooperativeLaunchTooLarge;
  const K2Attn attn{cw, back, ahead, dwell_first, dwell_rest, need};
  err = cudaLaunchKernelEx(&cfg, fn, w, io, d, pl, k2_layout(d, pl), attn, max_iters, zoneout, zoneout_keep,
                           drop_keep, drop_thresh, counter);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
