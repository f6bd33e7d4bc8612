// WaveRNN RAW sample loop (K1): one cooperative grid runs every step of the
// serial loop.
//
// Replaces the TPU kernel tacotronv2_wavernn_chinese_tpu/ops/wavernn_kernel.py
// (generate_pallas, _kernel): per step and fold, the I projection of
// [x, mel, a1] -> GRU1 + residual -> GRU2 on [x, a2] + residual -> fc1 ReLU
// on [x, a3] -> fc2 ReLU on [x, a4] -> fc3 logits -> Gumbel-argmax (or
// greedy argmax) -> feed back 2*l/(n-1) - 1.
//
// The chain I -> GRU1 -> GRU2 -> fc1 -> fc2 -> fc3 -> argmax -> x is serial,
// and every link is a matrix-vector product over f32 weights (~4.3 M
// parameters, ~17.4 MB at the default widths).  The arithmetic is small
// (2 x 4.3 M FLOP per fold and step: 2.1 us at 16 folds at the f32 rate),
// but no SM can hold the weights, and one SM streaming them from L2 at every
// step draws ~51 GB/s (340 us per step: the first version of this kernel,
// one block per 4 folds).
//
// Design: a persistent grid of G blocks, about one per SM (G = ceil(H /
// ceil(H / SMs)): 128 at H = 512 on 132 SMs), launched cooperatively so that
// every block is resident.  Block k owns a fixed slice of every layer's
// output columns, ceil-division ranges: hidden units (GRU1, GRU2, I
// projection columns) k*cH.., fc1/fc2 columns k*cF.., logits k*cN...  It keeps
// those rows of the f32 weights in its shared memory for the whole loop (and
// the full w_x column of the I projection), so no weight is read from L2
// after the prologue.  The blocks exchange activations through a global
// scratch (it stays in L2) and meet at a grid barrier between dependent
// layers.  Step t, five barriers:
//
//   1. GRU1: merge the (max, index) partials of step t-1 of every fold into
//      x (the block that owns fold f, f % G, writes labels[t-1, f]); stage
//      xt = x w_x + xt_cond and h1[t&1]; own units: h1[~t&1], x1 = xt + h1.
//   2. GRU2: own units on [x1, a2] and h2[t&1]: h2[~t&1], x2 = x1 + h2.
//   3. fc1: own columns of relu([x2, a3] W + b) -> y1.
//   4. fc2: own columns of relu([y1, a4] W + b) -> y2.
//   5. fc3: own logits (+ Gumbel noise) -> one (max, index) partial per fold
//      and block; and own columns of xt_cond = [mel, a1]_{t+1} W_I[1:] + b_I
//      (the part of the I projection that does not depend on x).
//
// One more barrier before step 0 (xt_cond of step 0) and one merge after the
// last step (labels[T-1]).  Every phase stages its whole input vectors for a
// tile of FT folds in shared memory with cp.async, all copies of the phase
// in flight together, and loops over fold tiles, re-reading the weights from
// shared memory.  The next step's conditioning is prefetched into L2.
//
// What bounds it now: every block reads every phase's whole input vectors,
// ~15 KB per fold and step, so a step moves ~2 MB per fold from L2 to the
// SMs, and five grid barriers cost ~1.2 us each.  The arithmetic is a small
// part (PERF.md has the split by phase).  Thread-block clusters that share
// one copy of the inputs are the next step (ROADMAP.md).
//
// Hazards and what handles them:
//   - stale reads: the exchange buffers are written during the launch, so
//     they are read through L2 only (cp.async.cg, ld.global.cg), never
//     through L1 or the read-only path; the barrier orders the writes (fence,
//     then arrive);
//   - write-after-read across blocks: every block reads the whole old h1 (h2)
//     in the phase where the owners write the new one, so h1 and h2 are
//     double-buffered by the parity of t; xt_cond is written in phase 5 and
//     read in phase 1 of the next step, with no reader in between, so one
//     buffer suffices;
//   - ties: a partial is the first maximum of the block's ascending columns
//     (strict >), and partials merge under "v > bv || (v == bv && i < bi)",
//     a total order (partials are never NaN), so a label is torch.argmax's
//     first occurrence; an all-NaN fold gives label 0;
//   - co-residency: launched only with cudaLaunchCooperativeKernel, after an
//     occupancy check; a grid that cannot be resident returns an error.
// The barrier is a monotone arrival counter that the wrapper zeroes: the
// n-th barrier of the launch waits until the counter reads n * G.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "common.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int NMEL = 80;
constexpr int AUX = 32;
constexpr int COND = NMEL + 4 * AUX;  // 208: mel | a1 | a2 | a3 | a4
constexpr int XI = 116;               // packed w_i row: x | mel | a1 | pad
constexpr int CI = NMEL + AUX;        // 112: the I projection's conditioning inputs
constexpr int A2 = NMEL + AUX, A3 = NMEL + 2 * AUX, A4 = NMEL + 3 * AUX;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int pad4(int a) { return (a + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int clampi(int a, int lo, int hi) { return a < lo ? lo : (a > hi ? hi : a); }

// Shared-memory layout of one block, in floats.  Mirrored term for term by
// ops/wavernn_kernel.py (k1_plan), which sizes and checks the launch.
struct Layout {
  int cH, cF, cN;  // owned hidden units (= I projection columns), fc1/fc2 columns, logits
  int KA, KB;      // H + AUX ([x1|a2], [x2|a3]) and FC + AUX ([y1|a4])
  int wI, wx, wi1, wh1, wi2, wh2, wf1, wf2, wf3, stage, out, bias, xs, total;
};

__host__ __device__ inline Layout make_layout(int G, int H, int FC, int NC, int FT) {
  Layout L;
  L.cH = cdiv(H, G);
  L.cF = cdiv(FC, G);
  L.cN = cdiv(NC, G);
  L.KA = H + AUX;
  L.KB = FC + AUX;
  int o = 0;
  L.wI = o;  o += L.cH * CI;
  L.wx = o;  o += H;
  L.wi1 = o; o += 3 * L.cH * H;
  L.wh1 = o; o += 3 * L.cH * H;
  L.wi2 = o; o += 3 * L.cH * L.KA;
  L.wh2 = o; o += 3 * L.cH * H;
  L.wf1 = o; o += L.cF * L.KA;
  L.wf2 = o; o += L.cF * L.KB;
  L.wf3 = o; o += L.cN * FC;
  L.stage = o; o += FT * imax(imax(2 * H, L.KA + H), imax(L.KB, FC + CI));
  L.out = o;  o += FT * imax(6 * L.cH, imax(L.cF, L.cN + L.cH));
  L.bias = o; o += pad4(13 * L.cH + 2 * L.cF + L.cN);
  L.xs = o;   o += pad4(FT);
  L.total = o;
  return L;
}

// Global scratch (floats), zeroed by the wrapper: h1 and h2 [2][B][H],
// x1, x2, xt_cond [B][H], y1, y2 [B][FC], partials [B][G] of int2.
__host__ __device__ inline size_t scratch_floats(int B, int G, int H, int FC) {
  return (size_t)B * (7 * (size_t)H + 2 * (size_t)FC + 2 * (size_t)G);
}

struct Scratch {
  float *h1, *h2, *x1, *x2, *xtc, *y1, *y2;
  int2* part;
};

__device__ inline Scratch carve(float* s, int B, int H, int FC) {
  Scratch S;
  const size_t bh = (size_t)B * H, bf = (size_t)B * FC;
  S.h1 = s;  s += 2 * bh;
  S.h2 = s;  s += 2 * bh;
  S.x1 = s;  s += bh;
  S.x2 = s;  s += bh;
  S.xtc = s; s += bh;
  S.y1 = s;  s += bf;
  S.y2 = s;  s += bf;
  S.part = reinterpret_cast<int2*>(s);
  return S;
}

struct Params {
  const float* cond;
  const float *w_i, *b_i, *wi1, *bi1, *wh1, *bh1, *wi2, *bi2, *wh2, *bh2;
  const float *wfc1, *bfc1, *wfc2, *bfc2, *wfc3, *bfc3;
  int* labels;
  float* scratch;
  unsigned* counter;
  int T, B, H, FC, NC, G, FT, greedy;
  uint32_t seed;
};

// Every block arrives once; the n-th barrier returns when the counter reads
// n * G (``target``).  The fence before the arrival publishes this block's
// writes; the acquire load orders the reads after it.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// One job of a phase: out[r * ldo + f] = sum_k W[r * K + k] * X[f * ldx + k]
// for r < R and the staged folds, W and X in shared memory, K a multiple of 4.
struct MV {
  const float* W;
  int R, K;
  const float* X;
  int ldx;
  float* out;
};

// One halving step of reduce16: lanes keep the half of their values that
// bit 2*HALF of the lane selects and add the partner's copy of it.
template <int HALF>
__device__ __forceinline__ void fold_step(float (&v)[16], int lane) {
  const bool up = lane & (2 * HALF);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// Sums 16 per-lane values over the warp in 16 shuffles (halving the values
// held at each step); lane l returns the total of value (l >> 1) & 15.
__device__ __forceinline__ float reduce16(float (&v)[16], int lane) {
  fold_step<8>(v, lane);
  fold_step<4>(v, lane);
  fold_step<2>(v, lane);
  fold_step<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// 4 rows x 4 folds of one job by one warp, lanes over k in float4 steps.
__device__ __forceinline__ void mv_group(const float* W, int R, int K, const float* X, int ldx, float* out,
                                         int r0, int f0, int ldo, int lane) {
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  const float4* w[4];
  const float4* x[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) w[r] = reinterpret_cast<const float4*>(W + (size_t)min(r0 + r, R - 1) * K);
#pragma unroll
  for (int f = 0; f < 4; ++f) x[f] = reinterpret_cast<const float4*>(X + (size_t)(f0 + f) * ldx);
  const int K4 = K >> 2;
#pragma unroll 1
  for (int k4 = lane; k4 < K4; k4 += 32) {
    float4 wv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) wv[r] = w[r][k4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float4 xv = x[f][k4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float a = acc[r * 4 + f];
        a = fmaf(wv[r].x, xv.x, a);
        a = fmaf(wv[r].y, xv.y, a);
        a = fmaf(wv[r].z, xv.z, a);
        a = fmaf(wv[r].w, xv.w, a);
        acc[r * 4 + f] = a;
      }
    }
  }
  const float v = reduce16(acc, lane);
  const int idx = (lane >> 1) & 15, r = r0 + (idx >> 2);
  if (!(lane & 1) && r < R) out[(size_t)r * ldo + f0 + (idx & 3)] = v;
}

// The jobs a and b (b.R may be 0) over nf4 staged folds, their 4x4 groups
// spread over the warps together.
__device__ __forceinline__ void run_jobs(const MV& a, const MV& b, int nf4, int ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int fg = nf4 >> 2;
  const int na = cdiv(a.R, 4) * fg, nb = cdiv(b.R, 4) * fg;
#pragma unroll 1
  for (int g = warp; g < na + nb; g += NWARPS) {
    const bool first = g < na;
    const int gg = first ? g : g - na;
    mv_group(first ? a.W : b.W, first ? a.R : b.R, first ? a.K : b.K, first ? a.X : b.X,
             first ? a.ldx : b.ldx, first ? a.out : b.out, (gg / fg) * 4, (gg % fg) * 4, ldo, lane);
  }
}

// Issues asynchronous copies dst[f * ld + c] = src[f * sld + c] for c < W
// (all multiples of 4) and f < nf, zeros for nf <= f < nf4; stage_wait()
// completes them.  cp.async.cg reads through L2 only, never L1: the exchange
// buffers were written by other blocks during the launch.  Each block starts
// at its own offset, so the blocks do not all ask for one L2 line at once.
__device__ void stage_async(float* dst, int ld, const float* src, size_t sld, int W, int nf, int nf4) {
  const int W4 = W >> 2, n = nf4 * W4;
  const int rot = (int)((long long)blockIdx.x * n / gridDim.x);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    int e = i + rot;
    if (e >= n) e -= n;
    const int f = e / W4, c = 4 * (e - f * W4);
    const bool valid = f < nf;
    const float* from = valid ? src + f * sld + c : src;
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + f * ld + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to), "l"(from), "r"(valid ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// Asks L2 for [base, base + floats): the next step's conditioning, spread
// over all blocks' threads, so that the phases do not wait on device memory.
__device__ __forceinline__ void prefetch_l2(const float* base, size_t floats) {
  const char* b = reinterpret_cast<const char*>(base);
  const size_t lines = (floats * 4 + 127) / 128;
  for (size_t l = blockIdx.x + (size_t)threadIdx.x * gridDim.x; l < lines; l += (size_t)THREADS * gridDim.x)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(b + l * 128));
}

// Rows [r0, r0 + n) of a global [*, K] matrix into shared rows [0, cap),
// rows past n zeroed.
__device__ void load_rows(float* dst, const float* src, int K, int r0, int n, int cap) {
  const int K4 = K >> 2;
  for (int i = threadIdx.x; i < cap * K4; i += THREADS) {
    const int r = i / K4, c4 = i - r * K4;
    reinterpret_cast<float4*>(dst)[i] =
        r < n ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * K) + c4)
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__device__ void load_vec(float* dst, const float* src, int r0, int n, int cap) {
  for (int i = threadIdx.x; i < cap; i += THREADS) dst[i] = i < n ? __ldg(src + r0 + i) : 0.0f;
}

// The label of one fold from its G partials, by one warp.
__device__ int merge_label(const int2* part, int G, int lane) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int j = lane; j < G; j += 32) {  // from this block's offset: any order gives the same maximum
    int k = j + (int)blockIdx.x % G;
    if (k >= G) k -= G;
    const int2 p = __ldcg(part + k);
    const float v = __int_as_float(p.x);
    if (v > bv || (v == bv && p.y < bi)) { bv = v; bi = p.y; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, o);
    const int i = __shfl_xor_sync(0xffffffffu, bi, o);
    if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
  }
  return bi == INT_MAX ? 0 : bi;  // all-NaN logits: nothing compared greater
}

__device__ __forceinline__ float gru_unit(float ir, float iz, float in, float hr, float hz, float hn,
                                          float h) {
  const float r = sigmoidf_(ir + hr);
  const float z = sigmoidf_(iz + hz);
  const float n = tanhf(in + r * hn);
  return (1.0f - z) * n + z * h;
}

__global__ void __launch_bounds__(THREADS, 1) wavernn_grid_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = p.T, B = p.B, H = p.H, FC = p.FC, G = p.G, FT = p.FT;
  const Layout L = make_layout(G, H, FC, p.NC, FT);
  const int cH = L.cH, cF = L.cF, cN = L.cN, KA = L.KA, KB = L.KB;
  const int k = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = k * cH, nu = clampi(H - j0, 0, cH);       // own hidden units
  const int c0 = k * cF, nc = clampi(FC - c0, 0, cF);      // own fc1/fc2 columns
  const int n0 = k * cN, nn = clampi(p.NC - n0, 0, cN);    // own logits

  float *wI = sm + L.wI, *wx = sm + L.wx, *wi1 = sm + L.wi1, *wh1 = sm + L.wh1;
  float *wi2 = sm + L.wi2, *wh2 = sm + L.wh2, *wf1 = sm + L.wf1, *wf2 = sm + L.wf2, *wf3 = sm + L.wf3;
  float *stg = sm + L.stage, *out = sm + L.out, *xs = sm + L.xs;
  float *bI = sm + L.bias, *bi1 = bI + cH, *bh1 = bi1 + 3 * cH, *bi2 = bh1 + 3 * cH,
        *bh2 = bi2 + 3 * cH, *bf1 = bh2 + 3 * cH, *bf2 = bf1 + cF, *bf3 = bf2 + cF;

  prefetch_l2(p.cond, (size_t)B * COND);
  // prologue: this block's weight rows into shared memory, for the whole loop
  for (int i = tid; i < cH * CI; i += THREADS) {
    const int u = i / CI, c = i - u * CI;
    wI[i] = u < nu ? __ldg(p.w_i + (size_t)(j0 + u) * XI + 1 + c) : 0.0f;
  }
  for (int j = tid; j < H; j += THREADS) wx[j] = __ldg(p.w_i + (size_t)j * XI);
  load_vec(bI, p.b_i, j0, nu, cH);
  for (int g = 0; g < 3; ++g) {  // gate g of unit u is row g * cH + u
    const size_t gH = (size_t)g * H;
    load_rows(wi1 + g * cH * H, p.wi1 + gH * H, H, j0, nu, cH);
    load_rows(wh1 + g * cH * H, p.wh1 + gH * H, H, j0, nu, cH);
    load_rows(wi2 + g * cH * KA, p.wi2 + gH * KA, KA, j0, nu, cH);
    load_rows(wh2 + g * cH * H, p.wh2 + gH * H, H, j0, nu, cH);
    load_vec(bi1 + g * cH, p.bi1 + gH, j0, nu, cH);
    load_vec(bh1 + g * cH, p.bh1 + gH, j0, nu, cH);
    load_vec(bi2 + g * cH, p.bi2 + gH, j0, nu, cH);
    load_vec(bh2 + g * cH, p.bh2 + gH, j0, nu, cH);
  }
  load_rows(wf1, p.wfc1, KA, c0, nc, cF);
  load_rows(wf2, p.wfc2, KB, c0, nc, cF);
  load_rows(wf3, p.wfc3, FC, n0, nn, cN);
  load_vec(bf1, p.bfc1, c0, nc, cF);
  load_vec(bf2, p.bfc2, c0, nc, cF);
  load_vec(bf3, p.bfc3, n0, nn, cN);

  const Scratch S = carve(p.scratch, B, H, FC);
  const MV none{nullptr, 0, 4, nullptr, 0, nullptr};
  unsigned target = 0;
  __syncthreads();

  // xt_cond of step 0 (phase 5's second job, alone)
  for (int f0 = 0; f0 < B; f0 += FT) {
    const int nf = min(FT, B - f0), nf4 = pad4(nf);
    stage_async(stg, CI, p.cond + (size_t)f0 * COND, COND, CI, nf, nf4);
    stage_wait();
    run_jobs(MV{wI, cH, CI, stg, CI, out}, none, nf4, FT);
    __syncthreads();
    for (int i = tid; i < nu * nf; i += THREADS) {
      const int u = i / nf, f = i - u * nf;
      S.xtc[(size_t)(f0 + f) * H + j0 + u] = out[u * FT + f] + bI[u];
    }
    __syncthreads();
  }
  grid_barrier(p.counter, target += G);

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const float* cond_t = p.cond + (size_t)t * B * COND;
    if (t + 1 < T) prefetch_l2(cond_t + (size_t)B * COND, (size_t)B * COND);

    // ---- phase 1: merge -> x; GRU1 ----
    for (int f0 = 0; f0 < B; f0 += FT) {
      const int nf = min(FT, B - f0), nf4 = pad4(nf);
      float *xt = stg, *hs = stg + FT * H;
      stage_async(xt, H, S.xtc + (size_t)f0 * H, H, H, nf, nf4);
      stage_async(hs, H, S.h1 + ((size_t)cur * B + f0) * H, H, H, nf, nf4);
      for (int f = warp; f < nf4; f += NWARPS) {
        float x = 0.0f;
        if (t > 0 && f < nf) {
          const int fold = f0 + f;
          const int label = merge_label(S.part + (size_t)fold * G, G, lane);
          if (lane == 0 && fold % G == k) p.labels[(size_t)(t - 1) * B + fold] = label;
          // label_2_float's op order (2*l, then / (n-1), then - 1)
          x = 2.0f * (float)label / ((float)p.NC - 1.0f) - 1.0f;
        }
        if (lane == 0) xs[f] = x;
      }
      stage_wait();
      const int H4 = H >> 2;
      for (int i = tid; i < nf4 * H4; i += THREADS) {  // xt = x w_x + xt_cond
        const int f = i / H4, c4 = i - f * H4;
        float4* q = reinterpret_cast<float4*>(xt) + i;
        const float4 wv = reinterpret_cast<const float4*>(wx)[c4], v = *q;
        const float x = xs[f];
        *q = make_float4(fmaf(x, wv.x, v.x), fmaf(x, wv.y, v.y), fmaf(x, wv.z, v.z), fmaf(x, wv.w, v.w));
      }
      __syncthreads();
      run_jobs(MV{wi1, 3 * cH, H, xt, H, out}, MV{wh1, 3 * cH, H, hs, H, out + 3 * cH * FT},
                              nf4, FT);
      __syncthreads();
      for (int i = tid; i < nu * nf; i += THREADS) {
        const int u = i / nf, f = i - u * nf, j = j0 + u;
        const float* o = out + u * FT + f;
        const float h = gru_unit(o[0] + bi1[u], o[cH * FT] + bi1[cH + u],
                                 o[2 * cH * FT] + bi1[2 * cH + u],
                                 o[3 * cH * FT] + bh1[u], o[4 * cH * FT] + bh1[cH + u],
                                 o[5 * cH * FT] + bh1[2 * cH + u], hs[f * H + j]);
        const size_t fold = f0 + f;
        S.h1[((size_t)nxt * B + fold) * H + j] = h;
        S.x1[fold * H + j] = xt[f * H + j] + h;
      }
      __syncthreads();
    }
    grid_barrier(p.counter, target += G);

    // ---- phase 2: GRU2 on [x1, a2] ----
    for (int f0 = 0; f0 < B; f0 += FT) {
      const int nf = min(FT, B - f0), nf4 = pad4(nf);
      float *xa = stg, *hs = stg + FT * KA;
      stage_async(xa, KA, S.x1 + (size_t)f0 * H, H, H, nf, nf4);
      stage_async(xa + H, KA, cond_t + (size_t)f0 * COND + A2, COND, AUX, nf, nf4);
      stage_async(hs, H, S.h2 + ((size_t)cur * B + f0) * H, H, H, nf, nf4);
      stage_wait();
      run_jobs(MV{wi2, 3 * cH, KA, xa, KA, out}, MV{wh2, 3 * cH, H, hs, H, out + 3 * cH * FT},
                              nf4, FT);
      __syncthreads();
      for (int i = tid; i < nu * nf; i += THREADS) {
        const int u = i / nf, f = i - u * nf, j = j0 + u;
        const float* o = out + u * FT + f;
        const float h = gru_unit(o[0] + bi2[u], o[cH * FT] + bi2[cH + u],
                                 o[2 * cH * FT] + bi2[2 * cH + u],
                                 o[3 * cH * FT] + bh2[u], o[4 * cH * FT] + bh2[cH + u],
                                 o[5 * cH * FT] + bh2[2 * cH + u], hs[f * H + j]);
        const size_t fold = f0 + f;
        S.h2[((size_t)nxt * B + fold) * H + j] = h;
        S.x2[fold * H + j] = xa[f * KA + j] + h;
      }
      __syncthreads();
    }
    grid_barrier(p.counter, target += G);

    // ---- phase 3: fc1 on [x2, a3] ----
    for (int f0 = 0; f0 < B; f0 += FT) {
      const int nf = min(FT, B - f0), nf4 = pad4(nf);
      stage_async(stg, KA, S.x2 + (size_t)f0 * H, H, H, nf, nf4);
      stage_async(stg + H, KA, cond_t + (size_t)f0 * COND + A3, COND, AUX, nf, nf4);
      stage_wait();
      run_jobs(MV{wf1, cF, KA, stg, KA, out}, none, nf4, FT);
      __syncthreads();
      for (int i = tid; i < nc * nf; i += THREADS) {
        const int c = i / nf, f = i - c * nf;
        S.y1[(size_t)(f0 + f) * FC + c0 + c] = fmaxf(out[c * FT + f] + bf1[c], 0.0f);
      }
      __syncthreads();
    }
    grid_barrier(p.counter, target += G);

    // ---- phase 4: fc2 on [y1, a4] ----
    for (int f0 = 0; f0 < B; f0 += FT) {
      const int nf = min(FT, B - f0), nf4 = pad4(nf);
      stage_async(stg, KB, S.y1 + (size_t)f0 * FC, FC, FC, nf, nf4);
      stage_async(stg + FC, KB, cond_t + (size_t)f0 * COND + A4, COND, AUX, nf, nf4);
      stage_wait();
      run_jobs(MV{wf2, cF, KB, stg, KB, out}, none, nf4, FT);
      __syncthreads();
      for (int i = tid; i < nc * nf; i += THREADS) {
        const int c = i / nf, f = i - c * nf;
        S.y2[(size_t)(f0 + f) * FC + c0 + c] = fmaxf(out[c * FT + f] + bf2[c], 0.0f);
      }
      __syncthreads();
    }
    grid_barrier(p.counter, target += G);

    // ---- phase 5: fc3 -> argmax partials; xt_cond of step t+1 ----
    const bool more = t + 1 < T;
    for (int f0 = 0; f0 < B; f0 += FT) {
      const int nf = min(FT, B - f0), nf4 = pad4(nf);
      float* cs = stg + FT * FC;
      stage_async(stg, FC, S.y2 + (size_t)f0 * FC, FC, FC, nf, nf4);
      if (more) stage_async(cs, CI, cond_t + (size_t)(B + f0) * COND, COND, CI, nf, nf4);
      stage_wait();
      run_jobs(MV{wf3, cN, FC, stg, FC, out}, MV{wI, more ? cH : 0, CI, cs, CI, out + cN * FT},
                              nf4, FT);
      __syncthreads();
      // logits (+ noise) in place, each element by one thread
      for (int i = tid; i < nn * nf; i += THREADS) {
        const int n = i / nf, f = i - n * nf;
        float v = out[n * FT + f] + bf3[n];
        if (!p.greedy) v += rng_gumbel(rng_bits_from_key(rng_key(p.seed, (uint32_t)(f0 + f), (uint32_t)t),
                                                         (uint32_t)(n0 + n)));
        out[n * FT + f] = v;
      }
      if (more) {
        for (int i = tid; i < nu * nf; i += THREADS) {
          const int u = i / nf, f = i - u * nf;
          S.xtc[(size_t)(f0 + f) * H + j0 + u] = out[(cN + u) * FT + f] + bI[u];
        }
      }
      __syncthreads();
      for (int f = tid; f < nf; f += THREADS) {  // first maximum over the ascending own columns
        float bv = -INFINITY;
        int bi = INT_MAX;
        for (int n = 0; n < nn; ++n) {
          const float v = out[n * FT + f];
          if (v > bv) { bv = v; bi = n0 + n; }
        }
        S.part[(size_t)(f0 + f) * G + k] = make_int2(__float_as_int(bv), bi);
      }
      __syncthreads();
    }
    grid_barrier(p.counter, target += G);
  }

  // labels of the last step, each fold by the block that owns it
  for (int fold = k + warp * G; fold < B; fold += NWARPS * G) {
    const int label = merge_label(S.part + (size_t)fold * G, G, lane);
    if (lane == 0) p.labels[(size_t)(T - 1) * B + fold] = label;
  }
}

}  // namespace

// Bytes of shared memory per block and floats of global scratch of a launch
// (ops/wavernn_kernel.py k1_plan computes the same; the wrapper checks).
extern "C" int wavernn_sample_smem_bytes(int G, int H, int FC, int NC, int FT) {
  return make_layout(G, H, FC, NC, FT).total * 4;
}

extern "C" int wavernn_sample_scratch_floats(int B, int G, int H, int FC) {
  return (int)scratch_floats(B, G, H, FC);
}

// Launches the whole sample loop on ``stream`` as one cooperative grid of G
// blocks with FT-fold tiles.  cond: [T, B, 208] f32; weights transposed to
// [out, in] with in padded to a multiple of 4 (ops/wavernn_kernel.py
// pack_weights); labels: [T, B] int32; scratch: zeroed floats
// (wavernn_sample_scratch_floats); counter: one zeroed uint32.  Returns a
// cudaError_t: cudaErrorCooperativeLaunchTooLarge when G blocks cannot be
// resident together, else the launch's own.
extern "C" int wavernn_sample_launch(
    const float* cond,
    const float* w_i, const float* b_i,
    const float* wi1, const float* bi1, const float* wh1, const float* bh1,
    const float* wi2, const float* bi2, const float* wh2, const float* bh2,
    const float* wfc1, const float* bfc1, const float* wfc2, const float* bfc2,
    const float* wfc3, const float* bfc3,
    int* labels, float* scratch, unsigned* counter,
    int T, int B, int H, int FC, int NC, int G, int FT, int greedy, uint32_t seed, void* stream) {
  Params p{cond, w_i, b_i, wi1, bi1, wh1, bh1, wi2, bi2, wh2, bh2, wfc1, bfc1, wfc2, bfc2, wfc3, bfc3,
           labels, scratch, counter, T, B, H, FC, NC, G, FT, greedy, seed};
  const int smem = wavernn_sample_smem_bytes(G, H, FC, NC, FT);
  cudaError_t err = cudaFuncSetAttribute(wavernn_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wavernn_grid_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * n_sm < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(wavernn_grid_kernel), dim3(G), dim3(THREADS),
                                    args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
