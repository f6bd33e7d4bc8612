// Tacotron-2 autoregressive decode: one launch runs every decoder step up
// to max_iters, with the batch-wide early exit.
//
// Replaces the TPU kernel
// tacotronv2_wavernn_chinese_tpu/ops/tacotron_decoder_kernel.py
// (decode_autoregressive_pallas, _kernel), default branch: forward
// attention, r = 1, no anti-repeat, no smoothing.  Per step and row:
// prenet with always-on dropout (per-row seed, rng.cuh) -> LSTM1 on
// [prenet, context, h1] -> LSTM2 on [out1, h2] (TF gate order, forget bias
// +1, eval-mode zoneout on the carried state) -> forward attention (SAME
// location conv over the cumulated alignments, tanh energy against the
// keys, masked softmax, forward recursion with mu, renormalize) -> context
// -> frame, stop and mu projections.
//
// Semantics kept exactly: finished rows keep advancing with real outputs
// until every row is done; after that each step writes frames 0, stops 1e4
// and aligns 0.  The initial alpha/cumulated state is one-hot at position 0
// with mu = 0.5; the right shift in the recursion is zero-filled and the
// 1e-10 sits inside the product.
//
// What bounds it on the card: every step is a serial chain of small
// matrix-vector products over ~1.7 M f32 weights (~7 MB, resident in L2)
// plus the attention over T_in encoder positions; at serving batch sizes
// (1-16 rows) the step is bound by how fast one SM can stream the weights
// from L2 and by the ~15 block barriers per step, not by arithmetic.
//
// Design: ONE block runs all rows.  Whole-batch done needs agreement
// across rows at every step; with one block that is a __syncthreads() and
// a flag in shared memory, with no grid barrier or cluster.  Each weight
// read from L2 is used for up to 4 rows in registers: up to 4 rows read the
// weights once per step, each further 4 rows once more.  All per-row state (LSTM c/h,
// context, alpha, cumulated, mu, done) lives in a global scratch buffer the
// wrapper allocates; it stays in L1/L2.  The combined location-conv weights
// sit in shared memory.  Spreading the rows or the weight columns over a
// cluster of blocks is left to later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int NMEL = 80;
constexpr int NPROJ = 82;  // frame (80) | stop (1) | mu (1)
constexpr int RB = 4;      // rows per matvec pass

struct Weights {
  const float *pre_w1, *pre_b1, *pre_w2, *pre_b2;
  const float *l1, *l1_b, *l2, *l2_b;
  const float *wq, *w_comb, *b_comb, *att_v, *att_b;
  const float *proj, *proj_b;
};

struct Dims {
  int B, T_in, A, V, U, P1, P2, taps, max_iters;
};

struct Layout {  // per-row float offsets into the scratch buffer
  int prev, pre1, xin1, gates, c1, xin2, c2, xproj, pq, outp, misc, alpha, cum, en, stride;
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  int o = 0;
  L.prev = o;  o += NMEL;
  L.pre1 = o;  o += d.P1;
  L.xin1 = o;  o += d.P2 + d.V + d.U;  // [pre2 | context | h1]
  L.gates = o; o += 4 * d.U;
  L.c1 = o;    o += d.U;
  L.xin2 = o;  o += 2 * d.U;            // [out1 | h2]
  L.c2 = o;    o += d.U;
  L.xproj = o; o += d.U + d.V;          // [out2 | context]
  L.pq = o;    o += d.A;
  L.outp = o;  o += up4(NPROJ);
  L.misc = o;  o += 4;                  // mu, done
  L.alpha = o; o += up4(d.T_in);
  L.cum = o;   o += up4(d.T_in);
  L.en = o;    o += up4(d.T_in);
  L.stride = o;
  return L;
}

// y rows = act(W x rows + b) for all B rows, RB rows per pass.
__device__ void matvec_all(const float* W, const float* b, int N, int Kp, float* scratch,
                           int x_off, int y_off, int stride, int B, int act) {
  for (int r0 = 0; r0 < B; r0 += RB) {
    const int nr = B - r0 < RB ? B - r0 : RB;
    matvec_rows<RB>(W, b, N, Kp, scratch + (size_t)r0 * stride + x_off, stride, nr,
                    scratch + (size_t)r0 * stride + y_off, stride, act);
  }
}

__device__ void dropout(float* scratch, const Layout& L, int off, int width, int lane0, int B,
                        const int* seeds, int step, float keep, uint32_t thresh) {
  for (int i = threadIdx.x; i < B * width; i += blockDim.x) {
    const int b = i / width, n = i - b * width;
    float* p = scratch + (size_t)b * L.stride + off + n;
    const uint32_t bits = rng_bits((uint32_t)seeds[b], 0u, (uint32_t)step, (uint32_t)(lane0 + n));
    *p = bits < thresh ? *p / keep : 0.0f;
  }
}

// TF-order LSTM cell + eval-mode zoneout.  gates [i | j | f | o]; c and h
// are the carried state (updated in place), out receives the raw new_h.
__device__ void lstm_cell(float* scratch, const Layout& L, int c_off, int h_off, int out_off,
                          int U, int B, float zo, float zo_keep) {
  for (int i = threadIdx.x; i < B * U; i += blockDim.x) {
    const int b = i / U, j = i - b * U;
    float* row = scratch + (size_t)b * L.stride;
    const float* g = row + L.gates;
    const float c = row[c_off + j], h = row[h_off + j];
    const float new_c = sigmoidf_(g[2 * U + j] + 1.0f) * c + sigmoidf_(g[j]) * tanhf(g[U + j]);
    const float new_h = sigmoidf_(g[3 * U + j]) * tanhf(new_c);
    row[c_off + j] = zo_keep * new_c + zo * c;
    row[h_off + j] = zo_keep * new_h + zo * h;
    row[out_off + j] = new_h;
  }
}

__global__ void __launch_bounds__(THREADS)
tacotron_decode_kernel(const float* __restrict__ keys, const float* __restrict__ values,
                       const float* __restrict__ mask, const int* __restrict__ seeds, Weights w,
                       float* __restrict__ frames, float* __restrict__ stops, float* __restrict__ aligns,
                       float* scratch, Dims d, float zo, float zo_keep, float drop_keep,
                       uint32_t drop_thresh) {
  extern __shared__ float4 smem4[];
  float* s_wc = reinterpret_cast<float*>(smem4);  // [taps, A] combined location conv
  __shared__ int s_all_done;
  const Layout L = make_layout(d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int B = d.B, T_in = d.T_in, A = d.A, V = d.V, U = d.U;
  const int padl = (d.taps - 1) / 2;

  for (int i = tid; i < d.taps * A; i += blockDim.x) s_wc[i] = w.w_comb[i];
  for (int i = tid; i < B * L.stride; i += blockDim.x) {
    const int b = i / L.stride, k = i - b * L.stride;
    float v = 0.0f;
    if ((k == L.alpha || k == L.cum)) v = 1.0f;  // one-hot at position 0
    if (k == L.misc) v = 0.5f;                   // mu
    scratch[(size_t)b * L.stride + k] = v;
  }
  if (tid == 0) s_all_done = 0;
  __syncthreads();

  int step = 0;
  for (; step < d.max_iters; ++step) {
    if (s_all_done) break;
    // prenet, always-on dropout: lanes [0, P1) then [P1, P1 + P2)
    matvec_all(w.pre_w1, w.pre_b1, d.P1, NMEL, scratch, L.prev, L.pre1, L.stride, B, ACT_RELU);
    __syncthreads();
    if (drop_keep < 1.0f) {
      dropout(scratch, L, L.pre1, d.P1, 0, B, seeds, step, drop_keep, drop_thresh);
      __syncthreads();
    }
    matvec_all(w.pre_w2, w.pre_b2, d.P2, d.P1, scratch, L.pre1, L.xin1, L.stride, B, ACT_RELU);
    __syncthreads();
    if (drop_keep < 1.0f) {
      dropout(scratch, L, L.xin1, d.P2, d.P1, B, seeds, step, drop_keep, drop_thresh);
      __syncthreads();
    }
    // LSTM1 on [prenet, context, h1]; its raw output feeds LSTM2
    matvec_all(w.l1, w.l1_b, 4 * U, d.P2 + V + U, scratch, L.xin1, L.gates, L.stride, B, ACT_NONE);
    __syncthreads();
    lstm_cell(scratch, L, L.c1, L.xin1 + d.P2 + V, L.xin2, U, B, zo, zo_keep);
    __syncthreads();
    matvec_all(w.l2, w.l2_b, 4 * U, 2 * U, scratch, L.xin2, L.gates, L.stride, B, ACT_NONE);
    __syncthreads();
    lstm_cell(scratch, L, L.c2, L.xin2 + U, L.xproj, U, B, zo, zo_keep);
    __syncthreads();
    // attention query projection
    matvec_all(w.wq, nullptr, A, U, scratch, L.xproj, L.pq, L.stride, B, ACT_NONE);
    __syncthreads();
    // energies: one warp per (row, position), lanes over the attention dim
    for (int p = warp; p < B * T_in; p += nwarps) {
      const int b = p / T_in, t = p - b * T_in;
      const float* row = scratch + (size_t)b * L.stride;
      const float* cum = row + L.cum;
      float acc = 0.0f;
      for (int a = lane; a < A; a += 32) {
        float conv = 0.0f;
        for (int k = 0; k < d.taps; ++k) {
          const int tt = t + k - padl;
          if (tt >= 0 && tt < T_in) conv = fmaf(cum[tt], s_wc[k * A + a], conv);
        }
        const float loc = conv + __ldg(w.b_comb + a);
        const float e = tanhf(__ldg(keys + ((size_t)b * T_in + t) * A + a) + row[L.pq + a] + loc
                              + __ldg(w.att_b + a));
        acc = fmaf(__ldg(w.att_v + a), e, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0)
        scratch[(size_t)b * L.stride + L.en + t] = mask[(size_t)b * T_in + t] > 0.0f ? acc : -1e9f;
    }
    __syncthreads();
    // masked softmax, cumulate, forward recursion, renormalize: a warp per row
    for (int b = warp; b < B; b += nwarps) {
      float* row = scratch + (size_t)b * L.stride;
      float* en = row + L.en;
      float* alpha = row + L.alpha;
      float* cum = row + L.cum;
      float m = -INFINITY;
      for (int t = lane; t < T_in; t += 32) m = fmaxf(m, en[t]);
      m = warp_max(m);
      float ssum = 0.0f;
      for (int t = lane; t < T_in; t += 32) ssum += expf(en[t] - m);
      ssum = warp_sum(ssum);
      const float mu = row[L.misc];
      float s2 = 0.0f;
      for (int t = lane; t < T_in; t += 32) {
        const float sm = expf(en[t] - m) / ssum;
        cum[t] += sm;
        const float shifted = t > 0 ? alpha[t - 1] : 0.0f;
        const float al = ((1.0f - mu) * alpha[t] + mu * shifted + 1e-10f) * sm;
        en[t] = al;
        s2 += al;
      }
      s2 = warp_sum(s2);
      __syncwarp();
      for (int t = lane; t < T_in; t += 32) {
        const float a = en[t] / s2;
        alpha[t] = a;
        aligns[((size_t)step * B + b) * T_in + t] = a;
      }
    }
    __syncthreads();
    // context = alignment . values; it is both a projection input and the
    // next step's LSTM1 input
    for (int i = tid; i < B * V; i += blockDim.x) {
      const int b = i / V, v = i - b * V;
      float* row = scratch + (size_t)b * L.stride;
      const float* alpha = row + L.alpha;
      const float* val = values + (size_t)b * T_in * V + v;
      float acc = 0.0f;
      for (int t = 0; t < T_in; ++t) acc = fmaf(alpha[t], __ldg(val + (size_t)t * V), acc);
      row[L.xproj + U + v] = acc;
      row[L.xin1 + d.P2 + v] = acc;
    }
    __syncthreads();
    matvec_all(w.proj, w.proj_b, NPROJ, U + V, scratch, L.xproj, L.outp, L.stride, B, ACT_NONE);
    __syncthreads();
    for (int i = tid; i < B * NMEL; i += blockDim.x) {
      const int b = i / NMEL, c = i - b * NMEL;
      float* row = scratch + (size_t)b * L.stride;
      const float f = row[L.outp + c];
      frames[((size_t)step * B + b) * NMEL + c] = f;
      row[L.prev + c] = f;
    }
    for (int b = tid; b < B; b += blockDim.x) {
      float* row = scratch + (size_t)b * L.stride;
      const float stop = row[L.outp + NMEL];
      stops[(size_t)step * B + b] = stop;
      row[L.misc] = sigmoidf_(row[L.outp + NMEL + 1]);
      if (sigmoidf_(stop) > 0.5f) row[L.misc + 1] = 1.0f;
    }
    __syncthreads();
    if (tid == 0) {
      int all = 1;
      for (int b = 0; b < B; ++b) all &= scratch[(size_t)b * L.stride + L.misc + 1] > 0.5f;
      s_all_done = all;
    }
    __syncthreads();
  }
  // every row is done: the remaining steps are frames 0, stops 1e4, aligns 0
  const size_t s0 = (size_t)step;
  const size_t n_left = (size_t)d.max_iters - s0;
  for (size_t i = tid; i < n_left * B * NMEL; i += blockDim.x) frames[s0 * B * NMEL + i] = 0.0f;
  for (size_t i = tid; i < n_left * B; i += blockDim.x) stops[s0 * B + i] = 1e4f;
  for (size_t i = tid; i < n_left * B * T_in; i += blockDim.x) aligns[s0 * B * T_in + i] = 0.0f;
}

}  // namespace

// Floats of per-row scratch the wrapper must allocate (times B).
extern "C" int tacotron_decode_scratch_floats(int T_in, int A, int V, int U, int P1, int P2) {
  Dims d{1, T_in, A, V, U, P1, P2, 1, 1};
  return make_layout(d).stride;
}

// Launches the whole decode on ``stream``.  keys [B, T_in, A], values
// [B, T_in, V], mask [B, T_in] f32, seeds [B] int32; weights transposed to
// [out, in] (ops/tacotron_decoder_kernel.py pack_weights); frames
// [max_iters, B, 80], stops [max_iters, B], aligns [max_iters, B, T_in];
// scratch [B * tacotron_decode_scratch_floats(...)].
// Returns cudaGetLastError() after the launch.
extern "C" int tacotron_decode_launch(
    const float* keys, const float* values, const float* mask, const int* seeds,
    const float* pre_w1, const float* pre_b1, const float* pre_w2, const float* pre_b2,
    const float* l1, const float* l1_b, const float* l2, const float* l2_b,
    const float* wq, const float* w_comb, const float* b_comb, const float* att_v, const float* att_b,
    const float* proj, const float* proj_b,
    float* frames, float* stops, float* aligns, float* scratch,
    int B, int T_in, int A, int V, int U, int P1, int P2, int taps, int max_iters,
    float zoneout, float zoneout_keep, float drop_keep, uint32_t drop_thresh, void* stream) {
  Weights w{pre_w1, pre_b1, pre_w2, pre_b2, l1, l1_b, l2, l2_b, wq, w_comb, b_comb, att_v, att_b,
            proj, proj_b};
  Dims d{B, T_in, A, V, U, P1, P2, taps, max_iters};
  const int smem = taps * A * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tacotron_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tacotron_decode_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      keys, values, mask, seeds, w, frames, stops, aligns, scratch, d, zoneout, zoneout_keep,
      drop_keep, drop_thresh);
  return (int)cudaGetLastError();
}
