// Tacotron-2 teacher-forced decoder core, forward (training): one launch
// runs every step of the sequence and writes the outputs and the residual
// saves the backward kernel (tacotron_train_bwd.cu) reads.
//
// Replaces the TPU kernel
// tacotronv2_wavernn_chinese_tpu/ops/tacotron_trainer_kernel.py
// (_fwd_call, _fwd_kernel).  Per step and row, in that kernel's order: save
// the pre-step state (c1, h1, c2, h2, ctx, alpha, mu) -> LSTM1 on
// [p_t | ctx | h1] -> LSTM2 on [out1 | h2] (TF gate order, forget bias +1;
// zoneout carry m*new + (1-m)*prev with the given keep-masks in train mode,
// (1-z)*new + z*prev in eval mode; out1/out2 are the raw new_h) -> query
// projection -> location conv at F width over the cumulated alignments and
// the F->A location dense (conv bias merged into ``ball`` by the wrapper)
// -> tanh energies against the keys, masked softmax (-1e9) -> cumulate ->
// forward recursion ((1-mu)*alpha + mu*shift(alpha) + 1e-10) * align_sm,
// normalised -> context -> next mu.  alpha and cum start one-hot at
// position 0, mu at 0.5.  All arithmetic is f32.
//
// What bounds it on the card: every step streams the ~6.3 MB of f32 gate
// and attention weights (full width) from L2 into each block, and the
// steps are serial; per row the arithmetic is ~2.3 M multiply-adds a step.
// Design: rows are independent, so each row has its own block
// (tacotron_train_common.cuh); its state stays in shared memory, the
// location conv and dense weights are staged in shared memory once, and
// the gate matrices, read as [out, in] float4 rows by matvec_rows, come
// from L2.  With B rows the card runs B blocks, all drawing weights at once.
#include "tacotron_train_common.cuh"

namespace {

// Pointer-array slots (ops/tacotron_trainer_kernel.py train_fwd).
enum {
  I_P, I_MC1, I_MH1, I_MC2, I_MH2, I_KEYS, I_VALUES, I_MASK,
  W_L1T, W_L1B, W_L2T, W_L2B, W_WQT, W_WCONV, W_WLOC, W_BALL, W_V, W_MUC, W_MUQ, W_MUB,
  O_OUT2, O_CTX, O_ALIGN, O_ALIGN_SM, O_OUT1, O_C1P, O_H1P, O_C2P, O_H2P, O_CTXP, O_ALPHAP,
  O_MUP, N_PTRS
};

struct Ptrs {
  const float* in[W_L1T];
  const float* w[O_OUT2 - W_L1T];
  float* out[N_PTRS - O_OUT2];
};

__device__ __forceinline__ const float* W(const Ptrs& p, int i) { return p.w[i - W_L1T]; }
__device__ __forceinline__ float* O(const Ptrs& p, int i) { return p.out[i - O_OUT2]; }

__global__ void __launch_bounds__(TR_THREADS, 1)
tacotron_train_fwd_kernel(Ptrs p, TrDims d, int use_masks, float zoneout) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const FwdLayout L = fwd_layout(d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthr = blockDim.x;
  const int b = blockIdx.x;
  const int B = d.B, T_in = d.T_in, P = d.P, U = d.U, V = d.V, A = d.A, F = d.F;
  float* x1 = sm + L.x1;   // [p | ctx | h1]
  float* x2 = sm + L.x2;   // [out1 | h2]
  float* c1 = sm + L.c1;
  float* c2 = sm + L.c2;
  float* o2 = sm + L.o2;
  float* g = sm + L.g;
  float* pq = sm + L.pq;
  float* wconv = sm + L.wconv;
  float* wloc = sm + L.wloc;
  float* red = sm + L.red;
  float* alpha = sm + L.alpha;
  float* cum = sm + L.cum;
  float* en = sm + L.en;
  float* al = sm + L.al;
  const float* keys = p.in[I_KEYS] + (size_t)b * T_in * A;
  const float* values = p.in[I_VALUES] + (size_t)b * T_in * V;
  const float* mask = p.in[I_MASK] + (size_t)b * T_in;
  const float* ball = W(p, W_BALL);
  const float* vv = W(p, W_V);

  for (int i = tid; i < d.taps * F; i += nthr) wconv[i] = W(p, W_WCONV)[i];
  for (int i = tid; i < F * A; i += nthr) wloc[i] = W(p, W_WLOC)[i];
  for (int i = tid; i < P + V + U; i += nthr) x1[i] = 0.0f;
  for (int i = tid; i < U; i += nthr) {
    x2[U + i] = 0.0f;
    c1[i] = 0.0f;
    c2[i] = 0.0f;
  }
  for (int t = tid; t < T_in; t += nthr) {
    alpha[t] = t == 0 ? 1.0f : 0.0f;
    cum[t] = t == 0 ? 1.0f : 0.0f;
  }
  float mu = 0.5f;
  __syncthreads();

  for (int s = 0; s < d.T; ++s) {
    const size_t ru = ((size_t)s * B + b) * U, rv = ((size_t)s * B + b) * V;
    const size_t rt = ((size_t)s * B + b) * T_in, rp = ((size_t)s * B + b) * P;
    // save the pre-step state, load this step's prenet output
    for (int i = tid; i < U; i += nthr) {
      O(p, O_C1P)[ru + i] = c1[i];
      O(p, O_H1P)[ru + i] = x1[P + V + i];
      O(p, O_C2P)[ru + i] = c2[i];
      O(p, O_H2P)[ru + i] = x2[U + i];
    }
    for (int i = tid; i < V; i += nthr) O(p, O_CTXP)[rv + i] = x1[P + i];
    for (int t = tid; t < T_in; t += nthr) O(p, O_ALPHAP)[rt + t] = alpha[t];
    for (int i = tid; i < P; i += nthr) x1[i] = p.in[I_P][rp + i];
    if (tid == 0) O(p, O_MUP)[(size_t)s * B + b] = mu;
    __syncthreads();

    // LSTM1
    matvec_rows<1>(W(p, W_L1T), W(p, W_L1B), 4 * U, P + V + U, x1, 0, 1, g, 0, ACT_NONE);
    __syncthreads();
    for (int j = tid; j < U; j += nthr) {
      const Gates q = tr_gates(g, U, j);
      const float cp = c1[j], hp = x1[P + V + j];
      const float nc = q.sf * cp + q.si * q.tj;
      const float nh = q.so * tanhf(nc);
      float kc = 1.0f - zoneout, zc = zoneout, kh = kc, zh = zc;
      if (use_masks) {
        kc = p.in[I_MC1][ru + j];
        zc = 1.0f - kc;
        kh = p.in[I_MH1][ru + j];
        zh = 1.0f - kh;
      }
      c1[j] = kc * nc + zc * cp;
      x1[P + V + j] = kh * nh + zh * hp;
      x2[j] = nh;
      O(p, O_OUT1)[ru + j] = nh;
    }
    __syncthreads();

    // LSTM2
    matvec_rows<1>(W(p, W_L2T), W(p, W_L2B), 4 * U, 2 * U, x2, 0, 1, g, 0, ACT_NONE);
    __syncthreads();
    for (int j = tid; j < U; j += nthr) {
      const Gates q = tr_gates(g, U, j);
      const float cp = c2[j], hp = x2[U + j];
      const float nc = q.sf * cp + q.si * q.tj;
      const float nh = q.so * tanhf(nc);
      float kc = 1.0f - zoneout, zc = zoneout, kh = kc, zh = zc;
      if (use_masks) {
        kc = p.in[I_MC2][ru + j];
        zc = 1.0f - kc;
        kh = p.in[I_MH2][ru + j];
        zh = 1.0f - kh;
      }
      c2[j] = kc * nc + zc * cp;
      x2[U + j] = kh * nh + zh * hp;
      o2[j] = nh;
      O(p, O_OUT2)[ru + j] = nh;
    }
    __syncthreads();

    // query projection
    matvec_rows<1>(W(p, W_WQT), nullptr, A, U, o2, 0, 1, pq, 0, ACT_NONE);
    __syncthreads();

    // energies: one warp per encoder position, lanes over filters, then
    // over the attention dim
    for (int t = warp; t < T_in; t += TR_WARPS) {
      float* fb = sm + L.fbuf + warp * tr_up4(F);
      tr_loc_features(cum, wconv, t, T_in, d.taps, F, fb);
      float e = 0.0f;
      for (int a = lane; a < A; a += 32)
        e = fmaf(vv[a], tanhf(tr_energy_arg(fb, wloc, F, A, a, keys[(size_t)t * A + a], pq[a], ball[a])), e);
      e = warp_sum(e);
      if (lane == 0) en[t] = mask[t] > 0.0f ? e : -1e9f;
      __syncwarp();
    }
    __syncthreads();

    // masked softmax, cumulate, forward recursion, normalise (warp 0)
    if (warp == 0) {
      float m = -INFINITY;
      for (int t = lane; t < T_in; t += 32) m = fmaxf(m, en[t]);
      m = warp_max(m);
      float z = 0.0f;
      for (int t = lane; t < T_in; t += 32) z += expf(en[t] - m);
      z = warp_sum(z);
      float s2 = 0.0f;
      for (int t = lane; t < T_in; t += 32) {
        const float a_sm = expf(en[t] - m) / z;
        O(p, O_ALIGN_SM)[rt + t] = a_sm;
        cum[t] += a_sm;
        const float shifted = t > 0 ? alpha[t - 1] : 0.0f;
        const float pre = ((1.0f - mu) * alpha[t] + mu * shifted + 1e-10f) * a_sm;
        al[t] = pre;
        s2 += pre;
      }
      s2 = warp_sum(s2);
      __syncwarp();
      for (int t = lane; t < T_in; t += 32) {
        const float a = al[t] / s2;
        al[t] = a;
        O(p, O_ALIGN)[rt + t] = a;
      }
    }
    __syncthreads();

    // context = align . values, the next step's LSTM1 input
    for (int v = tid; v < V; v += nthr) {
      float acc = 0.0f;
      for (int t = 0; t < T_in; ++t) acc = fmaf(al[t], values[(size_t)t * V + v], acc);
      x1[P + v] = acc;
      O(p, O_CTX)[rv + v] = acc;
    }
    for (int t = tid; t < T_in; t += nthr) alpha[t] = al[t];
    __syncthreads();

    // next mu = sigmoid(ctx . mu_c + out2 . mu_q + mu_b)
    float part = 0.0f;
    for (int i = tid; i < V + U; i += nthr)
      part += i < V ? x1[P + i] * W(p, W_MUC)[i] : o2[i - V] * W(p, W_MUQ)[i - V];
    mu = sigmoidf_(tr_block_sum(part, red) + W(p, W_MUB)[0]);
  }
}

}  // namespace

// Dynamic shared-memory bytes of one block (the wrapper's envelope check
// mirrors this; chip_smoke compares the two).
extern "C" int tacotron_train_smem_bytes(int backward, int T_in, int P, int U, int V, int A,
                                         int F, int taps) {
  TrDims d{1, 1, T_in, P, U, V, A, F, taps};
  return (backward ? bwd_layout(d).total : fwd_layout(d).total) * (int)sizeof(float);
}

// Launches the forward on ``stream``.  ``ptrs`` holds N_PTRS device
// pointers in enum order (mask slots may be null when use_masks is 0):
// p_seq [T, B, P], the four zoneout keep-masks [T, B, U], keys [B, T_in, A],
// values [B, T_in, V], mem_mask [B, T_in]; the weights l1T [4U, P+V+U],
// l1_b [4U], l2T [4U, 2U], l2_b [4U], wqT [A, U], w_conv [taps, F],
// w_loc [F, A], ball [A], v [A], mu_c [V], mu_q [U], mu_b [1]; then the
// outputs in FWD_OUTS order ([T, B, ...], mup [T, B]).
// Returns the CUDA error of the launch (0 on success).
extern "C" int tacotron_train_fwd_launch(void* const* ptrs, int B, int T, int T_in, int P, int U,
                                         int V, int A, int F, int taps, int use_masks,
                                         float zoneout, void* stream) {
  Ptrs p;
  for (int i = 0; i < W_L1T; ++i) p.in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = W_L1T; i < O_OUT2; ++i) p.w[i - W_L1T] = static_cast<const float*>(ptrs[i]);
  for (int i = O_OUT2; i < N_PTRS; ++i) p.out[i - O_OUT2] = static_cast<float*>(ptrs[i]);
  TrDims d{B, T, T_in, P, U, V, A, F, taps};
  const int smem = fwd_layout(d).total * (int)sizeof(float);
  if (smem > TR_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tacotron_train_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tacotron_train_fwd_kernel<<<B, TR_THREADS, smem, (cudaStream_t)stream>>>(p, d, use_masks, zoneout);
  return (int)cudaGetLastError();
}
