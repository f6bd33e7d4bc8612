// Tacotron-2 teacher-forced decoder core, backward (training): one launch
// runs the reverse-time adjoint of tacotron_train_fwd.cu over every step.
//
// Replaces the TPU kernel
// tacotronv2_wavernn_chinese_tpu/ops/tacotron_trainer_kernel.py
// (_bwd_call, _bwd_kernel) in its "stream" weight-gradient layout.  Per
// step, last to first, for each row: rebuild cum_{t-1} = cum_t - align_sm_t
// (cum_T comes from the wrapper) -> recompute mu_t and add the adjoint of
// mu -> context adjoint into the alignment adjoint -> normalisation and
// forward-recursion adjoints (carrying alpha and mu adjoints) -> softmax
// adjoint -> recompute the energies and run the adjoint of tanh, the F->A
// location dense and the location conv, whose transpose adds into the
// carried cum adjoint -> query projection adjoint -> LSTM2 and LSTM1
// adjoints with gates recomputed from the saves (zoneout masks in train
// mode, the EMA factors in eval mode).  Written per step: d_g1, d_g2
// [T, B, 4U], d_q [T, B, A], d_mulin [T, B], d_ctx_tot [T, B, V]; the
// wrapper contracts them against the saves for the gate, query and mu
// weight gradients, the prenet cotangent and d_values (ops/
// tacotron_trainer_kernel.py weight_grads).  Kept in the kernel: d_keys
// [B, T_in, A] and per-row partials of d_conv [B, taps, F], d_wloc
// [B, F, A], d_v and d_ball [B, A], each written by its own block with no
// atomics; the wrapper sums the partials over rows.
//
// What bounds it on the card: like the forward, the serial steps and the
// weights streamed from L2 every step, about twice the forward's bytes
// (the gate matrices are read for the recompute in [out, in] layout and
// for the W^T d products in [in, out] layout).  Design: one block per row
// (tacotron_train_common.cuh); state and adjoints in shared memory; the
// per-position location features, d_th and d_f of a step go to a per-row
// global scratch (L2-resident) so the reductions over positions (d_wloc,
// d_conv, the conv transpose) need no atomics.
#include "tacotron_train_common.cuh"

namespace {

// Pointer-array slots (ops/tacotron_trainer_kernel.py train_bwd).
enum {
  I_P, I_MC1, I_MH1, I_MC2, I_MH2, I_KEYS, I_VALUES, I_MASK, I_CUMT, I_GOUT2, I_GCTX, I_GALIGN,
  W_L1T, W_L1B, W_L2T, W_L2B, W_WQT, W_WCONV, W_WLOC, W_BALL, W_V, W_MUC, W_MUQ, W_MUB,
  W_L1IO, W_L2IO, W_WQIO, W_WLOCT,
  S_OUT2, S_CTX, S_ALIGN, S_ALIGN_SM, S_OUT1, S_C1P, S_H1P, S_C2P, S_H2P, S_CTXP, S_ALPHAP, S_MUP,
  O_DG1, O_DG2, O_DQ, O_DMULIN, O_DCTX, O_DKEYS, O_DCONV, O_DWLOC, O_DV, O_DBALL, O_SCRATCH,
  N_PTRS
};

struct Ptrs {
  const float* c[O_DG1];
  float* o[N_PTRS - O_DG1];
};

__device__ __forceinline__ float* O(const Ptrs& p, int i) { return p.o[i - O_DG1]; }

__global__ void __launch_bounds__(TR_THREADS, 1)
tacotron_train_bwd_kernel(Ptrs p, TrDims d, int use_masks, float zoneout) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const BwdLayout L = bwd_layout(d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthr = blockDim.x;
  const int b = blockIdx.x;
  const int B = d.B, T_in = d.T_in, P = d.P, U = d.U, V = d.V, A = d.A, F = d.F, taps = d.taps;
  const int A4 = tr_up4(A), padl = (taps - 1) / 2;
  float *x1 = sm + L.x1, *x2 = sm + L.x2, *o2 = sm + L.o2, *g = sm + L.g, *dg = sm + L.dg;
  float *ac1 = sm + L.ac1, *ah1 = sm + L.ah1, *ac2 = sm + L.ac2, *ah2 = sm + L.ah2;
  float *actx = sm + L.actx, *dctx = sm + L.dctx, *dout2 = sm + L.dout2;
  float *y1 = sm + L.y1, *y2 = sm + L.y2, *y3 = sm + L.y3;
  float *pq = sm + L.pq, *dq = sm + L.dq, *dv = sm + L.dv, *dball = sm + L.dball;
  float *wconv = sm + L.wconv, *wloc = sm + L.wloc, *wlocT = sm + L.wlocT, *red = sm + L.red;
  float *cum = sm + L.cum, *aalpha = sm + L.aalpha, *acum = sm + L.acum;
  float *bufA = sm + L.bufA, *bufE = sm + L.bufE;
  const float* keys = p.c[I_KEYS] + (size_t)b * T_in * A;
  const float* values = p.c[I_VALUES] + (size_t)b * T_in * V;
  const float* ball = p.c[W_BALL];
  const float* vv = p.c[W_V];
  const float* mu_c = p.c[W_MUC];
  const float* mu_q = p.c[W_MUQ];
  float* dkeys = O(p, O_DKEYS) + (size_t)b * T_in * A;
  float* dconv = O(p, O_DCONV) + (size_t)b * taps * F;
  float* dwloc = O(p, O_DWLOC) + (size_t)b * F * A;
  float* FT = O(p, O_SCRATCH) + (size_t)b * T_in * (2 * F + A);  // [T_in, F] features
  float* DF = FT + (size_t)T_in * F;                                // [T_in, F] d_f
  float* DTH = DF + (size_t)T_in * F;                               // [T_in, A] d_th

  for (int i = tid; i < taps * F; i += nthr) wconv[i] = p.c[W_WCONV][i];
  for (int i = tid; i < F * A; i += nthr) {
    wloc[i] = p.c[W_WLOC][i];
    wlocT[i] = p.c[W_WLOCT][i];
  }
  for (int i = tid; i < U; i += nthr) ac1[i] = ah1[i] = ac2[i] = ah2[i] = 0.0f;
  for (int i = tid; i < V; i += nthr) actx[i] = 0.0f;
  for (int i = tid; i < A; i += nthr) dv[i] = dball[i] = 0.0f;
  for (int t = tid; t < T_in; t += nthr) {
    aalpha[t] = acum[t] = 0.0f;
    cum[t] = p.c[I_CUMT][(size_t)b * T_in + t];
  }
  for (int i = tid; i < T_in * A; i += nthr) dkeys[i] = 0.0f;
  for (int i = tid; i < taps * F; i += nthr) dconv[i] = 0.0f;
  for (int i = tid; i < F * A; i += nthr) dwloc[i] = 0.0f;
  float amu = 0.0f;
  __syncthreads();

  for (int s = d.T - 1; s >= 0; --s) {
    const size_t r = (size_t)s * B + b;
    const size_t ru = r * U, rv = r * V, rt = r * T_in, rp = r * P, rg = r * 4 * U, ra = r * A;
    const float* align_sm = p.c[S_ALIGN_SM] + rt;
    const float* align_t = p.c[S_ALIGN] + rt;
    const float* alphap = p.c[S_ALPHAP] + rt;
    const float mup = p.c[S_MUP][r];

    // 1. loads; cum_{t-1}; recompute mu_t and add the mu adjoint
    for (int t = tid; t < T_in; t += nthr) cum[t] -= align_sm[t];
    for (int i = tid; i < U; i += nthr) {
      x2[i] = p.c[S_OUT1][ru + i];
      x2[U + i] = p.c[S_H2P][ru + i];
      o2[i] = p.c[S_OUT2][ru + i];
      dout2[i] = p.c[I_GOUT2][ru + i];
      x1[P + V + i] = p.c[S_H1P][ru + i];
    }
    for (int i = tid; i < V; i += nthr) {
      x1[P + i] = p.c[S_CTXP][rv + i];
      dctx[i] = p.c[I_GCTX][rv + i] + actx[i];
    }
    for (int i = tid; i < P; i += nthr) x1[i] = p.c[I_P][rp + i];
    float part = 0.0f;
    for (int i = tid; i < V + U; i += nthr)
      part += i < V ? p.c[S_CTX][rv + i] * mu_c[i] : p.c[S_OUT2][ru + i - V] * mu_q[i - V];
    const float mu_t = sigmoidf_(tr_block_sum(part, red) + p.c[W_MUB][0]);
    const float d_lin = amu * mu_t * (1.0f - mu_t);
    for (int i = tid; i < V; i += nthr) {
      dctx[i] += d_lin * mu_c[i];
      O(p, O_DCTX)[rv + i] = dctx[i];
    }
    for (int i = tid; i < U; i += nthr) dout2[i] += d_lin * mu_q[i];
    if (tid == 0) O(p, O_DMULIN)[r] = d_lin;
    __syncthreads();

    // 2. alignment adjoint: cotangent + carried alpha adjoint + values . d_ctx
    for (int t = warp; t < T_in; t += TR_WARPS) {
      float acc = 0.0f;
      for (int v = lane; v < V; v += 32) acc = fmaf(values[(size_t)t * V + v], dctx[v], acc);
      acc = warp_sum(acc);
      if (lane == 0) bufA[t] = p.c[I_GALIGN][rt + t] + aalpha[t] + acc;
    }
    __syncthreads();

    // 3. normalisation: align = pre / S, pre = w * align_sm
    float pa = 0.0f, pb = 0.0f;
    for (int t = tid; t < T_in; t += nthr) {
      const float w = (1.0f - mup) * alphap[t] + mup * (t > 0 ? alphap[t - 1] : 0.0f) + 1e-10f;
      pa += bufA[t] * align_t[t];
      pb += w * align_sm[t];
    }
    const float2 r1S = tr_block_sum2(pa, pb, red);
    for (int t = tid; t < T_in; t += nthr) {
      const float w = (1.0f - mup) * alphap[t] + mup * (t > 0 ? alphap[t - 1] : 0.0f) + 1e-10f;
      const float d_pre = (bufA[t] - r1S.x) / r1S.y;
      bufE[t] = d_pre * w + acum[t];  // d_align_sm
      bufA[t] = d_pre * align_sm[t];  // d_w
    }
    __syncthreads();

    // 4. forward recursion: alpha_{t-1} and mu_{t-1} adjoints
    pa = 0.0f;
    pb = 0.0f;
    for (int t = tid; t < T_in; t += nthr) {
      const float dw = bufA[t];
      aalpha[t] = dw * (1.0f - mup) + (t + 1 < T_in ? bufA[t + 1] * mup : 0.0f);
      pa += dw * ((t > 0 ? alphap[t - 1] : 0.0f) - alphap[t]);
      pb += bufE[t] * align_sm[t];
    }
    const float2 dmu_r2 = tr_block_sum2(pa, pb, red);

    // 5. softmax adjoint d_e; query projection; clear the per-warp sums
    for (int t = tid; t < T_in; t += nthr) bufE[t] = align_sm[t] * (bufE[t] - dmu_r2.y);
    for (int i = tid; i < TR_WARPS * A4; i += nthr) sm[L.partq + i] = sm[L.partv + i] = 0.0f;
    matvec_rows<1>(p.c[W_WQT], nullptr, A, U, o2, 0, 1, pq, 0, ACT_NONE);
    __syncthreads();

    // 6. energies recomputed and differentiated, one warp per position
    for (int t = warp; t < T_in; t += TR_WARPS) {
      float* fb = sm + L.fbuf + warp * tr_up4(F);
      float* db = sm + L.dthbuf + warp * A4;
      float* pqw = sm + L.partq + warp * A4;
      float* pvw = sm + L.partv + warp * A4;
      tr_loc_features(cum, wconv, t, T_in, taps, F, fb);
      for (int f = lane; f < F; f += 32) FT[(size_t)t * F + f] = fb[f];
      const float de = bufE[t];
      for (int a = lane; a < A; a += 32) {
        const float th = tanhf(tr_energy_arg(fb, wloc, F, A, a, keys[(size_t)t * A + a], pq[a], ball[a]));
        const float dth = de * vv[a] * (1.0f - th * th);
        db[a] = dth;
        DTH[(size_t)t * A + a] = dth;
        pqw[a] += dth;
        pvw[a] += th * de;
        dkeys[(size_t)t * A + a] += dth;
      }
      __syncwarp();
      for (int f = lane; f < F; f += 32) {
        float acc = 0.0f;
        for (int a = 0; a < A; ++a) acc = fmaf(db[a], wlocT[a * F + f], acc);
        DF[(size_t)t * F + f] = acc;
      }
      __syncwarp();
    }
    __syncthreads();

    // 7. reductions over positions: d_q, d_ball, d_v, d_wloc, d_conv and
    //    the conv transpose (the cum_{t-1} adjoint)
    for (int a = tid; a < A; a += nthr) {
      float q = 0.0f, vs = 0.0f;
      for (int w = 0; w < TR_WARPS; ++w) {
        q += sm[L.partq + w * A4 + a];
        vs += sm[L.partv + w * A4 + a];
      }
      dq[a] = q;
      O(p, O_DQ)[ra + a] = q;
      dball[a] += q;
      dv[a] += vs;
    }
    for (int i = tid; i < F * A; i += nthr) {
      const int f = i / A, a = i - f * A;
      float acc = 0.0f;
      for (int t = 0; t < T_in; ++t) acc = fmaf(FT[(size_t)t * F + f], DTH[(size_t)t * A + a], acc);
      dwloc[i] += acc;
    }
    for (int i = tid; i < taps * F; i += nthr) {
      const int k = i / F, f = i - k * F;
      float acc = 0.0f;
      for (int t = 0; t < T_in; ++t) {
        const int tt = t + k - padl;
        if (tt >= 0 && tt < T_in) acc = fmaf(cum[tt], DF[(size_t)t * F + f], acc);
      }
      dconv[i] += acc;
    }
    for (int sp = tid; sp < T_in; sp += nthr) {
      float acc = 0.0f;
      for (int k = 0; k < taps; ++k) {
        const int t = sp + padl - k;
        if (t < 0 || t >= T_in) continue;
        for (int f = 0; f < F; ++f) acc = fmaf(DF[(size_t)t * F + f], wconv[k * F + f], acc);
      }
      bufA[sp] = acc;
    }
    __syncthreads();

    // 8. cum adjoint; d_out2 from the query projection; LSTM2 gates
    for (int t = tid; t < T_in; t += nthr) acum[t] += bufA[t];
    matvec_rows<1>(p.c[W_WQIO], nullptr, U, A, dq, 0, 1, y3, 0, ACT_NONE);
    matvec_rows<1>(p.c[W_L2T], p.c[W_L2B], 4 * U, 2 * U, x2, 0, 1, g, 0, ACT_NONE);
    __syncthreads();

    // 9. LSTM2 adjoint
    for (int j = tid; j < U; j += nthr) {
      const float d_o2 = dout2[j] + y3[j];
      const Gates q = tr_gates(g, U, j);
      const float cp = p.c[S_C2P][ru + j];
      const float thc = tanhf(q.sf * cp + q.si * q.tj);
      float kc = 1.0f - zoneout, zc = zoneout, kh = kc, zh = zc;
      if (use_masks) {
        kc = p.c[I_MC2][ru + j];
        zc = 1.0f - kc;
        kh = p.c[I_MH2][ru + j];
        zh = 1.0f - kh;
      }
      const float dnh = ah2[j] * kh + d_o2;
      const float dnc = ac2[j] * kc + dnh * q.so * (1.0f - thc * thc);
      ac2[j] = ac2[j] * zc + dnc * q.sf;
      ah2[j] = ah2[j] * zh;
      dg[j] = dnc * q.tj * q.si * (1.0f - q.si);
      dg[U + j] = dnc * q.si * (1.0f - q.tj * q.tj);
      dg[2 * U + j] = dnc * cp * q.sf * (1.0f - q.sf);
      dg[3 * U + j] = dnh * thc * q.so * (1.0f - q.so);
      for (int k = 0; k < 4; ++k) O(p, O_DG2)[rg + k * U + j] = dg[k * U + j];
    }
    __syncthreads();

    // 10. [d_out1 | d_h2] = l2 d_g2; LSTM1 gates
    matvec_rows<1>(p.c[W_L2IO], nullptr, 2 * U, 4 * U, dg, 0, 1, y2, 0, ACT_NONE);
    matvec_rows<1>(p.c[W_L1T], p.c[W_L1B], 4 * U, P + V + U, x1, 0, 1, g, 0, ACT_NONE);
    __syncthreads();

    // 11. LSTM1 adjoint
    for (int j = tid; j < U; j += nthr) {
      ah2[j] += y2[U + j];
      const Gates q = tr_gates(g, U, j);
      const float cp = p.c[S_C1P][ru + j];
      const float thc = tanhf(q.sf * cp + q.si * q.tj);
      float kc = 1.0f - zoneout, zc = zoneout, kh = kc, zh = zc;
      if (use_masks) {
        kc = p.c[I_MC1][ru + j];
        zc = 1.0f - kc;
        kh = p.c[I_MH1][ru + j];
        zh = 1.0f - kh;
      }
      const float dnh = ah1[j] * kh + y2[j];
      const float dnc = ac1[j] * kc + dnh * q.so * (1.0f - thc * thc);
      ac1[j] = ac1[j] * zc + dnc * q.sf;
      ah1[j] = ah1[j] * zh;
      dg[j] = dnc * q.tj * q.si * (1.0f - q.si);
      dg[U + j] = dnc * q.si * (1.0f - q.tj * q.tj);
      dg[2 * U + j] = dnc * cp * q.sf * (1.0f - q.sf);
      dg[3 * U + j] = dnh * thc * q.so * (1.0f - q.so);
      for (int k = 0; k < 4; ++k) O(p, O_DG1)[rg + k * U + j] = dg[k * U + j];
    }
    __syncthreads();

    // 12. [a_ctx | d_h1] = l1[ctx | h rows] d_g1 (the prenet rows are
    //     contracted outside, as d_pre)
    matvec_rows<1>(p.c[W_L1IO] + (size_t)P * 4 * U, nullptr, V + U, 4 * U, dg, 0, 1, y1, 0, ACT_NONE);
    __syncthreads();
    for (int i = tid; i < V; i += nthr) actx[i] = y1[i];
    for (int j = tid; j < U; j += nthr) ah1[j] += y1[V + j];
    amu = dmu_r2.x;
    __syncthreads();
  }
  for (int a = tid; a < A; a += nthr) {
    O(p, O_DV)[(size_t)b * A + a] = dv[a];
    O(p, O_DBALL)[(size_t)b * A + a] = dball[a];
  }
}

}  // namespace

// Launches the backward on ``stream``.  ``ptrs`` holds N_PTRS device
// pointers in enum order (mask slots may be null when use_masks is 0):
// p_seq, the four zoneout keep-masks, keys, values, mem_mask, cum_T
// [B, T_in], the cotangents of out2, ctx and align; the forward's weight
// pointers (tacotron_train_fwd.cu order), then l1 [P+V+U, 4U], l2
// [2U, 4U], wq [U, A] in [in, out] layout and w_locT [A, F]; the forward's
// outputs in FWD_OUTS order; the outputs in BWD_OUTS order; scratch
// [B, T_in * (2F + A)].  Returns the CUDA error of the launch.
extern "C" int tacotron_train_bwd_launch(void* const* ptrs, int B, int T, int T_in, int P, int U,
                                         int V, int A, int F, int taps, int use_masks,
                                         float zoneout, void* stream) {
  Ptrs p;
  for (int i = 0; i < O_DG1; ++i) p.c[i] = static_cast<const float*>(ptrs[i]);
  for (int i = O_DG1; i < N_PTRS; ++i) p.o[i - O_DG1] = static_cast<float*>(ptrs[i]);
  TrDims d{B, T, T_in, P, U, V, A, F, taps};
  const int smem = bwd_layout(d).total * (int)sizeof(float);
  if (smem > TR_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tacotron_train_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tacotron_train_bwd_kernel<<<B, TR_THREADS, smem, (cudaStream_t)stream>>>(p, d, use_masks, zoneout);
  return (int)cudaGetLastError();
}
