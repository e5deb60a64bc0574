// K2 and K2b: the CTC alpha/beta recursion with the posterior gradient, and
// its Hessian-vector product, one kernel each.
//
// K2, ctc_alpha_beta_kernel, replaces the Pallas kernel
// metaasr_tpu/ops/ctc_pallas.py:66 _ctc_kernel (pallas_call at :276 in
// _ctc_run). Same function, laid out for the GPU:
//
//   in : logp_z [B, T, S] f32 (label-gathered log-probs, S = 2U+1, no lane
//        padding), skip_bias [B, S] f32 (0 or LOG_EPS), lens [B] i32 (valid
//        frames), end [B] i32 (= 2 * label length)
//   out: nll [B] f32, grad [B, T, S] f32 = d nll / d logp_z
//        = -exp(alpha + beta + nll) for t < lens, 0 for t >= lens
//
// Design. One block per utterance, one thread per lane s (block size S
// rounded up to a warp). The alpha row lives in registers and a
// double-buffered shared row; one __syncthreads() per time step publishes
// it to the neighbouring lanes (s-1, s-2). The alpha history is written
// into the grad output buffer itself; the beta pass then runs backward over
// it, reading alpha[t, s] and overwriting the same element with the
// gradient, so no scratch buffer exists (the TPU kernel keeps a VMEM
// scratch of [T, BB, S_pad]). beta[t] + logp[t] is published through a
// second shared row, again one barrier per step. Any T is taken: the only
// per-utterance state on chip is two rows of S floats.
//
// Arithmetic follows the reference exactly: lse3 clamps its max at LOG_EPS
// before subtracting, the sums run (a + b) + c, alpha freezes for
// t >= lens, beta restarts at each row's own lens - 1, and the NLL is read
// from lanes end and end - 1. IEEE expf/logf (no fast math), no FMAs on the
// recursion (it has no products).
//
// Bound. Per element the reference's cost estimate counts 10 flops and 6
// transcendentals, and the bytes are logp_z read and grad written (twice
// each in the TPU estimate, once each as a lower bound). At the meta-step
// shapes ([4..16, 99, 65]) both give well under a microsecond on an H100.
// What bounds the kernel is the dependency chain: 2*T sequential steps, each
// a barrier, a shared-memory round trip and an expf/logf chain, with only B
// blocks (4..16) busy on 132 SMs. Later work could keep the alpha history in
// shared memory when it fits, map short S to one warp (no block barrier),
// fuse the label gather, or pack several utterances into one block.
//
// K2b, ctc_hvp_kernel, replaces the second-order wiring of the same file,
// metaasr_tpu/ops/ctc_pallas.py:191 _ctc_pair_jvp, whose tangent is
// jvp(grad(_scan_nll_gathered)) through a lax.scan (:131) that XLA compiles
// into one program. Here it is the forward-mode tangent of K2's own
// recursion along a direction v, in one launch:
//
//   in : K2's four inputs and v [B, T, S] f32
//   out: hv [B, T, S] f32 = (d^2 nll / d logp_z^2) v, nll_dot [B] = <grad, v>
//   scratch: adot [B, T, S] f32, allocated by the caller
//
//   adot[0, s]  = v[0, s] on the lanes alpha[0] emits (s = 0; s = 1 if
//                 end > 0), else 0
//   adot[t, s]  = v[t, s] + sum_k w_k adot[t-1, s-k],  w = softmax of K2's
//                 three terms (alpha[s], alpha[s-1], alpha[s-2] + skip[s]);
//                 frozen with alpha for t >= lens
//   nll_dot     = -sum softmax(alpha[T-1, {end, end-1}]) adot[T-1, .]
//   bdot[t-1,s] = sum_k w'_k (bdot[t, s+k] + v[t, s+k]) over K2's beta step,
//                 0 at each row's own lens - 1
//   hv[t, s]    = grad[t, s] * ((adot[t, s] + bdot[t, s]) + nll_dot),
//                 0 for t >= lens
//
// A state whose alpha (or beta) is below LOG_EPS / 2 is unreachable: its
// tangent is 0 (the reference clamps alpha at LOG_EPS with a maximum, which
// routes the tangent to the constant), and its posterior is 0 anyway. The
// guard is per lane, so no NaN is ever made and none is swept away. A row
// whose labels do not fit its frames (nll > -LOG_EPS / 2) gives hv = 0 and
// nll_dot = 0: the clamped loss is constant there.
//
// Design: K2's, doubled. alpha and adot each have a register, a
// double-buffered shared row (16 KB of shared memory in all) and a [T, S]
// history: alpha's in the hv buffer, as K2 keeps it in grad, adot's in the
// scratch. The beta pass reads both at t, and overwrites alpha with hv. The
// weights reuse lse3's three exponentials, e_k / sum. Products and sums are
// written with __fmul_rn / __fadd_rn so that nvcc contracts none into an
// FMA and the order matches the plain PyTorch version.
//
// Bound. Bytes the function must move: logp_z and v read, hv written,
// 3 * B*T*S*4 (counted as K2's are: inputs once, outputs once). This design
// moves 5 * B*T*S*4, because it also writes and reads the adot scratch; that
// is its own traffic, which histories kept in shared memory would remove, so
// it is not part of the bound. Operations: K2's 16 per element for the
// primal, and for the tangent 7 per element and pass (3 products, 3 sums,
// 1 division) plus 3 for hv: 33 per element. Both are far below a
// microsecond at [16, 99, 65]; as for K2 the floor is the chain of 2*T
// dependent steps on B of 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#define LOG_EPS (-1e30f)
#define HALF_EPS (-5e29f)  // below this a state is unreachable
#define MAX_S 1024

__device__ __forceinline__ float lse3(float a, float b, float c) {
  float m = fmaxf(fmaxf(a, b), c);
  float m_safe = fmaxf(m, LOG_EPS);
  return m + logf((expf(a - m_safe) + expf(b - m_safe)) + expf(c - m_safe));
}

__global__ void ctc_alpha_beta_kernel(const float* __restrict__ logp,
                                      const float* __restrict__ skip,
                                      const int32_t* __restrict__ lens,
                                      const int32_t* __restrict__ ends,
                                      float* __restrict__ nll,
                                      float* __restrict__ grad,
                                      int T, int S) {
  __shared__ float row[2][MAX_S];
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool lane = s < S;
  const int len = lens[b];
  const int end = ends[b];
  const float* lp = logp + (size_t)b * T * S;
  float* g = grad + (size_t)b * T * S;
  const float skip_s = lane ? skip[(size_t)b * S + s] : 0.0f;
  const float skip_s2 = (s + 2 < S) ? skip[(size_t)b * S + s + 2] : 0.0f;

  // ---- alpha pass: history into grad ----
  float lp_t = lane ? lp[s] : 0.0f;
  float alpha = LOG_EPS;
  if (s == 0) alpha = lp_t;
  if (s == 1 && end > 0) alpha = lp_t;
  if (lane) {
    g[s] = alpha;
    row[0][s] = alpha;
  }
  float lp_next = (lane && T > 1) ? lp[(size_t)S + s] : 0.0f;
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* prev = row[(t - 1) & 1];
    lp_t = lp_next;
    if (lane && t + 1 < T) lp_next = lp[(size_t)(t + 1) * S + s];
    if (lane) {
      float a1 = s >= 1 ? prev[s - 1] : LOG_EPS;
      float a2 = s >= 2 ? prev[s - 2] : LOG_EPS;
      float nw = lp_t + lse3(alpha, a1, a2 + skip_s);
      if (t < len) alpha = nw;
      g[(size_t)t * S + s] = alpha;
      row[t & 1][s] = alpha;
    }
    __syncthreads();
  }

  // ---- nll from the end lanes of the final alpha row ----
  const float* fin = row[(T - 1) & 1];
  float a_last = fin[end];
  float a_prev = end > 0 ? fin[end - 1] : LOG_EPS;
  float m = end > 0 ? fmaxf(a_last, a_prev) : a_last;
  float m_safe = fmaxf(m, LOG_EPS);
  float sum = expf(a_last - m_safe);
  if (end > 0) sum = sum + expf(a_prev - m_safe);
  const float nll_b = -(m + logf(sum));
  if (s == 0) nll[b] = nll_b;
  __syncthreads();  // every lane has read fin before row is reused

  // ---- beta pass: grad rows from t = T-1 down ----
  const bool pick = (s == end) || (s == end - 1 && end > 0);
  const float beta_init = pick ? 0.0f : LOG_EPS;
  float carry = beta_init;
  lp_t = lane ? lp[(size_t)(T - 1) * S + s] : 0.0f;
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    float* cur = row[i & 1];
    float beta_t = (t >= len - 1) ? beta_init : carry;
    float lp_prev = (lane && t > 0) ? lp[(size_t)(t - 1) * S + s] : 0.0f;
    if (lane) {
      size_t at = (size_t)t * S + s;
      g[at] = t < len ? -expf(g[at] + beta_t + nll_b) : 0.0f;
      cur[s] = beta_t + lp_t;
    }
    __syncthreads();
    if (lane) {
      float b0 = cur[s];
      float b1 = s + 1 < S ? cur[s + 1] : LOG_EPS;
      float b2 = s + 2 < S ? cur[s + 2] + skip_s2 : LOG_EPS;
      carry = lse3(b0, b1, b2);
    }
    lp_t = lp_prev;
  }
}

// sum_k e_k d_k / sum, in the order ((e0 d0 + e1 d1) + e2 d2) / sum
__device__ __forceinline__ float mix3(float e0, float e1, float e2, float d0,
                                      float d1, float d2, float sum) {
  float num = __fadd_rn(__fadd_rn(__fmul_rn(e0, d0), __fmul_rn(e1, d1)),
                        __fmul_rn(e2, d2));
  return __fdiv_rn(num, sum);
}

__global__ void ctc_hvp_kernel(const float* __restrict__ logp,
                               const float* __restrict__ skip,
                               const int32_t* __restrict__ lens,
                               const int32_t* __restrict__ ends,
                               const float* __restrict__ vdir,
                               float* __restrict__ adot_hist,
                               float* __restrict__ hv,
                               float* __restrict__ nll_dot, int T, int S) {
  __shared__ float row[2][MAX_S];   // alpha, then beta + logp
  __shared__ float rowd[2][MAX_S];  // their tangents
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool lane = s < S;
  const int len = lens[b];
  const int end = ends[b];
  const float* lp = logp + (size_t)b * T * S;
  const float* vv = vdir + (size_t)b * T * S;
  float* out = hv + (size_t)b * T * S;
  float* hist = adot_hist + (size_t)b * T * S;
  const float skip_s = lane ? skip[(size_t)b * S + s] : 0.0f;
  const float skip_s2 = (s + 2 < S) ? skip[(size_t)b * S + s + 2] : 0.0f;

  // ---- alpha pass: alpha history into hv, adot history into the scratch --
  float lp_t = lane ? lp[s] : 0.0f;
  float v_t = lane ? vv[s] : 0.0f;
  float alpha = LOG_EPS;
  float ad = 0.0f;
  if (s == 0 || (s == 1 && end > 0)) {
    alpha = lp_t;
    ad = v_t;
  }
  if (lane) {
    out[s] = alpha;
    hist[s] = ad;
    row[0][s] = alpha;
    rowd[0][s] = ad;
  }
  float lp_next = (lane && T > 1) ? lp[(size_t)S + s] : 0.0f;
  float v_next = (lane && T > 1) ? vv[(size_t)S + s] : 0.0f;
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* prev = row[(t - 1) & 1];
    const float* prevd = rowd[(t - 1) & 1];
    lp_t = lp_next;
    v_t = v_next;
    if (lane && t + 1 < T) {
      lp_next = lp[(size_t)(t + 1) * S + s];
      v_next = vv[(size_t)(t + 1) * S + s];
    }
    if (lane) {
      float x1 = s >= 1 ? prev[s - 1] : LOG_EPS;
      float x2 = (s >= 2 ? prev[s - 2] : LOG_EPS) + skip_s;
      float d1 = s >= 1 ? prevd[s - 1] : 0.0f;
      float d2 = s >= 2 ? prevd[s - 2] : 0.0f;
      float m = fmaxf(fmaxf(alpha, x1), x2);
      float m_safe = fmaxf(m, LOG_EPS);
      float e0 = expf(alpha - m_safe);
      float e1 = expf(x1 - m_safe);
      float e2 = expf(x2 - m_safe);
      float sum = (e0 + e1) + e2;
      float nw = lp_t + (m + logf(sum));
      float nd = nw > HALF_EPS
                     ? __fadd_rn(v_t, mix3(e0, e1, e2, ad, d1, d2, sum))
                     : 0.0f;
      if (t < len) {
        alpha = nw;
        ad = nd;
      }
      out[(size_t)t * S + s] = alpha;
      hist[(size_t)t * S + s] = ad;
      row[t & 1][s] = alpha;
      rowd[t & 1][s] = ad;
    }
    __syncthreads();
  }

  // ---- nll and its tangent from the end lanes of the final rows ----
  const float* fin = row[(T - 1) & 1];
  const float* find = rowd[(T - 1) & 1];
  float a_last = fin[end];
  float a_prev = end > 0 ? fin[end - 1] : LOG_EPS;
  float m = end > 0 ? fmaxf(a_last, a_prev) : a_last;
  float m_safe = fmaxf(m, LOG_EPS);
  float e_last = expf(a_last - m_safe);
  float e_prev = end > 0 ? expf(a_prev - m_safe) : 0.0f;
  float sum = end > 0 ? e_last + e_prev : e_last;
  const float nll_b = -(m + logf(sum));
  const bool feasible = !(nll_b > -HALF_EPS);
  float nd_b = 0.0f;
  if (feasible) {
    float d_last = find[end];
    float d_prev = end > 0 ? find[end - 1] : 0.0f;
    nd_b = -__fdiv_rn(
        __fadd_rn(__fmul_rn(e_last, d_last), __fmul_rn(e_prev, d_prev)), sum);
  }
  if (s == 0) nll_dot[b] = nd_b;
  __syncthreads();  // every lane has read the final rows before their reuse

  // ---- beta pass: hv rows from t = T-1 down ----
  const bool pick = (s == end) || (s == end - 1 && end > 0);
  const float beta_init = pick ? 0.0f : LOG_EPS;
  float carry = beta_init;
  float carryd = 0.0f;
  lp_t = lane ? lp[(size_t)(T - 1) * S + s] : 0.0f;
  v_t = lane ? vv[(size_t)(T - 1) * S + s] : 0.0f;
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    float* cur = row[i & 1];
    float* curd = rowd[i & 1];
    const bool at_last = t >= len - 1;
    float beta_t = at_last ? beta_init : carry;
    float bd = at_last ? 0.0f : carryd;
    float lp_prev = (lane && t > 0) ? lp[(size_t)(t - 1) * S + s] : 0.0f;
    float v_prev = (lane && t > 0) ? vv[(size_t)(t - 1) * S + s] : 0.0f;
    if (lane) {
      size_t at = (size_t)t * S + s;
      float res = 0.0f;
      if (t < len && feasible) {
        float g = -expf(out[at] + beta_t + nll_b);
        res = __fmul_rn(g, __fadd_rn(__fadd_rn(hist[at], bd), nd_b));
      }
      out[at] = res;
      cur[s] = beta_t + lp_t;
      curd[s] = __fadd_rn(bd, v_t);
    }
    __syncthreads();
    if (lane) {
      float x0 = cur[s];
      float x1 = s + 1 < S ? cur[s + 1] : LOG_EPS;
      float x2 = s + 2 < S ? cur[s + 2] + skip_s2 : LOG_EPS;
      float d0 = curd[s];
      float d1 = s + 1 < S ? curd[s + 1] : 0.0f;
      float d2 = s + 2 < S ? curd[s + 2] : 0.0f;
      float mb = fmaxf(fmaxf(x0, x1), x2);
      float mb_safe = fmaxf(mb, LOG_EPS);
      float e0 = expf(x0 - mb_safe);
      float e1 = expf(x1 - mb_safe);
      float e2 = expf(x2 - mb_safe);
      float sb = (e0 + e1) + e2;
      carry = mb + logf(sb);
      carryd = carry > HALF_EPS ? mix3(e0, e1, e2, d0, d1, d2, sb) : 0.0f;
    }
    lp_t = lp_prev;
    v_t = v_prev;
  }
}

extern "C" {

int metaasr_ctc_max_lanes(void) { return MAX_S; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int metaasr_ctc_alpha_beta(const void* logp, const void* skip,
                           const void* lens, const void* ends, void* nll,
                           void* grad, int B, int T, int S, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  int threads = ((S + 31) / 32) * 32;
  ctc_alpha_beta_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const float*)logp, (const float*)skip, (const int32_t*)lens,
      (const int32_t*)ends, (float*)nll, (float*)grad, T, S);
  return (int)cudaGetLastError();
}

// K2b on `stream`: hv and nll_dot from K2's inputs and the direction v;
// `scratch` is [B, T, S] f32. Returns cudaGetLastError() (0 = launched).
int metaasr_ctc_hvp(const void* logp, const void* skip, const void* lens,
                    const void* ends, const void* v, void* scratch, void* hv,
                    void* nll_dot, int B, int T, int S, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  int threads = ((S + 31) / 32) * 32;
  ctc_hvp_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const float*)logp, (const float*)skip, (const int32_t*)lens,
      (const int32_t*)ends, (const float*)v, (float*)scratch, (float*)hv,
      (float*)nll_dot, T, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
