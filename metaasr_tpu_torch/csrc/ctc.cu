// K2: CTC alpha/beta recursion with the posterior gradient, one kernel.
//
// Replaces the Pallas kernel metaasr_tpu/ops/ctc_pallas.py:66 _ctc_kernel
// (pallas_call at :276 in _ctc_run). Same function, laid out for the GPU:
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

#include <cuda_runtime.h>
#include <stdint.h>

#define LOG_EPS (-1e30f)
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

}  // extern "C"
