// K2 and K2b: the CTC alpha/beta recursion with its posterior gradient, and
// its Hessian-vector product along a direction v; one kernel template,
// ctc_kernel<kTangent, K, kStreamed>, for both.
//
// K2 (kTangent = false) replaces the Pallas kernel
// metaasr_tpu/ops/ctc_pallas.py:66 _ctc_kernel (pallas_call at :276 in
// _ctc_run). K2b (kTangent = true) replaces the second-order wiring of the
// same file, :179 _ctc_pair, :191 _ctc_pair_jvp and :224 _ctc_pallas_jvp,
// whose tangent is jvp(grad(_scan_nll_gathered)) through a lax.scan (:131).
//
//   in : logp_z [B, T, S] f32 (label-gathered log-probs, S = 2U+1), skip
//        [B, S] f32 (0 or LOG_EPS), lens [B] i32, end [B] i32 (= 2 * label
//        length); K2b also v [B, T, S] f32
//   K2 : nll [B]; grad [B, T, S] = -exp(alpha + beta + nll), 0 for t >= lens
//   K2b: hv [B, T, S] = grad * ((adot + bdot) + nll_dot) = (d^2 nll /
//        d logp_z^2) v, 0 for t >= lens; nll_dot [B] = <grad, v>
//
// adot[t] = v[t] + the mix of adot[t-1] weighted by the softmax of alpha's
// lse3 terms; bdot likewise over beta's, with v[t+1], 0 at each row's own
// lens - 1. A state below LOG_EPS / 2 is unreachable: tangent 0. A row whose
// labels do not fit its frames (nll > -LOG_EPS / 2) gives hv = 0 and
// nll_dot = 0. The arithmetic is the plain PyTorch versions'
// (ops/ctc_kernel.py) element by element and in the same order, so both
// kernels are bit-equal to them: lse3 clamps its max at LOG_EPS and sums
// (e0 + e1) + e2; the tangents' products and sums are __fmul_rn / __fadd_rn,
// their quotient correctly rounded (div_rn); IEEE expf and logf.
//
// Bound. Inputs read and outputs written once take 0.06 us (K2) and 0.4 us
// (K2b) at [16, 99, 65] on an H100; the operations less. What bounds both is
// the chain of T dependent steps: one lse3 (3 expf, 1 logf: some 40
// dependent instructions of IEEE code) plus two shuffles on the neighbours'
// values of the step before, one CTA per utterance, B of 132 SMs.
//
// Design, against that chain:
// - alpha and beta at the same time, T steps and not 2T: warps [0, W) run
//   alpha (and adot), warps [W, 2W) beta (and bdot), one function for both
//   (recurse). Beta's states are mirrored (r = S-1-s), so both take their
//   neighbours r-1, r-2 from below.
// - Warp-synchronous steps: a thread holds K consecutive states in
//   registers, its edge states' neighbours come by __shfl_up_sync, and no
//   block barrier runs in the time loop. K = ceil(S / 32W) <= MAX_K; the
//   K chains of a step interleave (no branch in the step). Above 32 * MAX_K
//   states a recursion spans W <= MAX_W warps, which trade their edge states
//   through shared memory under a named barrier of those warps alone.
// - Global memory off the chain. Layout "resident", where it fits the opt-in
//   shared memory: logp_z (and v) staged once by cp.async, the histories
//   kept in shared memory: 77 KB (K2), 154 KB (K2b) at [99, 65]. Layout
//   "streamed": the histories in global memory (alpha in the output, the
//   rest in a scratch the caller allocates), each recursion's rows of logp_z
//   (and v) through a shared ring RING rows ahead by cp.async.
//   ops/ctc_kernel.py:plan picks layout, K and W.
// - Each recursion stops at its row's own lens; one __syncthreads() after
//   both; then all THREADS threads write the output rows, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#define LOG_EPS (-1e30f)
#define HALF_EPS (-5e29f)  // below this a state is unreachable
#define MAX_S 1024
#define MAX_K 8            // states a thread holds
#define MAX_W 4            // warps a recursion spans
#define THREADS 256        // 2 * MAX_W warps: alpha's, beta's; all combine
#define RING 8             // rows in flight per recursion, streamed layout
#define FULL 0xffffffffu

struct Params {
  const float *logp, *skip;
  const int32_t *lens, *ends;
  const float* v;  // K2b's direction
  float* out;      // grad (K2) or hv (K2b)
  float* scratch;  // streamed: beta's history (and adot's, bdot's)
  float* scalar;   // nll (K2) or nll_dot (K2b)
  int T, S, W, streamed;
};

struct Rec {  // what one recursion reads and writes of its utterance
  const float *lp_g, *v_g, *skip;  // global
  float *lp, *v;                   // staged arrays, or this recursion's rings
  float *h, *hd;                   // its history [T, S], and its tangent's
  float* fin;                      // alpha (adot) at end, end-1 of its last row
  float (*edge)[MAX_W][4];         // [step parity][warp], when W > 1
  int S, n, end, W;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

// num / den rounded to nearest float, as __fdiv_rn, but without its
// slow-path branch, which would end the step's basic block and keep the K
// chains from interleaving. den here is a sum of three exponentials whose
// largest is e^0: 1 <= den <= 3, or 0 where the result is discarded. The
// quotient is formed in double from rcp.approx and two Newton steps, within
// 2^-51 of the exact one; a quotient of floats lies more than 2^-49 from any
// rounding midpoint, so the one rounding to float is the correct one.
__device__ __forceinline__ float div_rn(float num, float den) {
  float r0;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r0) : "f"(den));
  const double d = den;
  double r = r0;
  r = fma(r, fma(-d, r, 1.0), r);
  r = fma(r, fma(-d, r, 1.0), r);
  return (float)((double)num * r);
}

// Rows i = 0 .. n-1 of alpha (t = i) or beta (kBeta, t = n-1-i). y is what
// the next lse3 reads: alpha, or beta + logp_z[t]; the history keeps alpha
// and beta. Thread g of the recursion holds states r = gK .. gK+K-1, and
// s = r (alpha) or S-1-r (beta): alpha's s-1, s-2 and beta's s+1, s+2 are
// both r-1, r-2. A step's K lse3 chains come first, then the tangents.
template <bool kTangent, int K, bool kBeta, bool kStreamed>
__device__ __forceinline__ void recurse(const Rec& c, int gw, int lane) {
  const int S = c.S, n = c.n, end = c.end, r0 = (gw * 32 + lane) * K;
  const int s0 = kBeta ? S - 1 - r0 : r0, dir = kBeta ? -1 : 1;
  const int last = kBeta ? n - 1 : 0;  // the row of step 0
  auto fetch = [&](int i) {  // streamed: row i's states into slot i % RING
    const int row = (last + (kBeta ? -i : i)) * S + s0;
    const int slot = (i % RING) * S + s0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (r0 + k < S) {
        cp_async4(c.lp + slot + dir * k, c.lp_g + row + dir * k);
        if (kTangent) cp_async4(c.v + slot + dir * k, c.v_g + row + dir * k);
      }
    }
  };
  if (kStreamed) {
    for (int i = 0; i < RING - 1; ++i) {
      if (i < n) fetch(i);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  float y[K], yd[K], sk[K], lpk[K], vk[K], z[K], zd[K];
  auto load = [&](int i) {  // step i's row of logp_z (and v)
    if (kStreamed) {
      if (i + RING - 1 < n) fetch(i + RING - 1);
      asm volatile("cp.async.commit_group;\n"
                   "cp.async.wait_group %0;\n" :: "n"(RING - 1) : "memory");
    }
    const int at = (kStreamed ? i % RING : last + (kBeta ? -i : i)) * S + s0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lpk[k] = r0 + k < S ? c.lp[at + dir * k] : 0.0f;
      vk[k] = kTangent && r0 + k < S ? c.v[at + dir * k] : 0.0f;
    }
  };
  auto emit = [&](int i) {  // step i's row into the history; the next y
    const int at = (last + (kBeta ? -i : i)) * S + s0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (r0 + k < S) c.h[at + dir * k] = z[k];
      if (kTangent && r0 + k < S) c.hd[at + dir * k] = zd[k];
      y[k] = kBeta ? z[k] + lpk[k] : z[k];
      yd[k] = kBeta && kTangent ? __fadd_rn(zd[k], vk[k]) : zd[k];
    }
  };
  load(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {  // alpha adds skip[s] to the s-2 term,
    const int s = s0 + dir * k;  // beta skip[s+2]; step 0's states
    sk[k] = r0 + k < S && (!kBeta || s + 2 < S) ? c.skip[kBeta ? s + 2 : s]
                                                : 0.0f;
    const bool on = kBeta ? s == end || (s == end - 1 && end > 0)
                          : s == 0 || (s == 1 && end > 0);
    z[k] = on ? (kBeta ? 0.0f : lpk[k]) : LOG_EPS;
    zd[k] = !kBeta && on ? vk[k] : 0.0f;
  }
  emit(0);
  for (int i = 1; i < n; ++i) {
    load(i);
    float u1 = __shfl_up_sync(FULL, y[K - 1], 1);  // states r0-1, r0-2
    float u2 = __shfl_up_sync(FULL, y[K > 1 ? K - 2 : 0], K > 1 ? 1 : 2);
    float du1 = 0.0f, du2 = 0.0f;
    if (kTangent) {
      du1 = __shfl_up_sync(FULL, yd[K - 1], 1);
      du2 = __shfl_up_sync(FULL, yd[K > 1 ? K - 2 : 0], K > 1 ? 1 : 2);
    }
    if (K >= 5 && c.W > 1) {  // a warp's top two states to the next warp
      float* e = c.edge[i & 1][gw];
      if (lane == 31) {
        e[0] = y[K - 1], e[1] = y[K > 1 ? K - 2 : 0];
        e[2] = yd[K - 1], e[3] = yd[K > 1 ? K - 2 : 0];
      }
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + kBeta), "r"(32 * c.W)
                   : "memory");
      const float* f = c.edge[i & 1][gw > 0 ? gw - 1 : 0];
      if (gw > 0 && lane == 0) u1 = f[0], u2 = f[1], du1 = f[2], du2 = f[3];
    }
    if (r0 < 1) u1 = LOG_EPS, du1 = 0.0f;
    if (r0 < 2) u2 = LOG_EPS, du2 = 0.0f;
    float e0[K], e1[K], e2[K], sum[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {  // log(e^x0 + e^x1 + e^x2), max clamped
      const float x1 = k >= 1 ? y[k >= 1 ? k - 1 : 0] : u1;
      const float x2 = k >= 2 ? y[k >= 2 ? k - 2 : 0] : k == 1 ? u1 : u2;
      // no s-2 (alpha) keeps LOG_EPS + skip[s]; no s+2 (beta) is LOG_EPS
      const float x2s = kBeta && r0 + k < 2 ? LOG_EPS : x2 + sk[k];
      const float m = fmaxf(fmaxf(y[k], x1), x2s);
      const float m_safe = fmaxf(m, LOG_EPS);
      e0[k] = expf(y[k] - m_safe), e1[k] = expf(x1 - m_safe);
      e2[k] = expf(x2s - m_safe);
      sum[k] = (e0[k] + e1[k]) + e2[k];
      const float l = m + logf(sum[k]);
      z[k] = kBeta ? l : lpk[k] + l;
    }
#pragma unroll
    for (int k = 0; k < K && kTangent; ++k) {  // ((e0 d0 + e1 d1) + e2 d2) / sum
      const float d1 = k >= 1 ? yd[k >= 1 ? k - 1 : 0] : du1;
      const float d2 = k >= 2 ? yd[k >= 2 ? k - 2 : 0] : k == 1 ? du1 : du2;
      const float mix = div_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(e0[k], yd[k]), __fmul_rn(e1[k], d1)),
                    __fmul_rn(e2[k], d2)), sum[k]);
      zd[k] = z[k] > HALF_EPS ? (kBeta ? mix : __fadd_rn(vk[k], mix)) : 0.0f;
    }
    emit(i);
  }
#pragma unroll
  for (int k = 0; k < K && !kBeta; ++k) {  // alpha's last row at end, end-1
    const int s = s0 + k;
    if (s == end || s == end - 1) c.fin[end - s] = y[k], c.fin[2 + end - s] = yd[k];
  }
}

template <bool kTangent, int K, bool kStreamed>
__global__ void __launch_bounds__(THREADS, 1) ctc_kernel(Params p) {
  extern __shared__ float sm[];
  __shared__ float edge[2][2][MAX_W][4];  // [alpha, beta][step parity][warp]
  __shared__ float fin[4];
  const int b = blockIdx.x, T = p.T, S = p.S, W = p.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = p.lens[b], end = p.ends[b];
  const size_t TS = (size_t)T * S, A = kTangent ? 2 : 1;
  const float* lp_g = p.logp + b * TS;
  const float* v_g = kTangent ? p.v + b * TS : nullptr;
  Rec ra = {lp_g, v_g, p.skip + (size_t)b * S, sm, sm + A / 2 * TS, nullptr,
            nullptr, fin, edge[0], S, min(max(len, 1), T), end, W};
  Rec rb = ra;
  rb.edge = edge[1];
  if (kStreamed) {  // rings: alpha's, beta's of logp_z; alpha's, beta's of v
    ra.v = sm + 2 * RING * S;
    rb.lp = ra.lp + RING * S, rb.v = ra.v + RING * S;
    ra.h = p.out + b * TS;
    rb.h = p.scratch + b * TS;
    ra.hd = rb.h + gridDim.x * TS;
    rb.hd = ra.hd + gridDim.x * TS;
  } else {  // staged logp_z (and v), then alpha, beta (and adot, bdot)
    ra.h = sm + A * TS, rb.h = ra.h + TS;
    ra.hd = rb.h + TS, rb.hd = ra.hd + TS;
    for (size_t j = tid; j < TS; j += THREADS) {
      cp_async4(sm + j, lp_g + j);
      if (kTangent) cp_async4(sm + TS + j, v_g + j);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  if (warp < W)
    recurse<kTangent, K, false, kStreamed>(ra, warp, lane);
  else if (warp < 2 * W)
    recurse<kTangent, K, true, kStreamed>(rb, warp - W, lane);
  __syncthreads();  // the one barrier: both histories are complete

  // nll (and nll_dot) off the last alpha row; then the output rows
  const float a_last = fin[0], a_prev = end > 0 ? fin[1] : LOG_EPS;
  const float m = end > 0 ? fmaxf(a_last, a_prev) : a_last;
  const float m_safe = fmaxf(m, LOG_EPS);
  const float e_last = expf(a_last - m_safe);
  const float e_prev = end > 0 ? expf(a_prev - m_safe) : 0.0f;
  const float sum = end > 0 ? e_last + e_prev : e_last;
  const float nll = -(m + logf(sum));
  const bool feasible = !kTangent || !(nll > -HALF_EPS);
  float nd = 0.0f;
  if (kTangent && feasible)
    nd = -__fdiv_rn(__fadd_rn(__fmul_rn(e_last, fin[2]),
                              __fmul_rn(e_prev, end > 0 ? fin[3] : 0.0f)), sum);
  if (tid == 0) p.scalar[b] = kTangent ? nd : nll;
  float* out = p.out + b * TS;
  for (int t = warp; t < T; t += THREADS / 32) {
    for (int s = lane; s < S; s += 32) {
      const size_t at = (size_t)t * S + s;
      float r = 0.0f;
      if (t < len && feasible) {
        const float g = -expf((ra.h[at] + rb.h[at]) + nll);
        r = kTangent ? __fmul_rn(g, __fadd_rn(__fadd_rn(ra.hd[at], rb.hd[at]),
                                              nd))
                     : g;
      }
      out[at] = r;
    }
  }
}

typedef void (*Kernel)(Params);
#define KS(t, st)                                                    \
  {ctc_kernel<t, 1, st>, ctc_kernel<t, 2, st>, ctc_kernel<t, 3, st>, \
   ctc_kernel<t, 4, st>, ctc_kernel<t, 5, st>, ctc_kernel<t, 6, st>, \
   ctc_kernel<t, 7, st>, ctc_kernel<t, 8, st>}
static const Kernel kernels[2][2][MAX_K] = {{KS(false, false), KS(false, true)},
                                            {KS(true, false), KS(true, true)}};

// dynamic shared memory of a launch, as ops/ctc_kernel.py:plan reckons it
static long smem_bytes(int T, int S, int tangent, int streamed) {
  const long arrays = tangent ? 2 : 1;
  return 4 * arrays * (streamed ? 2L * RING * S : 3L * T * S);
}

static int launch(int tangent, const Params& p, int B, int K, int smem,
                  void* stream) {
  if (B <= 0) return 0;
  if (p.T < 1 || p.S < 1 || p.S > MAX_S || K < 1 || K > MAX_K || p.W < 1 ||
      p.W > MAX_W || p.S > 32 * p.W * K || (p.W > 1 && K < 5) ||
      smem != smem_bytes(p.T, p.S, tangent, p.streamed) ||
      (p.streamed && !p.scratch))
    return (int)cudaErrorInvalidValue;
  const Kernel fn = kernels[tangent][p.streamed ? 1 : 0][K - 1];
  static int opted[16][2][2][MAX_K];  // per device: the size set so far
  int dev = 0;
  cudaGetDevice(&dev);
  int* seen = dev < 16 ? &opted[dev][tangent][p.streamed][K - 1] : nullptr;
  // opt in whatever the size: the 48 KB a block gets without it covers
  // static and dynamic shared memory together, so a dynamic size just
  // under 48 KB (K2 at [*, 63, 65]: 49,140 B) already needs it
  if (!seen || smem > *seen) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (seen) *seen = smem;
  }
  fn<<<B, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" {

int metaasr_ctc_max_lanes(void) { return MAX_S; }

// the opt-in shared memory per block of the current device, in bytes
int metaasr_ctc_smem_optin(void) {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// K2 on `stream` with the plan's K, W, layout and shared memory; `scratch`
// is [B, T, S] f32 in the streamed layout, else null. Returns
// cudaGetLastError() (0 = launched).
int metaasr_ctc_alpha_beta(const void* logp, const void* skip,
                           const void* lens, const void* ends, void* nll,
                           void* grad, void* scratch, int B, int T, int S,
                           int K, int W, int streamed, int smem, void* stream) {
  Params p = {(const float*)logp, (const float*)skip, (const int32_t*)lens,
              (const int32_t*)ends, nullptr, (float*)grad, (float*)scratch,
              (float*)nll, T, S, W, streamed};
  return launch(0, p, B, K, smem, stream);
}

// K2b likewise: hv and nll_dot from K2's inputs and the direction v;
// `scratch` is [3, B, T, S] f32 in the streamed layout, else null.
int metaasr_ctc_hvp(const void* logp, const void* skip, const void* lens,
                    const void* ends, const void* v, void* scratch, void* hv,
                    void* nll_dot, int B, int T, int S, int K, int W,
                    int streamed, int smem, void* stream) {
  Params p = {(const float*)logp, (const float*)skip, (const int32_t*)lens,
              (const int32_t*)ends, (const float*)v, (float*)hv,
              (float*)scratch, (float*)nll_dot, T, S, W, streamed};
  return launch(1, p, B, K, smem, stream);
}

}  // extern "C"
