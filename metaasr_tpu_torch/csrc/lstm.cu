// K3 / K3b: the LSTM recurrence, its BPTT and the recurrent-weight gradient.
//
// Replaces the Pallas kernels of metaasr_tpu/ops/lstm_pallas.py:
//   K3  :48 _fwd_kernel (pallas_call at :132 in _lstm_fwd_run)
//   K3b :71 _bwd_kernel (pallas_call at :178 in _lstm_vjp_bwd)
//
//   forward : gx [T, B, 4H] f32 (input projection and bias already applied),
//             U [H, 4H] f32 -> h_seq, c_seq [T, B, H] f32 and, when a
//             backward follows, the post-activation gates [T, B, 4H]. Per
//             step g = gx[t] + h @ U, gates (i, f, g, o) with +1 on the
//             forget gate, c = f*c + i*g, h = o*tanh(c); zero initial state.
//   backward: gates, U, c_seq, dout [T, B, H] -> dgx [T, B, 4H]; then
//             dU [H, 4H] from h_seq and dgx. Time reversed: dgates from the
//             saved gates, tanh(c[t]), c[t-1], dout and the carried dh, dc;
//             dh = dgates @ U^T and dc = dc_tot * f are carried;
//             dU = sum_t h[t-1]^T @ dgates[t]. No h @ U is recomputed.
//
// Bound. 2*T*B*H*4H (forward) and, from the saved gates, 4*T*B*H*4H
// (backward: dgates @ U^T and the dU product) fp32 flops, 1.30 and 2.60
// GFLOP at [99, 16, 320], 0.019 / 0.039 ms at 67 TFLOP/s; the bytes are
// smaller. What limits both kernels is the chain of T dependent steps: each
// step needs all of h[t-1] and all of U.
//
// Design: U resident on-chip across a thread-block cluster.
// - One cluster of N CTAs (N = 16, non-portable; 8 where 16 does not
//   schedule; fewer for small H, so that every CTA owns a unit) per batch
//   tile of `tile` rows (384 threads per CTA in K3, 256 in K3b). CTA c owns
//   the hidden units [c*NU, c*NU + nu), NU = ceil(H / N), and all four gate
//   columns of each; the last CTA of an uneven split owns fewer.
// - It loads its column slice U[:, cols_c] once per launch into shared
//   memory by cp.async as [H rows][4*NU] (column 4*lu + gate; row stride
//   ldu with ldu/4
//   odd, so that the backward's row-parallel reads are free of bank
//   conflicts). At H = 320, N = 16: 20 units, 80 columns, 105 KB. Where the
//   slice does not fit (above H ~ 500 at N = 16), the first rows that fit
//   stay resident and the rest of its own slice is read from L2 each step:
//   1/N of U per SM, not all of it.
// - Forward step t: every CTA holds the whole h[t-1] of its tile in shared
//   memory (double-buffered). Threads take (unit, 4 batch rows, k slice)
//   with a 4 x 4 register tile (rows x gates); the slices' partial sums meet
//   in shared memory. A quad of lanes owns each (row, unit) pair, one gate a
//   lane: it adds its gate's partials in slice order, applies the gate
//   (sigmoid as (1 + tanh(x/2)) / 2, so that the four lanes take one path),
//   the quad exchanges the four by shuffles, and every lane keeps the same c
//   in a register. The quad sends h[t] to the next h buffer of every CTA of
//   the cluster with st.async (distributed shared memory), each send
//   counting its bytes on the receiving CTA's mbarrier (complete_tx).
// - Synchronisation is one mbarrier wait per step and one CTA barrier, not
//   a cluster barrier: a CTA's buffer is full when the bytes of all N CTAs
//   have landed. Double buffering is safe by data flow: a CTA can send h[t]
//   only after it received all of h[t-1], which every CTA sent after its
//   step t-1 product had finished reading the buffer that h[t] overwrites.
//   Each CTA arms (arrive.expect_tx) the phase of a buffer before it sends
//   the piece that lets anyone fill it. One cluster barrier at the start and
//   one at the end of a launch. (A first version with a cluster barrier per
//   step, arrive.release / wait.acquire, was markedly slower: every CTA
//   waited for the slowest CTA of the cluster, and the release for the
//   step's stores to global memory.)
// - Backward step t: the owner of (row, unit), one thread, sums the N
//   partial dh pieces it received, in CTA order (deterministic), forms
//   dgates from the saved gates, writes them to dgx and to shared memory
//   (double-buffered) and carries dc in a register; its loads of step t-1
//   are in flight during the product. Each CTA then computes dh_part[b, k] =
//   sum over its columns j of dgates[b, j] * U[k, j] for all k (a thread
//   takes 4 rows x the U rows k and k + H/2) and sends each owner its piece
//   with st.async.v4 (a reduce-scatter through distributed shared memory,
//   mbarrier-counted as above).
// - Batch tiles: tile = 4 rows, four clusters (64 SMs) at B = 16; the tile
//   sweep of chip_smoke.py's phase 8 measured 4 faster than 8 and 16 (the
//   per-step product shrinks with the tile, and 7 clusters of 16 fit the
//   card).
// - dU is a reduction over T and B that no cluster owns: a second kernel
//   computes it after the recurrence as one tiled fp32 product dU =
//   h_prev^T [H, (T-1)*B] @ dgx[B:] [(T-1)*B, 4H] (the t = 0 term is zero):
//   64 x 64 output tiles, 32-deep chunks in two shared-memory stages with
//   the next chunk loaded during the FMAs, a 4 x 4 register tile per
//   thread. At [99, 16, 320] the 100 output tiles leave a third of the SMs
//   idle, so the chunks are split over a cluster of S CTAs per tile (S = 2
//   there, metaasr_lstm_du_splits), each summing its chunks in order; the
//   S partial tiles meet in distributed shared memory and are added in CTA
//   order, so dU is deterministic. Fusing it into K3b's recurrence would
//   add as many FMAs to every dependent step as the dh product has, and
//   the batch tiles' clusters would still need a reduction across them.
//
// Arithmetic: fp32 IEEE FMAs, tanhf without fast math, no tensor cores,
// every sum in a fixed order.
// Limits: any T >= 0 and B >= 0; H a multiple of 4 up to 5,808 at N = 16,
// tile 4 (16 rounds of 96 owned pairs per CTA, and the h buffers and dh
// pieces fill the shared memory: the largest H then keeps no row of U
// resident in K3b). metaasr_lstm_plan reports what it picked, including
// cudaOccupancyMaxActiveClusters, and fails where no cluster can run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define FWD_THREADS 384  // per CTA; at 512 both kernels spilled registers
#define BWD_THREADS 256  // (128 a thread) and ran slower
#define RB 4             // batch rows of a thread's register tile
#define QUADS (FWD_THREADS / 4)  // (row, unit) pairs owned per round
#define MAXQ 16  // rounds of pairs (the kernels' template Q: 1, 2, 4, 8, 16)
#define TILE 4           // batch rows per cluster
#define MAX_CLUSTER 16
#define MAX_SMEM 232448  // bytes of shared memory one block can opt in to

// ---- distributed shared memory and mbarriers (PTX, sm_90) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of the same shared-memory location in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// the one arrival of a phase, which also expects `bytes` of st.async data
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for the phase of the given parity to complete; acquire at cluster
// scope makes the remote CTAs' st.async data visible
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// store v into another CTA's shared memory and count its 4 bytes on that
// CTA's mbarrier (both addresses from map_rank)
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" :: "r"(addr), "f"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async4(uint32_t addr, float4 v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// The split of one launch; host and device compute it alike.
struct Layout {
  int H, N, tile;
  int NU;   // units per CTA (the last ones may own fewer)
  int ldu;  // row stride of the resident slice, 4*NU rounded so ldu/4 is odd
  int G;    // 4-row groups of the tile
  int P;    // forward (unit, row group) pairs, at most FWD_THREADS
  int S;    // forward k slices, P * S <= FWD_THREADS
  int W;    // backward (row group, pair of U rows) items

  __host__ __device__ Layout(int H_, int N_, int tile_)
      : H(H_), N(N_), tile(tile_) {
    NU = (H + N - 1) / N;
    ldu = 4 * (NU % 2 ? NU : NU + 1);
    G = tile / RB;
    P = NU * G;
    const int s = FWD_THREADS / P;
    S = s < 1 ? 1 : (s > H / 4 ? H / 4 : s);
    W = G * (H / 2);
  }
  // shared-memory floats beside the resident rows
  __host__ __device__ size_t fwd_fixed() const {
    return (size_t)2 * tile * H + (size_t)S * P * 16;
  }
  __host__ __device__ size_t bwd_fixed() const {
    return (size_t)2 * tile * ldu + (size_t)2 * N * tile * NU;
  }
};

// rows of the slice that stay in shared memory beside `fixed` floats and
// the mbarriers
static int resident_rows(const Layout& L, size_t fixed) {
  const long avail = (long)(MAX_SMEM / 4) - (long)fixed - 4;
  if (avail < 0) return -1;
  long rows = avail / L.ldu;
  rows -= rows % 4;
  return (int)(rows < L.H ? rows : L.H);
}

// one float from global into shared memory, asynchronously
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// us[k * ldu + 4 * lu + g] = U[k, g * H + u0 + lu] for the resident rows, by
// cp.async (the gather transposes, so the copies are 4 bytes each); the
// columns of units this CTA does not own are zero. The caller synchronises
// the CTA before reading us.
__device__ __forceinline__ void load_slice(const float* __restrict__ u,
                                           float* us, const Layout& L,
                                           int rows, int u0, int nu) {
  const int H4 = 4 * L.H;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * L.NU; e += blockDim.x) {
    const int k = e / L.NU;
    const int lu = e % L.NU;
    float* dst = us + (size_t)k * L.ldu + 4 * lu;
    if (lu < nu) {
      const float* col = u + (size_t)k * H4 + u0 + lu;
#pragma unroll
      for (int g = 0; g < 4; ++g) cp_async4(dst + g, col + (size_t)g * L.H);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the four gate columns of unit lu in row k of this CTA's slice, from
// global memory (the rows past the resident ones)
__device__ __forceinline__ float4 global_row(const float* __restrict__ u,
                                             int H, int u0, int k, int lu) {
  const float* row = u + (size_t)k * 4 * H + u0 + lu;
  return make_float4(__ldg(row), __ldg(row + H), __ldg(row + 2 * H),
                     __ldg(row + 3 * H));
}

__device__ __forceinline__ void fma_rows(float (&acc)[RB][4],
                                         const float4 (&hv)[RB],
                                         const float4 (&uv)[4]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const float hk[4] = {hv[r].x, hv[r].y, hv[r].z, hv[r].w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc[r][0] = fmaf(hk[kk], uv[kk].x, acc[r][0]);
      acc[r][1] = fmaf(hk[kk], uv[kk].y, acc[r][1]);
      acc[r][2] = fmaf(hk[kk], uv[kk].z, acc[r][2]);
      acc[r][3] = fmaf(hk[kk], uv[kk].w, acc[r][3]);
    }
  }
}

template <int Q>
__global__ void __launch_bounds__(FWD_THREADS, 1)
lstm_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ u,
                float* __restrict__ h_seq, float* __restrict__ c_seq,
                float* __restrict__ gates, int T, int B, int H, int tile,
                int rows) {
  cg::cluster_group cluster = cg::this_cluster();
  const int N = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Layout L(H, N, tile);
  const int H4 = 4 * H;
  const int u0 = rank * L.NU;
  const int nu = max(0, min(L.NU, H - u0));
  const int b0 = (int)(blockIdx.x / N) * tile;  // cluster = batch tile
  const int bv = min(tile, B - b0);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [2] h buffers full
  float* us = smem + 4;                         // [rows][ldu] resident slice
  float* hb = us + (size_t)rows * L.ldu;        // [2][tile][H] h[t-1]
  float* part = hb + (size_t)2 * tile * H;      // [S][RB][P][4] partials

  load_slice(u, us, L, rows, u0, nu);
  for (int e = tid; e < 2 * tile * H; e += FWD_THREADS) hb[e] = 0.0f;
  const uint32_t bytes = (uint32_t)(bv * H * 4);  // h[t] of the tile
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (T > 1) mbar_expect(&bar[1], bytes);  // h[0], sent in step 0
    if (T > 2) mbar_expect(&bar[0], bytes);  // h[1], sent in step 1
  }

  // this thread's matvec item: unit lu, rows 4gi.., k slice [k0, k1)
  const bool item = tid < L.P * L.S;
  const int lu_m = tid % L.P % L.NU;
  const int gi_m = tid % L.P / L.NU;
  const int s_m = tid / L.P;
  const int k0 = 4 * ((s_m * (H / 4)) / L.S);
  const int k1 = item ? 4 * (((s_m + 1) * (H / 4)) / L.S) : k0;
  const int km = min(k1, max(k0, rows));
  const float* ur = us + 4 * lu_m;
  float* part_m = part + ((size_t)s_m * RB * L.P + tid % L.P) * 4;

  // the (row, unit) pairs: a quad of lanes per pair, lane g4 its gate g4;
  // round i takes pairs [i * QUADS, (i + 1) * QUADS)
  const int g4 = tid & 3;
  const int pairs = bv * nu;
  int ob[Q], ou[Q];
  float c_reg[Q], gxv[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int q = (tid >> 2) + i * QUADS;
    ob[i] = q < pairs ? q / nu : -1;
    ou[i] = q < pairs ? q % nu : 0;
    c_reg[i] = 0.0f;
    if (T > 0 && ob[i] >= 0)
      gxv[i] = __ldg(gx + (size_t)(b0 + ob[i]) * H4 + g4 * H + u0 + ou[i]);
  }
  cluster.sync();  // every CTA started, its buffers zero, mbarriers ready

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t > 0) {
      mbar_wait(&bar[cur], ((t - 1) >> 1) & 1);  // h[t-1] complete
      if (tid == 0 && t + 2 < T) mbar_expect(&bar[cur], bytes);  // h[t+1]
    }
    const float* hcur = hb + (size_t)cur * tile * H;

    // partial pre-activations of (unit lu, rows 4gi..4gi+3) over k0..k1
    if (item) {
      const float* hr = hcur + (size_t)gi_m * RB * H;
      float acc[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
      for (int k = k0; k < k1; k += 4) {
        float4 hv[RB], uv[4];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          hv[r] = *reinterpret_cast<const float4*>(hr + (size_t)r * H + k);
        if (k < km) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            uv[kk] = *reinterpret_cast<const float4*>(
                ur + (size_t)(k + kk) * L.ldu);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            uv[kk] = lu_m < nu ? global_row(u, H, u0, k + kk, lu_m)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        fma_rows(acc, hv, uv);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        *reinterpret_cast<float4*>(part_m + (size_t)r * L.P * 4) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();  // partial sums complete

    const uint32_t hnext = smem_addr(hb + (size_t)(cur ^ 1) * tile * H);
    const uint32_t bnext = smem_addr(&bar[cur ^ 1]);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      if (i * QUADS >= pairs) break;  // uniform: every lane reaches the shfl
      const bool own = ob[i] >= 0;
      const int b = own ? ob[i] : 0;
      const int lu = ou[i];
      // this lane's gate of the pair, summed over the k slices in order
      float x = 0.0f;
      if (own) {
        const float* src =
            part + ((size_t)(b % RB) * L.P + (b / RB) * L.NU + lu) * 4 + g4;
        x = src[0];
#pragma unroll 4
        for (int s = 1; s < L.S; ++s) x += src[(size_t)s * RB * L.P * 4];
        x += gxv[i] + (g4 == 1 ? 1.0f : 0.0f);
      }
      // sigmoid(x) = (1 + tanh(x / 2)) / 2, so the four lanes take one path
      const float y = tanhf(g4 == 2 ? x : 0.5f * x);
      const float a = g4 == 2 ? y : 0.5f + 0.5f * y;
      const int quad = tid & 28;
      const float ig = __shfl_sync(0xffffffffu, a, quad);
      const float fg = __shfl_sync(0xffffffffu, a, quad + 1);
      const float gg = __shfl_sync(0xffffffffu, a, quad + 2);
      const float og = __shfl_sync(0xffffffffu, a, quad + 3);
      if (!own) continue;
      const float c = fg * c_reg[i] + ig * gg;
      const float h = og * tanhf(c);
      c_reg[i] = c;
      const int n = u0 + lu;
      if (t + 1 < T) {
        // h[t] into the next h buffer of every CTA, a quarter from each lane
        const uint32_t at = hnext + (uint32_t)((b * H + n) * 4);
        for (int r = g4; r < N; r += 4)
          st_async(map_rank(at, r), h, map_rank(bnext, r));
      }
      const size_t row = (size_t)t * B + b0 + b;
      if (g4 == 0) h_seq[row * H + n] = h;
      if (g4 == 1) c_seq[row * H + n] = c;
      if (gates) gates[row * H4 + g4 * H + n] = a;
      if (t + 1 < T) gxv[i] = __ldg(gx + (row + B) * H4 + g4 * H + n);
    }
  }
  cluster.sync();  // no CTA leaves while its shared memory is a target
}

template <int Q>
__global__ void __launch_bounds__(BWD_THREADS, 1)
lstm_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ u,
                const float* __restrict__ c_seq,
                const float* __restrict__ dout, float* __restrict__ dgx,
                int T, int B, int H, int tile, int rows) {
  cg::cluster_group cluster = cg::this_cluster();
  const int N = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Layout L(H, N, tile);
  const int H4 = 4 * H;
  const int H2 = H / 2;
  const int u0 = rank * L.NU;
  const int nu = max(0, min(L.NU, H - u0));
  const int b0 = (int)(blockIdx.x / N) * tile;  // cluster = batch tile
  const int bv = min(tile, B - b0);
  const int tid = threadIdx.x;
  const size_t recv_floats = (size_t)N * tile * L.NU;

  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [2] dh pieces in
  float* us = smem + 4;                        // [rows][ldu] resident slice
  float* dgs = us + (size_t)rows * L.ldu;      // [2][tile][ldu] dgates
  float* recv = dgs + (size_t)2 * tile * L.ldu;  // [2][N][NU][tile] pieces

  load_slice(u, us, L, rows, u0, nu);
  for (int e = tid; e < 2 * tile * L.ldu; e += BWD_THREADS) dgs[e] = 0.0f;
  const uint32_t bytes = (uint32_t)(N * bv * nu * 4);  // dh[t-1] pieces
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (T > 1) mbar_expect(&bar[(T - 1) & 1], bytes);  // sent in step T-1
  }

  // the (row, unit) pairs this thread owns; their inputs of the next step:
  // gates (4), c[t], c[t-1], dout[t]
  int ob[Q], ou[Q];
  float dc_reg[Q], in[Q][7];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      if (ob[i] < 0) continue;
      const size_t row = (size_t)t * B + b0 + ob[i];
      const int n = u0 + ou[i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        in[i][j] = __ldg(gates + row * H4 + j * H + n);
      in[i][4] = __ldg(c_seq + row * H + n);
      in[i][5] = t > 0 ? __ldg(c_seq + (row - B) * H + n) : 0.0f;
      in[i][6] = __ldg(dout + row * H + n);
    }
  };
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int q = tid + i * BWD_THREADS;
    ob[i] = q < bv * nu ? q / nu : -1;
    ou[i] = q < bv * nu ? q % nu : 0;
    dc_reg[i] = 0.0f;
  }
  if (T > 0) fetch(T - 1);

  cluster.sync();  // every CTA started, mbarriers ready

  for (int t = T - 1; t >= 0; --t) {
    if (t + 1 < T) {
      mbar_wait(&bar[(t + 1) & 1], ((T - 2 - t) >> 1) & 1);  // dh[t] in
    }
    if (tid == 0 && t >= 2) mbar_expect(&bar[(t - 1) & 1], bytes);
    const float* got = recv + (size_t)((t + 1) & 1) * recv_floats;
    float* dgt = dgs + (size_t)(t & 1) * tile * L.ldu;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      if (ob[i] < 0) continue;
      const int b = ob[i];
      const int lu = ou[i];
      float dh = 0.0f;
      if (t + 1 < T)
        for (int r = 0; r < N; ++r)
          dh += got[((size_t)r * L.NU + lu) * tile + b];
      const float ig = in[i][0], fg = in[i][1], gg = in[i][2], og = in[i][3];
      const float tc = tanhf(in[i][4]);
      const float dh_tot = in[i][6] + dh;
      const float dc_tot = dh_tot * og * (1.0f - tc * tc) + dc_reg[i];
      const float do_pre = dh_tot * tc * og * (1.0f - og);
      const float df_pre = dc_tot * in[i][5] * fg * (1.0f - fg);
      const float di_pre = dc_tot * gg * ig * (1.0f - ig);
      const float dg_pre = dc_tot * ig * (1.0f - gg * gg);
      dc_reg[i] = dc_tot * fg;
      *reinterpret_cast<float4*>(dgt + (size_t)b * L.ldu + 4 * lu) =
          make_float4(di_pre, df_pre, dg_pre, do_pre);
      float* d = dgx + ((size_t)t * B + b0 + b) * H4 + u0 + lu;
      d[0] = di_pre; d[H] = df_pre; d[2 * H] = dg_pre; d[3 * H] = do_pre;
    }
    if (t > 0) fetch(t - 1);  // in flight during the product below
    __syncthreads();  // dgates of the tile complete
    if (t == 0) break;

    // dh_part[b, k] = sum_j dgt[b, j] * us[k, j]; an item is the rows
    // 4gi.. x the U rows k and k + H/2, sent to the owners of those units
    const uint32_t put = smem_addr(recv + (size_t)(t & 1) * recv_floats);
    const uint32_t bput = smem_addr(&bar[t & 1]);
    for (int w = tid; w < L.W; w += BWD_THREADS) {
      const int gi = w / H2;
      const int k = w % H2;
      const float* dr = dgt + (size_t)gi * RB * L.ldu;
      float acc[RB][2];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = 0.0f;
      auto step = [&](int lu, const float4& ua, const float4& ub) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 d =
              *reinterpret_cast<const float4*>(dr + (size_t)r * L.ldu + 4 * lu);
          acc[r][0] = fmaf(d.x, ua.x, acc[r][0]);
          acc[r][0] = fmaf(d.y, ua.y, acc[r][0]);
          acc[r][0] = fmaf(d.z, ua.z, acc[r][0]);
          acc[r][0] = fmaf(d.w, ua.w, acc[r][0]);
          acc[r][1] = fmaf(d.x, ub.x, acc[r][1]);
          acc[r][1] = fmaf(d.y, ub.y, acc[r][1]);
          acc[r][1] = fmaf(d.z, ub.z, acc[r][1]);
          acc[r][1] = fmaf(d.w, ub.w, acc[r][1]);
        }
      };
      if (k + H2 < rows) {  // both rows resident
        const float* ra = us + (size_t)k * L.ldu;
        const float* rb = us + (size_t)(k + H2) * L.ldu;
        for (int lu = 0; lu < nu; ++lu)
          step(lu, *reinterpret_cast<const float4*>(ra + 4 * lu),
               *reinterpret_cast<const float4*>(rb + 4 * lu));
      } else {
        for (int lu = 0; lu < nu; ++lu)
          step(lu, k < rows ? *reinterpret_cast<const float4*>(
                                  us + (size_t)k * L.ldu + 4 * lu)
                            : global_row(u, H, u0, k, lu),
               global_row(u, H, u0, k + H2, lu));
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int kk = k + x * H2;
        const int owner = kk / L.NU;
        const uint32_t at = map_rank(
            put + (uint32_t)(((rank * L.NU + kk % L.NU) * tile + gi * RB) * 4),
            owner);
        const uint32_t ab = map_rank(bput, owner);
        if (gi * RB + RB <= bv) {
          st_async4(at, make_float4(acc[0][x], acc[1][x], acc[2][x], acc[3][x]),
                    ab);
        } else {
#pragma unroll
          for (int r = 0; r < RB; ++r)
            if (gi * RB + r < bv) st_async(at + 4 * r, acc[r][x], ab);
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while its shared memory is a target
}

#define DU_BM 64
#define DU_BN 64
#define DU_BK 32
#define DU_THREADS 256

// du[m, n] = sum_{r < K} h_seq[r, m] * dgx[r + B, n]: rows r = (t-1)*B + b of
// h_seq are h[t-1], rows r + B of dgx are dgates[t]. Both tiles are read
// along their contiguous axis; the next k chunk is loaded into registers
// while the current one is multiplied out of shared memory (two stages).
// The k chunks are split over the S CTAs of a cluster (grid z, cluster
// 1 x 1 x S): each sums its share in order, and CTA z then adds the S
// partial tiles of its share of the outputs in CTA order through
// distributed shared memory, so dU is deterministic for a given S.
__global__ void __launch_bounds__(DU_THREADS)
lstm_du_kernel(const float* __restrict__ h_seq, const float* __restrict__ dgx,
               float* __restrict__ du, int K, int B, int H) {
  constexpr int PER = DU_BK * DU_BM / DU_THREADS;  // elements per thread
  __shared__ __align__(16) float As[2][DU_BK][DU_BM];
  __shared__ __align__(16) float Bs[2][DU_BK][DU_BN];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int z = (int)cluster.block_rank();
  const int H4 = 4 * H;
  const int m0 = blockIdx.y * DU_BM;
  const int n0 = blockIdx.x * DU_BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float ra[PER], rb[PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * DU_THREADS;
      const int r = k0 + e / DU_BM;
      const int x = e % DU_BM;
      ra[i] = (r < K && m0 + x < H) ? h_seq[(size_t)r * H + m0 + x] : 0.0f;
      rb[i] = (r < K && n0 + x < H4) ? dgx[(size_t)(r + B) * H4 + n0 + x]
                                    : 0.0f;
    }
  };
  auto store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * DU_THREADS;
      As[stage][e / DU_BM][e % DU_BM] = ra[i];
      Bs[stage][e / DU_BM][e % DU_BM] = rb[i];
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const int chunks = (K + DU_BK - 1) / DU_BK;
  const int c0 = z * chunks / S;
  const int c1 = (z + 1) * chunks / S;
  if (c0 < c1) {
    load(c0 * DU_BK);
    store(0);
  }
  __syncthreads();
  for (int c = c0; c < c1; ++c) {
    const int st = (c - c0) & 1;
    if (c + 1 < c1) load((c + 1) * DU_BK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < DU_BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[st][kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (c + 1 < c1) store(st ^ 1);
    __syncthreads();  // the next stage complete, this one no longer read
  }
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= H) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < H4) du[(size_t)m * H4 + n] = acc[i][j];
      }
    }
    return;
  }
  // the partial tile [DU_BM][DU_BN] in As (no longer read), then CTA z sums
  // outputs [z * share, (z + 1) * share) over the cluster in CTA order
  float* part = &As[0][0][0];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(part + (ty * 4 + i) * DU_BN + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();  // every partial tile written
  const int share = DU_BM * DU_BN / S;
  for (int e = z * share + threadIdx.x; e < (z + 1) * share;
       e += DU_THREADS) {
    float v = 0.0f;
    for (int r = 0; r < S; ++r) v += cluster.map_shared_rank(part, r)[e];
    const int m = m0 + e / DU_BN;
    const int n = n0 + e % DU_BN;
    if (m < H && n < H4) du[(size_t)m * H4 + n] = v;
  }
  cluster.sync();  // no CTA leaves while its partial tile is read
}

// ------------------------------------------------------------ launches ----

// The launch of either recurrence kernel for a cluster of N CTAs.
typedef void (*FwdKernel)(const float*, const float*, float*, float*, float*,
                          int, int, int, int, int);
typedef void (*BwdKernel)(const float*, const float*, const float*,
                          const float*, float*, int, int, int, int, int);

struct Launch {
  Layout L;
  int ntiles, rows_fwd, rows_bwd;
  int q;  // owner rounds, rounded up to the kernels' template Q
  size_t smem_fwd, smem_bwd;

  Launch(int B, int H, int N, int tile)
      : L(H, N, tile), ntiles((B + tile - 1) / tile) {
    const int rounds = (L.tile * L.NU + QUADS - 1) / QUADS;
    q = rounds <= 1 ? 1 : rounds <= 2 ? 2 : rounds <= 4 ? 4
      : rounds <= 8 ? 8 : 16;
    rows_fwd = resident_rows(L, L.fwd_fixed());
    rows_bwd = resident_rows(L, L.bwd_fixed());
    smem_fwd = ((size_t)rows_fwd * L.ldu + L.fwd_fixed() + 4) * sizeof(float);
    smem_bwd = ((size_t)rows_bwd * L.ldu + L.bwd_fixed() + 4) * sizeof(float);
  }
  bool fits() const {
    return rows_fwd >= 0 && rows_bwd >= 0 && L.P <= FWD_THREADS &&
           L.tile * L.NU <= MAXQ * QUADS;
  }
  FwdKernel fwd() const {
    return q == 1 ? lstm_fwd_kernel<1> : q == 2 ? lstm_fwd_kernel<2>
         : q == 4 ? lstm_fwd_kernel<4> : q == 8 ? lstm_fwd_kernel<8>
         : lstm_fwd_kernel<16>;
  }
  BwdKernel bwd() const {
    return q == 1 ? lstm_bwd_kernel<1> : q == 2 ? lstm_bwd_kernel<2>
         : q == 4 ? lstm_bwd_kernel<4> : q == 8 ? lstm_bwd_kernel<8>
         : lstm_bwd_kernel<16>;
  }
  cudaLaunchConfig_t config(int threads, size_t smem, cudaStream_t s,
                            cudaLaunchAttribute* attr) const {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(L.N * (ntiles > 0 ? ntiles : 1), 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = L.N;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }
};

template <typename Kernel>
static cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename Kernel>
static cudaError_t active_clusters(Kernel kernel, const Launch& l,
                                   int threads, size_t smem, int* count) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = l.config(threads, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(count, (void*)kernel, &cfg);
}

extern "C" {

// Pick the cluster size and batch tile for [B, H] (tile 0: the default) ->
// out[0..7] = cluster, tile, smem bytes fwd, smem bytes bwd, resident rows
// fwd, resident rows bwd, cudaOccupancyMaxActiveClusters fwd, bwd.
// Returns 0 or a cudaError_t; cudaErrorInvalidConfiguration where no
// cluster of either kernel can be scheduled.
int metaasr_lstm_plan(int B, int H, int tile, int* out) {
  if (B < 0 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  if (tile <= 0) tile = TILE;
  if (tile % RB || tile > 16) return (int)cudaErrorInvalidValue;
  // the largest N at which every CTA owns a unit
  int N = MAX_CLUSTER;
  while (N > 1 && ((H + N - 1) / N) * (N - 1) >= H) N /= 2;
  for (;;) {
    const Launch l(B, H, N, tile);
    int fwd = 0, bwd = 0;
    if (l.fits()) {
      cudaError_t err =
          active_clusters(l.fwd(), l, FWD_THREADS, l.smem_fwd, &fwd);
      if (err == cudaSuccess)
        err = active_clusters(l.bwd(), l, BWD_THREADS, l.smem_bwd, &bwd);
      if (err != cudaSuccess) {
        cudaGetLastError();  // an occupancy query that fails is not sticky
        fwd = bwd = 0;
      }
    }
    if (fwd > 0 && bwd > 0) {
      const int vals[8] = {N, tile, (int)l.smem_fwd, (int)l.smem_bwd,
                           l.rows_fwd, l.rows_bwd, fwd, bwd};
      for (int i = 0; i < 8; ++i) out[i] = vals[i];
      return 0;
    }
    if (N != MAX_CLUSTER) return (int)cudaErrorInvalidConfiguration;
    N = 8;  // the portable size
  }
}

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
// `gates` may be null (no backward follows).
int metaasr_lstm_forward(const void* gx, const void* u, void* h_seq,
                         void* c_seq, void* gates, int T, int B, int H,
                         int cluster, int tile, void* stream) {
  if (T < 0 || B < 0 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return 0;
  const Launch l(B, H, cluster, tile);
  if (!l.fits()) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = prepare(l.fwd(), l.smem_fwd);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      l.config(FWD_THREADS, l.smem_fwd, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, l.fwd(), (const float*)gx,
                           (const float*)u, (float*)h_seq, (float*)c_seq,
                           (float*)gates, T, B, H, tile, l.rows_fwd);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The reversed recurrence: dgx from the saved gates.
int metaasr_lstm_bptt(const void* gates, const void* u, const void* c_seq,
                      const void* dout, void* dgx, int T, int B, int H,
                      int cluster, int tile, void* stream) {
  if (T < 0 || B < 0 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return 0;
  const Launch l(B, H, cluster, tile);
  if (!l.fits()) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = prepare(l.bwd(), l.smem_bwd);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      l.config(BWD_THREADS, l.smem_bwd, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, l.bwd(), (const float*)gates,
                           (const float*)u, (const float*)c_seq,
                           (const float*)dout, (float*)dgx, T, B, H, tile,
                           l.rows_bwd);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The k splits of the dU product (a power of 2 up to 8): as many as keep
// every output tile's CTAs within one wave at two CTAs per SM, each split at
// least one chunk.
int metaasr_lstm_du_splits(int T, int B, int H) {
  if (T < 0 || B < 0 || H < 4 || H % 4) return 1;
  const long chunks = ((long)(T > 0 ? T - 1 : 0) * B + DU_BK - 1) / DU_BK;
  const long tiles = (long)((4 * H + DU_BN - 1) / DU_BN) *
                     ((H + DU_BM - 1) / DU_BM);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int S = 1;
  while (S < 8 && tiles * 2 * S <= 2L * sms && 2 * S <= chunks) S *= 2;
  return S;
}

// dU = h_prev^T @ dgx[B:] after the reversed recurrence, the k chunks split
// over `splits` CTAs (1, 2, 4 or 8; 0: metaasr_lstm_du_splits).
int metaasr_lstm_du(const void* h_seq, const void* dgx, void* du, int T,
                    int B, int H, int splits, void* stream) {
  if (T < 0 || B < 0 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  if (splits <= 0) splits = metaasr_lstm_du_splits(T, B, H);
  if (splits > 8 || (splits & (splits - 1))) return (int)cudaErrorInvalidValue;
  const int K = T > 0 ? (T - 1) * B : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((4 * H + DU_BN - 1) / DU_BN, (H + DU_BM - 1) / DU_BM,
                     splits);
  cfg.blockDim = dim3(DU_THREADS, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = splits;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, lstm_du_kernel,
                                       (const float*)h_seq, (const float*)dgx,
                                       (float*)du, K, B, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
