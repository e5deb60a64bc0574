// K3 / K3b: the LSTM recurrence, its BPTT and the recurrent-weight gradient.
//
// Replaces the Pallas kernels of metaasr_tpu/ops/lstm_pallas.py:
//   K3  :48 _fwd_kernel (pallas_call at :132 in _lstm_fwd_run)
//   K3b :71 _bwd_kernel (pallas_call at :178 in _lstm_vjp_bwd)
//
//   forward : gx [T, B, 4H] f32 (input projection and bias already applied),
//             U [H, 4H] f32 -> h_seq, c_seq [T, B, H] f32. Per step
//             g = gx[t] + h @ U, gates (i, f, g, o) with +1 on the forget
//             gate, c = f*c + i*g, h = o*tanh(c); zero initial state.
//   backward: gx, U, U^T [4H, H], h_seq, c_seq, dout [T, B, H] ->
//             dgx [T, B, 4H], dU [H, 4H]. Time reversed: the gates are
//             recomputed from gx[t] + h[t-1] @ U, dgates go to dgx[t],
//             dh = dgates @ U^T and dc = dc_tot * f are carried, and
//             dU = sum_t h[t-1]^T @ dgates[t].
//
// Design. Batch rows never interact inside the recurrence, so one block owns
// one batch row for all T steps and no grid-wide synchronisation exists. U
// (H*4H floats, 1.6 MB at H = 320) does not fit a block's shared memory; it
// is streamed every step and stays resident in the L2 cache. What a step
// costs is therefore the latency and the width of one SM's path to L2, and
// the block is laid out to keep that path full: 1024 threads, each owning
// four neighbouring columns of U (one 16-byte load per row, neighbouring
// threads on neighbouring addresses) and one slice of the rows, so that
// column groups x row slices covers the block. Each thread multiplies its
// slice of h (shared memory, a broadcast) into its columns, the partial sums
// of the row slices meet in shared memory, and the first H threads add them
// in slice order (deterministic), apply the gates and own c. Two barriers
// per forward step. Any T and B and every H that is a multiple of 4 are
// taken; nothing is padded and there is no size fallback. h[t-1] and c[t-1]
// are read at index t-1 of h_seq/c_seq (zeros at t = 0) instead of from
// shifted copies.
//
// The backward recurrence needs dh[k] = sum_j dgates[j] * U[k, j], a walk
// along a row of U. The wrapper hands in U^T so that this product is the
// same column-group matvec (over 4H rows of width H). Four barriers per
// backward step.
//
// dU is a reduction over T and B that no block of the recurrence owns, so a
// second kernel computes it after the recurrence pass as one tiled fp32
// product dU = h_prev^T [H, (T-1)*B] @ dgx[B:] [(T-1)*B, 4H] (the t = 0 term
// is zero): 64 x 64 output tiles, 16-deep shared-memory stages, a 4 x 4
// register tile per thread, k summed in order, so dU is deterministic.
//
// Arithmetic: fp32 IEEE FMAs, expf/tanhf without fast math, no tensor cores.
//
// Bound. The operations are 2*T*B*H*4H (forward) and 6*T*B*H*4H (backward)
// fp32 flops, the bytes each array once; at [99, 16, 320] the operations
// term is larger and far below a millisecond. What bounds these kernels is
// the chain of T dependent steps, each of which streams all of U (and of U^T
// in the backward) through one SM's path to L2, with only B blocks on 132
// SMs. Later designs: split U's columns over a thread-block cluster and keep
// the slices in distributed shared memory; a persistent cooperative kernel;
// a tensor-core h @ U over a batch tile.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 1024
#define MAX_SMEM 232448  // bytes of shared memory one block can opt in to

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Row slices of a [rows, cols] matvec for a block of THREADS threads:
// cols / 4 column groups, THREADS / groups slices (1 when the groups exceed
// the block, which then loops over them).
__host__ __device__ __forceinline__ int row_slices(int cols) {
  const int groups = cols / 4;
  return groups >= THREADS ? 1 : THREADS / groups;
}

// part[s * cols + j] = sum over row slice s of vec[k] * mat[k, j], for the
// row-major mat [rows, cols] in global memory (cols a multiple of 4, rows 16
// bytes aligned) and vec [rows] in shared memory. Every thread of the block
// calls it; the caller synchronises before reading part.
__device__ __forceinline__ void block_matvec(const float* __restrict__ mat,
                                             int rows, int cols,
                                             const float* vec, float* part) {
  const int groups = cols / 4;
  const int slices = row_slices(cols);
  const int per = (rows + slices - 1) / slices;
  for (int id = threadIdx.x; id < groups * slices; id += THREADS) {
    const int grp = id % groups;
    const int s = id / groups;
    const int k0 = s * per;
    const int k1 = min(rows, k0 + per);
    const float4* col = reinterpret_cast<const float4*>(mat) + grp;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int k = k0;
    for (; k + 4 <= k1; k += 4) {
      // four independent 16-byte loads in flight before the first FMA
      const float4 m0 = __ldg(col + (size_t)k * groups);
      const float4 m1 = __ldg(col + (size_t)(k + 1) * groups);
      const float4 m2 = __ldg(col + (size_t)(k + 2) * groups);
      const float4 m3 = __ldg(col + (size_t)(k + 3) * groups);
      const float v0 = vec[k], v1 = vec[k + 1], v2 = vec[k + 2],
                  v3 = vec[k + 3];
      acc.x = fmaf(v0, m0.x, acc.x); acc.y = fmaf(v0, m0.y, acc.y);
      acc.z = fmaf(v0, m0.z, acc.z); acc.w = fmaf(v0, m0.w, acc.w);
      acc.x = fmaf(v1, m1.x, acc.x); acc.y = fmaf(v1, m1.y, acc.y);
      acc.z = fmaf(v1, m1.z, acc.z); acc.w = fmaf(v1, m1.w, acc.w);
      acc.x = fmaf(v2, m2.x, acc.x); acc.y = fmaf(v2, m2.y, acc.y);
      acc.z = fmaf(v2, m2.z, acc.z); acc.w = fmaf(v2, m2.w, acc.w);
      acc.x = fmaf(v3, m3.x, acc.x); acc.y = fmaf(v3, m3.y, acc.y);
      acc.z = fmaf(v3, m3.z, acc.z); acc.w = fmaf(v3, m3.w, acc.w);
    }
    for (; k < k1; ++k) {
      const float4 m = __ldg(col + (size_t)k * groups);
      const float v = vec[k];
      acc.x = fmaf(v, m.x, acc.x); acc.y = fmaf(v, m.y, acc.y);
      acc.z = fmaf(v, m.z, acc.z); acc.w = fmaf(v, m.w, acc.w);
    }
    reinterpret_cast<float4*>(part + (size_t)s * cols)[grp] = acc;
  }
}

// sum of the row slices' partial sums for column j, in slice order
__device__ __forceinline__ float slice_sum(const float* part, int cols,
                                           int slices, int j) {
  float acc = part[j];
  for (int s = 1; s < slices; ++s) acc += part[(size_t)s * cols + j];
  return acc;
}

// shared-memory floats of the two kernels (host and device agree on these)
__host__ __device__ __forceinline__ size_t part_floats(int H) {
  const size_t a = (size_t)row_slices(4 * H) * 4 * H;
  const size_t b = (size_t)row_slices(H) * H;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ u,
                float* __restrict__ h_seq, float* __restrict__ c_seq, int T,
                int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* part = smem;                  // [slices][4H] partial gate sums
  float* hbuf = part + part_floats(H);  // [H] h[t-1]
  float* cbuf = hbuf + H;               // [H] c[t-1], owning thread only
  const int b = blockIdx.x;
  const int H4 = 4 * H;
  const int slices = row_slices(H4);
  for (int n = threadIdx.x; n < H; n += THREADS) {
    hbuf[n] = 0.0f;
    cbuf[n] = 0.0f;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const size_t row = (size_t)t * B + b;
    const float* gxt = gx + row * H4;
    block_matvec(u, H, H4, hbuf, part);
    __syncthreads();  // part complete, hbuf no longer read
    for (int n = threadIdx.x; n < H; n += THREADS) {
      const float i = sigmoid_f(gxt[n] + slice_sum(part, H4, slices, n));
      const float f = sigmoid_f(
          gxt[H + n] + slice_sum(part, H4, slices, H + n) + 1.0f);
      const float gg =
          tanhf(gxt[2 * H + n] + slice_sum(part, H4, slices, 2 * H + n));
      const float o =
          sigmoid_f(gxt[3 * H + n] + slice_sum(part, H4, slices, 3 * H + n));
      const float c = f * cbuf[n] + i * gg;
      const float h = o * tanhf(c);
      cbuf[n] = c;
      hbuf[n] = h;
      h_seq[row * H + n] = h;
      c_seq[row * H + n] = c;
    }
    __syncthreads();  // hbuf complete, part no longer read
  }
}

__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const float* __restrict__ gx, const float* __restrict__ u,
                const float* __restrict__ ut, const float* __restrict__ h_seq,
                const float* __restrict__ c_seq,
                const float* __restrict__ dout, float* __restrict__ dgx,
                int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* part = smem;                // partial sums of either matvec
  float* dg = part + part_floats(H);  // [4H] dgates of this step
  float* hp = dg + 4 * H;             // [H]  h[t-1]
  float* dh = hp + H;                 // [H]  carried dL/dh[t-1], own thread
  float* dc = dh + H;                 // [H]  carried dL/dc[t-1], own thread
  const int b = blockIdx.x;
  const int H4 = 4 * H;
  const int slices_u = row_slices(H4);
  const int slices_ut = row_slices(H);
  for (int n = threadIdx.x; n < H; n += THREADS) {
    dh[n] = 0.0f;
    dc[n] = 0.0f;
  }
  for (int t = T - 1; t >= 0; --t) {
    const size_t row = (size_t)t * B + b;
    const size_t prev = row - B;  // used only when t > 0
    for (int n = threadIdx.x; n < H; n += THREADS)
      hp[n] = t > 0 ? h_seq[prev * H + n] : 0.0f;
    __syncthreads();  // hp complete; last step's reads of part are done
    block_matvec(u, H, H4, hp, part);
    __syncthreads();  // part complete
    const float* gxt = gx + row * H4;
    float* dgxt = dgx + row * H4;
    for (int n = threadIdx.x; n < H; n += THREADS) {
      const float i = sigmoid_f(gxt[n] + slice_sum(part, H4, slices_u, n));
      const float f = sigmoid_f(
          gxt[H + n] + slice_sum(part, H4, slices_u, H + n) + 1.0f);
      const float gg =
          tanhf(gxt[2 * H + n] + slice_sum(part, H4, slices_u, 2 * H + n));
      const float o = sigmoid_f(
          gxt[3 * H + n] + slice_sum(part, H4, slices_u, 3 * H + n));
      const float c_prev = t > 0 ? c_seq[prev * H + n] : 0.0f;
      const float tc = tanhf(c_seq[row * H + n]);
      const float dh_tot = dout[row * H + n] + dh[n];
      const float dc_tot = dh_tot * o * (1.0f - tc * tc) + dc[n];
      const float do_pre = dh_tot * tc * o * (1.0f - o);
      const float df_pre = dc_tot * c_prev * f * (1.0f - f);
      const float di_pre = dc_tot * gg * i * (1.0f - i);
      const float dg_pre = dc_tot * i * (1.0f - gg * gg);
      dg[n] = di_pre;
      dg[H + n] = df_pre;
      dg[2 * H + n] = dg_pre;
      dg[3 * H + n] = do_pre;
      dgxt[n] = di_pre;
      dgxt[H + n] = df_pre;
      dgxt[2 * H + n] = dg_pre;
      dgxt[3 * H + n] = do_pre;
      dc[n] = dc_tot * f;
    }
    __syncthreads();  // dg complete; part no longer read
    // dh[t-1][n] = sum_j dgates[j] * U[n, j] = sum_j dg[j] * U^T[j, n]
    block_matvec(ut, H4, H, dg, part);
    __syncthreads();  // part complete
    for (int n = threadIdx.x; n < H; n += THREADS)
      dh[n] = slice_sum(part, H, slices_ut, n);
  }
}

#define DU_BM 64
#define DU_BN 64
#define DU_BK 16
#define DU_THREADS 256

// du[m, n] = sum_{r < K} h_seq[r, m] * dgx[r + B, n]: rows r = (t-1)*B + b of
// h_seq are h[t-1], rows r + B of dgx are dgates[t]. Both tiles are read
// along their contiguous axis.
__global__ void lstm_du_kernel(const float* __restrict__ h_seq,
                               const float* __restrict__ dgx,
                               float* __restrict__ du, int K, int B, int H) {
  __shared__ __align__(16) float As[DU_BK][DU_BM];
  __shared__ __align__(16) float Bs[DU_BK][DU_BN];
  const int H4 = 4 * H;
  const int m0 = blockIdx.y * DU_BM;
  const int n0 = blockIdx.x * DU_BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += DU_BK) {
    for (int e = threadIdx.x; e < DU_BK * DU_BM; e += DU_THREADS) {
      const int kk = e / DU_BM;
      const int x = e % DU_BM;
      const int r = k0 + kk;
      As[kk][x] = (r < K && m0 + x < H)
                      ? h_seq[(size_t)r * H + m0 + x] : 0.0f;
      Bs[kk][x] = (r < K && n0 + x < H4)
                      ? dgx[(size_t)(r + B) * H4 + n0 + x] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DU_BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
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
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" {

// Both launch on `stream` and return cudaGetLastError() (0 = launched).

int metaasr_lstm_forward(const void* gx, const void* u, void* h_seq,
                         void* c_seq, int T, int B, int H, void* stream) {
  if (T < 0 || B < 0 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return 0;
  const size_t smem = (part_floats(H) + (size_t)2 * H) * sizeof(float);
  cudaError_t err = allow_smem(lstm_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_fwd_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)gx, (const float*)u, (float*)h_seq, (float*)c_seq, T, B,
      H);
  return (int)cudaGetLastError();
}

int metaasr_lstm_backward(const void* gx, const void* u, const void* ut,
                          const void* h_seq, const void* c_seq,
                          const void* dout, void* dgx, void* du, int T, int B,
                          int H, void* stream) {
  if (T < 0 || B < 0 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 0 && B > 0) {
    const size_t smem = (part_floats(H) + (size_t)7 * H) * sizeof(float);
    cudaError_t err = allow_smem(lstm_bwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    lstm_bwd_kernel<<<B, THREADS, smem, s>>>(
        (const float*)gx, (const float*)u, (const float*)ut,
        (const float*)h_seq, (const float*)c_seq, (const float*)dout,
        (float*)dgx, T, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int K = T > 0 ? (T - 1) * B : 0;
  dim3 grid((4 * H + DU_BN - 1) / DU_BN, (H + DU_BM - 1) / DU_BM);
  lstm_du_kernel<<<grid, DU_THREADS, 0, s>>>(
      (const float*)h_seq, (const float*)dgx, (float*)du, K, B, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
