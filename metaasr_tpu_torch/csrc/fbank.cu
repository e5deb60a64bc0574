// K1: log-mel filterbank for Hopper (sm_90a) as a per-frame FFT, plain C
// interface.
//
// Replaces the Pallas kernel metaasr_tpu/frontend/pallas_fbank.py:54
// _kernel (launched by _pallas_fbank at :80) and computes the same
// function. For frame f of utterance b, the 400 samples
// audio[b, 160 f : 160 f + 400] go through DC removal (minus the frame
// mean), preemphasis x[n] - p x[n-1] (x[0] against itself), the povey
// window and zero padding to 512; then the power of real-FFT bins 0..255
// (Nyquist dropped), the Kaldi mel banks and log(max(mel, FLT_EPSILON)),
// with 0 for frames at or past the utterance's frame length:
// [B, S] f32 audio -> [B, F, num_mel] f32, num_mel <= 128.
//
// The TPU kernel folds the front-end and a 512-point DFT into two
// [400, 256] matrices, because its matrix unit makes the 450,560 FLOP a
// frame cheap; on this card, in fp32 on CUDA cores, those products were
// the whole cost. Here each step of the front-end runs as written and the
// DFT is an FFT: ~13,000 operations a frame.
//
// Bound. At [16, 64000] with every frame valid the kernel must read the
// audio once (4.10 MB) and write the features once (2.04 MB at 80 mel
// bins): 6.1 MB, 1.8 us at 3.35 TB/s. The arithmetic, 6,368 frames x
// ~13,000 fp64 operations, is 84 MFLOP: 1.25 us at the H100 SXM's 67
// TFLOP/s fp64 (its tensor-core rate, the card's highest for the type), so
// bytes bound it (chip_smoke.py counts both).
//
// Precision. The front-end and the FFT run in float64. In fp32 the white
// rounding noise of the explicit front-end and of the FFT lies ~30 dB (the
// preemphasis's attenuation) closer to the low mel bands than the
// rounding of the folded product, and at near-zero bands it moves log-mel
// past the 1e-4 bar: phase 2 of chip_smoke.py prints how far the fp32
// cuFFT composite lands from the float64 oracle, and how far K1 does.
// Hopper runs fp64 at half its fp32 rate. Twiddles and the window come as
// float64 tables from the host; the power is rounded to fp32, the mel sums
// and logf are IEEE fp32 (no fast math).
//
// Design:
// - a block is WARPS = 2 warps, one frame each, over 2 consecutive frames
//   of one utterance; grid (ceil(F / 2), B): 796 blocks for 132 SMs at
//   [4, 64000]. In trials on an H100, blocks of 1, 4 and 8 warps were
//   slower at [16, 64000] and [4, 64000];
// - the block's waveform span, (n - 1) * 160 + 400 samples for its n live
//   frames, is staged once in shared memory: one cp.async.bulk completed on
//   an mbarrier where the span starts 16-byte aligned, coalesced 4-byte
//   cp.async otherwise. Each sample is read from device memory once per
//   block, and no DFT matrix is read at all. The tables (twiddles, window,
//   mel banks: ~17 KB in one buffer, the same for every block) are read
//   through the L1 (__ldg);
// - one warp per frame. Lane l holds z[n] = y[2n] + i y[2n+1] for
//   n = l + 32 r (z is 0 past n = 199), the 256-point complex FFT of the
//   sample pairs runs as Stockham passes of radix 8 (in registers), 8 and
//   4, exchanged through the warp's shared buffer (index + index / 8: no
//   bank conflict in any pass's 16-byte accesses); the pass twiddles are
//   laid out so lanes read consecutive entries;
// - the real split X[k] = (s - i W^k d) / 2, s, d = Z[k] +- conj Z[256-k],
//   W = exp(-2 pi i / 512), takes the partner bin from the shared buffer;
// - the mel product is sparse: each filter is one contiguous bin range,
//   its weights stored column by column in a [widest filter, num_mel]
//   table (~500 non-zeros, 16 x 80 entries at 80 bins, against 20,480
//   dense); lane l sums filters l, l + 32, ... side by side, one bin of
//   each per step, so its loads are coalesced and its sums independent;
// - a frame at or past its utterance's length writes 0 and computes
//   nothing; a block with no live frame stages nothing.
// What holds a frame back is not measured: in trials on an H100, cutting
// the shared-memory traffic by a third, or forcing 85 registers for more
// warps an SM, did not lower the device time.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int FRAME_LEN = 400;
constexpr int FRAME_SHIFT = 160;
constexpr int PAIRS = FRAME_LEN / 2;   // complex samples z[n] of a frame
constexpr int WARPS = 2;               // warps, a frame each, per block
constexpr int MAX_MEL = 128;
constexpr int MEL_PER_LANE = MAX_MEL / 32;
constexpr int BUF = 256 + 256 / 8;     // a warp's padded buffer, double2
// the twiddle table (double2), W = exp(-2 pi i / 512), one region per use
constexpr int TW2 = 0;                 // [r - 1][m] = W^(8 r m), r 1..7, m 0..7
constexpr int TW3 = TW2 + 7 * 8;       // [r - 1][j] = W^(2 r j), r 1..3, j 0..63
constexpr int TWS = TW3 + 3 * 64;      // [k] = W^k, k 0..255
constexpr int N_TW = TWS + 256;

// dynamic shared memory of a block: the warps' buffers, the span
constexpr int SMEM_BYTES =
    16 * WARPS * BUF + 4 * ((WARPS - 1) * FRAME_SHIFT + FRAME_LEN);
static_assert(SMEM_BYTES <= 48 * 1024, "no opt-in needed");

// The tables as one buffer, each part 16-byte aligned: twiddles [N_TW],
// window pairs [PAIRS] (w[2n], w[2n + 1]), mel bins [num_mel] (filter m's
// bins lo..hi-1), mel weights [mel_width][num_mel] (filter m's weight of
// bin lo + t at [t][m], 0 past its end).
struct Tables {
  const double2* tw;
  const double2* win;
  const int2* bins;
  const float* w;
};

__device__ __forceinline__ Tables tables(const unsigned char* base,
                                         int num_mel) {
  Tables t;
  t.tw = reinterpret_cast<const double2*>(base);
  t.win = t.tw + N_TW;
  t.bins = reinterpret_cast<const int2*>(t.win + PAIRS);
  t.w = reinterpret_cast<const float*>(base + 16 * (N_TW + PAIRS)
                                       + ((8 * num_mel + 15) & ~15));
  return t;
}

struct Args {
  const float* audio;       // [B, S]
  const int* frame_lens;    // [B]
  const unsigned char* tables;  // see Tables
  float* out;               // [B, F, num_mel]
  int S, F, num_mel, mel_width;
  double p;                 // preemphasis
  int remove_dc;
};

// ---- PTX: shared-memory addresses, cp.async, the bulk copy, mbarriers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// the phase's one arrival, which also expects `bytes` of the bulk copy
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to shared
// `dst`, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- complex float64 arithmetic and the small DFTs ----

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 mul_mi(double2 a) {  // -i a
  return make_double2(a.y, -a.x);
}

// (a0, a1, a2, a3) <- their 4-point DFT, exp(-2 pi i n q / 4)
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2,
                                     double2& a3) {
  const double2 b0 = cadd(a0, a2), b2 = csub(a0, a2);
  const double2 b1 = cadd(a1, a3), b3 = mul_mi(csub(a1, a3));
  a0 = cadd(b0, b1);
  a1 = cadd(b2, b3);
  a2 = csub(b0, b1);
  a3 = csub(b2, b3);
}

// v <- its 8-point DFT, exp(-2 pi i n q / 8): one radix-2 split, then two
// 4-point DFTs (even outputs from the sums, odd from the twiddled
// differences)
__device__ __forceinline__ void dft8(double2 (&v)[8]) {
  constexpr double C = 0.70710678118654752440;
  double2 a0 = cadd(v[0], v[4]), a4 = csub(v[0], v[4]);
  double2 a1 = cadd(v[1], v[5]), a5 = csub(v[1], v[5]);
  double2 a2 = cadd(v[2], v[6]), a6 = csub(v[2], v[6]);
  double2 a3 = cadd(v[3], v[7]), a7 = csub(v[3], v[7]);
  a5 = make_double2(C * (a5.x + a5.y), C * (a5.y - a5.x));    // x W8
  a6 = mul_mi(a6);                                             // x W8^2
  a7 = make_double2(C * (a7.y - a7.x), -C * (a7.x + a7.y));   // x W8^3
  dft4(a0, a1, a2, a3);
  dft4(a4, a5, a6, a7);
  v[0] = a0; v[1] = a4; v[2] = a1; v[3] = a5;
  v[4] = a2; v[5] = a6; v[6] = a3; v[7] = a7;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

// One warp: the log-mel row of the frame whose 400 samples start at `x`
// (shared memory) into `row`; `buf` is the warp's exchange buffer.
__device__ __forceinline__ void frame_log_mel(const Args& a, const Tables& tb,
                                              const float* x, double2* buf,
                                              int lane, float* row) {
  // the samples as pairs, and the frame mean
  double2 z[8];
  double sum = 0.0;
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    const int n = lane + 32 * r;
    z[r] = make_double2(0.0, 0.0);
    if (n < PAIRS) {
      const float2 v = *reinterpret_cast<const float2*>(x + 2 * n);
      z[r] = make_double2(v.x, v.y);
      sum += z[r].x + z[r].y;
    }
  }
  z[7] = make_double2(0.0, 0.0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const double mean = a.remove_dc ? sum * (1.0 / FRAME_LEN) : 0.0;
  // DC removal, preemphasis against the previous sample, the window
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    const int n = lane + 32 * r;
    if (n < PAIRS) {
      const double e = z[r].x - mean, o = z[r].y - mean;
      const double prev = (n > 0 ? (double)x[2 * n - 1] : z[r].x) - mean;
      const double2 w = __ldg(tb.win + n);
      z[r] = make_double2((e - a.p * prev) * w.x, (o - a.p * e) * w.y);
    }
  }

  // pass 1, radix 8 (stride 1): z[l + 32 r] -> buf[8 l + r]
  dft8(z);
#pragma unroll
  for (int r = 0; r < 8; ++r) buf[pad(8 * lane + r)] = z[r];
  __syncwarp();
  // pass 2, radix 8 (stride 8): buf[l + 32 r] x W^(8 r (l % 8)) ->
  // buf[64 (l / 8) + l % 8 + 8 r]
#pragma unroll
  for (int r = 0; r < 8; ++r) z[r] = buf[pad(lane + 32 * r)];
#pragma unroll
  for (int r = 1; r < 8; ++r)
    z[r] = cmul(z[r], __ldg(tb.tw + TW2 + 8 * (r - 1) + (lane & 7)));
  dft8(z);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 8; ++r)
    buf[pad(64 * (lane >> 3) + (lane & 7) + 8 * r)] = z[r];
  __syncwarp();
  // pass 3, radix 4 (stride 64) for j = l and l + 32: buf[j + 64 r] x
  // W^(2 r j) -> Z[j + 64 r], kept in z[2 r + h]: z[q] is bin l + 32 q
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    double2 u[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) u[r] = buf[pad(j + 64 * r)];
#pragma unroll
    for (int r = 1; r < 4; ++r)
      u[r] = cmul(u[r], __ldg(tb.tw + TW3 + 64 * (r - 1) + j));
    dft4(u[0], u[1], u[2], u[3]);
#pragma unroll
    for (int r = 0; r < 4; ++r) z[2 * r + h] = u[r];
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q) buf[pad(lane + 32 * q)] = z[q];
  __syncwarp();

  // the real split and the power of bins l + 32 q
  float pw[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k = lane + 32 * q;
    const double2 zp = buf[pad((256 - k) & 255)];
    const double2 s = make_double2(z[q].x + zp.x, z[q].y - zp.y);
    const double2 d = make_double2(z[q].x - zp.x, z[q].y + zp.y);
    const double2 t = cmul(__ldg(tb.tw + TWS + k), d);
    const double re = s.x + t.y, im = s.y - t.x;   // 2 X[k] = s - i t
    pw[q] = (float)(0.25 * (re * re + im * im));
  }
  __syncwarp();
  float* power = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int q = 0; q < 8; ++q) power[lane + 32 * q] = pw[q];
  __syncwarp();

  // the sparse mel product of filters l + 32 i, one bin of each per step,
  // and the log
  int2 bins[MEL_PER_LANE];
  float acc[MEL_PER_LANE];
#pragma unroll
  for (int i = 0; i < MEL_PER_LANE; ++i) {
    const int m = lane + 32 * i;
    bins[i] = m < a.num_mel ? __ldg(tb.bins + m) : make_int2(0, 0);
    acc[i] = 0.f;
  }
  for (int t = 0; t < a.mel_width; ++t) {
    const float* w = tb.w + t * a.num_mel + lane;
#pragma unroll
    for (int i = 0; i < MEL_PER_LANE; ++i) {
      const int k = bins[i].x + t;
      if (k < bins[i].y) acc[i] = fmaf(__ldg(w + 32 * i), power[k], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < MEL_PER_LANE; ++i) {
    const int m = lane + 32 * i;
    if (m < a.num_mel) row[m] = logf(fmaxf(acc[i], FLT_EPSILON));
  }
}

// 8 blocks an SM at least: 128 registers a thread
__global__ void __launch_bounds__(32 * WARPS, 8)
fbank_fft_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double2* buf = reinterpret_cast<double2*>(smem) + warp * BUF;
  float* span = reinterpret_cast<float*>(smem + 16 * WARPS * BUF);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * WARPS;
  const int f_end = min(f0 + WARPS, a.F);
  const int live_end = min(f_end, max(a.frame_lens[b], 0));

  // stage the span of the live frames [f0, live_end)
  if (live_end > f0) {
    const float* src = a.audio + (size_t)b * a.S + (size_t)f0 * FRAME_SHIFT;
    const int n = (live_end - f0 - 1) * FRAME_SHIFT + FRAME_LEN;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      if (threadIdx.x == 0) {
        mbar_init(&bar);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_expect(&bar, 4u * n);
        bulk_load(span, src, 4u * n, &bar);
      }
      __syncthreads();
      mbar_wait(&bar, 0);
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        cp_async4(span + i, src + i);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
  }

  const int f = f0 + warp;
  if (f >= f_end) return;
  float* row = a.out + ((size_t)b * a.F + f) * a.num_mel;
  if (f >= live_end) {
    for (int m = lane; m < a.num_mel; m += 32) row[m] = 0.f;
  } else {
    frame_log_mel(a, tables(a.tables, a.num_mel),
                  span + (f - f0) * FRAME_SHIFT, buf, lane, row);
  }
}

}  // namespace

extern "C" {

// Largest mel dimension the kernel takes (the reference Pallas path's).
int metaasr_fbank_max_mel() { return MAX_MEL; }

// Consecutive frames of one utterance a block computes.
int metaasr_fbank_frames_per_block() { return WARPS; }

// audio [batch, num_samples] f32, frame_lens [batch] i32, the tables (see
// Tables: twiddles, window, mel bins and weights of num_mel filters, the
// widest mel_width bins) -> out
// [batch, num_frames, num_mel] f32, all contiguous on the device;
// launched on `stream`. Returns cudaGetLastError() after the launch (0 on
// success).
int metaasr_fbank_log_mel(const float* audio, const int* frame_lens,
                          const void* tables, float* out, int batch,
                          int num_samples, int num_frames, int num_mel,
                          int mel_width, double preemphasis, int remove_dc,
                          void* stream) {
  if (batch <= 0 || num_frames <= 0) return 0;
  if (num_mel < 1 || num_mel > MAX_MEL ||
      mel_width < 0 || mel_width > 256 || batch > 65535 ||
      num_samples < (num_frames - 1) * FRAME_SHIFT + FRAME_LEN)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.audio = audio;
  a.frame_lens = frame_lens;
  a.tables = static_cast<const unsigned char*>(tables);
  a.out = out;
  a.S = num_samples;
  a.F = num_frames;
  a.num_mel = num_mel;
  a.mel_width = mel_width;
  a.p = preemphasis;
  a.remove_dc = remove_dc;
  const dim3 grid((num_frames + WARPS - 1) / WARPS, batch);
  fbank_fft_kernel<<<grid, 32 * WARPS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
