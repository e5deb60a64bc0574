// K1: fused log-mel filterbank for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel metaasr_tpu/frontend/pallas_fbank.py::_kernel
// (launched by _pallas_fbank). Per frame row it computes
//     real  = frame @ C_cos            [400] x [400, 256]
//     imag  = frame @ C_sin
//     power = real^2 + imag^2          [256]
//     mel   = power @ M                [256] x [256, num_mel]
//     out   = log(max(mel, FLT_EPSILON)), and 0 for frames at or past the
//             utterance's frame length.
// C_cos/C_sin fold DC removal, preemphasis, the povey window and the real
// DFT of the zero-padded 512-point window into one linear map (see
// frontend/fbank.py::FbankParams).
//
// Bound. Per frame the work is 2*400*256*2 + 2*256*80 = 450,560 fp32 FLOP
// against 1.6 KB of input and 320 B of output, so the kernel is bound by
// fp32 CUDA-core throughput, not by memory: at B=16 x 64,000 samples
// (6,368 frames) that is 2.87 GFLOP, ~43 us at the H100 SXM's 67 TFLOP/s.
// The reference pins HIGHEST precision, so the products are plain IEEE
// fp32 FMAs (no TF32 tensor cores; -use_fast_math is not used).
//
// Design against that bound:
// - frames are read straight from the waveform: frame f of utterance b is
//   the contiguous window audio[b, f*160 : f*160+400], so the A3 frame
//   matrix of the TPU version is never built;
// - a block owns TILE_F = 32 frames and all 256 bins. The 400-sample
//   reduction is walked in chunks of TILE_T samples; each chunk of frames
//   (stored transposed, so one 16-byte shared load yields 4 frames) and of
//   both DFT planes is staged in shared memory;
// - each thread keeps an 8-frame x 4-bin register tile of real and imag
//   accumulators, so every (frame, coefficient) pair loaded from shared
//   memory feeds 64 FMAs per 10 loads;
// - the power spectrum stays in shared memory (it reuses the staging
//   buffer) and feeds the mel product and the log epilogue in the same
//   block, so nothing but the [rows, num_mel] result is written;
// - a tile whose frames are all past their utterance's length writes zeros
//   and skips the arithmetic.
// Tensor cores (3xTF32 splitting, wgmma) and TMA staging are later work.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int FRAME_LEN = 400;
constexpr int FRAME_SHIFT = 160;
constexpr int N_BINS = 256;
constexpr int TILE_F = 32;                  // frames per block
constexpr int TILE_T = 16;                  // samples per staged chunk
constexpr int THREADS = 256;
constexpr int F_PER_THREAD = 8;             // DFT phase: frames per thread
constexpr int B_PER_THREAD = 4;             // DFT phase: bins per thread
constexpr int BIN_GROUPS = N_BINS / B_PER_THREAD;  // 64
constexpr int ROW_STRIDE = TILE_F + 4;      // pad: 16-byte aligned rows,
                                            // conflict-free 128-bit stores
constexpr int MEL_FRAMES = 4;               // mel phase: frames per thread
constexpr int MEL_PER_LANE = 3;             // mel bins lane + 32*j
constexpr int MAX_MEL = 32 * MEL_PER_LANE;  // 96

static_assert(FRAME_LEN % TILE_T == 0, "chunking must cover the frame");
static_assert(TILE_F * TILE_T == 2 * THREADS, "two frame loads per thread");
static_assert(TILE_T * N_BINS == 16 * THREADS, "four float4 loads per plane");
static_assert((THREADS / BIN_GROUPS) * F_PER_THREAD == TILE_F, "frame cover");
static_assert((THREADS / 32) * MEL_FRAMES == TILE_F, "mel frame cover");

struct DftStage {
  float xs[TILE_T][ROW_STRIDE];   // frames, transposed: [sample][frame]
  float cs[TILE_T][N_BINS];       // C_cos rows of this chunk
  float sn[TILE_T][N_BINS];       // C_sin rows of this chunk
};

struct MelStage {
  float pw[N_BINS][ROW_STRIDE];   // power spectrum, transposed: [bin][frame]
};

union Smem {
  DftStage dft;
  MelStage mel;
};

__global__ void __launch_bounds__(THREADS)
fbank_log_mel_kernel(const float* __restrict__ audio,
                     const int* __restrict__ frame_lens,
                     const float* __restrict__ ccos,
                     const float* __restrict__ csin,
                     const float* __restrict__ mel,
                     float* __restrict__ out,
                     int batch, int num_samples, int num_frames,
                     int num_mel) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x;
  const long long rows = (long long)batch * num_frames;
  const long long row0 = (long long)blockIdx.x * TILE_F;

  // Skip tiles with no valid frame (ragged batches pad with silence).
  int valid = 0;
  if (tid < TILE_F) {
    const long long r = row0 + tid;
    if (r < rows) {
      const long long b = r / num_frames;
      valid = (r - b * num_frames) < frame_lens[b];
    }
  }
  if (!__syncthreads_or(valid)) {
    for (int e = tid; e < TILE_F * num_mel; e += THREADS) {
      const long long r = row0 + e / num_mel;
      if (r < rows) out[r * num_mel + e % num_mel] = 0.f;
    }
    return;
  }

  // ---- DFT: real/imag for TILE_F frames x 256 bins ----
  const int bg = tid % BIN_GROUPS;  // bins bg + 64*j
  const int fg = tid / BIN_GROUPS;  // frames fg*8 .. fg*8+7
  float re[F_PER_THREAD][B_PER_THREAD];
  float im[F_PER_THREAD][B_PER_THREAD];
#pragma unroll
  for (int i = 0; i < F_PER_THREAD; ++i)
#pragma unroll
    for (int j = 0; j < B_PER_THREAD; ++j) re[i][j] = im[i][j] = 0.f;

  // source offsets of this thread's two staged samples (fixed per block)
  long long src[2];
  int xs_t[2], xs_f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = tid + i * THREADS;
    xs_f[i] = e / TILE_T;
    xs_t[i] = e % TILE_T;
    const long long r = row0 + xs_f[i];
    if (r < rows) {
      const long long b = r / num_frames;
      const long long f = r - b * num_frames;
      src[i] = b * num_samples + f * FRAME_SHIFT + xs_t[i];
    } else {
      src[i] = -1;
    }
  }

  for (int t0 = 0; t0 < FRAME_LEN; t0 += TILE_T) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sm.dft.xs[xs_t[i]][xs_f[i]] = src[i] >= 0 ? __ldg(audio + src[i] + t0) : 0.f;
    const float4* gc = reinterpret_cast<const float4*>(ccos + t0 * N_BINS);
    const float4* gs = reinterpret_cast<const float4*>(csin + t0 * N_BINS);
    float4* scs = reinterpret_cast<float4*>(&sm.dft.cs[0][0]);
    float4* ssn = reinterpret_cast<float4*>(&sm.dft.sn[0][0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * THREADS;
      scs[e] = __ldg(gc + e);
      ssn[e] = __ldg(gs + e);
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < TILE_T; ++t) {
      const float4 xa = *reinterpret_cast<const float4*>(&sm.dft.xs[t][fg * F_PER_THREAD]);
      const float4 xb = *reinterpret_cast<const float4*>(&sm.dft.xs[t][fg * F_PER_THREAD + 4]);
      const float x[F_PER_THREAD] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      float c[B_PER_THREAD], s[B_PER_THREAD];
#pragma unroll
      for (int j = 0; j < B_PER_THREAD; ++j) {
        c[j] = sm.dft.cs[t][bg + BIN_GROUPS * j];
        s[j] = sm.dft.sn[t][bg + BIN_GROUPS * j];
      }
#pragma unroll
      for (int i = 0; i < F_PER_THREAD; ++i)
#pragma unroll
        for (int j = 0; j < B_PER_THREAD; ++j) {
          re[i][j] = fmaf(x[i], c[j], re[i][j]);
          im[i][j] = fmaf(x[i], s[j], im[i][j]);
        }
    }
    __syncthreads();
  }

  // ---- power spectrum into shared memory (reuses the staging buffer) ----
#pragma unroll
  for (int j = 0; j < B_PER_THREAD; ++j) {
    float p[F_PER_THREAD];
#pragma unroll
    for (int i = 0; i < F_PER_THREAD; ++i)
      p[i] = fmaf(re[i][j], re[i][j], im[i][j] * im[i][j]);
    float4* dst = reinterpret_cast<float4*>(&sm.mel.pw[bg + BIN_GROUPS * j][fg * F_PER_THREAD]);
    dst[0] = make_float4(p[0], p[1], p[2], p[3]);
    dst[1] = make_float4(p[4], p[5], p[6], p[7]);
  }
  __syncthreads();

  // ---- mel product + log epilogue ----
  const int lane = tid % 32;
  const int fm = tid / 32;  // frames fm*4 .. fm*4+3
  float acc[MEL_FRAMES][MEL_PER_LANE];
#pragma unroll
  for (int i = 0; i < MEL_FRAMES; ++i)
#pragma unroll
    for (int j = 0; j < MEL_PER_LANE; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < N_BINS; ++k) {
    const float4 p = *reinterpret_cast<const float4*>(&sm.mel.pw[k][fm * MEL_FRAMES]);
#pragma unroll
    for (int j = 0; j < MEL_PER_LANE; ++j) {
      const int m = lane + 32 * j;
      const float w = m < num_mel ? __ldg(mel + k * num_mel + m) : 0.f;
      acc[0][j] = fmaf(p.x, w, acc[0][j]);
      acc[1][j] = fmaf(p.y, w, acc[1][j]);
      acc[2][j] = fmaf(p.z, w, acc[2][j]);
      acc[3][j] = fmaf(p.w, w, acc[3][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < MEL_FRAMES; ++i) {
    const long long r = row0 + fm * MEL_FRAMES + i;
    if (r >= rows) continue;
    const long long b = r / num_frames;
    const bool live = (r - b * num_frames) < frame_lens[b];
#pragma unroll
    for (int j = 0; j < MEL_PER_LANE; ++j) {
      const int m = lane + 32 * j;
      if (m < num_mel)
        out[r * num_mel + m] = live ? logf(fmaxf(acc[i][j], FLT_EPSILON)) : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Largest mel dimension the kernel's register tile covers.
int metaasr_fbank_max_mel() { return MAX_MEL; }

// audio [batch, num_samples] f32, frame_lens [batch] i32, ccos/csin
// [400, 256] f32, mel [256, num_mel] f32 -> out [batch, num_frames,
// num_mel] f32, all contiguous on the device; launched on `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
int metaasr_fbank_log_mel(const float* audio, const int* frame_lens,
                          const float* ccos, const float* csin,
                          const float* mel, float* out, int batch,
                          int num_samples, int num_frames, int num_mel,
                          void* stream) {
  const long long rows = (long long)batch * num_frames;
  if (rows == 0) return 0;
  if (num_mel < 1 || num_mel > MAX_MEL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((rows + TILE_F - 1) / TILE_F);
  fbank_log_mel_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      audio, frame_lens, ccos, csin, mel, out, batch, num_samples,
      num_frames, num_mel);
  return (int)cudaGetLastError();
}

}  // extern "C"
