// sweep_spec.cu: the SSB receive chain with spectral-subtraction noise
// reduction folded in, one channel per thread block.
//
// Replaces _spec_chain_kernel (radiodsp_sdr_rx_tpu/ops/pallas_sweep_spec.py:46,
// wrapper sweep_spec_chain :246), K4. Per channel: the SSB chain of
// sweep_chain.cu without the blanker (input gain / IQ balance, DDS NCO mix,
// overlap-save band-pass + SSB demod frames(rows,512) @ w_ssb(512,128), AGC),
// PBT frames(rows,256) @ w_pbt(256,256) -> [l|r] with no output gain yet,
// then per 128-sample row:
//   [prev_l | l | prev_r | r] @ W_fwd(512,512) -> [sr | si] over 256 bins,
//   mag = sqrt(sr^2 + si^2),
//   floor_est = (sum of mag over bins 30..180) * nr_gain, nr_gain = level*1.5/150,
//   nf[j] = 0.35*nf[j-1] + 0.65*floor_est[j], across rows, chunks, segments,
//   scale = 0.2 where mag <= max(nf, 0), else 1 - nf/max(mag, 1e-20),
//   [sr*scale | si*scale] @ W_inv(512,256) -> the right halves [yl | yr],
// times the output gain. Carries: the raw input's last block (re-scaled and
// re-mixed at positions -128..-1), the PBT tail (AGC'd audio), the AGC
// envelope, the floor (unclamped: the clamp shows only in nf) and the last
// post-PBT block of l and r (before the output gain).
//
// What bounds it on an H100: per IQ sample it reads 8 B and writes 8 B, and
// does 8,192 flops: 2,048 for the chain's two products, 4,096 for W_fwd and
// 2,048 for W_inv. One 64-channel x 2^19-sample segment is 275 GFLOP, 4.1 ms
// at the 67 TFLOP/s fp32 rate outside the tensor cores, against 0.16 ms for
// its 0.54 GB: bound by arithmetic. The bound counts the direct operators; a
// split radix-2 DFT would halve W_fwd's and W_inv's work (later speed work).
//
// What the design does about it: as in sweep_chain.cu, every intermediate
// stays on chip and the products are register-blocked fp32 FMA from
// chain_common.cuh (one 256-thread block per channel; 64 channels keep 64 of
// 132 SMs busy, and splitting a channel's time axis across blocks is later
// speed work). Shared memory is the constraint: a 64-row chunk's spectrum is
// 128 KB and K1's buffers already hold about 140 KB. So the spectrum takes
// the place of buffers that are dead by then. The mixed rows are dead after
// the band-pass (their last row is saved as the next chunk's carry), so PBT
// writes l and r into them; W_fwd runs as two passes of 256 columns (its
// columns permuted by the wrapper so that a pass holds sr and si of 128 bins
// and one thread holds sr and si of the same bin, as K1-am pairs zr and zi):
// pass A's spectrum goes to a 64 x 257 buffer, pass B's stays in registers
// until l and r are dead (their last rows saved as the carries) and then
// overwrites them. The floor's order: each warp sums its rows' VAD bins
// (shuffles), one thread runs the 64-row one-pole scan from the carry, and
// only then is any bin scaled. W_inv reads the two spectrum halves in its
// natural row order (chain_common.cuh, ALayout::kSpectrum).

#include "chain_common.cuh"

namespace {

constexpr int kSpecFloats = kRows * kLdSpec;  // one spectrum half: 64 rows x (128 sr | 128 si)
// As, Bs, the mixed rows (then l, r, then pass B's spectrum), the audio rows,
// pass A's spectrum, scan segment ends, floor sums and floors per row, the
// mixed carry, the l/r carry, [AGC envelope, floor]
constexpr int kSmemFloats = kAsFloats + kBsFloats + 3 * kRowBuf + kSpecFloats + kThreads +
                            2 * kRows + 2 * kBlk + 2 * kBlk + 2;
constexpr int kVadStart = 30, kVadEnd = 180;  // the VAD band, bins inclusive
constexpr float kFloorBeta = 0.65f;
constexpr float kFloorA = (float)(1.0 - 0.65);
constexpr float kUnderFloorGain = 0.2f;

static_assert(kSpecFloats <= 2 * kRowBuf, "pass B's spectrum fits the two mixed-row buffers");
static_assert(kSmemFloats * 4 <= 232448, "shared memory of one H100 block");

__device__ __forceinline__ float magnitude(float sr, float si) {
  return sqrtf(__fadd_rn(__fmul_rn(sr, sr), __fmul_rn(si, si)));
}

__device__ __forceinline__ float subtract_scale(float mag, float nf) {
  return mag <= nf ? kUnderFloorGain : 1.f - nf / fmaxf(mag, 1e-20f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1) sweep_spec_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const long long* __restrict__ inc, const long long* __restrict__ phase0,
    const float* __restrict__ w_ssb, const float* __restrict__ w_pbt,
    const float* __restrict__ w_fwd, const float* __restrict__ w_inv,
    const float* __restrict__ tail_r, const float* __restrict__ tail_i,
    const float* __restrict__ atail_in, const float* __restrict__ env0,
    const float* __restrict__ nfl0, const float* __restrict__ stl0,
    const float* __restrict__ str0, float* __restrict__ out_l,
    float* __restrict__ out_r, float* __restrict__ atail_out,
    float* __restrict__ env_out, float* __restrict__ nfl_out,
    float* __restrict__ stl_out, float* __restrict__ str_out, int n,
    double release, float target, float max_gain, int agc_enabled,
    float out_gain, float g_i, float g_q, float nr_gain) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* X = Bs + kBsFloats;   // mixed I rows, then l; with Y, pass B's spectrum
  float* Y = X + kRowBuf;      // mixed Q rows, then r
  float* Ab = Y + kRowBuf;     // demodulated audio rows, AGC applied in place
  float* Sa = Ab + kRowBuf;    // pass A's spectrum: [sr | si] of bins 0..127
  float* seg = Sa + kSpecFloats;  // scan segment ends, then carries into segments
  float* fsum = seg + kThreads;   // per row: the VAD band's magnitude sum
  float* nfr = fsum + kRows;      // per row: the floor, clamped at 0
  float* mt = nfr + kRows;        // the mixed carry row [re | im]
  float* st = mt + 2 * kBlk;      // the l/r carry rows [l | r]
  float* carry = st + 2 * kBlk;   // [0] AGC envelope, [1] noise floor
  float* Sb = X;                  // pass B's spectrum: [sr | si] of bins 128..255

  const int c = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)c * n;
  const uint32_t ph0 = (uint32_t)phase0[c];
  const uint32_t dph = (uint32_t)inc[c];
  const float rel = (float)release;
  float rel_lanes[5];
  const float rel_seg = seg_factors(release, rel_lanes);

  if (tid < kBlk) {
    const size_t t = (size_t)c * kBlk + tid;
    mix(tail_r[t], tail_i[t], ph0 + (uint32_t)(tid - kBlk) * dph, g_i, g_q, mt[tid],
        mt[kBlk + tid]);
    Ab[tid] = atail_in[t];
    st[tid] = stl0[t];
    st[kBlk + tid] = str0[t];
  }
  if (tid == 0) {
    carry[0] = env0[c];
    carry[1] = nfl0[c];
  }

  const int nrows = n / kBlk;
  for (int row0 = 0; row0 < nrows; row0 += kRows) {
    const int rows = min(kRows, nrows - row0);

    // 1. scale + mix into rows 1..kRows (zeros past the end), the carry in row 0
    if (tid < kBlk) {
      X[tid] = mt[tid];
      Y[tid] = mt[kBlk + tid];
    }
#pragma unroll 4
    for (int e = tid; e < kRows * kBlk; e += kThreads) {
      const int r = e / kBlk, j = e % kBlk;
      float vr = 0.f, vi = 0.f;
      if (r < rows) {
        const int pos = (row0 + r) * kBlk + j;
        mix(xr[base + pos], xi[base + pos], ph0 + (uint32_t)pos * dph, g_i, g_q, vr, vi);
      }
      X[(r + 1) * kLd + j] = vr;
      Y[(r + 1) * kLd + j] = vi;
    }
    __syncthreads();

    // 2. band-pass + SSB demod -> Ab rows 1..kRows; the last mixed row is
    // the next chunk's carry
    {
      float acc[8][4];
      chunk_gemm<128>(X, Y, w_ssb, 512, As, Bs, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ab[(warp * 8 + i + 1) * kLd + lane * 4 + j] = acc[i][j];
    }
    if (tid < kBlk) {
      mt[tid] = X[rows * kLd + tid];
      mt[kBlk + tid] = Y[rows * kLd + tid];
    }
    __syncthreads();

    // 3. AGC, as sweep_chain.cu step 3
    {
      const int r = tid % kRows, quarter = tid / kRows;
      const int s = r * kSegsPerRow + quarter;
      float* a = Ab + (r + 1) * kLd + quarter * kSegLen;
      float e = 0.f;
      for (int k = 0; k < kSegLen; ++k) e = fmaxf(fabsf(a[k]), e * rel);
      seg[s] = e;
      __syncthreads();
      if (warp == 0) scan_segment_carries<false>(seg, carry[0], rel_seg, rel_lanes);
      __syncthreads();
      e = seg[s];
      for (int k = 0; k < kSegLen; ++k) {
        const float v = a[k];
        e = fmaxf(fabsf(v), e * rel);
        if (agc_enabled) a[k] = v * fminf(target / fmaxf(e, 1e-12f), max_gain);
      }
      if (s == rows * kSegsPerRow - 1) carry[0] = e;
    }
    __syncthreads();

    // 4. PBT -> l into X, r into Y (rows 1..kRows), their carries in row 0;
    // the last audio row becomes the next chunk's PBT carry
    {
      float acc[8][8];
      chunk_gemm<256>(Ab, Ab, w_pbt, 256, As, Bs, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          X[(warp * 8 + i + 1) * kLd + lane * 4 + j] = acc[i][j];
          Y[(warp * 8 + i + 1) * kLd + lane * 4 + j] = acc[i][4 + j];
        }
    }
    if (tid < kBlk) {
      X[tid] = st[tid];
      Y[tid] = st[kBlk + tid];
      Ab[tid] = Ab[rows * kLd + tid];
    }
    __syncthreads();

    // 5. W_fwd pass A: bins 0..127 -> Sa, and each row's VAD sum over them
    {
      float acc[8][8];
      chunk_gemm<256>(X, Y, w_fwd, 512, As, Bs, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bin = lane * 4 + j;
          float* p = Sa + (warp * 8 + i) * kLdSpec + bin;
          p[0] = acc[i][j];
          p[kBlk] = acc[i][4 + j];
          if (bin >= kVadStart) part += magnitude(acc[i][j], acc[i][4 + j]);
        }
        part = warp_sum(part);
        if (lane == 0) fsum[warp * 8 + i] = part;
      }
    }

    // 6. W_fwd pass B: bins 128..255 stay in registers until l and r are
    // dead; their last rows are the next chunk's l/r carries
    float acc_b[8][8];
    chunk_gemm<256>(X, Y, w_fwd + 512 * 256, 512, As, Bs, acc_b);
    if (tid < kBlk) {
      st[tid] = X[rows * kLd + tid];
      st[kBlk + tid] = Y[rows * kLd + tid];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kBlk + lane * 4 + j <= kVadEnd) part += magnitude(acc_b[i][j], acc_b[i][4 + j]);
      part = warp_sum(part);
      if (lane == 0) fsum[warp * 8 + i] += part;
    }
    __syncthreads();

    // 7. the floor across the chunk's rows, from the carry, before any scale
    if (tid == 0) {
      float nf = carry[1];
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) nf = kFloorBeta * (fsum[r] * nr_gain) + kFloorA * nf;
        nfr[r] = r < rows ? fmaxf(nf, 0.f) : 0.f;
      }
      carry[1] = nf;
    }
    __syncthreads();

    // 8. scale every bin: pass B from registers into Sb (over the dead l and
    // r), pass A in place in Sa
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i;
      const float nf = nfr[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bin = lane * 4 + j;
        float g = subtract_scale(magnitude(acc_b[i][j], acc_b[i][4 + j]), nf);
        Sb[r * kLdSpec + bin] = acc_b[i][j] * g;
        Sb[r * kLdSpec + kBlk + bin] = acc_b[i][4 + j] * g;
        float* p = Sa + r * kLdSpec + bin;
        const float sr = p[0], si = p[kBlk];
        g = subtract_scale(magnitude(sr, si), nf);
        p[0] = sr * g;
        p[kBlk] = si * g;
      }
    }
    __syncthreads();

    // 9. W_inv -> [yl | yr] right halves, output gain, straight to device memory
    {
      float acc[8][8];
      chunk_gemm<256, ALayout::kSpectrum>(Sa, Sb, w_inv, 512, As, Bs, acc);
      store_rows<256>(acc, out_l, out_r, base, row0, rows, out_gain);
    }
  }
  if (tid < kBlk) {
    const size_t t = (size_t)c * kBlk + tid;
    atail_out[t] = Ab[tid];
    stl_out[t] = st[tid];
    str_out[t] = st[kBlk + tid];
  }
  if (tid == 0) {
    env_out[c] = carry[0];
    nfl_out[c] = carry[1];
  }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous tensors.
// w_fwd is (2, 512, 256): W_fwd's columns [sr bins 0..127 | si bins 0..127]
// then [sr bins 128..255 | si bins 128..255]; w_inv is W_inv (512, 256) as
// spectral_sub.spectral_matmul_ops gives it. nr_gain = level * 1.5 / 150.
extern "C" int sweep_spec_chain(
    const float* xr, const float* xi, const long long* inc,
    const long long* phase0, const float* w_ssb, const float* w_pbt,
    const float* w_fwd, const float* w_inv, const float* tail_r,
    const float* tail_i, const float* atail_in, const float* env0,
    const float* nfl0, const float* stl0, const float* str0, float* out_l,
    float* out_r, float* atail_out, float* env_out, float* nfl_out,
    float* stl_out, float* str_out, int channels, int n, int device,
    double release, float target, float max_gain, int agc_enabled,
    float out_gain, float g_i, float g_q, float nr_gain, void* stream) {
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_spec_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sweep_spec_kernel<<<channels, kThreads, smem, (cudaStream_t)stream>>>(
      xr, xi, inc, phase0, w_ssb, w_pbt, w_fwd, w_inv, tail_r, tail_i, atail_in,
      env0, nfl0, stl0, str0, out_l, out_r, atail_out, env_out, nfl_out, stl_out,
      str_out, n, release, target, max_gain, agc_enabled, out_gain, g_i, g_q,
      nr_gain);
  return (int)cudaGetLastError();
}
