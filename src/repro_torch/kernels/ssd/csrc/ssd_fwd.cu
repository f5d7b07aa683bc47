// Mamba-2 chunked SSD forward scan for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/ssd/kernel.py::ssd_pallas (body _ssd_kernel).
//
//   s_t = a_t s_{t-1} + x_t B_t^T,   y_t = s_t C_t        (per batch b, head h)
//
// Within a chunk of L steps the recurrence is three small matrix products
// (la = cumsum log a, relative to the chunk start):
//
//   y  = (C B^T ⊙ M) x + exp(la) ⊙ (C s^T),     M[t, r] = exp(la_t - la_r), r <= t
//   s' = exp(la_end) s + Σ_t exp(la_end - la_t) x_t B_t^T
//
// Design.  One CTA per (b, h) walks the chunks in order, so the carried
// (P, N) fp32 state never leaves shared memory (the TPU kernel's sequential
// grid axis becomes this loop).  The kernel runs at its own chunk length
// L = 64: the caller's chunk (256 for mamba2-1.3b) would need a 256 KB fp32
// score tile, more than the 227 KB a CTA may use; the result differs from the
// caller's chunking only by fp32 rounding.  Inputs are read in their own dtype
// (fp32 or bf16) and all arithmetic is fp32 on CUDA cores.
//
// Role.  ssd_fwd_wgmma.cu serves bf16 at mamba2-1.3b's (P, N) = (64, 128);
// this kernel takes fp32 and bf16 at the other (P, N), off the serving path
// (kernels/ssd/kernel.py routes by dtype and shape).  chip_smoke.py times it
// at mamba2's wave-1 shape in fp32 ("serve wave 1 fp32"): there the products
// at the caller's chunk of 256, ~5.4 GFLOP at the 67 TFLOP/s fp32 peak, bound
// it, and its fp32 FMAs from shared memory and serial walk over the chunks
// keep it well above that.
//
// Shared-memory rows of B, C and the state are padded to N + 1 floats so that
// the 16 rows a half-warp reads at one column fall in distinct banks.
// Decay weights are masked by selection, never by multiplying with 0:
// exp(la_t - la_r) for r > t overflows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;          // internal chunk length
constexpr int THREADS = 256;   // 16 x 16 thread tile over (t, r) and (t, p)
constexpr int MAX_P = 64;      // P must be a multiple of 16, at most 64
constexpr int MAX_N = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_fwd_kernel(
    const T* __restrict__ x,        // (Bsz, S, H, P)
    const float* __restrict__ a,    // (Bsz, S, H)
    const T* __restrict__ bmat,     // (Bsz, S, N)
    const T* __restrict__ cmat,     // (Bsz, S, N)
    const float* __restrict__ s0,   // (Bsz, H, P, N) or null for zeros
    T* __restrict__ y,              // (Bsz, S, H, P)
    float* __restrict__ sfin,       // (Bsz, H, P, N)
    int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* xs = smem;                 // (L, P)
  float* bs = xs + L * P;           // (L, NP)
  float* cs = bs + L * NP;          // (L, NP)
  float* ss = cs + L * NP;          // (L, L + 1) masked scores
  float* st = ss + L * (L + 1);     // (P, NP) carried state
  float* la = st + P * NP;          // (L,) cumulative log decay
  float* ela = la + L;              // (L,) exp(la)
  float* wt = ela + L;              // (L,) exp(la_end - la)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t state_off = (size_t)bh * P * N;

  for (int i = tid; i < P * N; i += THREADS)
    st[(i / N) * NP + i % N] = s0 ? s0[state_off + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int len = min(L, S - c0);
    __syncthreads();  // the previous chunk is done with every tile

    // Load the chunk; steps past the end are zero input with decay 1.
    for (int i = tid; i < L * P; i += THREADS) {
      const int t = i / P, p = i % P;
      xs[i] = t < len ? to_f32(x[(((size_t)b * S + c0 + t) * H + h) * P + p]) : 0.f;
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int t = i / N, n = i % N;
      const size_t g = ((size_t)b * S + c0 + t) * N + n;
      bs[t * NP + n] = t < len ? to_f32(bmat[g]) : 0.f;
      cs[t * NP + n] = t < len ? to_f32(cmat[g]) : 0.f;
    }
    if (warp == 0) {  // inclusive scan of log a, 32 steps at a time
      float carry = 0.f;
      for (int s = 0; s < L; s += 32) {
        const int t = s + lane;
        float v = t < len ? logf(a[((size_t)b * S + c0 + t) * H + h]) : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        la[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float total = la[L - 1];
    if (tid < L) {
      ela[tid] = expf(la[tid]);
      wt[tid] = expf(total - la[tid]);
    }

    // (1) masked scores: ss[t][r] = (C_t . B_r) exp(la_t - la_r) for r <= t.
    {
      const int ti = tid >> 4, ri = tid & 15;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ti + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(ri + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ti + 16 * i, r = ri + 16 * j;
          ss[t * (L + 1) + r] = r <= t ? acc[i][j] * expf(la[t] - la[r]) : 0.f;
        }
    }
    __syncthreads();

    // (2) y[t][p] = Σ_r ss[t][r] x[r][p] + exp(la_t) Σ_n C[t][n] st[p][n].
    {
      const int ti = tid >> 4, pi = tid & 15, pj = P >> 4;
      float intra[4][4] = {}, inter[4][4] = {};
      for (int r = 0; r < L; ++r) {
        float sv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = ss[(ti + 16 * i) * (L + 1) + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = j < pj ? xs[r * P + pi + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) intra[i][j] = fmaf(sv[i], xv[j], intra[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ti + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = j < pj ? st[(pi + 16 * j) * NP + n] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(cv[i], sv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ti + 16 * i;
        if (t >= len) continue;
        T* yrow = y + (((size_t)b * S + c0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < pj) put(yrow + pi + 16 * j, intra[i][j] + ela[t] * inter[i][j]);
      }
    }
    __syncthreads();

    // (3) st[p][n] = exp(la_end) st[p][n] + Σ_t wt[t] x[t][p] B[t][n].
    {
      const int pi = warp, pk = P >> 3;
      float acc[8][4] = {};
      for (int t = 0; t < L; ++t) {
        const float w = wt[t];
        float xv[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = i < pk ? xs[t * P + pi + 8 * i] * w : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = lane + 32 * j < N ? bs[t * NP + lane + 32 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float decay = expf(total);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = pi + 8 * i, n = lane + 32 * j;
          if (i < pk && n < N) st[p * NP + n] = fmaf(decay, st[p * NP + n], acc[i][j]);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS)
    sfin[state_off + i] = st[(i / N) * NP + i % N];
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) * ((size_t)L * P + 2 * (size_t)L * (N + 1) + (size_t)L * (L + 1)
                          + (size_t)P * (N + 1) + 3 * L);
}

template <typename T>
int launch(const void* x, const void* a, const void* bmat, const void* cmat, const void* s0,
           void* y, void* sfin, int batch, int S, int H, int P, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_kernel<T><<<batch * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(bmat),
      static_cast<const T*>(cmat), static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(sfin), S, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or a cudaError_t code.  The caller checks shapes, dtypes and
// contiguity; this refuses only what the kernel's tiling cannot take.
extern "C" int ssd_fwd_launch(const void* x, const void* a, const void* bmat, const void* cmat,
                              const void* s0, void* y, void* sfin, int batch, int S, int H,
                              int P, int N, int is_bf16, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 16 || P > MAX_P || N <= 0 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, a, bmat, cmat, s0, y, sfin, batch, S, H, P, N, s)
                 : launch<float>(x, a, bmat, cmat, s0, y, sfin, batch, S, H, P, N, s);
}
