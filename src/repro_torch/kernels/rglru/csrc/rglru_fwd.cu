// RG-LRU forward scan for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/rglru/kernel.py::rglru_pallas (body _rglru_kernel).
//
//   a_t = exp(-8 softplus(lam) sigmoid(r_t))
//   u_t = sqrt(max(1 - a_t^2, 1e-12)) sigmoid(i_t) x_t
//   h_t = a_t h_{t-1} + u_t,   y_t = h_t            (per batch b, channel w)
//
// Design.  Channels are independent and time is a recurrence, so one thread
// owns one (b, w) pair and walks the sequence with h in a register: the TPU
// grid's sequential chunk axis becomes that loop.  Neighbouring threads hold
// neighbouring w, so every load and store of a time step is coalesced.  The
// loop reads U steps of x, r and i into registers before it does the
// arithmetic of any of them: the loads do not depend on h, so U of them are
// in flight per thread.  Ragged S is the loop's remainder.  Inputs are read in
// their own dtype (fp32 or bf16); all arithmetic is fp32.
//
// Bound.  At the serving shape (B=4, S=3072, W=4096, bf16) x, r, i read and y
// written are ~403 MB: ~0.12 ms at 3.35 TB/s; the gates are a few tens of
// operations per element, far below the card's rate.  So the floor is memory.
// One thread per channel gives only B*W = 16,384 threads, about one 4-warp
// block per SM, so this version cannot keep enough loads in flight to reach
// that floor; a chunk-parallel scan (per-chunk (prod a, h) pairs, then a short
// pass over chunks) is the fix, left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 16;             // time steps loaded ahead per thread
constexpr float RGLRU_C = 8.f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_fwd_kernel(
    const T* __restrict__ x,        // (Bsz, S, W)
    const T* __restrict__ r,        // (Bsz, S, W)
    const T* __restrict__ gi,       // (Bsz, S, W)
    const float* __restrict__ lam,  // (W,)
    const float* __restrict__ h0,   // (Bsz, W) or null for zeros
    T* __restrict__ y,              // (Bsz, S, W)
    float* __restrict__ hfin,       // (Bsz, W)
    int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const float l = lam[w];
  // -c * softplus(lam), softplus(v) = max(v, 0) + log1p(exp(-|v|)) as jax's
  const float neg_c_sp = -RGLRU_C * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
  float h = h0 ? h0[(size_t)b * W + w] : 0.f;
  size_t off = (size_t)b * S * W + w;

  int t = 0;
  for (; t + U <= S; t += U, off += (size_t)U * W) {
    float xr[U], rr[U], ir[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const size_t o = off + (size_t)k * W;
      xr[k] = to_f32(x[o]);
      rr[k] = to_f32(r[o]);
      ir[k] = to_f32(gi[o]);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const float a = expf(neg_c_sp * sigmoid(rr[k]));
      const float u = sqrtf(fmaxf(1.f - a * a, 1e-12f)) * sigmoid(ir[k]) * xr[k];
      h = a * h + u;
      put(y + off + (size_t)k * W, h);
    }
  }
  for (; t < S; ++t, off += W) {
    const float a = expf(neg_c_sp * sigmoid(to_f32(r[off])));
    const float u = sqrtf(fmaxf(1.f - a * a, 1e-12f)) * sigmoid(to_f32(gi[off])) * to_f32(x[off]);
    h = a * h + u;
    put(y + off, h);
  }
  hfin[(size_t)b * W + w] = h;
}

template <typename T>
int launch(const void* x, const void* r, const void* gi, const void* lam, const void* h0,
           void* y, void* hfin, int batch, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, batch);
  rglru_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(gi),
      static_cast<const float*>(lam), static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hfin), S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or a cudaError_t code.  The caller checks shapes, dtypes and
// contiguity.
extern "C" int rglru_fwd_launch(const void* x, const void* r, const void* gi, const void* lam,
                                const void* h0, void* y, void* hfin, int batch, int S, int W,
                                int is_bf16, void* stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, r, gi, lam, h0, y, hfin, batch, S, W, s)
                 : launch<float>(x, r, gi, lam, h0, y, hfin, batch, S, W, s);
}
