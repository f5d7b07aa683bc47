// Flash attention forward for Hopper (sm_90a) on CUDA cores, plain C
// interface: fp32 at head_dim 16 .. 256 and bf16 at head_dim 16 and 32.
// bf16 at head_dim 64, 128 and 256, the serving path, runs on the tensor
// cores in flash_fwd_wgmma.cu; kernel.py picks the route by dtype and
// head_dim.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _fa_kernel, launcher _call) for those dtypes and head_dims.
//
//   out[b, t, h] = sum_s softmax_s(mask(softcap(scale q_t . k_s))) v_s
//
// over the keys s of kv head h / (Hq / Hkv) (GQA; MQA when Hkv = 1).  The
// mask is: s < Sk; causal: t + q_offset >= s; window: t + q_offset - s <
// window; segments: qseg[t] == kseg[s].  Softcap (cap * tanh(x / cap)) comes
// before the mask, as in the reference.
//
// Design.  One CTA per (q tile of 64 rows, q head, batch) loops over the KV
// tiles that can hold a valid pair for one of its rows: tiles wholly above
// the causal diagonal or wholly older than the window are never loaded (the
// TPU kernel's pl.when block skip).  The online softmax (running max m, sum
// l, fp32 accumulator) lives in registers, as the TPU kernel's VMEM scratch
// did across its sequential KV grid axis.  256 threads form a 16 x 16 grid:
// thread (ty, tx) owns query rows 4 ty .. 4 ty + 3, score columns tx + 16 j
// and output columns (tx + 16 j) * VEC (+1); a row's max and sum are
// reduced over its 16 threads, which are one half-warp, with shuffles.  q is
// scaled in fp32 before the dot, as in the reference, and held as fp32 in
// shared memory; K and V tiles stay in the input dtype (fp32 or bf16), and
// all arithmetic is fp32 FMAs on CUDA cores.  head_dim is a template
// parameter (16 .. 256); at 256 the KV tile is 32 keys so that two CTAs fit
// an SM (106 KB of shared memory each, set with cudaFuncSetAttribute).
// Ragged Sq and Sk are masked in the kernel: rows past Sq are not written,
// keys past Sk are loaded as zeros and masked.  Masking is a selection with
// NEG_INF = -1e30, never -inf and never a product with 0; a fully masked row
// keeps m finite through the m_safe guard and returns 0 (l == 0 -> 1).
//
// Bound.  At the serving shape (q 4 x 3072 x 16 x 256, k/v 4 x 3072 x 1 x
// 256, window 2048, causal, bf16) the valid pairs need ~275 GFLOP (QK^T and
// PV, 2 operations per multiply-add): ~0.28 ms on the bf16 tensor cores,
// against ~0.06 ms for the bytes.  So the floor is operations.  This version
// does its products on CUDA cores in fp32 (67 TFLOP/s peak), which puts its
// own floor at ~4 ms; flash_fwd_wgmma.cu takes the bf16 serving shape to the
// tensor cores.
// Shared-memory rows are padded so that the 16 rows a half-warp reads at one
// column fall in distinct banks.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // 16 x 16 thread grid
constexpr int BQ = 64;           // query rows per CTA, 4 per thread row
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
struct Cfg {
  static constexpr int BK = D >= 256 ? 32 : 64;     // keys per tile
  static constexpr int NC = BK / 16;                 // score columns per thread
  static constexpr int VEC = D >= 32 ? 2 : 1;        // output columns per load
  static constexpr int NV = D / (16 * VEC);          // output loads per row
  static constexpr int QS = D + 4;                   // Q row stride (floats)
  static constexpr int PS = BK + 4;                  // P row stride (floats)
  static constexpr int KS = D + (sizeof(T) == 2 ? 2 : 1);   // K row stride (T)
  static constexpr size_t smem = sizeof(float) * (BQ * QS + BQ * PS)
                                 + sizeof(T) * ((size_t)BK * D + (size_t)BK * KS)
                                 + sizeof(int) * BK;
};

// Four consecutive elements of T, read from device memory as one load.
template <typename T> struct Raw4;
template <> struct Raw4<float> { using type = float4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 to_f32x4(float4 v) { return v; }
__device__ __forceinline__ float4 to_f32x4(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// K rows have an odd number of words, so a K row start is only 4-byte aligned.
__device__ __forceinline__ void store_k(float* dst, float4 v) {
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void store_k(__nv_bfloat16* dst, uint2 v) {
  reinterpret_cast<uint32_t*>(dst)[0] = v.x;
  reinterpret_cast<uint32_t*>(dst)[1] = v.y;
}
__device__ __forceinline__ void store_v(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store_v(__nv_bfloat16* dst, uint2 v) {
  *reinterpret_cast<uint2*>(dst) = v;
}

__device__ __forceinline__ float4 load_k4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ float4 load_k4(const __nv_bfloat16* p) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float2 load_v2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_v2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float load_v1(const float* p) { return *p; }
__device__ __forceinline__ float load_v1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Max and sum over the 16 threads of a half-warp (one row group).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q,         // (Bsz, Sq, Hq, D)
    const T* __restrict__ k,         // (Bsz, Sk, Hkv, D)
    const T* __restrict__ v,         // (Bsz, Sk, Hkv, D)
    const int* __restrict__ qseg,    // (Bsz, Sq) or null
    const int* __restrict__ kseg,    // (Bsz, Sk) or null
    T* __restrict__ out,             // (Bsz, Sq, Hq, D)
    int Sq, int Sk, int Hq, int Hkv, int causal, int window, int q_offset,
    float scale, float softcap) {
  using C = Cfg<T, D>;
  constexpr int BK = C::BK, NC = C::NC, VEC = C::VEC, NV = C::NV;
  constexpr int QS = C::QS, PS = C::PS, KS = C::KS;
  using R4 = typename Raw4<T>::type;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);      // (BQ, QS) scaled fp32 q
  float* Ps = Qs + BQ * QS;                            // (BQ, PS) probabilities
  T* Vs = reinterpret_cast<T*>(Ps + BQ * PS);          // (BK, D)
  T* Ks = Vs + BK * D;                                 // (BK, KS)
  int* ksg = reinterpret_cast<int*>(Ks + BK * KS);     // (BK,) key segments

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_rows = min(BQ, Sq - q0);

  for (int e = tid; e < BQ * (D / 4); e += THREADS) {
    const int r = e / (D / 4), d = (e % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < q_rows) {
      val = to_f32x4(*reinterpret_cast<const R4*>(
          q + (((size_t)b * Sq + q0 + r) * Hq + h) * D + d));
      val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * QS + d) = val;
  }

  long long qa[4];             // absolute position of each of this thread's rows
  int qsg[4];
  float m[4], l[4], acc[4][NV][VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    qa[i] = (long long)q_offset + q0 + row;
    qsg[i] = (qseg && row < q_rows) ? qseg[(size_t)b * Sq + q0 + row] : 0;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[i][jj][c] = 0.f;
  }

  // The keys that can hold a valid pair for some row of this tile.
  const long long qa_lo = (long long)q_offset + q0, qa_hi = qa_lo + q_rows - 1;
  long long k_lo = 0, k_hi = Sk;
  if (window != INT_MAX) k_lo = max(0LL, qa_lo - window + 1);
  if (causal) k_hi = min((long long)Sk, qa_hi + 1);
  k_lo = k_lo / BK * BK;

  for (long long kt = k_lo; kt < k_hi; kt += BK) {
    const int k0 = (int)kt;
    const int k_rows = min(BK, Sk - k0);
    __syncthreads();   // the previous tile is done with K, V and P
    for (int e = tid; e < BK * (D / 4); e += THREADS) {
      const int c = e / (D / 4), d = (e % (D / 4)) * 4;
      R4 kr{}, vr{};
      if (c < k_rows) {
        const size_t g = (((size_t)b * Sk + k0 + c) * Hkv + hk) * D + d;
        kr = *reinterpret_cast<const R4*>(k + g);
        vr = *reinterpret_cast<const R4*>(v + g);
      }
      store_k(Ks + c * KS + d, kr);
      store_v(Vs + c * D + d, vr);
    }
    if (tid < BK) ksg[tid] = (kseg && tid < k_rows) ? kseg[(size_t)b * Sk + k0 + tid] : 0;
    __syncthreads();

    // Scores for rows 4 ty + i, columns tx + 16 j.
    float s[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * QS + d);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 kv = load_k4(Ks + (tx + 16 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // Softcap, mask, online softmax; probabilities to shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      bool ok[NC];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tx + 16 * j;
        const long long col = (long long)k0 + c;
        bool valid = row < q_rows && c < k_rows && qa[i] - col < window;
        if (causal) valid = valid && qa[i] >= col;
        if (qseg) valid = valid && qsg[i] == ksg[c];
        float sv = s[i][j];
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        s[i][j] = valid ? sv : NEG_INF;
        ok[j] = valid;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        Ps[row * PS + tx + 16 * j] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      const float alpha = m[i] <= NEG_INF * 0.5f ? 0.f : expf(m[i] - m_safe);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NV; ++jj)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[i][jj][c] *= alpha;
    }
    __syncthreads();

    // acc += P V for output columns (tx + 16 jj) * VEC (+1).
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* vrow = Vs + (kk + e) * D;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          if constexpr (VEC == 2) {
            const float2 vv = load_v2(vrow + (tx + 16 * jj) * 2);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = lane(pv[i], e);
              acc[i][jj][0] = fmaf(p, vv.x, acc[i][jj][0]);
              acc[i][jj][1] = fmaf(p, vv.y, acc[i][jj][1]);
            }
          } else {
            const float vv = load_v1(vrow + tx + 16 * jj);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][jj][0] = fmaf(lane(pv[i], e), vv, acc[i][jj][0]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row >= q_rows) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (((size_t)b * Sq + q0 + row) * Hq + h) * D;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int c = 0; c < VEC; ++c) put(orow + (tx + 16 * jj) * VEC + c, acc[i][jj][c] / l_safe);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const int* qseg, const int* kseg,
             void* out, int batch, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
             int q_offset, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = Cfg<T, D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, batch);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qseg, kseg,
      static_cast<T*>(out), Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* qseg, const int* kseg,
           void* out, int batch, int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
           int q_offset, float scale, float softcap, cudaStream_t s) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, qseg, kseg, out, batch, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, softcap, s);
    case 32: return launch_d<T, 32>(q, k, v, qseg, kseg, out, batch, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, softcap, s);
    default: break;
  }
  // bf16 at head_dim 64, 128 and 256 runs on the tensor cores
  // (flash_fwd_wgmma.cu); this kernel has no instance for it.
  if constexpr (sizeof(T) == 4) {
    switch (D) {
      case 64: return launch_d<T, 64>(q, k, v, qseg, kseg, out, batch, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, softcap, s);
      case 128: return launch_d<T, 128>(q, k, v, qseg, kseg, out, batch, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, softcap, s);
      case 256: return launch_d<T, 256>(q, k, v, qseg, kseg, out, batch, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, softcap, s);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns 0 or a cudaError_t code.  The caller checks shapes, dtypes,
// contiguity and 16-byte alignment; window == INT_MAX means no window and
// softcap <= 0 means no softcap.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const void* qseg,
                                const void* kseg, void* out, int batch, int Sq, int Sk, int Hq,
                                int Hkv, int D, int causal, int window, int q_offset, int is_bf16,
                                float scale, float softcap, void* stream) {
  if (batch <= 0 || batch > 65535 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hq > 65535 || Hkv <= 0 ||
      Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kseg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, qs, ks, out, batch, Sq, Sk, Hq, Hkv, D, causal,
                                         window, q_offset, scale, softcap, s)
                 : launch<float>(q, k, v, qs, ks, out, batch, Sq, Sk, Hq, Hkv, D, causal, window,
                                 q_offset, scale, softcap, s);
}
