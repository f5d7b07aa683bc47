// Flash attention forward for Hopper tensor cores (sm_90a), bf16, head_dim
// 64, 128 or 256; plain C interface.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _fa_kernel, launcher _call) on the bf16 serving path.  The same
// function as flash_fwd.cu, which keeps fp32 and the small head_dims:
//
//   out[b, t, h] = sum_s softmax_s(mask(softcap(scale q_t . k_s))) v_s
//
// over the keys s of kv head h / (Hq / Hkv) (GQA; MQA when Hkv = 1).  The
// mask is: s < Sk; causal: t + q_offset >= s; window: t + q_offset - s <
// window; segments: qseg[t] == kseg[s].  Softcap (cap * tanh(x / cap)) comes
// before the mask, as in the reference; masking is a selection with NEG_INF =
// -1e30, and a fully masked row keeps m finite through the m_safe guard and
// returns 0 (l == 0 -> 1).
//
// Bound.  At the serving shape (q 4 x 3072 x 16 x 256, k/v 4 x 3072 x 1 x
// 256, window 2048, causal, bf16) the valid pairs need ~275 GFLOP (QK^T and
// PV): ~0.28 ms on the bf16 tensor cores against ~0.06 ms for the bytes, so
// the floor is operations, and only wgmma reaches the tensor cores' full rate.
//
// Design (the FlashAttention-3 layout, without its intra-warpgroup overlap
// and ping-pong scheduling: both were tried and gained too little to keep).
// One CTA per (q head, batch, 128-row q tile), 384 threads in three
// warpgroups.
// Warpgroups 0 and 1 are consumers of 64 q rows each; warpgroup 2 is the
// producer: its first warp issues the copies and the other three exit.
// setmaxnreg moves registers from the producer (24) to the consumers (240):
// the D 256 consumer holds the 128-register O accumulator, the 32-register
// score tile and P without spilling (ptxas reports the launch count, 168).
// setmaxnreg acts on whole warpgroups, hence a full producer warpgroup.
//   - Shared memory, all in the 128-byte swizzle that TMA writes and the wgmma
//     descriptors read, in column blocks of 64 bf16 (one 128-byte row each):
//     the Q tile (128 x D, loaded once), and a two-stage ring of K and V
//     tiles of 64 keys (at D 256: 64 KB + 2 x 2 x 32 KB, ~193 KB).
//   - The producer loads K and V tiles by TMA (4-d tensor maps over
//     (D, H, S, B), built per launch on the host; rows past Sq or Sk arrive
//     as zeros), each on its own mbarrier, so S = QK^T starts while V is in
//     flight.  K and V slots are released separately.  Key segments, when
//     given, go through shared memory too.
//   - S = Q K^T: wgmma m64n64k16, Q and K both from shared memory, K-major.
//     The fp32 score is multiplied by `scale` after the product (q stays
//     bf16 as given: 1/sqrt(D) is not a power of two at D 128).
//   - Softcap, the mask, the online softmax in fp32 (exp2 with log2(e)
//     folded in); the row max is reduced over the four threads of a quad,
//     the row sum l stays per thread until the end.  l sums the fp32 P.
//     Softcap and segments are template switches and interior tiles take
//     their own code, so each softmax loop is straight-line: with run-time
//     tests inside it, ptxas branched around every element and the loop,
//     not the tensor cores, set the pace.  O is rescaled only when a row's
//     max moved (the factor is otherwise exactly 1).
//   - O += P V: wgmma m64n64k16 per 64 output columns with P from registers.
//     The m64n64 fp32 accumulator layout of S, packed pairwise to bf16x2, is
//     exactly the A-operand register fragment, so P never touches shared
//     memory; V is read through the descriptor's transpose flag (MN-major),
//     so it needs no transposed copy.  P is rounded to bf16 only here, as
//     every tensor-core flash attention does: the output's error bound is
//     then 2^-8 sum_s p_s |v_s| / l on top of the bf16 rounding of the output
//     (kernels/flash_attention/ref.py::bf16_flash_limit).
//   - Descriptors are rebuilt from opaque base addresses inside the KV loop;
//     hoisted out of it they held dozens of registers, and ptxas spilled and
//     serialized the wgmma at D 256.
//   - KV tiles wholly outside the causal/window range are never loaded;
//     tiles wholly inside it for a warpgroup's 64 rows take no per-element
//     causal, window or bounds test (only diagonal, window-edge and ragged
//     tiles do).  The segment test is per element.
//   - Q tiles are launched longest first (the q-tile index is the slowest
//     grid axis, reversed), so that short causal tiles fill the grid's tail.
// A wait on an mbarrier that never completes traps after seconds instead of
// hanging.

#include <climits>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int BQ = 128;          // query rows per CTA
constexpr int BK = 64;           // keys per KV tile
constexpr int STAGES = 2;        // K/V ring depth
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 384;     // two consumer warpgroups, then the producer warpgroup
constexpr float NEG_INF = -1e30f;

template <int D>
struct Layout {
  static constexpr int NCB = D / COLS;                 // column blocks
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;          // one K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int SEG_OFF = V_OFF + STAGES * KV_BYTES;     // int [STAGES][BK]
  static constexpr int BAR_OFF = SEG_OFF + STAGES * BK * 4;
  // q_full, then per stage: k_full, v_full, seg_full, k_empty, v_empty
  static constexpr int N_BARS = 1 + 5 * STAGES;
  static constexpr size_t BYTES = BAR_OFF + N_BARS * 8;
  static constexpr size_t ALLOC = BYTES + 1024;       // the base is aligned up to 1024
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
struct Consumer {
  static constexpr int NCB = D / COLS;
  float o[NCB][32];
  float m0, m1, l0, l1;

  // S = Q K^T for this warpgroup's 64 rows, over D in steps of 16.
  __device__ __forceinline__ static void issue_s(float (&sc)[32], uint32_t q_addr,
                                                 uint32_t k_addr) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk & 3) * 32;      // 16 columns within a 128-byte row
      wgmma_ss(sc, sw128_desc(q_addr + (kk >> 2) * BQ * ROW_BYTES + step),
               sw128_desc(k_addr + (kk >> 2) * BK * ROW_BYTES + step), kk > 0);
    }
    wgmma_commit();
  }

  // O += P V over the tile's 64 keys in steps of 16, 64 output columns each.
  __device__ __forceinline__ void issue_pv(const uint32_t (&p)[16], uint32_t v_addr) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NCB; ++c)
        wgmma_rs(o[c], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                 sw128_desc(v_addr + c * BK * ROW_BYTES + kk * 16 * ROW_BYTES));
    wgmma_commit();
  }

  __device__ __forceinline__ void fence_o() {
#pragma unroll
    for (int c = 0; c < NCB; ++c) reg_fence(o[c]);
  }

  __device__ __forceinline__ void rescale(float al0, float al1) {
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j + 0] *= al0;
        o[c][4 * j + 1] *= al0;
        o[c][4 * j + 2] *= al1;
        o[c][4 * j + 3] *= al1;
      }
  }
};

// What a consumer thread knows of its two rows.
struct Rows {
  long long qa0, w_lo, w_hi;   // absolute position of row r0; the warpgroup's rows
  int qs0, qs1, cq;            // segments of rows r0 and r0 + 8; column offset
};

struct Opts {
  int Sk, causal, window;
  float scale, softcap, inv_softcap;
};

// Scale, softcap and mask one 64 x 64 score tile by selection, then the
// online-softmax step: P (bf16 pairs, the wgmma A fragment) from the fp32
// scores, m and l updated, the rescale factors of O returned.  EDGE tiles
// take the per-element causal, window and bounds test; interior tiles of the
// warpgroup's rows skip it.  Each instance is straight-line code.
template <bool EDGE, bool SOFTCAP, bool SEG>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], uint32_t (&p)[16], float& m0,
                                             float& m1, float& l0, float& l1, float& al0,
                                             float& al1, const Rows& r, const int* ks, int k0,
                                             const Opts& op) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int2 kseg2 = make_int2(0, 0);
    if constexpr (SEG) kseg2 = *reinterpret_cast<const int2*>(ks + 8 * j + r.cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * op.scale;
      if constexpr (SOFTCAP) x = op.softcap * tanhf(x * op.inv_softcap);
      bool ok = true;
      if constexpr (EDGE) {
        const long long qa = e < 2 ? r.qa0 : r.qa0 + 8;
        const long long col = (long long)k0 + 8 * j + r.cq + (e & 1);
        ok = col < op.Sk && qa - col < op.window && (!op.causal || qa >= col);
      }
      if constexpr (SEG) ok = ok && (e < 2 ? r.qs0 : r.qs1) == ((e & 1) ? kseg2.y : kseg2.x);
      if constexpr (EDGE || SEG) x = ok ? x : NEG_INF;
      sc[4 * j + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
    }
  }
  const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
  const float ms0 = mn0 <= NEG_INF * 0.5f ? 0.f : mn0;
  const float ms1 = mn1 <= NEG_INF * 0.5f ? 0.f : mn1;
  al0 = m0 <= NEG_INF * 0.5f ? 0.f : fast_exp2((m0 - ms0) * LOG2E);
  al1 = m1 <= NEG_INF * 0.5f ? 0.f : fast_exp2((m1 - ms1) * LOG2E);
  m0 = mn0;
  m1 = mn1;
  // Masked scores are NEG_INF, so their exp2 is exactly 0.
  const float b0 = -ms0 * LOG2E, b1 = -ms1 * LOG2E;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = fast_exp2(fmaf(sc[4 * j + 0], LOG2E, b0));
    const float p1 = fast_exp2(fmaf(sc[4 * j + 1], LOG2E, b0));
    const float p2 = fast_exp2(fmaf(sc[4 * j + 2], LOG2E, b1));
    const float p3 = fast_exp2(fmaf(sc[4 * j + 3], LOG2E, b1));
    sum0 += p0 + p1;
    sum1 += p2 + p3;
    p[2 * j] = pack_bf16(p0, p1);
    p[2 * j + 1] = pack_bf16(p2, p3);
  }
  l0 = al0 * l0 + sum0;      // l sums the fp32 P; only the PV operand is bf16
  l1 = al1 * l1 + sum1;
}

template <bool SOFTCAP, bool SEG>
__device__ __forceinline__ void softmax_any(bool edge, float (&sc)[32], uint32_t (&p)[16],
                                            float& m0, float& m1, float& l0, float& l1,
                                            float& al0, float& al1, const Rows& r,
                                            const int* ks, int k0, const Opts& op) {
  if (edge)
    softmax_tile<true, SOFTCAP, SEG>(sc, p, m0, m1, l0, l1, al0, al1, r, ks, k0, op);
  else
    softmax_tile<false, SOFTCAP, SEG>(sc, p, m0, m1, l0, l1, al0, al1, r, ks, k0, op);
}

template <int D, bool SOFTCAP, bool SEG>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // (B, Sq, Hq, D) bf16, box 64 x 1 x 128 x 1
    const __grid_constant__ CUtensorMap tm_k,   // (B, Sk, Hkv, D) bf16, box 64 x 1 x 64 x 1
    const __grid_constant__ CUtensorMap tm_v,
    const int* __restrict__ qseg,               // (B, Sq) or null
    const int* __restrict__ kseg,               // (B, Sk) or null
    __nv_bfloat16* __restrict__ out,            // (B, Sq, Hq, D)
    int Sq, int Sk, int Hq, int Hkv, int causal, int window, int q_offset,
    float scale, float softcap) {
  using L = Layout<D>;
  constexpr int NCB = L::NCB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t sQ = sbase + L::Q_OFF, sK = sbase + L::K_OFF, sV = sbase + L::V_OFF;
  int* seg_s = reinterpret_cast<int*>(smem + L::SEG_OFF);
  const uint32_t q_full = sbase + L::BAR_OFF;
  // Per stage: K and V arrived (TMA bytes), segments stored (32 producer
  // lanes), K and V released (one arrival per consumer warp).
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  auto seg_full = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 3 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 4 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;     // longest q tiles first
  const int hk = h / (Hq / Hkv);
  const int q_rows = min(BQ, Sq - q0);

  // The KV tiles that can hold a valid pair for some row of this q tile.
  const long long qa_lo = (long long)q_offset + q0, qa_hi = qa_lo + q_rows - 1;
  long long k_lo = 0, k_hi = Sk;
  if (window != INT_MAX) k_lo = max(0LL, qa_lo - window + 1);
  if (causal) k_hi = min((long long)Sk, qa_hi + 1);
  k_lo = k_lo / BK * BK;
  const int n_tiles = k_hi > k_lo ? (int)((k_hi - k_lo + BK - 1) / BK) : 0;
  const int kt0 = (int)min(k_lo, (long long)Sk);

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(k_full(s), 1);
      bar_init(v_full(s), 1);
      bar_init(seg_full(s), 32);
      bar_init(k_empty(s), CONSUMER_WARPS);
      bar_init(v_empty(s), CONSUMER_WARPS);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: warp 8 issues the copies, warps 9-11 exit ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    const int lane = threadIdx.x - 256;
    if (lane < 32 && n_tiles > 0) {
      if (lane == 0) {
        bar_arrive_tx(q_full, L::Q_BYTES);
        for (int c = 0; c < NCB; ++c)
          tma_load(sQ + c * BQ * ROW_BYTES, &tm_q, q_full, c * COLS, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t ph = ((i / STAGES) & 1) ^ 1;     // the first round passes
        const int k0 = kt0 + i * BK;
        bar_wait(k_empty(s), ph);
        if (lane == 0) {
          bar_arrive_tx(k_full(s), L::KV_BYTES);
          for (int c = 0; c < NCB; ++c)
            tma_load(sK + s * L::KV_BYTES + c * BK * ROW_BYTES, &tm_k, k_full(s), c * COLS, hk,
                     k0, b);
        }
        if constexpr (SEG) {
          for (int j = lane; j < BK; j += 32)
            seg_s[s * BK + j] = k0 + j < Sk ? kseg[(size_t)b * Sk + k0 + j] : 0;
          bar_arrive(seg_full(s));
        }
        bar_wait(v_empty(s), ph);
        if (lane == 0) {
          bar_arrive_tx(v_full(s), L::KV_BYTES);
          for (int c = 0; c < NCB; ++c)
            tma_load(sV + s * L::KV_BYTES + c * BK * ROW_BYTES, &tm_v, v_full(s), c * COLS, hk,
                     k0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroups 0 and 1, 64 q rows each ----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = threadIdx.x / 128;
    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int r0 = cw * 64 + 16 * w + (lane >> 2);   // rows r0 and r0 + 8 of the tile
    Rows rows;
    rows.cq = 2 * (lane & 3);                        // columns cq, cq + 1 of each 8
    rows.qa0 = (long long)q_offset + q0 + r0;
    rows.w_lo = (long long)q_offset + q0 + cw * 64;
    rows.w_hi = rows.w_lo + 63;
    rows.qs0 = rows.qs1 = 0;
    if constexpr (SEG) {
      if (q0 + r0 < Sq) rows.qs0 = qseg[(size_t)b * Sq + q0 + r0];
      if (q0 + r0 + 8 < Sq) rows.qs1 = qseg[(size_t)b * Sq + q0 + r0 + 8];
    }

    Consumer<D> acc;
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc.o[c][e] = 0.f;
    acc.m0 = acc.m1 = NEG_INF;
    acc.l0 = acc.l1 = 0.f;
    const Opts op{Sk, causal, window, scale, softcap, SOFTCAP ? 1.f / softcap : 0.f};
    const uint32_t q_addr = sQ + cw * 64 * ROW_BYTES;
    // Does tile k0 need the per-element causal, window and bounds test for
    // this warpgroup's rows?
    auto edge = [&](int k0) {
      return !(k0 + BK <= Sk && (!causal || k0 + BK - 1 <= rows.w_lo) &&
               rows.w_hi - k0 < window);
    };
    auto rescale = [&](float al0, float al1) {
      // When no row's max moved, every factor is exactly 1.
      if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) acc.rescale(al0, al1);
    };

    if (n_tiles > 0) bar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int k0 = kt0 + i * BK;
      float sc[32];
      bar_wait(k_full(s), ph);
      Consumer<D>::issue_s(sc, opaque(q_addr), opaque(sK + s * L::KV_BYTES));
      wgmma_wait_all();
      reg_fence(sc);
      if constexpr (SEG) bar_wait(seg_full(s), ph);
      uint32_t p[16];
      float al0, al1;
      softmax_any<SOFTCAP, SEG>(edge(k0), sc, p, acc.m0, acc.m1, acc.l0, acc.l1, al0, al1, rows,
                                seg_s + s * BK, k0, op);
      __syncwarp();
      if (lane == 0) bar_arrive(k_empty(s));
      rescale(al0, al1);
      bar_wait(v_full(s), ph);
      acc.issue_pv(p, opaque(sV + s * L::KV_BYTES));
      wgmma_wait_all();
      reg_fence(p);
      acc.fence_o();
      __syncwarp();
      if (lane == 0) bar_arrive(v_empty(s));
    }

    // out = O / l, rounded to bf16 once; rows past Sq are not written.
    const float l0 = quad_sum(acc.l0), l1 = quad_sum(acc.l1);
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * COLS + 8 * j + rows.cq;
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * Sq + row0) * Hq + h) * D + col) =
              __floats2bfloat162_rn(acc.o[c][4 * j] * inv0, acc.o[c][4 * j + 1] * inv0);
        if (row1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * Sq + row1) * Hq + h) * D + col) =
              __floats2bfloat162_rn(acc.o[c][4 * j + 2] * inv1, acc.o[c][4 * j + 3] * inv1);
      }
  }
}

// ---- host ---------------------------------------------------------------------

template <int D, bool SOFTCAP, bool SEG>
int launch_k(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
             const int* qseg, const int* kseg, void* out, int batch, int Sq, int Sk, int Hq,
             int Hkv, int causal, int window, int q_offset, float scale, float softcap,
             cudaStream_t stream) {
  const size_t smem = Layout<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, SOFTCAP, SEG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, batch, (Sq + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<D, SOFTCAP, SEG><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, qseg, kseg, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, causal, window,
      q_offset, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const int* qseg, const int* kseg,
             void* out, int batch, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
             int q_offset, float scale, float softcap, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, D, Hq, Sq, batch, BQ);
  if (!rc) rc = make_map(&mk, k, D, Hkv, Sk, batch, BK);
  if (!rc) rc = make_map(&mv, v, D, Hkv, Sk, batch, BK);
  if (rc) return rc;
  // Softcap and segments are template switches, so that the softmax loop of
  // each instance is straight-line code.
  const bool cap = softcap > 0.f, seg = qseg != nullptr;
  auto go = [&](auto kern) {
    return kern(mq, mk, mv, qseg, kseg, out, batch, Sq, Sk, Hq, Hkv, causal, window, q_offset,
                scale, softcap, stream);
  };
  if (cap && seg) return go(launch_k<D, true, true>);
  if (cap) return go(launch_k<D, true, false>);
  if (seg) return go(launch_k<D, false, true>);
  return go(launch_k<D, false, false>);
}

}  // namespace

// Returns 0 or a cudaError_t code.  The caller checks shapes, dtypes (bf16
// only), contiguity and 16-byte alignment; window == INT_MAX means no window
// and softcap <= 0 means no softcap.
extern "C" int flash_fwd_wgmma_launch(const void* q, const void* k, const void* v,
                                      const void* qseg, const void* kseg, void* out, int batch,
                                      int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                                      int window, int q_offset, float scale, float softcap,
                                      void* stream) {
  if (batch <= 0 || batch > 65535 || Sq <= 0 || (Sq + BQ - 1) / BQ > 65535 || Sk <= 0 ||
      Hq <= 0 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kseg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_d<64>(q, k, v, qs, ks, out, batch, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, softcap, s);
    case 128: return launch_d<128>(q, k, v, qs, ks, out, batch, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, softcap, s);
    case 256: return launch_d<256>(q, k, v, qs, ks, out, batch, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
