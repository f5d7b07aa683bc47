// Mamba-2 chunked SSD forward for Hopper tensor cores (sm_90a), bf16, head
// dim P = 64 and state N = 128 (mamba2-1.3b's); plain C interface.
//
// Replaces src/repro/kernels/ssd/kernel.py::ssd_pallas (body _ssd_kernel) on
// the bf16 serving path.  The same function as ssd_fwd.cu, which keeps fp32
// and the other shapes:
//
//   s_t = a_t s_{t-1} + x_t B_t^T,   y_t = s_t C_t        (per batch b, head h)
//
// and within a chunk of Q steps (la = cumsum log a from the chunk start):
//
//   y  = (C B^T ⊙ M) x + exp(la) ⊙ (C s^T),     M[t, r] = exp(la_t - la_r), r <= t
//   s' = exp(la_end) s + Σ_t exp(la_end - la_t) x_t B_t^T
//
// y comes back in bf16, the final state in fp32.
//
// Bound.  At mamba2's wave-1 shape (B 4, S 512, H 64, P 64, N 128) the bytes
// that must move (x, y, B, C, a, the final state) take ~13 us at 3.35 TB/s;
// the products at the caller's chunk of 256 (C B^T once per batch row and
// chunk, the causal half of each chunk's c x c product per head, and the
// state terms) take ~9 us at the bf16 tensor-core peak.  So the floor is
// bytes, and what stands between ssd_fwd.cu and it is its serial walk over
// the chunks (256 CTAs of one SM each) and its fp32 CUDA-core products.
//
// Design: the chunks are independent but for a short fp32 recurrence over
// the chunk states, so the work is three launches, two of them
// chunk-parallel (the layout of ssd_combined in state-spaces/mamba):
//   1. la and chunk states, per (head, chunk, batch): la = cumsum(log a)
//      over the chunk (a block-wide scan while the first tiles load; steps
//      past S get log a = 0, decay 1), written out for the later passes;
//      then dstate_g = Σ_t w_t x_t B_t^T with w_t = exp(la_end - la_t).
//      The x rows are scaled by w_t in shared memory (rounded to bf16
//      there) and the (P x c)(c x N) product runs on wgmma m64n64k16 with
//      both operands MN-major (the transpose flags), so neither needs a
//      transposed copy.
//   2. state passing, per (batch, head) and 4 state elements a thread, in
//      order over the chunks, fp32: s_{g+1} = exp(total_g) s_g + dstate_g.
//      It writes each chunk's entering state in bf16 (the next pass's
//      operand) and the final state in fp32.
//   3. chunk scan, per (head, batch x chunk, 64-row t tile): causal linear
//      attention with a decay mask, in flash_fwd_wgmma.cu's shape with C as
//      Q, B as K and x as V.  O = C s_g^T (wgmma, the entering state as a
//      K-major operand) scaled by exp(la_t) per row; then for each 64-step
//      r tile up to the diagonal (tiles above it are never loaded):
//      S = C_t B_r^T (wgmma m64n64k16 over N = 128), the decay exp(la_t -
//      la_r) applied in fp32 registers and, on the diagonal tile only, the
//      causal mask by selection (exp overflows for r > t, so never by
//      multiplying with 0), packed to bf16 straight into the register A
//      operand of O += S x_r (x read MN-major).  y = O rounded to bf16 once.
//      t tiles are launched longest first.
// Tiles arrive by TMA in the 128-byte swizzle (4-d tensor maps built per
// launch; rows past S arrive as zeros), B and x in a two-stage ring so the
// next tile's load overlaps this tile's products.  Each CTA is one
// warpgroup; registers are light (S, O 32 fp32 each).  A scan CTA holds
// ~66 KB of shared memory (the entering state borrows the ring's second B
// slot), so three fit on an SM; a state CTA ~50 KB, four.
//
// Roundings to bf16 on a term's path, besides the inputs and y: w_t x_t,
// the entering state, the decayed scores.  kernels/ssd/ref.py::
// bf16_ssd_limit bounds what they can add.
//
// The kernels' chunk Q is the caller's chunk rounded up to a multiple of the
// 64-row tile (and no longer than S so rounded); any S is taken.

#include "../../csrc/hopper.cuh"

namespace {

constexpr int TR = 64;                      // tile rows: steps t or r, or state rows p
constexpr int P_DIM = 64, N_DIM = 128;
constexpr int PN = P_DIM * N_DIM;
constexpr int CB_BYTES = TR * ROW_BYTES;    // one 64-column block of a 64-row tile
constexpr int BN_BYTES = TR * N_DIM * 2;    // a 64-row tile of B, C or a state
constexpr int X_BYTES = TR * P_DIM * 2;     // a 64-row tile of x
constexpr int THREADS = 128;                // one warpgroup

// The B tile (both column blocks) and x tile of 64 steps from `row` of batch
// row b, head h, onto one mbarrier.
__device__ __forceinline__ void load_bx(const CUtensorMap* tm_b, const CUtensorMap* tm_x,
                                        uint32_t sB, uint32_t sX, uint32_t bar, int h, int row,
                                        int b) {
  bar_arrive_tx(bar, BN_BYTES + X_BYTES);
  for (int c = 0; c < 2; ++c) tma_load(sB + c * CB_BYTES, tm_b, bar, c * COLS, 0, row, b);
  tma_load(sX, tm_x, bar, 0, h, row, b);
}

// ---- 1. la and the chunk states ---------------------------------------------------

struct StateLayout {
  static constexpr int B_OFF = 0;                       // [2] B tiles
  static constexpr int X_OFF = B_OFF + 2 * BN_BYTES;    // [2] x tiles
  static constexpr int BAR_OFF = X_OFF + 2 * X_BYTES;   // full[2]
  static constexpr int LA_OFF = BAR_OFF + 64;           // la * log2(e), Q floats
  static size_t alloc(int Q) { return LA_OFF + (size_t)Q * 4 + 1024; }
};

// la[b, h, chunk g] = cumsum(log a) over the chunk's Q steps (log a = 0 past
// S), and dstate[b, h, g] (P x N, fp32) = Σ_t exp(la_end - la_t) x_t B_t^T.
__global__ void __launch_bounds__(THREADS) ssd_chunk_state_kernel(
    const __grid_constant__ CUtensorMap tm_x,   // (B, S, H, P), box 64 x 1 x 64 x 1
    const __grid_constant__ CUtensorMap tm_b,   // (B, S, 1, N), box 64 x 1 x 64 x 1
    const float* __restrict__ a, float* __restrict__ la, float* __restrict__ dstate, int S,
    int H, int Q, int nc, int Spad) {
  using L = StateLayout;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t sB = sbase + L::B_OFF, sX = sbase + L::X_OFF;
  auto full = [&](int s) { return sbase + L::BAR_OFF + 8 * s; };
  float* la_s = reinterpret_cast<float*>(smem + L::LA_OFF);

  const int h = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int c0 = g * Q;
  const int n_tiles = (min(Q, S - c0) + TR - 1) / TR;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  auto load = [&](int j) {
    const int s = j & 1;
    load_bx(&tm_b, &tm_x, sB + s * BN_BYTES, sX + s * X_BYTES, full(s), h, c0 + j * TR, b);
  };
  if (tid == 0) {
    bar_init(full(0), 1);
    bar_init(full(1), 1);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load(0);
    if (n_tiles > 1) load(1);
  }
  // la while the first tiles load: a block-wide inclusive scan, one step a
  // thread per round of 128 (warp shuffles, then the warps' totals).
  {
    __shared__ float warp_total[THREADS / 32];
    const int warp = tid >> 5, lane = tid & 31;
    float* la_g = la + bh * Spad + c0;
    float carry = 0.f;
    for (int seg = 0; seg < Q; seg += THREADS) {
      const int t = seg + tid;
      float v = t < Q && c0 + t < S ? logf(a[((size_t)b * S + c0 + t) * H + h]) : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) warp_total[warp] = v;
      __syncthreads();
      float prefix = carry;
      for (int w = 0; w < warp; ++w) prefix += warp_total[w];
      v += prefix;
      if (t < Q) {
        la_g[t] = v;
        la_s[t] = v * LOG2E;
      }
      for (int w = 0; w < THREADS / 32; ++w) carry += warp_total[w];
      __syncthreads();
    }
  }
  const float end2 = la_s[Q - 1];

  float d0[32], d1[32];             // n in [0, 64) and [64, 128)
#pragma unroll
  for (int e = 0; e < 32; ++e) d0[e] = d1[e] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    bar_wait(full(s), (j >> 1) & 1);
    {
      // x_t <- bf16(w_t x_t).  A step is one 128-byte row of the tile (the
      // swizzle permutes 16-byte pieces within it), two threads a row.
      const int row = tid >> 1;
      const float w = fast_exp2(end2 - la_s[j * TR + row]);
      uint4* piece = reinterpret_cast<uint4*>(smem + L::X_OFF + s * X_BYTES + row * ROW_BYTES +
                                              (tid & 1) * 64);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint4 v = piece[q];
        uint32_t* word = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&word[k]));
          word[k] = pack_bf16(f.x * w, f.y * w);
        }
        piece[q] = v;
      }
    }
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {
      const uint64_t xd = sw128_desc(sX + s * X_BYTES + kk * 16 * ROW_BYTES);
      wgmma_ss_mn(d0, xd, sw128_desc(sB + s * BN_BYTES + kk * 16 * ROW_BYTES));
      wgmma_ss_mn(d1, xd, sw128_desc(sB + s * BN_BYTES + CB_BYTES + kk * 16 * ROW_BYTES));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(d0);
    reg_fence(d1);
    __syncthreads();               // every warp is done with slot s
    if (tid == 0 && j + 2 < n_tiles) load(j + 2);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  float* out = dstate + (bh * nc + g) * PN;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + cq;
    *reinterpret_cast<float2*>(out + r0 * N_DIM + col) = make_float2(d0[4 * j], d0[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (r0 + 8) * N_DIM + col) =
        make_float2(d0[4 * j + 2], d0[4 * j + 3]);
    *reinterpret_cast<float2*>(out + r0 * N_DIM + COLS + col) =
        make_float2(d1[4 * j], d1[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (r0 + 8) * N_DIM + COLS + col) =
        make_float2(d1[4 * j + 2], d1[4 * j + 3]);
  }
}

// ---- 2. state passing -------------------------------------------------------------

// states[b, h, g] = the state entering chunk g, bf16; sfin = the final state.
__global__ void __launch_bounds__(THREADS) ssd_state_pass_kernel(
    const float* __restrict__ dstate, const float* __restrict__ s0,
    const float* __restrict__ la, __nv_bfloat16* __restrict__ states,
    float* __restrict__ sfin, int nc, int Q, int Spad) {
  const size_t bh = blockIdx.x;
  const int e = (blockIdx.y * THREADS + threadIdx.x) * 4;
  float4 s = s0 ? *reinterpret_cast<const float4*>(s0 + bh * PN + e) : make_float4(0, 0, 0, 0);
  for (int g = 0; g < nc; ++g) {
    const size_t off = (bh * nc + g) * PN + e;
    *reinterpret_cast<uint2*>(states + off) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    const float decay = expf(la[bh * Spad + (size_t)g * Q + Q - 1]);
    const float4 d = *reinterpret_cast<const float4*>(dstate + off);
    s = make_float4(fmaf(decay, s.x, d.x), fmaf(decay, s.y, d.y), fmaf(decay, s.z, d.z),
                    fmaf(decay, s.w, d.w));
  }
  *reinterpret_cast<float4*>(sfin + bh * PN + e) = s;
}

// ---- 3. chunk scan ------------------------------------------------------------------

// The entering state (64 p rows) arrives in the second B slot and is read
// before that slot's first B tile is loaded: 66 KB a CTA, three on an SM.
struct ScanLayout {
  static constexpr int C_OFF = 0;                       // C tile (64 t rows)
  static constexpr int B_OFF = C_OFF + BN_BYTES;        // [2] B tiles
  static constexpr int X_OFF = B_OFF + 2 * BN_BYTES;    // [2] x tiles
  static constexpr int BAR_OFF = X_OFF + 2 * X_BYTES;   // cs_full, full[2]
  static constexpr int LA_OFF = BAR_OFF + 64;           // la * log2(e)
  static size_t alloc(int Q) { return LA_OFF + (size_t)Q * 4 + 1024; }
};

// d (64 x 64) = A B^T over K = N = 128 (two 64-column blocks), A and B
// 64-row K-major tiles.
__device__ __forceinline__ void issue_k128(float (&d)[32], uint32_t a, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N_DIM / 16; ++kk) {
    const uint32_t step = (kk >> 2) * CB_BYTES + (kk & 3) * 32;
    wgmma_ss(d, sw128_desc(a + step), sw128_desc(b + step), kk > 0);
  }
  wgmma_commit();
}

// The decayed scores of one 64 x 64 tile, packed to bf16 as the A fragment:
// S[t, r] exp(la_t - la_r) (log2 units), and on the diagonal tile 0 where
// r > t, by selection.  Rows r0 and r0 + 8, columns cq, cq + 1 of each 8.
template <bool DIAG>
__device__ __forceinline__ void decay_tile(const float (&sc)[32], uint32_t (&p)[16],
                                           const float* la_r, float la_t0, float la_t1, int r0,
                                           int cq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + cq;
    const float2 lr = *reinterpret_cast<const float2*>(la_r + col);
    float v0 = sc[4 * j + 0] * fast_exp2(la_t0 - lr.x);
    float v1 = sc[4 * j + 1] * fast_exp2(la_t0 - lr.y);
    float v2 = sc[4 * j + 2] * fast_exp2(la_t1 - lr.x);
    float v3 = sc[4 * j + 3] * fast_exp2(la_t1 - lr.y);
    if constexpr (DIAG) {
      v0 = col <= r0 ? v0 : 0.f;
      v1 = col + 1 <= r0 ? v1 : 0.f;
      v2 = col <= r0 + 8 ? v2 : 0.f;
      v3 = col + 1 <= r0 + 8 ? v3 : 0.f;
    }
    p[2 * j] = pack_bf16(v0, v1);
    p[2 * j + 1] = pack_bf16(v2, v3);
  }
}

__global__ void __launch_bounds__(THREADS) ssd_chunk_scan_kernel(
    const __grid_constant__ CUtensorMap tm_x,   // (B, S, H, P)
    const __grid_constant__ CUtensorMap tm_b,   // (B, S, 1, N)
    const __grid_constant__ CUtensorMap tm_c,   // (B, S, 1, N)
    const __grid_constant__ CUtensorMap tm_s,   // (1, B H nc P, 1, N): entering states
    const float* __restrict__ la, __nv_bfloat16* __restrict__ y, int S, int H, int Q, int nc,
    int Spad, int has_s0) {
  using L = ScanLayout;
  const int h = blockIdx.x, g = blockIdx.y % nc, b = blockIdx.y / nc;
  const int it = gridDim.z - 1 - blockIdx.z;     // t tile in the chunk, longest first
  const int c0 = g * Q, t0 = c0 + it * TR;
  if (t0 >= S) return;                           // past the ragged end
  const bool has_state = g > 0 || has_s0;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t sC = sbase + L::C_OFF;
  const uint32_t sB = sbase + L::B_OFF, sX = sbase + L::X_OFF;
  const uint32_t sSt = sB + BN_BYTES;                   // until B tile 1 arrives
  const uint32_t cs_full = sbase + L::BAR_OFF;
  auto full = [&](int s) { return cs_full + 8 * (1 + s); };
  float* la_s = reinterpret_cast<float*>(smem + L::LA_OFF);
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;

  auto load = [&](int j) {
    const int s = j & 1;
    load_bx(&tm_b, &tm_x, sB + s * BN_BYTES, sX + s * X_BYTES, full(s), h, c0 + j * TR, b);
  };
  if (tid == 0) {
    bar_init(cs_full, 1);
    bar_init(full(0), 1);
    bar_init(full(1), 1);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    bar_arrive_tx(cs_full, BN_BYTES * (has_state ? 2 : 1));
    for (int c = 0; c < 2; ++c) {
      tma_load(sC + c * CB_BYTES, &tm_c, cs_full, c * COLS, 0, t0, b);
      if (has_state)
        tma_load(sSt + c * CB_BYTES, &tm_s, cs_full, c * COLS, 0,
                 (int)((bh * nc + g) * P_DIM), 0);
    }
    load(0);
    if (it >= 1 && !has_state) load(1);
  }
  const float* la_g = la + bh * Spad + c0;
  for (int i = tid; i < (it + 1) * TR; i += THREADS) la_s[i] = la_g[i] * LOG2E;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);   // rows r0, r0 + 8
  const float la_t0 = la_s[it * TR + r0], la_t1 = la_s[it * TR + r0 + 8];

  float o[32];
  bar_wait(cs_full, 0);
  if (has_state) {
    // O = exp(la_t) C_t s^T
    issue_k128(o, opaque(sC), opaque(sSt));
    wgmma_wait_all();
    reg_fence(o);
    const float e0 = fast_exp2(la_t0), e1 = fast_exp2(la_t1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= e0;
      o[4 * j + 1] *= e0;
      o[4 * j + 2] *= e1;
      o[4 * j + 3] *= e1;
    }
    __syncthreads();               // every warp is done with the state tile
    if (tid == 0 && it >= 1) load(1);
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
  }

  for (int j = 0; j <= it; ++j) {
    const int s = j & 1;
    bar_wait(full(s), (j >> 1) & 1);
    float sc[32];
    issue_k128(sc, opaque(sC), opaque(sB + s * BN_BYTES));
    wgmma_wait_all();
    reg_fence(sc);
    uint32_t p[16];
    if (j < it)
      decay_tile<false>(sc, p, la_s + j * TR, la_t0, la_t1, r0, cq);
    else
      decay_tile<true>(sc, p, la_s + j * TR, la_t0, la_t1, r0, cq);
    wgmma_fence();
    const uint32_t xs = opaque(sX + s * X_BYTES);
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk)
      wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               sw128_desc(xs + kk * 16 * ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(p);
    reg_fence(o);
    __syncthreads();               // every warp is done with slot s
    if (tid == 0 && j + 2 <= it) load(j + 2);
  }

  // y = O, rounded to bf16 once; rows past S are not written.
  const int row0 = t0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + cq;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(y + (((size_t)b * S + row0) * H + h) * P_DIM + col) =
          __floats2bfloat162_rn(o[4 * j], o[4 * j + 1]);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(y + (((size_t)b * S + row1) * H + h) * P_DIM + col) =
          __floats2bfloat162_rn(o[4 * j + 2], o[4 * j + 3]);
  }
}

}  // namespace

// Returns 0 or a cudaError_t code.  The caller checks shapes, dtypes (x, B, C
// bf16; a, s0 fp32), contiguity and 16-byte alignment, and allocates the
// scratch: la (B, H, nc Q) fp32, dstate (B, H, nc, P, N) fp32 and states
// (B, H, nc, P, N) bf16, with nc = ceil(S / Q).  Q, the kernels' chunk, is a
// positive multiple of 64.  s0 may be null (zeros).
extern "C" int ssd_fwd_wgmma_launch(const void* x, const void* a, const void* bmat,
                                    const void* cmat, const void* s0, void* y, void* sfin,
                                    void* la, void* dstate, void* states, int batch, int S, int H,
                                    int P, int N, int Q, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P != P_DIM || N != N_DIM || Q <= 0 || Q % TR)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  if ((long long)nc * batch > 65535 || batch > 65535 ||
      (long long)batch * H * nc * P_DIM > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int Spad = nc * Q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, mb, mc, ms;
  int rc = make_map(&mx, x, P_DIM, H, S, batch, TR);
  if (!rc) rc = make_map(&mb, bmat, N_DIM, 1, S, batch, TR);
  if (!rc) rc = make_map(&mc, cmat, N_DIM, 1, S, batch, TR);
  if (!rc) rc = make_map(&ms, states, N_DIM, 1, batch * H * nc * P_DIM, 1, TR);
  if (rc) return rc;
  const float* af = static_cast<const float*>(a);
  float* laf = static_cast<float*>(la);
  float* dst = static_cast<float*>(dstate);

  cudaError_t err;
  size_t smem = StateLayout::alloc(Q);
  err = cudaFuncSetAttribute(ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<<<dim3(H, nc, batch), THREADS, smem, st>>>(mx, mb, af, laf, dst, S, H,
                                                                   Q, nc, Spad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ssd_state_pass_kernel<<<dim3(batch * H, PN / (4 * THREADS)), THREADS, 0, st>>>(
      dst, static_cast<const float*>(s0), laf, static_cast<__nv_bfloat16*>(states),
      static_cast<float*>(sfin), nc, Q, Spad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  smem = ScanLayout::alloc(Q);
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<<<dim3(H, nc * batch, Q / TR), THREADS, smem, st>>>(
      mx, mb, mc, ms, laf, static_cast<__nv_bfloat16*>(y), S, H, Q, nc, Spad, s0 != nullptr);
  return (int)cudaGetLastError();
}
