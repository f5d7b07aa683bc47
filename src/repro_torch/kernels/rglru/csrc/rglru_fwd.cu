// RG-LRU forward scan for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/rglru/kernel.py:75 rglru_pallas (body
// _rglru_kernel, pallas_call at :94).
//
//   a_t = exp(-8 softplus(lam) sigmoid(r_t))
//   u_t = sqrt(max(1 - a_t^2, 1e-12)) sigmoid(i_t) x_t
//   h_t = a_t h_{t-1} + u_t,   y_t = h_t            (per batch b, channel w)
//
// y in x's dtype, rounded once from fp32; the final h in fp32.
//
// Bound.  At recurrentgemma-9b's wave A (B=4, S=3072, W=4096, bf16) x, r, i
// read and y written are 402.7 MB: 0.1202 ms at 3.35 TB/s.  The gates are
// ~20 fp32 operations an element, far below the CUDA cores' rate, but with
// the loads, conversions and scan they take some 40 instructions an element,
// about as long to issue as the bytes take to move, so loads and arithmetic
// must overlap and every instruction counts.  The floor is bytes.
//
// Arithmetic.  All in fp32.  1 - a^2 is computed as -(a - 1)(a + 1) with
// a - 1 from its series near a = 1: at slow decays (a within 1e-7 of 1)
// 1 - a*a loses up to a third of itself to the rounding of a, which put
// fp32 results over one bf16 ulp of the float64 result on ~0.1 % of wave A's
// elements.  The exponentials and the one reciprocal that both sigmoids
// share use the SFU's approximations (relative errors ~1e-7): near a = 1
// they move a - 1 only relatively, so nothing accumulates over slow decays.
//
// Design: a chunk-parallel, single-pass scan with a chained look-back.  One
// thread per (b, w) walking the whole sequence (the first version) gave 128
// blocks of 4 warps, one round trip to memory per 16 steps and no overlap of
// loads with arithmetic: bound by latency at 16 % of the byte rate.  Here the
// recurrence is split along time as well, into tiles of one (b, 128-channel)
// column and one chunk of CHUNK steps (6,144 tiles at wave A):
//
//  * Tickets.  Persistent CTAs (as many as fit on the card) take tiles from
//    an atomic ticket counter in chunk-major order across columns, so every
//    tile's predecessor in its column was taken first and is done or in
//    progress, which is what the look-back needs to make progress.  A CTA
//    holds two tiles: while it scans one, cp.async brings the next one's x,
//    r and i into its second shared-memory buffer (16-byte copies,
//    zero-filled past S and W), so loads overlap the arithmetic and the
//    look-back's wait.  The counter is reset by the last draw of the call.
//  * Scan.  Each thread owns one channel and SUB consecutive steps: it
//    computes their a and u once, keeps them in registers, and scans them
//    from zero to its sub-chunk aggregate (A = prod a, H).  Steps past S get
//    a = 1, u = 0, so they enter no aggregate.  The sub-chunk aggregates
//    compose, in order, through shared memory into the tile's (A_c, H_c).
//  * Look-back.  The last sub-chunk's 128 threads wait for the h at the end
//    of the column's previous tile (its inclusive value), h_in, and publish
//    their own, H_c + A_c h_in; chunk 0 takes h0.  Each tile folds exactly
//    its predecessor's inclusive value, so every h is computed in the same
//    order on every run and the kernel is deterministic (a decoupled
//    look-back, composing whichever predecessors' aggregates happen to be
//    published, was measured no faster; PERF.md).  The wait is short: the
//    predecessor was taken a column count of tickets earlier and publishes
//    as soon as its own scan ends.  Every value is a 64-bit word, the call's
//    epoch in the high half and the fp32 bits in the low half, stored and
//    loaded whole (single-copy atomic), so a word that carries this call's
//    epoch is valid without fences or flags, and the wrapper's cached
//    scratch needs no clearing between calls.
//  * Apply.  Each thread re-walks its steps from its true entering h, writes
//    y into shared memory over x's tile, and the CTA stores y with 16-byte
//    coalesced stores.  The last chunk of each column writes the final h.
//
// x, r and i are read from device memory once and y is written once; the
// look-back writes 8 bytes a channel a tile, read back from L2.  Row strides
// that are not a multiple of 16 bytes take element-wise loads and stores.
// The tiling (64 steps a tile, 32 a thread: 256 threads, two CTAs an SM) was
// the fastest of the tilings timed on an H100 at recurrentgemma's prefill
// shapes (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WT = 128;                       // channels a tile holds
constexpr int CHUNK = 64;                     // steps a tile holds
constexpr int SUB = 32;                       // steps a thread owns
constexpr int MIN_BLOCKS = 2;                 // CTAs an SM must fit (caps registers)
constexpr int K = CHUNK / SUB;                // sub-chunks a tile
constexpr int THREADS = WT * K;
constexpr int TILE_ELEMS = CHUNK * WT;
constexpr float RGLRU_C = 8.f;
constexpr int MAX_SPINS = 1 << 22;            // polls of one word, ~seconds
static_assert(CHUNK % SUB == 0 && THREADS <= 1024, "bad RG-LRU tiling");

typedef unsigned long long word_t;            // epoch << 32 | fp32 bits

struct Params {
  const void* x;            // (B, S, W)
  const void* r;
  const void* gi;
  const float* lam;         // (W,)
  const float* h0;          // (B, W) or null for zeros
  void* y;                  // (B, S, W)
  float* hfin;              // (B, W)
  word_t* pub;              // (tiles, WT): the h at each tile's end
  unsigned* counter;        // ticket counter, 0 between calls
  int S, W, wtiles, columns, tiles;
  unsigned epoch;
  int vec;                  // 16-byte loads and stores
};

struct Tile {
  int chunk, b, w0, rows, cols;
  size_t base;              // element offset of (b, chunk's first step, w0)
};

__device__ __forceinline__ Tile tile_of(const Params& p, int ticket) {
  Tile t;
  t.chunk = ticket / p.columns;
  const int col = ticket % p.columns;
  t.b = col / p.wtiles;
  t.w0 = (col % p.wtiles) * WT;
  const int t0 = t.chunk * CHUNK;
  t.rows = min(CHUNK, p.S - t0);
  t.cols = min(WT, p.W - t.w0);
  t.base = ((size_t)t.b * p.S + t0) * p.W + t.w0;
  return t;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// a - 1 = expm1(la) for la <= 0: its Taylor series where a is near 1 (five
// terms, exact to fp32 for |la| < 1/16), so that 1 - a^2 = -(a - 1)(a + 1)
// keeps its digits; exp(la) - 1 elsewhere, where a < 0.94.
__device__ __forceinline__ float a_minus_1(float la) {
  const float series =
      la * (1.f + la * (0.5f + la * (1.f / 6.f + la * (1.f / 24.f + la * (1.f / 120.f)))));
  return la > -0.0625f ? series : __expf(la) - 1.f;
}

__device__ __forceinline__ word_t ld_word(const word_t* p) {
  word_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(word_t* p, unsigned epoch, float v) {
  const word_t w = ((word_t)epoch << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ bool current(word_t w, unsigned epoch) {
  return (unsigned)(w >> 32) == epoch;
}

__device__ __forceinline__ float value(word_t w) { return __uint_as_float((unsigned)w); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

// Tickets.  Each CTA draws until it draws past the last tile, so a call
// makes tiles + gridDim.x draws, and the last one resets the counter for the
// next call on this scratch.
__device__ __forceinline__ int draw(const Params& p) { return (int)atomicAdd(p.counter, 1u); }

__device__ __forceinline__ void drawn(const Params& p, int t) {
  if ((unsigned)t == (unsigned)p.tiles + gridDim.x - 1) atomicExch(p.counter, 0u);
}

// Starts the copies of a tile's x, r and i into buf ([3][CHUNK][WT]).
template <typename T>
__device__ __forceinline__ void load_tile(const Params& p, int ticket, T* buf) {
  const Tile t = tile_of(p, ticket);
  const T* xg = static_cast<const T*>(p.x);
  const T* rg = static_cast<const T*>(p.r);
  const T* ig = static_cast<const T*>(p.gi);
  if (p.vec) {
    constexpr int EPV = 16 / sizeof(T);        // elements a 16-byte vector
    constexpr int VPR = WT / EPV;              // vectors a row
    const int vcols = t.cols / EPV;            // W % EPV == 0 on this route
    for (int v = threadIdx.x; v < 3 * CHUNK * VPR; v += THREADS) {
      const int m = v / (CHUNK * VPR), row = (v / VPR) % CHUNK, cv = v % VPR;
      T* dst = buf + m * TILE_ELEMS + row * WT + cv * EPV;
      const T* g = m == 0 ? xg : m == 1 ? rg : ig;
      if (row < t.rows && cv < vcols)
        cp_async16(dst, g + t.base + (size_t)row * p.W + cv * EPV);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = threadIdx.x; e < 3 * TILE_ELEMS; e += THREADS) {
      const int m = e / TILE_ELEMS, row = (e / WT) % CHUNK, cc = e % WT;
      const T* g = m == 0 ? xg : m == 1 ? rg : ig;
      buf[e] = (row < t.rows && cc < t.cols) ? g[t.base + (size_t)row * p.W + cc] : T(0.f);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Stores a tile's y from buf ([CHUNK][WT]).
template <typename T>
__device__ __forceinline__ void store_tile(const Params& p, const Tile& t, const T* buf) {
  T* y = static_cast<T*>(p.y);
  if (p.vec) {
    constexpr int EPV = 16 / sizeof(T);
    constexpr int VPR = WT / EPV;
    const int vcols = t.cols / EPV;
    for (int v = threadIdx.x; v < CHUNK * VPR; v += THREADS) {
      const int row = v / VPR, cv = v % VPR;
      if (row < t.rows && cv < vcols)
        *reinterpret_cast<uint4*>(y + t.base + (size_t)row * p.W + cv * EPV) =
            *reinterpret_cast<const uint4*>(buf + row * WT + cv * EPV);
    }
  } else {
    for (int e = threadIdx.x; e < TILE_ELEMS; e += THREADS) {
      const int row = e / WT, cc = e % WT;
      if (row < t.rows && cc < t.cols) y[t.base + (size_t)row * p.W + cc] = buf[e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) rglru_fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);                            // [2][3][CHUNK][WT]
  float2* ssub = reinterpret_cast<float2*>(bufs + 2 * 3 * TILE_ELEMS);  // [K][WT]
  float* shin = reinterpret_cast<float*>(ssub + K * WT);                // [WT]
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int c = tid % WT, s = tid / WT;

  if (tid == 0) {
    s_ticket = draw(p);
    drawn(p, s_ticket);
  }
  __syncthreads();
  int cur = s_ticket;
  if (cur >= p.tiles) return;
  load_tile(p, cur, bufs);
  __syncthreads();                              // every thread has read s_ticket
  if (tid == 0) {
    s_ticket = draw(p);
    drawn(p, s_ticket);
  }
  __syncthreads();
  int nxt = s_ticket;

  for (int bi = 0; cur < p.tiles; bi ^= 1) {
    T* buf = bufs + bi * 3 * TILE_ELEMS;
    // The next tile's loads overlap this one's scan; the ticket after it is
    // drawn now and read at the end of the iteration.
    int after = p.tiles;
    if (nxt < p.tiles) {
      load_tile(p, nxt, bufs + (bi ^ 1) * 3 * TILE_ELEMS);
      if (tid == 0) after = draw(p);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();

    // 1. gates, once an element, and the sub-chunk's scan from zero
    const Tile t = tile_of(p, cur);
    const int w = t.w0 + c;
    const float l = w < p.W ? p.lam[w] : 0.f;
    // -c softplus(lam), softplus(v) = max(v, 0) + log1p(exp(-|v|)) as jax's
    const float neg_c_sp = -RGLRU_C * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
    const T* bx = buf;
    const T* br = buf + TILE_ELEMS;
    const T* bg = buf + 2 * TILE_ELEMS;
    float a[SUB], u[SUB];
    float A = 1.f, H = 0.f;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int row = s * SUB + j, e = row * WT + c;
      // e^-v capped at e^40, so the product of the two denominators stays
      // finite (a sigmoid held at 4e-18 from below moves a and u by < 1e-17)
      const float er = __expf(fminf(-to_f32(br[e]), 40.f));
      const float ei = __expf(fminf(-to_f32(bg[e]), 40.f));
      const float inv = __fdividef(1.f, (1.f + er) * (1.f + ei));   // one reciprocal
      const float la = neg_c_sp * (1.f + ei) * inv;                 // log a
      const float am1 = a_minus_1(la);
      const float q = fmaxf(-am1 * (2.f + am1), 1e-12f);             // 1 - a^2
      const float uv = q * rsqrtf(q) * to_f32(bx[e]) * (1.f + er) * inv;
      a[j] = row < t.rows ? 1.f + am1 : 1.f;  // steps past S enter no aggregate
      u[j] = row < t.rows ? uv : 0.f;
      H = a[j] * H + u[j];
      A *= a[j];
    }
    ssub[s * WT + c] = make_float2(A, H);
    __syncthreads();

    // The sub-chunks before this one, composed in order: h entering this
    // sub-chunk = PH + PA * h entering the tile.
    float PA = 1.f, PH = 0.f;
    for (int q = 0; q < s; ++q) {
      const float2 g = ssub[q * WT + c];
      PH = g.x * PH + g.y;
      PA *= g.x;
    }

    // 2. look-back, by the last sub-chunk's threads (one a channel)
    if (s == K - 1) {
      const float Ac = A * PA, Hc = A * PH + H;   // the whole tile's aggregate
      float hin;
      if (t.chunk == 0) {
        hin = (p.h0 != nullptr && w < p.W) ? p.h0[(size_t)t.b * p.W + w] : 0.f;
      } else {
        const word_t* q = p.pub + (size_t)(cur - p.columns) * WT + c;
        word_t wi;
        for (int spins = 0; !current(wi = ld_word(q), p.epoch); ++spins) {
          if (spins == MAX_SPINS) __trap();      // the predecessor never published
          __nanosleep(32);
        }
        hin = value(wi);
      }
      const float hend = Hc + Ac * hin;
      st_word(p.pub + (size_t)cur * WT + c, p.epoch, hend);
      shin[c] = hin;
      if (t.chunk == (p.S - 1) / CHUNK && w < p.W) p.hfin[(size_t)t.b * p.W + w] = hend;
    }
    __syncthreads();

    // 3. apply: re-walk the steps from the true entering h; y over x's tile
    float h = PH + PA * shin[c];
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      h = a[j] * h + u[j];
      put(buf + (s * SUB + j) * WT + c, h);
    }
    __syncthreads();
    store_tile(p, t, buf);
    if (tid == 0) {
      drawn(p, after);                          // the draw's latency is hidden
      s_ticket = after;
    }
    __syncthreads();                            // buf is free; s_ticket is set
    cur = nxt;
    nxt = s_ticket;
  }
}

template <typename T>
constexpr int smem_bytes() {
  return 2 * 3 * TILE_ELEMS * (int)sizeof(T) + K * WT * (int)sizeof(float2) +
         WT * (int)sizeof(float);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(rglru_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rglru_fwd_kernel<T>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  // Persistent CTAs, as many as fit on the card at once.
  const int grid = min(p.tiles, sms * per_sm);
  rglru_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Steps a tile holds: the scratch holds ceil(S / chunk) x batch x ceil(W /
// 128) tiles.
extern "C" int rglru_fwd_chunk(void) { return CHUNK; }

// Returns 0 or a cudaError_t code.  The caller checks shapes, dtypes and
// contiguity, and passes scratch for at least `capacity` tiles: `pub`
// (capacity x 128 uint64, zero or written by calls of earlier epochs)
// and `counter` (one uint32, zero before the first call; each call leaves it
// zero).  `epoch` is positive and differs from the epochs of every earlier
// call on the same scratch.
extern "C" int rglru_fwd_launch(const void* x, const void* r, const void* gi, const void* lam,
                                const void* h0, void* y, void* hfin, void* pub, void* counter,
                                int batch, int S, int W, int is_bf16, int capacity, int epoch,
                                void* stream) {
  if (batch <= 0 || S <= 0 || W <= 0 || epoch <= 0) return (int)cudaErrorInvalidValue;
  const int wtiles = (W + WT - 1) / WT;
  const long long tiles = (long long)((S + CHUNK - 1) / CHUNK) * batch * wtiles;
  if (tiles > capacity || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int elt = is_bf16 ? 2 : 4;
  const uintptr_t any = (uintptr_t)x | (uintptr_t)r | (uintptr_t)gi | (uintptr_t)y;
  const Params p{x, r, gi, static_cast<const float*>(lam), static_cast<const float*>(h0), y,
                 static_cast<float*>(hfin), static_cast<word_t*>(pub),
                 static_cast<unsigned*>(counter), S, W, wtiles, batch * wtiles, (int)tiles,
                 (unsigned)epoch, (int)((any % 16 == 0) && ((long long)W * elt) % 16 == 0)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
