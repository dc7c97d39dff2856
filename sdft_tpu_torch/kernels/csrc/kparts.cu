// Probes of K1's parts: one spectra tile split into its pure store, its
// matrix products and its carry-rotation + window-convolution chain.
//
// Replaces the TPU microbenchmarks make.<locals>.run and mk.<locals>.run
// (scripts/archive/exp_kparts.py:41 and :215, pallas_call at :43 and :217).
// Each grid step t of those kernels writes one (K, m) tile of two f32
// planes from the table
//
//     dmf[k, w] = exp(-i*pi/m * ((k*(w - PAD)) mod 2m)),  k < K, w < W = m + 2*PAD
//
// (angle formed in f32, init_dmf :82-87; the product k*(w - PAD) is negative
// for w < PAD and the mod is taken non-negative), through one of the bodies
//
//     store  out_p = dmf_p[:, PAD:PAD+m]                               :96-103
//     dots   out_p = (thi_t@b_p + thi_t@b_p + tlo_t@b_p)[:, PAD:PAD+m]  :107-122
//     vpu    out_p = conv(rot_p)                                       :126-143
//     full   out_p = conv(dots_p + rot_p)                              :147-172
//
// with b_p = bf16(dmf_p), the products bf16 x bf16 accumulated in f32,
// rot_re = cr*dmf_re - ci*dmf_im and rot_im = cr*dmf_im + ci*dmf_re (cr, ci
// = rows 8t and 8t+1 of c0), and
// conv(a)[:, j] = 0.5*a[:, PAD+j] - 0.25*(a[:, PAD+j-1] + a[:, PAD+j+1]).
// The second TPU function (mk, "tables") runs the full body on d1, d2, b1,
// b2 read from device memory instead of the computed table.
//
// What bounds it on an H100: each tile writes 2*K*m f32 (4 MiB at K = 128,
// m = 4096) and reads 2*K*K bf16 and two rows of c0, so the stores bound
// every body (0.64 ms for 512 tiles at 3.35 TB/s); the six products of a
// tile are 12*K*K*m operations, 0.48 ms for 512 tiles at the bf16 peak, so
// the dots, full and tables bodies must keep the tensor cores and the store
// path busy at the same time to come near either bound.
//
// How the design answers it (times: 512 tiles on an H100 at 700 W, by
// scripts/kparts_check_torch.py and kernels/compare_bodies.py):
//   * The TPU kernels fill their tables in VMEM at grid step 0 and keep
//     them.  Here the grid is one wave of persistent blocks: a block owns
//     BN = 64 output columns and a contiguous range of tiles, and builds (or
//     loads) its table columns once, in shared memory.
//   * The products span NC = 72 columns (j0-4 .. j0+67, nine 8-column
//     chunks of the tensor-core instruction), so the convolution's
//     neighbours come out of the same accumulators and the stored columns
//     start on 16 bytes.
//   * A copy warp streams each tile's thi and tlo through a ring of three
//     32 KB stages with cp.async (16 bytes per thread, .cg), two copies in
//     flight; named barriers hand a filled stage to each plane's warpgroup
//     and a drained one back.  There is no block-wide barrier in the tile
//     loop.
//   * thi, tlo and the bf16 table (kept transposed, [column][k]) lie in
//     shared memory K-major in 128-byte rows whose 16-byte pieces are
//     XOR-swizzled by the row: wgmma's 128-byte swizzle, which its matrix
//     descriptors name and which is free of bank conflicts.
//   * The product instruction is wgmma.mma_async m64n72k16 (bf16 in, f32
//     out), both operands from shared memory.  A warpgroup owns one plane:
//     two 64-row blocks, 72 f32 accumulators per thread, live through all
//     three products.  Per 16-deep step thi's wgmma is issued twice in a
//     row (every instruction of both thi@b products runs), then tlo@b is
//     chained onto the same accumulators.  The f32 sums therefore run per
//     accumulator in the order thi_k0*b, thi_k0*b, thi_k1*b, thi_k1*b, ...,
//     tlo_k0*b, ..., each term a 16-deep tensor-core dot, not (thi@b +
//     thi@b) + tlo@b.  mma.sync.m16n8k16 with ldmatrix on the same layout
//     gave the same bits and took 1.87 ms (full) against 1.31.
//   * Dependent wgmmas this narrow are bound by the accumulator's latency
//     (about 150 cycles each by the kernel's own clocks, for 36 cycles of
//     work), so the four chains an SM holds (two blocks x two warpgroups)
//     just fill the tensor cores while they run, and the warpgroups issue
//     at the same time.  Taking turns, or keeping one block's products in
//     flight behind the other block's epilogue, halves the chains in flight
//     and measured slower (1.20 ms dots against 0.98; 1.83 ms full).
//   * The epilogue works on the accumulators in their register layout: the
//     rotation reads the f32 table as 8-byte pairs, and the convolution
//     takes column j-1 and j+1 from the neighbouring lane of the quad
//     (across a chunk: from the lane holding the next chunk's edge) by
//     __shfl_sync.
//   * Stored straight from that layout (8 bytes a thread, 32 bytes in each
//     of 8 rows per instruction) the store body took 2.79 ms, a quarter of
//     the store path's rate.  So each warp passes 8 rows through a 2.3 KB
//     stage of its own in shared memory (__syncwarp only, no barrier
//     between warps) and stores whole 256-byte rows, 16 bytes a thread, with
//     streaming stores: 0.71 ms.
//
// Shapes the fast instantiation (K = 128, m a multiple of 4) does not take
// run the general one: K a multiple of 16 below 128 (wgmma still multiplies
// 64-row blocks; rows past K are neither copied nor stored), other m with
// 4-byte stores of whole rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace kparts {

// Built with -DSDFT_KPARTS_CLOCKS (scripts/kparts_clocks_torch.py; the
// card's machine has no kernel profiler) each product warp sums the SM
// clock's cycles it spends in each phase of the tile loop and writes the five
// sums to the buffer given to sdft_kparts_clocks: [block][warp][before the
// products, waiting for a stage, issuing wgmma, waiting for wgmma, epilogue].
#ifdef SDFT_KPARTS_CLOCKS
__device__ long long* g_clocks = nullptr;
#define KPARTS_CLOCKS_BEGIN long long spent_[5] = {0, 0, 0, 0, 0}, last_ = clock64();
#define KPARTS_TICK(slot)              \
  {                                    \
    const long long now_ = clock64();  \
    spent_[slot] += now_ - last_;      \
    last_ = now_;                      \
  }
#define KPARTS_CLOCKS_END                                                             \
  if (g_clocks && lane == 0)                                                          \
    for (int k_ = 0; k_ < 5; ++k_)                                                    \
      g_clocks[((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * (CONSUMERS / 32) + warp) * 5 + k_] = \
          spent_[k_];
#else
#define KPARTS_CLOCKS_BEGIN
#define KPARTS_TICK(slot)
#define KPARTS_CLOCKS_END
#endif

constexpr int BN = 64;             // output columns per block
constexpr int LEAD = 4;            // product columns before the first stored one
constexpr int NC = 72;             // product columns per block: j0-4 .. j0+67
constexpr int CHUNKS = NC / 8;     // 8-column chunks of the accumulators' layout
constexpr int MAX_K = 128;
constexpr int CONSUMERS = 256;     // two warpgroups, one per plane
constexpr int COPY_WARP = CONSUMERS / 32;
constexpr int STAGES = 3;          // ring of (K, K) bf16 matrices: thi_t, tlo_t, thi_t+1
constexpr int A_HALF = MAX_K * 128;        // bytes of a 64-deep half of a stage
constexpr int STAGE_BYTES = 2 * A_HALF;
constexpr int B_HALF = NC * 128;           // the same for the transposed bf16 table
constexpr int B_PLANE = 2 * B_HALF;
constexpr int OUT_ROW = NC;                // f32 per row of a warp's output stage
constexpr int OUT_STAGE = 8 * OUT_ROW;     // 8 rows: one accumulator half of a 16-row tile

enum Body { STORE = 0, DOTS = 1, VPU = 2, FULL = 3 };

struct Args {
  const float* c0;                         // (nt*8, W)
  const __nv_bfloat16* thi;                // (nt*K, K)
  const __nv_bfloat16* tlo;                // (nt*K, K)
  const float* d1;                         // (K, W) or null: computed table
  const float* d2;
  const __nv_bfloat16* b1;                 // (K, W) or null
  const __nv_bfloat16* b2;
  float* o1;                               // (nt*K, m)
  float* o2;
  int m, K, pad, nt;
  float scale;                             // float32(-pi/m)
};

__host__ __device__ constexpr bool uses_dots(int body) { return body == DOTS || body == FULL; }
__host__ __device__ constexpr bool uses_table(int body) { return body != DOTS; }
__host__ __device__ constexpr bool uses_rot(int body) { return body == VPU || body == FULL; }

inline int threads(int body) { return uses_dots(body) ? CONSUMERS + 32 : CONSUMERS; }

inline size_t smem_bytes(int body, int K) {
  size_t n = 0;
  if (uses_dots(body)) n += 1024 + (size_t)STAGES * STAGE_BYTES + 2 * B_PLANE;  // + alignment
  if (uses_table(body)) n += 2 * (size_t)K * NC * sizeof(float);
  return n + (CONSUMERS / 32) * OUT_STAGE * sizeof(float);
}

// byte offset of the 16-byte piece `piece` of row `row` in a block of
// 128-byte rows, pieces XOR-swizzled by the row (wgmma's 128-byte swizzle)
__device__ __forceinline__ uint32_t swz(int row, int piece) {
  return (uint32_t)(row * 128 + ((piece ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// named barriers: `count` threads take part, the arriving ones do not wait
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// a stage is full for plane g once the copy warp (32) has arrived and the
// plane's four warps (128) wait; it is empty once all eight product warps
// (256) have arrived and the copy warp waits
__device__ __forceinline__ int bar_full(int stage, int g) { return 1 + 2 * stage + g; }
__device__ __forceinline__ int bar_empty(int stage) { return 1 + 2 * STAGES + stage; }
constexpr int FULL_COUNT = CONSUMERS / 2 + 32, EMPTY_COUNT = CONSUMERS + 32;

// The matrix descriptor of a wgmma operand that lies in shared memory K-major
// (its depth contiguous) in 128-byte rows under the 128-byte swizzle, 8-row
// groups 1024 bytes apart, starting on 1024 bytes (plus 32 bytes per 16-deep
// step inside the row).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// writes of this thread to shared memory (st.shared, cp.async) become
// visible to wgmma's reads, which go through the async proxy
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving uses of the accumulators across the
// asynchronous products' issue and wait
__device__ __forceinline__ void pin(float (&d)[CHUNKS][4]) {
#pragma unroll
  for (int n = 0; n < CHUNKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
// d (64 x 72, f32) += a (64 x 16) @ b (16 x 72), bf16 from shared memory,
// by the four warps of a warpgroup.  Warp w holds rows 16 w .. 16 w + 15 in
// mma.sync's accumulator layout: d[n][0..1] are row lane / 4, columns
// 8 n + 2 (lane % 4) and the next; d[n][2..3] the same columns 8 rows down.
__device__ __forceinline__ void wgmma_m64n72k16(float (&d)[CHUNKS][4], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "%36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3])
      : "l"(da), "l"(db), "r"(1));
}

// the window convolution at a column from the columns before and after it
__device__ __forceinline__ float conv(float before, float at, float after) {
  return __fadd_rn(__fmul_rn(0.5f, at), __fmul_rn(-0.25f, __fadd_rn(before, after)));
}

// dmf[k, w] as (cos, sin), the angle formed in f32 as the script does
__device__ __forceinline__ float2 dmf(const Args& a, int k, int w) {
  const int n2 = 2 * a.m;
  int r = (k * (w - a.pad)) % n2;
  if (r < 0) r += n2;
  const float ang = __fmul_rn(a.scale, (float)r);
  return make_float2(cosf(ang), sinf(ang));
}

// The block's table columns w = pad + j0 - LEAD + c, c < NC, zero outside
// [0, W): the f32 planes st[p][k][c] and the bf16 planes transposed and
// swizzled, bt[p][half of k][c][k mod 64].
template <bool DOT, bool TAB, bool TABLES>
__device__ __forceinline__ void build_tables(const Args& a, int j0, float* st,
                                             unsigned char* bt) {
  const int K = a.K, W = a.m + 2 * a.pad;
  for (int idx = threadIdx.x; idx < K * NC; idx += blockDim.x) {
    const int k = idx / NC, c = idx - k * NC;
    const int w = a.pad + j0 - LEAD + c;
    float2 v = make_float2(0.f, 0.f);
    __nv_bfloat16 h0 = __float2bfloat16(0.f), h1 = h0;
    if (w >= 0 && w < W) {
      if (TABLES) {
        const size_t at = (size_t)k * W + w;
        v = make_float2(a.d1[at], a.d2[at]);
        h0 = a.b1[at];
        h1 = a.b2[at];
      } else {
        v = dmf(a, k, w);
        h0 = __float2bfloat16(v.x);
        h1 = __float2bfloat16(v.y);
      }
    }
    if (TAB) {
      st[idx] = v.x;
      st[(size_t)K * NC + idx] = v.y;
    }
    if (DOT) {
      unsigned char* at = bt + (k >> 6) * B_HALF + swz(c, (k & 63) >> 3) + (k & 7) * 2;
      *reinterpret_cast<__nv_bfloat16*>(at) = h0;
      *reinterpret_cast<__nv_bfloat16*>(at + B_PLANE) = h1;
    }
  }
}

// The copy warp: matrix q of the block's sequence thi_t0, tlo_t0, thi_t0+1,
// ... goes to stage q mod 3, two copies in flight.  With K a run-time value
// the index arithmetic of the 64 copies per lane and matrix (a division
// each) made this one warp the slowest part of the block: 2.0 ms for 512
// tiles whatever the product instruction (scripts/kparts_check_torch.py,
// H100).  FAST fixes K at compile time, so the copies unroll to an address
// increment and an XOR each.
template <bool FAST>
__device__ __forceinline__ void copy_tiles(const Args& a, int t0, int t1, uint32_t ring,
                                           int lane) {
  const int K = FAST ? MAX_K : a.K, pieces = K / 8, total = 2 * (t1 - t0);
  int s = 0, prev = 0;
#pragma unroll 1
  for (int q = 0; q < total; ++q) {
    if (q >= STAGES) bar_sync(bar_empty(s), EMPTY_COUNT);
    const __nv_bfloat16* src = ((q & 1) ? a.tlo : a.thi) + (size_t)(t0 + (q >> 1)) * K * K;
    const uint32_t dst = ring + s * STAGE_BYTES;
#pragma unroll(FAST ? 16 : 1)
    for (int idx = lane; idx < K * pieces; idx += 32) {
      const int r = idx / pieces, c = idx - r * pieces;
      cp_async16(dst + (c >> 3) * A_HALF + swz(r, c & 7), src + (size_t)r * K + c * 8);
    }
    cp_async_commit();
    if (q > 0) {
      cp_async_wait<1>();
      fence_async_proxy();
      bar_arrive(bar_full(prev, 0), FULL_COUNT);
      bar_arrive(bar_full(prev, 1), FULL_COUNT);
    }
    prev = s;
    s = s + 1 == STAGES ? 0 : s + 1;
  }
  if (total > 0) {
    cp_async_wait<0>();
    fence_async_proxy();
    bar_arrive(bar_full(prev, 0), FULL_COUNT);
    bar_arrive(bar_full(prev, 1), FULL_COUNT);
  }
}

// Issues acc[i] += A (rows 64 i .. 64 i + 63 of the stage) @ b (the plane's
// table), every wgmma REPS times, and commits them as one group.  KS = K / 16
// at compile time, or 0 for a run-time K; live[i] is false for a 64-row
// block at or past K.
template <int KS, int REPS>
__device__ __forceinline__ void products(float (&acc)[2][CHUNKS][4], uint32_t stage,
                                         uint32_t plane, int K, const bool (&live)[2]) {
  const int ksteps = KS ? KS : K / 16;
#pragma unroll
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint32_t step = (ks >> 2) * A_HALF + (ks & 3) * 32;
    const uint64_t db = wgmma_desc(plane + (ks >> 2) * B_HALF + (ks & 3) * 32);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (live[i]) {
        const uint64_t da = wgmma_desc(stage + step + i * 64 * 128);
#pragma unroll
        for (int rep = 0; rep < REPS; ++rep) wgmma_m64n72k16(acc[i], da, db);
      }
  }
  wgmma_commit();
}

// FAST: K = 128 and m a multiple of 4 (compile-time depth, 16-byte stores)
template <int BODY, bool TABLES, bool FAST>
__global__ void __launch_bounds__(CONSUMERS + 32) kparts_kernel(Args a, int splits) {
  constexpr bool DOT = uses_dots(BODY), TAB = uses_table(BODY), ROT = uses_rot(BODY);
  extern __shared__ __align__(1024) unsigned char smem[];
  const int K = FAST ? MAX_K : a.K;
  const int W = a.m + 2 * a.pad;
  const int j0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = (int)((long long)blockIdx.y * a.nt / splits);
  const int t1 = (int)((long long)(blockIdx.y + 1) * a.nt / splits);

  // shared memory, from a 1024-byte boundary (the swizzle is a function of
  // the address): the ring, the bf16 table (both only with products), the
  // f32 table, each product warp's output stage
  const uint32_t smem_at = (uint32_t)__cvta_generic_to_shared(smem);
  unsigned char* const base = smem + (DOT ? (1024 - (smem_at & 1023)) & 1023 : 0);
  unsigned char* const bt = base + STAGES * STAGE_BYTES;
  float* const st = reinterpret_cast<float*>(DOT ? bt + 2 * B_PLANE : base);
  float* const sw = st + (TAB ? 2 * (size_t)a.K * NC : 0) + warp * OUT_STAGE;
  build_tables<DOT, TAB, TABLES>(a, j0, st, bt);
  if (DOT) fence_async_proxy();
  __syncthreads();

  if (DOT && warp == COPY_WARP) {
    copy_tiles<FAST>(a, t0, t1, (uint32_t)__cvta_generic_to_shared(base), lane);
    return;
  }

  const int p = warp >> 2;                  // the warpgroup's plane
  const int wrow = (warp & 3) * 16;         // the warp's rows in a 64-row block
  const int q = lane & 3, rq = lane >> 2;   // column pair and row within a chunk
  const bool live[2] = {true, FAST || 64 < K};                  // the 64-row blocks
  const bool mine[2] = {FAST || wrow < K, FAST || 64 + wrow < K};  // this warp's rows
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(base);
  const uint32_t plane = (uint32_t)__cvta_generic_to_shared(bt) + p * B_PLANE;
  float* const out = p == 0 ? a.o1 : a.o2;
  const float* const s1 = st;                     // cos plane
  const float* const s2 = st + (size_t)K * NC;    // sin plane
  int s = 0;
  KPARTS_CLOCKS_BEGIN
  // whether every column of the block's carry rows lies inside c0
  const bool inside = a.pad + j0 - LEAD >= 0 && a.pad + j0 - LEAD + NC <= W;

#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    float acc[2][CHUNKS][4];
    const int s_hi = s, s_lo = s + 1 == STAGES ? 0 : s + 1;  // the stages of thi_t, tlo_t
    s = s_lo + 1 == STAGES ? 0 : s_lo + 1;
    if (DOT) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < CHUNKS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
      pin(acc[0]);
      pin(acc[1]);
      KPARTS_TICK(0)
      bar_sync(bar_full(s_hi, p), FULL_COUNT);  // thi_t: multiplied twice
      KPARTS_TICK(1)
      wgmma_fence();
      products<FAST ? MAX_K / 16 : 0, 2>(acc, ring + s_hi * STAGE_BYTES, plane, K, live);
      KPARTS_TICK(2)
      bar_sync(bar_full(s_lo, p), FULL_COUNT);  // tlo_t, onto the same sums
      KPARTS_TICK(1)
      products<FAST ? MAX_K / 16 : 0, 1>(acc, ring + s_lo * STAGE_BYTES, plane, K, live);
    }
    // the tile's carry rows arrive while the products run
    float cr[CHUNKS][2], ci[CHUNKS][2];
    if (ROT) {
      const float* c = a.c0 + (size_t)8 * t * W + (a.pad + j0 - LEAD + 2 * q);
      if (inside) {
#pragma unroll
        for (int n = 0; n < CHUNKS; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            cr[n][e] = __ldg(c + 8 * n + e);
            ci[n][e] = __ldg(c + W + 8 * n + e);
          }
      } else {
#pragma unroll
        for (int n = 0; n < CHUNKS; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int w = a.pad + j0 - LEAD + 8 * n + 2 * q + e;
            const bool in = w >= 0 && w < W;
            cr[n][e] = in ? __ldg(c + 8 * n + e) : 0.f;
            ci[n][e] = in ? __ldg(c + W + 8 * n + e) : 0.f;
          }
      }
    }
    if (DOT) {
      KPARTS_TICK(2)
      wgmma_wait<1>();
      bar_arrive(bar_empty(s_hi), EMPTY_COUNT);  // thi_t's products are done
      wgmma_wait<0>();
      bar_arrive(bar_empty(s_lo), EMPTY_COUNT);
      pin(acc[0]);
      pin(acc[1]);
      KPARTS_TICK(3)
    }

    // the epilogue, in the accumulators' layout: this thread holds rows
    // rq and rq + 8 of the warp's 16 and columns 2q, 2q + 1 of each chunk
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!mine[i]) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 64 * i + wrow + 8 * hf + rq;
        float x[CHUNKS][2];
#pragma unroll
        for (int n = 0; n < CHUNKS; ++n) {
          float2 u = make_float2(0.f, 0.f), v = u;
          if (TAB) {
            const int at = row * NC + 8 * n + 2 * q;
            if (BODY != STORE || p == 0) u = *reinterpret_cast<const float2*>(s1 + at);
            if (BODY != STORE || p == 1) v = *reinterpret_cast<const float2*>(s2 + at);
          }
          const float ue[2] = {u.x, u.y}, ve[2] = {v.x, v.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float r = 0.f;
            if (BODY == STORE) r = p == 0 ? ue[e] : ve[e];
            if (ROT)
              r = p == 0 ? __fsub_rn(__fmul_rn(cr[n][e], ue[e]), __fmul_rn(ci[n][e], ve[e]))
                         : __fadd_rn(__fmul_rn(cr[n][e], ve[e]), __fmul_rn(ci[n][e], ue[e]));
            x[n][e] = DOT ? (ROT ? __fadd_rn(acc[i][n][2 * hf + e], r) : acc[i][n][2 * hf + e]) : r;
          }
        }
        // The convolution takes column 2q - 1 from lane - 1's second value,
        // or across the chunk edge from the quad's last lane and chunk
        // n - 1; column 2q + 2 likewise from lane + 1 or the quad's first
        // lane.  Then the warp's 8 rows x 72 columns go through its stage in
        // shared memory (the 4 columns on either side hold no result and are
        // not read back), and 16 lanes take a row and store 16 bytes each, so
        // whole 256-byte rows leave with streaming stores.  (Stored straight
        // from the accumulators' layout, 32 bytes in each of 8 rows per
        // instruction, the same stores ran at a quarter of this rate; taking
        // the neighbours from the stage instead of by shuffles was no
        // faster.)
        __syncwarp();  // the stage's last readers are done
#pragma unroll
        for (int n = 0; n < CHUNKS; ++n) {
          float v0 = x[n][0], v1 = x[n][1];
          if (ROT) {
            const float give_l = (q == 3 && n > 0) ? x[n > 0 ? n - 1 : 0][1] : x[n][1];
            const float give_r = (q == 0 && n < CHUNKS - 1) ? x[n < CHUNKS - 1 ? n + 1 : n][0]
                                                            : x[n][0];
            const float left = __shfl_sync(0xffffffffu, give_l, q == 0 ? lane + 3 : lane - 1);
            const float right = __shfl_sync(0xffffffffu, give_r, q == 3 ? lane - 3 : lane + 1);
            v0 = conv(left, x[n][0], x[n][1]);
            v1 = conv(x[n][0], x[n][1], right);
          }
          *reinterpret_cast<float2*>(sw + rq * OUT_ROW + 8 * n + 2 * q) = make_float2(v0, v1);
        }
        __syncwarp();
        float* const orow = out + ((size_t)t * K + row - rq) * a.m + j0;
        if (FAST) {
          const int c = 4 * (lane & 15);
#pragma unroll
          for (int r = lane >> 4; r < 8; r += 2)
            if (j0 + c < a.m)
              __stcs(reinterpret_cast<float4*>(orow + (size_t)r * a.m + c),
                     *reinterpret_cast<const float4*>(sw + r * OUT_ROW + LEAD + c));
        } else {
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = lane; c < BN; c += 32)
              if (j0 + c < a.m) __stcs(orow + (size_t)r * a.m + c, sw[r * OUT_ROW + LEAD + c]);
        }
      }
    }
    KPARTS_TICK(4)
  }
  KPARTS_CLOCKS_END
}

template <int BODY, bool TABLES, bool FAST>
int launch(const Args& a, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes(BODY, a.K);
  cudaError_t err = cudaFuncSetAttribute(kparts_kernel<BODY, TABLES, FAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.m + BN - 1) / BN, splits);
  kparts_kernel<BODY, TABLES, FAST><<<grid, threads(BODY), smem, stream>>>(a, splits);
  return (int)cudaGetLastError();
}

template <int BODY, bool TABLES, bool FAST>
int occupancy(int K) {
  int blocks = 0;
  const size_t smem = smem_bytes(BODY, K);
  if (cudaFuncSetAttribute(kparts_kernel<BODY, TABLES, FAST>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kparts_kernel<BODY, TABLES, FAST>,
                                                    threads(BODY), smem) != cudaSuccess)
    return 0;
  return blocks;
}

inline bool fast(int m, int K) { return K == MAX_K && m % 4 == 0; }

}  // namespace kparts

// fn<BODY, TABLES, FAST>(...) of the instantiation that takes (body, tables, f)
#define KPARTS_PICK(fn, BODY, TABLES, ...) \
  return f ? fn<BODY, TABLES, true>(__VA_ARGS__) : fn<BODY, TABLES, false>(__VA_ARGS__)
#define KPARTS_DISPATCH(fn, ...)                         \
  switch (body) {                                        \
    case STORE: KPARTS_PICK(fn, STORE, false, __VA_ARGS__); \
    case DOTS: KPARTS_PICK(fn, DOTS, false, __VA_ARGS__);   \
    case VPU: KPARTS_PICK(fn, VPU, false, __VA_ARGS__);     \
    case FULL:                                           \
      if (tables) KPARTS_PICK(fn, FULL, true, __VA_ARGS__); \
      KPARTS_PICK(fn, FULL, false, __VA_ARGS__);         \
    default: break;                                      \
  }

// body: 0 store, 1 dots, 2 vpu, 3 full; d1 != null selects the table inputs
// (full only).  The grid is (ceil(m / 64) column spans, splits): block
// (x, y) walks tiles [y*nt/splits, (y+1)*nt/splits) of span x.  Returns the
// CUDA error code (0 on success).
extern "C" int sdft_kparts_launch(const void* c0, const void* thi, const void* tlo,
                                  const void* d1, const void* d2, const void* b1,
                                  const void* b2, void* o1, void* o2, int m, int K,
                                  int pad, int nt, int body, float scale, int splits,
                                  void* stream) {
  using namespace kparts;
  if (K < 16 || K % 16 || K > MAX_K || m < 1 || pad < 1 || nt < 1 || splits < 1 ||
      splits > nt || splits > 65535 || (long long)K * (m + 2 * pad) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool tables = d1 != nullptr;
  if (tables && (body != FULL || !d2 || !b1 || !b2)) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(c0),
               static_cast<const __nv_bfloat16*>(thi),
               static_cast<const __nv_bfloat16*>(tlo),
               static_cast<const float*>(d1),
               static_cast<const float*>(d2),
               static_cast<const __nv_bfloat16*>(b1),
               static_cast<const __nv_bfloat16*>(b2),
               static_cast<float*>(o1),
               static_cast<float*>(o2),
               m, K, pad, nt, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = fast(m, K);
  KPARTS_DISPATCH(launch, a, splits, s)
  return (int)cudaErrorInvalidValue;
}

#ifdef SDFT_KPARTS_CLOCKS
// Where the next launches write their phase clocks (8 warps x 5 sums of
// int64 per block), or null to stop.
extern "C" int sdft_kparts_clocks(void* buf) {
  long long* b = static_cast<long long*>(buf);
  return (int)cudaMemcpyToSymbol(kparts::g_clocks, &b, sizeof(b));
}
#endif

// Resident blocks per SM of the instantiation that sdft_kparts_launch takes
// for this body (tables != 0: the table inputs) at width m and depth K; 0 on
// error.  The wrapper sizes the one-wave grid from it.
extern "C" int sdft_kparts_occupancy(int body, int tables, int m, int K) {
  using namespace kparts;
  if (K < 16 || K % 16 || K > MAX_K) return 0;
  const bool f = fast(m, K);
  KPARTS_DISPATCH(occupancy, K)
  return 0;
}
