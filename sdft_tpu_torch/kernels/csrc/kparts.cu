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
// with b_p = bf16(dmf_p), the products bf16 x bf16 accumulated in f32 and
// summed in the script's order, rot_re = cr*dmf_re - ci*dmf_im and
// rot_im = cr*dmf_im + ci*dmf_re (cr, ci = rows 8t and 8t+1 of c0), and
// conv(a)[:, j] = 0.5*a[:, PAD+j] - 0.25*(a[:, PAD+j-1] + a[:, PAD+j+1]).
// The second TPU function (mk, "tables") runs the full body on d1, d2, b1,
// b2 read from device memory instead of the computed table.
//
// The TPU kernels fill their tables in VMEM scratch at grid step 0 and keep
// them across steps.  CUDA blocks share nothing, so each block builds (or
// loads) the table columns it needs once and then walks several tiles:
// every tile's output is the same function of its own c0 rows and thi/tlo
// tiles as on the TPU.
//
// What bounds it on this card: each tile writes 2*K*m f32 (4 MiB at
// K = 128, m = 4096) and reads 2*K*K bf16 and two rows of c0, so the store
// bounds the store and vpu bodies, as it bounds K1.  The dots are 6*K*K
// bf16 multiply-adds per output column (80 columns computed for every 64
// stored), on the tensor cores through WMMA (16x16x16 fragments, f32
// accumulators, one 16-row band per warp); they bound the dots, full and
// tables bodies.
//
// How the design answers it: a block owns BN = 64 output columns of every
// tile it walks; its table columns live in shared memory (f32 for the
// rotation, bf16 for the products), the A operands stream from device
// memory straight into fragments, the products land in a shared f32 stage,
// and the stencil reads that stage and stores whole coalesced rows.  The
// products span BN + 16 columns so that the stencil's neighbours come from
// whole fragments.  A simple kernel that is right: no TMA, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

namespace kparts {

using namespace nvcuda;

constexpr int THREADS = 256;       // 8 warps
constexpr int BN = 64;             // output columns per block
constexpr int HALO = 8;            // product columns past each side of the block
constexpr int NC = BN + 2 * HALO;  // product columns per block (5 fragments)
constexpr int NCF = NC / 16;
constexpr int NS = BN + 2;         // f32 table columns per block (stencil halo 1)
constexpr int MAX_K = 128;         // one 16-row fragment band per warp

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

inline size_t smem_bytes(int body, int K) {
  size_t n = 0;
  if (uses_dots(body)) n += (size_t)K * NC * (sizeof(float) + 2 * sizeof(__nv_bfloat16));
  if (uses_table(body)) n += 2 * (size_t)K * NS * sizeof(float);
  if (uses_rot(body)) n += 2 * NS * sizeof(float);
  return n;
}

// dmf[k, w] as (cos, sin), the angle formed in f32 as the script does
__device__ __forceinline__ float2 dmf(const Args& a, int k, int w) {
  const int n2 = 2 * a.m;
  int r = (k * (w - a.pad)) % n2;
  if (r < 0) r += n2;
  const float ang = __fmul_rn(a.scale, (float)r);
  return make_float2(cosf(ang), sinf(ang));
}

template <bool TABLES>
__device__ __forceinline__ float2 table_f32(const Args& a, int k, int w, int W) {
  if (w < 0 || w >= W) return make_float2(0.f, 0.f);
  if (TABLES) return make_float2(a.d1[(size_t)k * W + w], a.d2[(size_t)k * W + w]);
  return dmf(a, k, w);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[f] = A (16 x K rows of one band) @ B (K x NC, shared), f32 accumulation
__device__ __forceinline__ void dot_band(FragC (&out)[NCF], const __nv_bfloat16* A,
                                         int K, const __nv_bfloat16* B) {
#pragma unroll
  for (int f = 0; f < NCF; ++f) wmma::fill_fragment(out[f], 0.f);
  for (int kk = 0; kk < K; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, A + kk, K);
#pragma unroll
    for (int f = 0; f < NCF; ++f) {
      FragB fb;
      wmma::load_matrix_sync(fb, B + (size_t)kk * NC + 16 * f, NC);
      wmma::mma_sync(out[f], fa, fb, out[f]);
    }
  }
}

__device__ __forceinline__ void add_to(FragC (&acc)[NCF], const FragC (&x)[NCF]) {
#pragma unroll
  for (int f = 0; f < NCF; ++f)
#pragma unroll
    for (int e = 0; e < acc[f].num_elements; ++e) acc[f].x[e] = __fadd_rn(acc[f].x[e], x[f].x[e]);
}

template <int BODY, bool TABLES>
__global__ void __launch_bounds__(THREADS) kparts_kernel(Args a) {
  constexpr bool DOT = uses_dots(BODY), TAB = uses_table(BODY), ROT = uses_rot(BODY);
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = a.K;
  const int W = a.m + 2 * a.pad;
  const int j0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  // shared stages: products (f32, K x NC), bf16 table (2 x K x NC),
  // f32 table (2 x K x NS), the tile's carry rows (2 x NS)
  float* aux = reinterpret_cast<float*>(smem);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + (DOT ? (size_t)K * NC * 4 : 0));
  float* st = reinterpret_cast<float*>(smem + (DOT ? (size_t)K * NC * 8 : 0));
  float* crci = st + (TAB ? 2 * (size_t)K * NS : 0);

  if (TAB) {
    for (int idx = tid; idx < K * NS; idx += THREADS) {
      const int k = idx / NS, c = idx - k * NS;
      const float2 v = table_f32<TABLES>(a, k, a.pad + j0 - 1 + c, W);
      st[idx] = v.x;
      st[(size_t)K * NS + idx] = v.y;
    }
  }
  if (DOT) {
    for (int idx = tid; idx < K * NC; idx += THREADS) {
      const int k = idx / NC, c = idx - k * NC;
      const int w = a.pad + j0 - HALO + c;
      __nv_bfloat16 h0 = __float2bfloat16(0.f), h1 = h0;
      if (w >= 0 && w < W) {
        if (TABLES) {
          h0 = a.b1[(size_t)k * W + w];
          h1 = a.b2[(size_t)k * W + w];
        } else {
          const float2 v = dmf(a, k, w);
          h0 = __float2bfloat16(v.x);
          h1 = __float2bfloat16(v.y);
        }
      }
      bs[idx] = h0;
      bs[(size_t)K * NC + idx] = h1;
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  for (int t = blockIdx.y; t < a.nt; t += gridDim.y) {
    const size_t row0 = (size_t)t * K;
    if (ROT) {
      __syncthreads();  // the previous tile is done with crci
      for (int c = tid; c < NS; c += THREADS) {
        const int w = a.pad + j0 - 1 + c;  // >= 0: pad >= 1
        const bool in = w < W;
        crci[c] = in ? a.c0[(size_t)8 * t * W + w] : 0.f;
        crci[NS + c] = in ? a.c0[((size_t)8 * t + 1) * W + w] : 0.f;
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int p = 0; p < 2; ++p) {
      if (DOT) {
        if (warp < K / 16) {
          const __nv_bfloat16* th = a.thi + (row0 + 16 * warp) * K;
          const __nv_bfloat16* tl = a.tlo + (row0 + 16 * warp) * K;
          const __nv_bfloat16* b = bs + (size_t)p * K * NC;
          FragC acc[NCF], x[NCF];
          dot_band(acc, th, K, b);  // (thi@b + thi@b) + tlo@b
          dot_band(x, th, K, b);
          add_to(acc, x);
          dot_band(x, tl, K, b);
          add_to(acc, x);
#pragma unroll
          for (int f = 0; f < NCF; ++f)
            wmma::store_matrix_sync(aux + (size_t)16 * warp * NC + 16 * f, acc[f], NC,
                                    wmma::mem_row_major);
        }
        __syncthreads();
      }
      float* out = p == 0 ? a.o1 : a.o2;
      const float* sp = st + (size_t)p * K * NS;  // this plane's table
      const float* sq = st + (size_t)(1 - p) * K * NS;
      for (int idx = tid; idx < K * BN; idx += THREADS) {
        const int k = idx / BN, j = idx - k * BN, col = j0 + j;
        if (col >= a.m) continue;
        float v;
        if (BODY == STORE) {
          v = sp[k * NS + j + 1];
        } else if (BODY == DOTS) {
          v = aux[(size_t)k * NC + j + HALO];
        } else {
          float x3[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {  // columns j-1, j, j+1
            const int c = j + d;
            const float s_re = p == 0 ? sp[k * NS + c] : sq[k * NS + c];
            const float s_im = p == 0 ? sq[k * NS + c] : sp[k * NS + c];
            const float cr = crci[c], ci = crci[NS + c];
            float r = p == 0 ? __fsub_rn(__fmul_rn(cr, s_re), __fmul_rn(ci, s_im))
                             : __fadd_rn(__fmul_rn(cr, s_im), __fmul_rn(ci, s_re));
            if (BODY == FULL) r = __fadd_rn(aux[(size_t)k * NC + j + HALO - 1 + d], r);
            x3[d] = r;
          }
          v = __fadd_rn(__fmul_rn(0.5f, x3[1]), __fmul_rn(-0.25f, __fadd_rn(x3[0], x3[2])));
        }
        out[(row0 + k) * a.m + col] = v;
      }
      if (DOT) __syncthreads();  // aux is rewritten for the next plane
    }
  }
}

template <int BODY, bool TABLES>
int launch(const Args& a, int grid_y, cudaStream_t stream) {
  const size_t smem = smem_bytes(BODY, a.K);
  cudaError_t err = cudaFuncSetAttribute(kparts_kernel<BODY, TABLES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.m + BN - 1) / BN, grid_y < a.nt ? grid_y : a.nt);
  kparts_kernel<BODY, TABLES><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BODY, bool TABLES>
int occupancy(int K) {
  int blocks = 0;
  const size_t smem = smem_bytes(BODY, K);
  if (cudaFuncSetAttribute(kparts_kernel<BODY, TABLES>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kparts_kernel<BODY, TABLES>,
                                                    THREADS, smem) != cudaSuccess)
    return 0;
  return blocks;
}

}  // namespace kparts

// body: 0 store, 1 dots, 2 vpu, 3 full; d1 != null selects the table inputs
// (full only).  Returns the CUDA error code (0 on success).
extern "C" int sdft_kparts_launch(const void* c0, const void* thi, const void* tlo,
                                  const void* d1, const void* d2, const void* b1,
                                  const void* b2, void* o1, void* o2, int m, int K,
                                  int pad, int nt, int body, float scale, int grid_y,
                                  void* stream) {
  using namespace kparts;
  if (K < 16 || K % 16 || K > MAX_K || m < 1 || pad < 1 || nt < 1 || grid_y < 1 ||
      (long long)K * (m + 2 * pad) >= (1LL << 31))
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
  switch (body) {
    case STORE: return launch<STORE, false>(a, grid_y, s);
    case DOTS: return launch<DOTS, false>(a, grid_y, s);
    case VPU: return launch<VPU, false>(a, grid_y, s);
    case FULL: return tables ? launch<FULL, true>(a, grid_y, s) : launch<FULL, false>(a, grid_y, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of a body at tile depth K (a diagnostic; 0 on error).
extern "C" int sdft_kparts_occupancy(int body, int K) {
  using namespace kparts;
  switch (body) {
    case STORE: return occupancy<STORE, false>(K);
    case DOTS: return occupancy<DOTS, false>(K);
    case VPU: return occupancy<VPU, false>(K);
    case FULL: return occupancy<FULL, false>(K);
    default: return 0;
  }
}
