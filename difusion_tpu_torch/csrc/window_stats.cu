// Window-statistics stencil for frame preprocessing, f32, sm_90a.
//
// Replaces the Pallas TPU kernel difusion_tpu/ops/stencil_pallas.py
// `window_stat_sums` (and the JAX default `scan` backend of
// core/tracker._window_stats, which computes the same function).  For every
// pixel of the (H, W) point map, over its (2w+1)^2 window (zero outside the
// image), with d = neighbour - centre and wgt = [|d|^2 <= normal_r2] * ok:
//   out[0] = sum [|d|^2 <= outlier_r2] * ok      out[1] = sum wgt
//   out[2..4] = sum wgt * {x, y, z}
//   out[5..10] = sum wgt * {xx, xy, xz, yy, yz, zz}
//
// Contract.  Every product and sum is rounded alone (__fmul_rn / __fadd_rn /
// __fsub_rn, add.rn.f32: nvcc contracts none of them into an FMA) and each
// pixel's taps arrive in the plain version's order (dv outer, du inner), so
// all 11 planes are bit-equal to ops/stencil.window_stat_sums_plain on finite
// inputs: the threshold tests cannot flip and the counts match exactly.
//
// What bounds it on an H100: the instruction schedulers.  The function needs 21
// single-rounded operations per tap and pixel (3 differences, |d|^2 in 3
// products and 2 sums, 2 threshold tests, 11 accumulating sums) and 9
// products per pixel (the moments' terms depend on the neighbour alone); at
// the main path's 240 x 320 map and w = 6 (169 taps) that is 0.273 G
// instructions against 4.6 MB of input and output: 0.0082 ms at 132 SMs x
// 128 lanes x 1.98 GHz = 33.5 T instructions/s, versus 1.4 us for the bytes.
// (Counting the 9 products once per tap, as the plain version computes them,
// gives 30 operations a tap and 0.0116 ms.)  Every executed instruction (loads,
// compares, loop and address arithmetic) takes a slot of the same
// one-per-clock scheduler, so the design is about scheduler slots and about
// giving each of the 4 x 132 schedulers the same number of them.
//
// Design.
//  * A thread owns R vertically adjacent pixels of one column; a warp's
//    lanes lie on 32 adjacent columns; a block is 4 warps stacked
//    vertically, one for each scheduler of an SM, on a 32 x 4R tile.  The
//    host plan (ops/stencil.plan) picks R from the image and the SM count:
//    at 240 x 320 on 132 SMs R = 5 gives 120 blocks, one a SM, one warp a
//    scheduler.  A lane's pixel count is an integer, so 5 against the mean
//    of 76,800 / (528 x 32) = 4.55 is the least imbalance whole pixels allow.
//  * The haloed tile lies in shared memory interleaved as float4 (x, y, z,
//    ok), invalid and out-of-image entries all zero: one LDS.128 a
//    neighbour, consecutive lanes on consecutive addresses.  Both entries
//    (four planes; or the (H, W, 3) point map with its bool validity map,
//    masked as it is loaded) fill the same tile and run the same body.
//  * Everything that depends on the neighbour alone is computed once per
//    loaded neighbour and shared by the R centres: the nine products
//    ok*{x, y, z} and (ok*x)*{x, y, z}, (ok*y)*{y, z}, (ok*z)*z.  They are
//    the plain version's wgt*n.. products wherever wgt = ok.
//  * Thresholds without selects: a tap is 3 FSUB, 3 FMUL + 2 FADD for
//    |d|^2, two FSETP and 11 predicated FADDs.  A predicated-off add is an
//    exact no-op: the plain version adds wgt = +0 there (or (+0 * n) * n =
//    +-0 for the finite n the contract asks for), and x + (+-0) = x for
//    every x but -0, which no accumulator holds: each starts at +0 and a
//    round-to-nearest sum is -0 only if both terms are.  So 21 executed
//    instructions per tap and centre, plus (1 load + 9 products + ~3 of
//    loop) / R: 23.8 at R = 5 against the 21 the function needs.
//  * Each neighbour row's set of active centres is fixed at compile time
//    (R - 1 rows of ramp-up, 2w + 2 - R full rows, R - 1 of ramp-down), and
//    the 2w + 1 taps of a row are a short loop that prefetches the next
//    neighbour.  Unrolling all 13 x (R + 12) steps of w = 6 would be ~300 KB
//    of code, far beyond the instruction cache; unrolling 2 to 13 of a row's
//    taps measured slower than the loop.  w = 6 (production) is a template parameter: a
//    static tile, constant strides and tap counts.  Every other window runs
//    the same body with run-time strides and a dynamic tile; the strip is
//    never longer than the window (R <= 2w + 1; R = 1 serves w = 0).  R is
//    1 or 5: at 240 x 320 on 132 SMs R = 4 and R = 6 measured 1.47x and
//    1.10x the time of R = 5, and R = 3 was the fastest at no shape or window
//    measured.
//  * One tile a block, so there is no next tile to prefetch behind the taps:
//    the tile's loads are all independent and started together (unrolled, from
//    clamped addresses, as asm volatile so that the compiler cannot turn them
//    back into one dependent round trip per entry) before one __syncthreads.
//    The tile is 11-25 KB at w = 6; neither cp.async nor TMA is used.  Tensor cores
//    have no part: the products must round one by one.
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int TW = 32;     // tile width: a warp's lanes on adjacent columns
constexpr int NWARP = 4;   // warps of a block, stacked vertically
constexpr int FIXED_WIN = 6;
// the devices whose shared-memory grant a launcher instance remembers
constexpr int MAX_DEVICES = 64;

// Loads the compiler may neither sink into a branch nor make conditional:
// the tile's loads must all be in flight together, not one round trip each.
__device__ __forceinline__ float ldg_f32(const float* p) {
  float v;
#if defined(__CUDACC__)
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
#else
  v = *p;
#endif
  return v;
}
__device__ __forceinline__ unsigned ldg_u8(const unsigned char* p) {
  unsigned v;
#if defined(__CUDACC__)
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
#else
  v = *p;
#endif
  return v;
}

// CHUNK entries a thread at a time of the haloed tile of n entries, SW wide,
// whose top-left image pixel is (y0, x0), as (x, y, z, ok): first every load
// of the chunk, from addresses that do not depend on a test (pixel 0 stands
// in outside the image), then the selects and the stores.  MAP: the (H, W, 3)
// point map in `a` and the bool validity map in `v`; else the four planes.
template <int CHUNK, bool MAP>
__device__ __forceinline__ void load_chunks(float4* tile, int SW, int n, int x0, int y0,
                                            int H, int W, const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            const float* __restrict__ c,
                                            const void* __restrict__ v) {
  constexpr int NT = TW * NWARP;
  for (int i0 = threadIdx.x; i0 < n; i0 += CHUNK * NT) {
    float4 e[CHUNK];
    bool keep[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = min(i0 + j * NT, n - 1);
      const int yy = y0 + i / SW, xx = x0 + i % SW;
      const bool in = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W);
      const int g = in ? yy * W + xx : 0;
      if (MAP) {
        e[j] = make_float4(ldg_f32(a + 3 * g), ldg_f32(a + 3 * g + 1),
                           ldg_f32(a + 3 * g + 2), 1.f);
        keep[j] = in & (ldg_u8((const unsigned char*)v + g) != 0);
      } else {
        e[j] = make_float4(ldg_f32(a + g), ldg_f32(b + g), ldg_f32(c + g),
                           ldg_f32((const float*)v + g));
        keep[j] = in;
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = i0 + j * NT;
      if (i < n) tile[i] = keep[j] ? e[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int CHUNK>
__device__ __forceinline__ void load_tile(float4* tile, int SW, int SH, int x0, int y0,
                                          int H, int W, const float* a, const float* b,
                                          const float* c, const void* v, bool pointmap) {
  if (pointmap) load_chunks<CHUNK, true>(tile, SW, SW * SH, x0, y0, H, W, a, b, c, v);
  else load_chunks<CHUNK, false>(tile, SW, SW * SH, x0, y0, H, W, a, b, c, v);
}

// What depends on the neighbour alone: ok*{x,y,z} and the six second-moment
// products, in the plain version's association (wgt * nx) * ny.
__device__ __forceinline__ void products(const float4 n, float (&m)[9]) {
  m[0] = __fmul_rn(n.w, n.x);
  m[1] = __fmul_rn(n.w, n.y);
  m[2] = __fmul_rn(n.w, n.z);
  m[3] = __fmul_rn(m[0], n.x);
  m[4] = __fmul_rn(m[0], n.y);
  m[5] = __fmul_rn(m[0], n.z);
  m[6] = __fmul_rn(m[1], n.y);
  m[7] = __fmul_rn(m[1], n.z);
  m[8] = __fmul_rn(m[2], n.z);
}

// One tap of one centre: |d|^2, the two threshold tests, 11 predicated adds.
__device__ __forceinline__ void tap(float (&a)[11], const float (&c)[3], const float4 n,
                                    const float (&m)[9], float r2o, float r2n) {
  const float dx = __fsub_rn(n.x, c[0]), dy = __fsub_rn(n.y, c[1]),
              dz = __fsub_rn(n.z, c[2]);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
#if defined(__CUDACC__)
  asm("{\n\t"
      ".reg .pred po, pn;\n\t"
      "setp.le.f32 po, %11, %12;\n\t"
      "setp.le.f32 pn, %11, %13;\n\t"
      "@po add.rn.f32 %0, %0, %14;\n\t"
      "@pn add.rn.f32 %1, %1, %14;\n\t"
      "@pn add.rn.f32 %2, %2, %15;\n\t"
      "@pn add.rn.f32 %3, %3, %16;\n\t"
      "@pn add.rn.f32 %4, %4, %17;\n\t"
      "@pn add.rn.f32 %5, %5, %18;\n\t"
      "@pn add.rn.f32 %6, %6, %19;\n\t"
      "@pn add.rn.f32 %7, %7, %20;\n\t"
      "@pn add.rn.f32 %8, %8, %21;\n\t"
      "@pn add.rn.f32 %9, %9, %22;\n\t"
      "@pn add.rn.f32 %10, %10, %23;\n\t"
      "}"
      : "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3]), "+f"(a[4]), "+f"(a[5]),
        "+f"(a[6]), "+f"(a[7]), "+f"(a[8]), "+f"(a[9]), "+f"(a[10])
      : "f"(d2), "f"(r2o), "f"(r2n), "f"(n.w), "f"(m[0]), "f"(m[1]), "f"(m[2]),
        "f"(m[3]), "f"(m[4]), "f"(m[5]), "f"(m[6]), "f"(m[7]), "f"(m[8]));
#else
  // the same updates in C++, for a reader and for a host-side build
  if (d2 <= r2o) a[0] = a[0] + n.w;
  if (d2 <= r2n) {
    a[1] = a[1] + n.w;
    for (int k = 0; k < 9; ++k) a[2 + k] = a[2 + k] + m[k];
  }
#endif
}

// The ntap taps of one neighbour row for the centres KLO..KHI of the thread.
// `row` points at the thread's leftmost neighbour; the next one is loaded
// before this one's arithmetic (the tile has one spare entry at its end).
template <int R, int KLO, int KHI>
__device__ __forceinline__ void row_taps(const float4* row, int ntap, float (&acc)[R][11],
                                         const float (&c)[R][3], float r2o, float r2n) {
  float4 nxt = row[0];
#pragma unroll 1
  for (int du = 0; du < ntap; ++du) {
    const float4 n = nxt;
    nxt = row[du + 1];
    float m[9];
    products(n, m);
#pragma unroll
    for (int k = KLO; k <= KHI; ++k) tap(acc[k], c[k], n, m, r2o, r2n);
  }
}

// neighbour rows 0..R-2 of the thread's strip: row I serves centres 0..I
template <int R, int... I>
__device__ __forceinline__ void ramp_up(std::integer_sequence<int, I...>, const float4* base,
                                        int SW, int side, float (&acc)[R][11],
                                        const float (&c)[R][3], float r2o, float r2n) {
  (row_taps<R, 0, I>(base + I * SW, side, acc, c, r2o, r2n), ...);
}

// neighbour rows 2w+1 .. 2w+R-1: row 2w+1+I serves centres I+1..R-1
template <int R, int... I>
__device__ __forceinline__ void ramp_down(std::integer_sequence<int, I...>, const float4* base,
                                          int SW, int side, float (&acc)[R][11],
                                          const float (&c)[R][3], float r2o, float r2n) {
  (row_taps<R, I + 1, R - 1>(base + (side + I) * SW, side, acc, c, r2o, r2n), ...);
}

template <int R>
__device__ __forceinline__ void store(const float (&acc)[R][11], float* __restrict__ out,
                                      int H, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * TW + lane;
  if (x >= W) return;
  const size_t plane = (size_t)H * W;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int y = blockIdx.y * (NWARP * R) + warp * R + k;
    if (y < H) {
#pragma unroll
      for (int p = 0; p < 11; ++p) out[p * plane + (size_t)y * W + x] = acc[k][p];
    }
  }
}

// WIN >= 0: the window is a template parameter (the production w = 6): a
// static tile, constant strides and tap counts.  WIN < 0: it is the run-time
// argument `win_arg` and the tile is dynamic shared memory.  One body.
template <int WIN, int R>
__global__ void __launch_bounds__(TW * NWARP)
window_stats_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ c, const void* __restrict__ v, int pointmap,
                    float* __restrict__ out, int H, int W, int win_arg, float r2o, float r2n) {
  static_assert(WIN < 0 || R <= 2 * WIN + 1, "a full row must serve all R centres");
  const int win = WIN >= 0 ? WIN : win_arg;
  const int side = 2 * win + 1, SW = TW + 2 * win, SH = NWARP * R + 2 * win;
  float4* tile;
  if constexpr (WIN >= 0) {
    __shared__ float4 fixed_tile[(NWARP * R + 2 * WIN) * (TW + 2 * WIN) + 1];
    tile = fixed_tile;
  } else {
    extern __shared__ __align__(16) float4 dyn_tile[];
    tile = dyn_tile;
  }
  constexpr int CHUNK =
      WIN >= 0 ? ((NWARP * R + 2 * WIN) * (TW + 2 * WIN) + TW * NWARP - 1) / (TW * NWARP) : 4;
  load_tile<CHUNK>(tile, SW, SH, blockIdx.x * TW - win, blockIdx.y * (NWARP * R) - win, H, W,
                   a, b, c, v, pointmap != 0);
  if (threadIdx.x == 0) tile[SH * SW] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* base = tile + warp * R * SW + lane;
  float ctr[R][3], acc[R][11];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float4 cc = base[(k + win) * SW + win];
    ctr[k][0] = cc.x;
    ctr[k][1] = cc.y;
    ctr[k][2] = cc.z;
#pragma unroll
    for (int p = 0; p < 11; ++p) acc[k][p] = 0.f;
  }
  // each neighbour row's set of centres is fixed at compile time: R - 1 rows
  // of ramp-up, 2w + 2 - R full rows, R - 1 rows of ramp-down (the launcher
  // refuses R > 2w + 1, where no row would serve every centre)
  ramp_up<R>(std::make_integer_sequence<int, R - 1>{}, base, SW, side, acc, ctr, r2o, r2n);
#pragma unroll 1
  for (int nr = R - 1; nr < side; ++nr)
    row_taps<R, 0, R - 1>(base + nr * SW, side, acc, ctr, r2o, r2n);
  ramp_down<R>(std::make_integer_sequence<int, R - 1>{}, base, SW, side, acc, ctr, r2o, r2n);
  store<R>(acc, out, H, W);
}

template <int R>
int launch_rows(const float* a, const float* b, const float* c, const void* v, int pointmap,
                float* out, int H, int W, int win, float r2o, float r2n,
                cudaStream_t stream) {
  if (R > 2 * win + 1) return (int)cudaErrorInvalidValue;
  const dim3 block(TW * NWARP), grid((W + TW - 1) / TW, (H + NWARP * R - 1) / (NWARP * R));
  if (win == FIXED_WIN) {
    auto kern = window_stats_kernel<FIXED_WIN, R>;
    kern<<<grid, block, 0, stream>>>(a, b, c, v, pointmap, out, H, W, win, r2o, r2n);
  } else {
    auto kern = window_stats_kernel<-1, R>;
    const int smem =
        ((TW + 2 * win) * (NWARP * R + 2 * win) + 1) * (int)sizeof(float4);
    // dynamic shared memory above 48 KB is asked for once per device and
    // size (the attribute belongs to the device's context; past MAX_DEVICES
    // on every launch that needs it): the largest size granted so far
    static int granted[MAX_DEVICES];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    int* have = device < MAX_DEVICES ? &granted[device] : nullptr;
    if (smem > 48 * 1024 && (have == nullptr || smem > *have)) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      if (have != nullptr) *have = smem;
    }
    kern<<<grid, block, smem, stream>>>(a, b, c, v, pointmap, out, H, W, win, r2o, r2n);
  }
  return (int)cudaGetLastError();
}

int launch(const float* a, const float* b, const float* c, const void* v, int pointmap,
           float* out, int H, int W, int win, float r2o, float r2n, int rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // pixel indices are 32-bit, also into the (H, W, 3) point map
  if (H <= 0 || W <= 0 || win < 0 || (long long)H * W * 3 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return launch_rows<1>(a, b, c, v, pointmap, out, H, W, win, r2o, r2n, s);
    case 5: return launch_rows<5>(a, b, c, v, pointmap, out, H, W, win, r2o, r2n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// px, py, pz, vf: (H, W) f32 contiguous on the device, masked by the caller
// (0 where vf = 0); out: (11, H, W).  rows: pixels a thread owns (1 or 5,
// from the host plan ops/stencil.plan), at most 2 * win + 1.  Returns cudaGetLastError().
extern "C" int window_stats_launch(const float* px, const float* py, const float* pz,
                                   const float* vf, float* out, int H, int W, int win,
                                   float outlier_r2, float normal_r2, int rows,
                                   void* stream) {
  return launch(px, py, pz, vf, 0, out, H, W, win, outlier_r2, normal_r2, rows, stream);
}

// pc: the (H, W, 3) f32 point map; valid: (H, W) bool (one byte each), both
// contiguous.  The same function on where(valid, pc, 0) and float(valid).
extern "C" int window_stats_map_launch(const float* pc, const unsigned char* valid, float* out,
                                       int H, int W, int win, float outlier_r2,
                                       float normal_r2, int rows, void* stream) {
  return launch(pc, nullptr, nullptr, valid, 1, out, H, W, win, outlier_r2, normal_r2, rows,
                stream);
}
