// The bf16 mode of the fused decoder kernels, designed for Hopper (sm_90a):
// kernel 1 (forward + d(sdf)/d(xyz), the GN SDF term under the tracker's
// `speed` mode) and kernel 3 (forward only, a lattice decode).
//
// They replace the Pallas TPU kernels difusion_tpu/ops/decoder_fused.py
// `_mlp_grad_kernel` and `_mlp_kernel` with a bf16 w_stack, and compute what
// those compute: the inputs and the weights rounded to bf16 (RNE; the pack
// rounds the folded f32 weights), every product exact and summed in f32 on
// the tensor cores, biases and heads in f32, each hidden activation rounded
// to bf16 after bias and relu, each backward dz rounded to bf16 after its
// relu mask (relu'(0) = 0), and the gradient to the 3 xyz inputs only:
//
//   dz3 = (1 - sdf^2) w_sdf * [h3 > 0]
//   dz2 = (dz3 W3a) * [h2 > 0];  dz1 = (dz2 W2) * [h1 > 0];  dz0 = (dz1 W1) * [h0 > 0]
//   dsdf/dxyz = dz3 W3b[:, xyz] + dz0 W0[:, xyz]
//
// What bounds them on an H100: the tensor cores.  Per point the forward is
// 49,408 multiply-adds and the backward 41,728; at the 989 TFLOP/s bf16
// dense peak kernel 1 at N = 8192 takes 1.51 us and kernel 3 at N = 2^20
// 0.105 ms, against 13.2 us for kernel 3's ~44 MB of inputs and outputs.
// Kernel 1 has one warpgroup an SM at N = 8192 and runs its tile's layers
// one after another: its clock stamps (decoder_tune.py --stamps) give ~40%
// of a tile's cycles to the per-lane epilogues, ~37% to wgmma and ~17% to
// arming the barriers and loading the inputs.
//
// Design.  A warpgroup (4 warps, 128 threads) owns a tile of 64 rows and
// runs every layer of it with wgmma.mma_async m64nNk16 (N = 128, or 96 for
// layer 2 and the backward's W3a), the A operand in registers and B, the
// layer's weights, in shared memory.  The accumulator fragment of a layer
// (lane g = lane / 4, t = lane % 4 of warp w holds rows 16w + g and
// 16w + g + 8 at columns 8j + 2t, +1 of n-tile j) is, after bias and relu,
// converted two values at a time to bf16x2 (cvt.rn.relu.bf16x2.f32) and is
// then the next layer's A fragment as it stands (k-step k takes n-tiles 2k
// and 2k + 1): activations never leave the registers, and a warpgroup needs
// no barrier with any other.  For the backward's relu masks kernel 1 keeps
// each thread's fragments of h0, h1 and h2 in shared memory (h3 is still in
// registers when the backward starts): [h > 0] is one bf16x2 compare
// (set.gt.u32.bf16x2) that masks the rounded dz pair.  The two heads and
// the two xyz row-dots are per-lane partial dots summed over the row's
// quad by shuffles.  A layer's wgmma chain runs
// its whole depth (up to 8 k-steps) in one accumulator: on the H100 this
// agreed with the plain version as closely as adding every 2 k-steps' sums
// with FADDs did, and ran faster.  The chain's first wgmma declares the
// accumulator output-only: while it was read-write, ptxas kept the old
// values live into the chain and serialized kernel 1's wgmma "for want of
// register resources".
//
// Weights resident.  A block copies its weights into shared memory once, one
// TMA bulk copy a matrix, each on its own mbarrier, so kernel 1's layer l
// waits only for matrix l while the later ones land (kernel 1: all seven,
// 176 KB; kernel 3: the forward's four, 96 KB), plus one copy of the f32
// vectors (biases, heads, xyz columns, 5.9 KB).  Kernel 1 starts the
// backward's three copies once the forward's have landed: all 128 blocks
// of a launch read the same bytes from L2 at once, and the backward's
// copies, started with the rest, held layer 3 back.  The pack stores each matrix
// (K x N) K-major in wgmma's canonical layout without swizzle: core matrices
// of 8 columns x 8 k values (16 bytes a column, 128 contiguous bytes, read
// without bank conflicts), the two of a 16-deep k-step 128 bytes apart (the
// descriptor's leading byte offset), neighbouring 8-column groups 256 bytes
// apart (its stride byte offset), one k-step after another (N x 32 bytes
// each): ops/decoder_fused._wgmma_tiles.
//
// Kernel 1: one 64-row tile a block, ceil(N / 64) blocks (128 at the point
// budget of 8192, one wave on 132 SMs).  Clusters of 2 and 4 blocks sharing
// one L2 read of each matrix by TMA multicast ran slower on the H100.
// Kernel 3: persistent, K3_WG warpgroups a block (3 ran faster than 1, 2 or
// 4) and as many blocks as the card holds at once, each warpgroup walking
// the tiles blockIdx * K3_WG + wg + k * gridDim * K3_WG and loading its next
// tile's inputs into registers before it multiplies the current one: the
// weights leave L2 once a block, not once a tile.
//
// Ragged N: rows past n load zeros and store nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decoder_pack.cuh"
#include "mlp_tc.cuh"

namespace {

using namespace decoder_pack;
using namespace mlp_tc;

constexpr int ROWS = 64;       // a warpgroup's tile
constexpr int NMAT = 7;        // f0 f1 f2 f3 (forward), g3 g2 g1 (backward)
constexpr int NFWD = 4;

// matrix l of the stream: K x N, bf16
__host__ __device__ constexpr int mat_k(int l) { return l == 0 ? DIN : (l == 5 ? H2 : HID); }
__host__ __device__ constexpr int mat_n(int l) { return (l == 2 || l == 4) ? H2 : HID; }
__host__ __device__ constexpr int mat_bytes(int l) { return mat_k(l) * mat_n(l) * 2; }
__host__ __device__ constexpr int mat_off(int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += mat_bytes(i);
  return off;
}
static_assert(mat_off(NMAT) == (PACKED_SIZE_BF16 - OFF_TC) * 4,
              "the pack holds the seven matrices");

// the f32 vectors, copied whole: [OFF_W3XYZ, OFF_TC) of the pack
constexpr int VEC_BYTES = (OFF_TC - OFF_W3XYZ) * 4;
constexpr int V_W3XYZ = 0, V_W0XYZ = OFF_W0XYZ - OFF_W3XYZ, V_B0 = OFF_B0 - OFF_W3XYZ,
              V_B1 = OFF_B1 - OFF_W3XYZ, V_B2 = OFF_B2 - OFF_W3XYZ,
              V_B3 = OFF_B3 - OFF_W3XYZ, V_WSDF = OFF_WSDF - OFF_W3XYZ,
              V_WSTD = OFF_WSTD - OFF_W3XYZ, V_BHEAD = OFF_BHEAD - OFF_W3XYZ;
static_assert(VEC_BYTES % 16 == 0, "a bulk copy moves 16-byte units");

// kernel 1 keeps each thread's fragments of h0, h1 and h2 (8 + 8 + 6
// k-steps of 16 bytes) for the backward's relu masks
constexpr int H_STEPS = 8 + 8 + 6;
constexpr int H_BYTES = 128 * H_STEPS * 16;   // a warpgroup's 128 threads

// shared memory: the first NM matrices, the vectors, (kernel 1) the kept
// activations, one mbarrier a matrix
template <int NM>
__host__ __device__ constexpr int smem_bytes() {
  return mat_off(NM) + VEC_BYTES + (NM == NMAT ? H_BYTES : 0) + NM * (int)sizeof(uint64_t);
}

// ---- wgmma ----

// wgmma's shared-memory descriptor of a K-major B operand without swizzle
// (layout type 0, base offset 0): start address, leading byte offset 128 (the
// two core matrices of a k-step), stride byte offset 256 (8-column groups),
// all in 16-byte units
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from reading the accumulators before the wgmma that
// writes them asynchronously has completed
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0, 64) (64 x 128) = a (64 x 16, registers) . B (16 x 128, shared memory
// at `desc`): d's earlier values are not read
__device__ __forceinline__ void wgmma_128_init(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),
        "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// d[0, 64) (64 x 128) += a (64 x 16, registers) . B (16 x 128, shared memory
// at `desc`)
__device__ __forceinline__ void wgmma_128_acc(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[0, 48) (64 x 96) = a (64 x 16, registers) . B (16 x 96, shared memory
// at `desc`): d's earlier values are not read
__device__ __forceinline__ void wgmma_96_init(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// d[0, 48) (64 x 96) += a (64 x 16, registers) . B (16 x 96, shared memory
// at `desc`)
__device__ __forceinline__ void wgmma_96_acc(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[0, N / 2) = A . W for the warpgroup's 64 rows: A (64 x 16 KS) in the
// first KS k-steps of `a` (registers), W (16 KS x N) at shared-memory address
// w in the pack's layout
template <int N, int KS, int KA>
__device__ __forceinline__ void gemm(float (&d)[64], const uint32_t (&a)[KA][4], uint32_t w) {
  static_assert((N == 128 || N == 96) && KS <= KA, "layers are 128 or 96 wide");
  wg_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint64_t desc = b_desc(w + s * N * 32);
    if constexpr (N == 128) {
      if (s == 0) wgmma_128_init(d, a[s], desc);
      else wgmma_128_acc(d, a[s], desc);
    } else {
      if (s == 0) wgmma_96_init(d, a[s], desc);
      else wgmma_96_acc(d, a[s], desc);
    }
  }
  wg_commit();
  wg_wait();
  reg_fence(d);
}

// ---- per-lane epilogues.  Accumulator d[4j + e]: row g + 8 (e >> 1),
// column 8j + 2t + (e & 1).  A fragment a[k][q] = (d[8k + 2q], d[8k + 2q + 1]):
// row g + 8 (q & 1), columns 16k + 8 (q >> 1) + 2t, +1. ----

// two f32 -> bf16x2 (lo in the low half), round to nearest even; the relu
// form takes max(., 0) first
__device__ __forceinline__ uint32_t cvt_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ uint32_t cvt_relu_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// 0xffff in each half of a bf16x2 that is > 0, else 0
__device__ __forceinline__ uint32_t positive(uint32_t h) {
  uint32_t m;
  asm("set.gt.u32.bf16x2 %0, %1, %2;\n" : "=r"(m) : "r"(h), "r"(0u));
  return m;
}
__device__ __forceinline__ float lo_f32(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float hi_f32(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// the first R accumulators -> a = bf16(relu(d + b)), the next layer's A
// fragment
template <int R>
__device__ __forceinline__ void bias_relu(const float (&d)[64], const float* b, int t,
                                          uint32_t (&a)[8][4]) {
#pragma unroll
  for (int k = 0; k < R / 8; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 8 * k + 2 * q;
      const float2 bb = *reinterpret_cast<const float2*>(b + 8 * (i >> 2) + 2 * t);
      a[k][q] = cvt_relu_bf16x2(d[i] + bb.x, d[i + 1] + bb.y);
    }
}

// the first R accumulators -> a = bf16(d) * [h > 0]: h(k) gives k-step k of
// the forward activations h as A fragments (read before a[k] is written)
template <int R, class H>
__device__ __forceinline__ void mask_round(const float (&d)[64], H h, uint32_t (&a)[8][4]) {
#pragma unroll
  for (int k = 0; k < R / 8; ++k) {
    const uint4 hk = h(k);
    const uint32_t hq[4] = {hk.x, hk.y, hk.z, hk.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[k][q] = cvt_bf16x2(d[8 * k + 2 * q], d[8 * k + 2 * q + 1]) & positive(hq[q]);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows g and g + 8 of h . u and h . v: h 128 bf16 activations as A
// fragments, u and v 128 f32; summed over the row's quad.  Each of the four
// registers q of a k-step sums apart (four short FMA chains, not two long
// ones); q and q + 2 hold the same row.
__device__ __forceinline__ float4 row_dots(const uint32_t (&a)[8][4], const float* u,
                                           const float* v, int t) {
  float su[4] = {0.f, 0.f, 0.f, 0.f}, sv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 16 * k + 8 * (q >> 1) + 2 * t;
      const float2 uu = *reinterpret_cast<const float2*>(u + c);
      const float2 vv = *reinterpret_cast<const float2*>(v + c);
      const float lo = lo_f32(a[k][q]), hi = hi_f32(a[k][q]);
      su[q] = fmaf(hi, uu.y, fmaf(lo, uu.x, su[q]));
      sv[q] = fmaf(hi, vv.y, fmaf(lo, vv.x, sv[q]));
    }
  return make_float4(quad_sum(su[0] + su[2]), quad_sum(su[1] + su[3]),
                     quad_sum(sv[0] + sv[2]), quad_sum(sv[1] + sv[3]));
}

// rows g and g + 8 of h . w for w (128, 3) f32: out[3r + x]; register q of
// each k-step sums apart, as in row_dots
__device__ __forceinline__ void xyz_dot(const uint32_t (&a)[8][4], const float* w, int t,
                                        float (&out)[6]) {
  float o[4][3] = {};
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // columns c, c + 1 (c even): w[3c .. 3c + 5], three 8-byte loads
      const float2* wc = reinterpret_cast<const float2*>(w + 3 * (16 * k + 8 * (q >> 1) + 2 * t));
      const float2 w0 = wc[0], w1 = wc[1], w2 = wc[2];
      const float lo = lo_f32(a[k][q]), hi = hi_f32(a[k][q]);
      o[q][0] = fmaf(hi, w1.y, fmaf(lo, w0.x, o[q][0]));
      o[q][1] = fmaf(hi, w2.x, fmaf(lo, w0.y, o[q][1]));
      o[q][2] = fmaf(hi, w2.y, fmaf(lo, w1.x, o[q][2]));
    }
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    out[x] = quad_sum(o[0][x] + o[2][x]);
    out[3 + x] = quad_sum(o[1][x] + o[3][x]);
  }
}

// the lane's inputs (rows ra and ra + 8, zeros past n) at its A fragment's
// columns: v[8s + 2q + h] is k-step s, register q, half h
__device__ __forceinline__ void load_x(const float* __restrict__ latent,
                                       const float* __restrict__ rel, int ra, int n, int t,
                                       float (&v)[16]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ra + 8 * (q & 1), col = 16 * s + 8 * (q >> 1) + 2 * t + h;
        float x = 0.f;
        if (row < n)
          x = col < LAT ? __ldg(latent + (size_t)row * LAT + col)
                        : __ldg(rel + (size_t)row * 3 + col - LAT);
        v[8 * s + 2 * q + h] = x;
      }
}

__device__ __forceinline__ void pack_x(const float (&v)[16], uint32_t (&xa)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) xa[s][q] = cvt_bf16x2(v[8 * s + 2 * q], v[8 * s + 2 * q + 1]);
}

// TMA bulk copy of matrix l of the pack into shared memory, on its mbarrier
__device__ __forceinline__ void copy_matrix(uint8_t* smem, uint64_t* bars,
                                            const float* __restrict__ P, int l) {
  bulk_copy(smem + mat_off(l), reinterpret_cast<const uint8_t*>(P + OFF_TC) + mat_off(l),
            mat_bytes(l), bars + l);
}

// Thread 0 arms one mbarrier for each of the first NM matrices (barrier 0
// also for the f32 vectors) and copies the vectors and the first NCOPY
// matrices; the block passes a barrier before any thread waits on them.
template <int NM, int NCOPY>
__device__ __forceinline__ void arm_weights(uint8_t* smem, uint64_t* bars,
                                            const float* __restrict__ P) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < NM; ++l) mbar_init(bars + l, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bars, mat_bytes(0) + VEC_BYTES);
#pragma unroll
    for (int l = 1; l < NM; ++l) mbar_arrive_expect_tx(bars + l, mat_bytes(l));
    bulk_copy(smem + mat_off(NM), P + OFF_W3XYZ, VEC_BYTES, bars);
#pragma unroll
    for (int l = 0; l < NCOPY; ++l) copy_matrix(smem, bars, P, l);
  }
}

// k-steps [0, KS) of a -> kept k-steps [S0, S0 + KS)
template <int S0, int KS>
__device__ __forceinline__ void keep(uint4* kept, const uint32_t (&a)[8][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
    kept[(S0 + k) * 128] = make_uint4(a[k][0], a[k][1], a[k][2], a[k][3]);
}

// One 64-row tile through the decoder on one warpgroup: sdf, std and (GRAD)
// the xyz gradient of rows ra and rb = ra + 8 of each lane.  xa: the inputs'
// A fragments; smem: the weights, then the f32 vectors `vec`.  Kernel 1
// (GRAD) waits for each matrix before its layer (kernel 3 has waited for
// all of them) and keeps the thread's fragments of h0, h1 and h2 after the
// vectors, k-step s at uint4 s * 128 + threadIdx.x (a warp's 16-byte
// stores contiguous).
template <bool GRAD>
__device__ __forceinline__ void tile(const uint32_t (&xa)[2][4], uint8_t* smem,
                                     const float* __restrict__ P, const float* vec,
                                     uint64_t* bars, int ra, int n, int t,
                                     float* __restrict__ sdf_out, float* __restrict__ std_out,
                                     float* __restrict__ grad_out) {
  const uint32_t w = smem_addr(smem);
  float d[64];
  uint32_t a[8][4];
  auto wait = [&](int l) {
    if constexpr (GRAD) mbar_wait(bars + l, 0);
  };
  uint4* kept = reinterpret_cast<uint4*>(smem + mat_off(NMAT) + VEC_BYTES) + threadIdx.x;
  auto from_kept = [=](int s0) { return [=](int k) { return kept[(s0 + k) * 128]; }; };
  // h3 is still in a when the backward starts
  auto h3 = [&](int k) { return make_uint4(a[k][0], a[k][1], a[k][2], a[k][3]); };

  wait(0);
  gemm<HID, 2>(d, xa, w + mat_off(0));                        // layer 0: x -> 128
  bias_relu<64>(d, vec + V_B0, t, a);
  if constexpr (GRAD) keep<0, 8>(kept, a);
  wait(1);
  gemm<HID, 8>(d, a, w + mat_off(1));                         // layer 1
  bias_relu<64>(d, vec + V_B1, t, a);
  if constexpr (GRAD) keep<8, 8>(kept, a);
  wait(2);
  gemm<H2, 8>(d, a, w + mat_off(2));                          // layer 2: 128 -> 96
  bias_relu<48>(d, vec + V_B2, t, a);
  if constexpr (GRAD) keep<16, 6>(kept, a);
#pragma unroll
  for (int q = 0; q < 4; ++q) {                               // layer 3's input [h2 | x]
    a[6][q] = xa[0][q];
    a[7][q] = xa[1][q];
  }
  wait(3);
  if constexpr (GRAD) {     // the backward's matrices once the forward's have landed
    if (threadIdx.x == 0) {
#pragma unroll
      for (int l = NFWD; l < NMAT; ++l) copy_matrix(smem, bars, P, l);
    }
  }
  gemm<HID, 8>(d, a, w + mat_off(3));                         // layer 3
  bias_relu<64>(d, vec + V_B3, t, a);

  // heads: sdf = tanh(h3 . w_sdf + b), std = 0.05 + 0.5 softplus(h3 . w_std + b);
  // lane t of a quad stores (t & 2 ? std : sdf) of row (t & 1 ? rb : ra)
  const float4 z = row_dots(a, vec + V_WSDF, vec + V_WSTD, t);   // (sdf a, b, std a, b)
  const float sa = tanhf(z.x + vec[V_BHEAD]), sb = tanhf(z.y + vec[V_BHEAD]);
  const int rb = ra + 8, row = (t & 1) ? rb : ra;
  {
    const float zd = ((t & 1) ? z.w : z.z) + vec[V_BHEAD + 1];
    const float sd = 0.05f + 0.5f * (fmaxf(zd, 0.f) + log1pf(expf(-fabsf(zd))));
    if (row < n) ((t & 2) ? std_out : sdf_out)[row] = (t & 2) ? sd : ((t & 1) ? sb : sa);
  }
  if constexpr (GRAD) {
    // ---- backward (sdf only) ----
#pragma unroll
    for (int j = 0; j < 16; ++j) {                            // dz3 before its mask
      const float2 ws = *reinterpret_cast<const float2*>(vec + V_WSDF + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = (e >> 1) ? sb : sa;
        d[4 * j + e] = (1.f - s * s) * ((e & 1) ? ws.y : ws.x);
      }
    }
    mask_round<64>(d, h3, a);
    float gx[6], g0[6];
    xyz_dot(a, vec + V_W3XYZ, t, gx);                         // dz3 . W3b[:, xyz]
    wait(4);
    gemm<H2, 8>(d, a, w + mat_off(4));                        // dh2 = dz3 W3a
    mask_round<48>(d, from_kept(16), a);
    wait(5);
    gemm<HID, 6>(d, a, w + mat_off(5));                       // dh1 = dz2 W2
    mask_round<64>(d, from_kept(8), a);
    wait(6);
    gemm<HID, 8>(d, a, w + mat_off(6));                       // dh0 = dz1 W1
    mask_round<64>(d, from_kept(0), a);
    xyz_dot(a, vec + V_W0XYZ, t, g0);                         // dz0 . W0[:, xyz]
    // lanes t < 3 of a quad store column t of both rows
    const float ga = t == 0 ? gx[0] + g0[0] : (t == 1 ? gx[1] + g0[1] : gx[2] + g0[2]);
    const float gb = t == 0 ? gx[3] + g0[3] : (t == 1 ? gx[4] + g0[4] : gx[5] + g0[5]);
    if (t < 3 && ra < n) grad_out[(size_t)ra * 3 + t] = ga;
    if (t < 3 && rb < n) grad_out[(size_t)rb * 3 + t] = gb;
  }
}

// Kernel 1: one 64-row tile a block of one warpgroup.
__global__ void __launch_bounds__(128, 1)
decode_grad_bf16_kernel(const float* __restrict__ latent, const float* __restrict__ rel,
                        const float* __restrict__ P, float* __restrict__ sdf_out,
                        float* __restrict__ std_out, float* __restrict__ grad_out, int n) {
  extern __shared__ __align__(128) uint8_t smem[];
  const float* vec = reinterpret_cast<const float*>(smem + mat_off(NMAT));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + mat_off(NMAT) + VEC_BYTES + H_BYTES);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ra = blockIdx.x * ROWS + 16 * warp + (lane >> 2), t = lane & 3;
  float v[16];
  uint32_t xa[2][4];
  arm_weights<NMAT, NFWD>(smem, bars, P);
  load_x(latent, rel, ra, n, t, v);
  __syncthreads();
  pack_x(v, xa);
  tile<true>(xa, smem, P, vec, bars, ra, n, t, sdf_out, std_out, grad_out);
}

// Kernel 3: persistent, WG warpgroups a block, each walking its tiles.
template <int WG>
__global__ void __launch_bounds__(WG * 128, 1)
decode_fwd_bf16_kernel(const float* __restrict__ latent, const float* __restrict__ rel,
                       const float* __restrict__ P, float* __restrict__ sdf_out,
                       float* __restrict__ std_out, int n) {
  extern __shared__ __align__(128) uint8_t smem[];
  const float* vec = reinterpret_cast<const float*>(smem + mat_off(NFWD));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + mat_off(NFWD) + VEC_BYTES);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int t = lane & 3, r0 = 16 * warp + (lane >> 2);
  const int tiles = (n + ROWS - 1) / ROWS, stride = gridDim.x * WG;
  int tl = blockIdx.x * WG + wg;
  float v[16];
  arm_weights<NFWD, NFWD>(smem, bars, P);
  if (tl < tiles) load_x(latent, rel, tl * ROWS + r0, n, t, v);
  __syncthreads();
#pragma unroll 1
  for (int l = 0; l < NFWD; ++l) mbar_wait(bars + l, 0);
#pragma unroll 1
  for (; tl < tiles; tl += stride) {
    uint32_t xa[2][4];
    pack_x(v, xa);
    if (tl + stride < tiles) load_x(latent, rel, (tl + stride) * ROWS + r0, n, t, v);
    tile<false>(xa, smem, P, vec, bars, tl * ROWS + r0, n, t, sdf_out, std_out, nullptr);
  }
}

constexpr int K3_WG = 3;   // 150 registers a thread: one block of 384 threads an SM
static_assert(smem_bytes<NMAT>() <= 232448 && smem_bytes<NFWD>() <= 232448,
              "a block has 227 KB of shared memory");

constexpr int MAX_DEVICES = 64;

// per device: the dynamic shared-memory attribute set (it belongs to the
// device's context) and the blocks the card holds at once
struct DeviceSetup {
  bool done;
  int resident_blocks;
};

template <typename Kernel>
int setup(Kernel kernel, DeviceSetup (&cache)[MAX_DEVICES], int smem, int threads,
          DeviceSetup& out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < MAX_DEVICES && cache[device].done) {
    out = cache[device];
    return 0;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out = {true, sms * (per_sm > 0 ? per_sm : 1)};
  if (device < MAX_DEVICES) cache[device] = out;
  return 0;
}

DeviceSetup grad_cache[MAX_DEVICES] = {}, fwd_cache[MAX_DEVICES] = {};

// kernel 3's blocks at n rows: min(tiles / K3_WG, the blocks the card holds
// at once).  Returns 0 or a CUDA error.
int fwd_blocks(int n, int& grid) {
  DeviceSetup s = {};
  const int err =
      setup(decode_fwd_bf16_kernel<K3_WG>, fwd_cache, smem_bytes<NFWD>(), K3_WG * 128, s);
  grid = ((n + ROWS - 1) / ROWS + K3_WG - 1) / K3_WG;
  if (grid > s.resident_blocks) grid = s.resident_blocks;
  return err;
}

}  // namespace

extern "C" int decode_bf16_packed_size() { return PACKED_SIZE_BF16; }

// Kernel 1's bf16 mode: latent (n, 29), rel (n, 3), packed
// (PACKED_SIZE_BF16,) f32 contiguous and 16-byte aligned on the device;
// writes sdf (n,), std (n,), grad (n, 3).  Returns cudaGetLastError().
extern "C" int decode_grad_bf16_launch(const float* latent, const float* rel,
                                       const float* packed, float* sdf, float* std_,
                                       float* grad, int n, void* stream) {
  DeviceSetup s = {};
  const int err = setup(decode_grad_bf16_kernel, grad_cache, smem_bytes<NMAT>(), 128, s);
  if (err) return err;
  decode_grad_bf16_kernel<<<(n + ROWS - 1) / ROWS, 128, smem_bytes<NMAT>(),
                            (cudaStream_t)stream>>>(latent, rel, packed, sdf, std_, grad, n);
  return (int)cudaGetLastError();
}

// Kernel 3's bf16 mode: as kernel 1's, without grad.
extern "C" int decode_fwd_bf16_launch(const float* latent, const float* rel,
                                      const float* packed, float* sdf, float* std_, int n,
                                      void* stream) {
  int grid = 0;
  const int err = fwd_blocks(n, grid);
  if (err) return err;
  decode_fwd_bf16_kernel<K3_WG><<<grid, K3_WG * 128, smem_bytes<NFWD>(),
                                  (cudaStream_t)stream>>>(latent, rel, packed, sdf, std_, n);
  return (int)cudaGetLastError();
}
