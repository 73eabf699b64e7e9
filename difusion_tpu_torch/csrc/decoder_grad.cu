// Fused decoder kernels on Hopper's tensor cores (3xTF32, f32 accumulation),
// sm_90a: kernel 1 (forward + d(sdf)/d(xyz), for the GN SDF term) and
// kernel 3 (forward only, for the mesher's lattice decode).  Both read the
// same packed weights and share the warp-level machinery of mlp_tc.cuh.
//
// Kernel 1 replaces the Pallas TPU kernel difusion_tpu/ops/decoder_fused.py
// `_mlp_grad_kernel` (reached through `decode_grad_fused_packed`); kernel 3
// replaces `_mlp_kernel` (`decode_fused_packed`).  Per point they run the
// probabilistic-SDF decoder (5 linears, latent re-injection at layer 3, tanh
// sdf head, std = 0.05 + 0.5 softplus read from the last hidden layer);
// kernel 1 then backpropagates the sdf ONLY to the 3 xyz inputs (the latent
// is stop-gradiented; relu'(0) = 0):
//
//   dz3 = (1 - sdf^2) w_sdf * [h3 > 0]
//   dz2 = (dz3 W3a) * [h2 > 0];  dz1 = (dz2 W2) * [h1 > 0];  dz0 = (dz1 W1) * [h0 > 0]
//   dsdf/dxyz = dz3 W3b[:, xyz] + dz0 W0[:, xyz]
//
// What bounds them on an H100: arithmetic.  Per point the forward is 49,408
// multiply-adds and the backward 41,728.  Kernel 1 at N = 8192 is 1.49 GFLOP
// against ~2 MB of bytes; kernel 3 at N = 2^20 is 103.6 GFLOP against
// ~140 MB.  3xTF32 triples the tensor-core work, so at the card's 495 TFLOP/s
// TF32 dense peak (H100 SXM, 700 W) the bounds are 9.0 us and 0.63 ms, 2.5x
// below the f32 SIMT bounds (67 TFLOP/s: 22.3 us and 1.55 ms).
//
// Design (mlp_tc.cuh has the fragment algebra).  The block's rows live in
// shared memory, [rows][136] f32; a layer is a chain of m16n8k8 tf32 mma over
// 8-wide k-tiles, three per (m-tile, k-tile, n-tile).  The warps of a block
// split every layer's output columns into 4 parts of 32 and its rows into
// groups of 16 MT (MT m-tiles: 1 for kernel 1, 2 for kernel 3), so a warp's
// accumulator is 16 MT x 32 and one 16-byte load of a B fragment feeds 3 MT
// mma.  Bias, relu and the relu-mask bits (for the backward, which walks the
// same tiling) act on the accumulator fragments in place; between two
// barriers (the other parts' warps read the same rows) the output overwrites
// the rows.  The two 1-wide heads and the two xyz row-dots are per-lane
// partial dots reduced over the 4 lanes of a row quad by shuffles, and over
// the 4 column parts through shared memory.
//
// Weights stream in layer order (f0 f1 f2 f3, then g3 g2 g1 for kernel 1) in
// chunks of 4 k-tiles (32 KB at N = 128) through a ring of shared-memory
// slots, each chunk one TMA bulk copy that thread 0 issues RING - 1 chunks
// ahead; per-slot mbarriers (full, empty) let each warp run on as soon as
// its data is there, so the warps drift apart and one warp's shared-memory
// loads overlap another's mma, and layer l+1's weights arrive while layer l
// multiplies.  Every 2 k-tiles the mma partials, summed from zero, join the
// f32 accumulator with a rounded FADD (mlp_tc.cuh says why).
//
// The bf16 mode (the JAX package's bf16 w_stack) has kernels of its own,
// designed for Hopper in decoder_bf16.cu.
//
// Designs tried on the H100 and dropped: a warp carrying 16 full rows in
// registers from layer to layer spilled past 255 registers; a cp.async ring
// with a __syncthreads per k-tile held all warps in step, so their
// shared-memory loads and their mma ran one after the other, not overlapped.
//
// Rows per block.  Each block reads every weight chunk once from L2 (hi and
// lo: 704 KB for kernel 1, 384 KB for kernel 3's forward), so more rows per
// block mean less L2 traffic but fewer blocks.  Kernel 1: 16 warps (4 row
// groups x 4 parts), 64 rows, 128 blocks at N = 8192 on 132 SMs (90 MB of L2
// reads); 32 rows would double that traffic for blocks the SMs cannot hold
// at once.  Kernel 3: 12 warps (3 row groups of 32 x 4 parts), 96 rows
// (4.2 GB of L2 reads per 2^20 sites): with 16 warps of 32 rows the 128
// registers a thread of a 512-thread block spilled.
//
// Shared memory (of 227 KB a block): the ring (5 slots of 32 KB for kernel 1,
// 4 for kernel 3), then per row the inputs (40 f32), the activations (136
// f32) and the 4 parts' head partials (and for kernel 1 their xyz row-dots),
// kernel 1's parked masks and the ring's mbarriers: 223,312 B for kernel 1,
// 201,792 B for kernel 3.  Row strides of 8 mod 32 floats put the 8-byte
// fragment loads and stores of a half-warp on distinct banks.  Ragged N:
// rows past n load zeros and store nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decoder_pack.cuh"
#include "mlp_tc.cuh"

namespace {

using namespace decoder_pack;
using namespace mlp_tc;

constexpr int LDX = 40;     // input row stride (floats)
constexpr int LDA = 136;    // activation row stride (floats)
constexpr int KC = 4;       // weight k-tiles a ring slot holds
constexpr int FLUSH = 2;    // k-tiles summed on the tensor cores between FADDs
constexpr int SLOT = KC * (HID / 8) * 32;  // float4s a slot holds: 32 KB

// chunks of KC k-tiles in the stream: every layer's depth is a multiple of
// 8 KC, so no chunk straddles two layers
constexpr int CHUNKS_FWD = (DIN + HID + HID + HID) / (8 * KC);  // 13
constexpr int CHUNKS_ALL = CHUNKS_FWD + (HID + H2 + HID) / (8 * KC);  // 24
static_assert(DIN % (8 * KC) == 0 && H2 % (8 * KC) == 0, "chunks must not straddle layers");

// chunk j of the stream: offset and size (float4s) in the fragment segment
struct DecoderSpan {
  __device__ static __forceinline__ void span(int j, int& off, int& cnt) {
    const int chunks[7] = {DIN / (8 * KC), HID / (8 * KC), HID / (8 * KC), HID / (8 * KC),
                           HID / (8 * KC), H2 / (8 * KC), HID / (8 * KC)};
    const int ns[7] = {HID, HID, H2, HID, H2, HID, HID};
    off = 0;
    cnt = 0;
    bool found = false;
#pragma unroll
    for (int l = 0; l < 7; ++l) {
      const int c = KC * ns[l] * 4;  // KC k-tiles x (N/8 n-tiles) x 32 lanes x 1 float4
      if (!found) {
        if (j < chunks[l]) {
          off += j * c;
          cnt = c;
          found = true;
        } else {
          j -= chunks[l];
          off += chunks[l] * c;
        }
      }
    }
  }
};

__device__ __forceinline__ float2 ldg2(const float* v, int i) {
  return __ldg(reinterpret_cast<const float2*>(v) + i);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// this lane's A values of k-tile kt of a [.][LD] row buffer for the warp's
// MT m-tiles: p0 points at row g, col 2t of m-tile 0 (m-tile m is 16 m rows
// on; each holds rows g, g+8 at cols 8kt + 2t, +1)
template <int LD, int MT>
__device__ __forceinline__ void load_frag(const float* p0, int kt, float (&a)[MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* p = p0 + 16 * m * LD + 8 * kt;
    const float2 r0 = *reinterpret_cast<const float2*>(p);
    const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * LD);
    a[m][0] = r0.x;
    a[m][1] = r0.y;
    a[m][2] = r1.x;
    a[m][3] = r1.y;
  }
}

// the warp's output fragments (n-tiles nb ..) -> the block's activation rows,
// between two barriers: every warp has read the layer's input before (the
// rows are shared with the warps that hold the other column parts), and
// every warp sees the whole output after
template <int MT, int NTN>
__device__ __forceinline__ void sync_store(const float (&z)[MT][4][4], float* p0, int nb) {
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      float* p = p0 + 16 * m * LDA + 8 * (nb + nt);
      *reinterpret_cast<float2*>(p) = make_float2(z[m][nt][0], z[m][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * LDA) = make_float2(z[m][nt][2], z[m][nt][3]);
    }
  __syncthreads();
}

// z += KT k-tiles of a [.][LD] row buffer times the next KT weight k-tiles of
// a layer with NT_ALL n-tiles, on the warp's NTN n-tiles from nb, a chunk of
// KC k-tiles at a time.  Every FLUSH k-tiles' partial sums start from zero on
// the tensor cores and join z with a rounded FADD (mlp_tc.cuh).
template <int KT, int NTN, int NT_ALL, int LD, int MT, class Ring>
__device__ __forceinline__ void gemm(float (&z)[MT][4][4], const float* p0, int nb,
                                     Ring& ring, int& it, int lane) {
  static_assert(KT % KC == 0 && KC % FLUSH == 0, "a layer takes whole chunks");
#pragma unroll 1
  for (int kc = 0; kc < KT; kc += KC) {
    const float4* w = ring.acquire(it) + 32 * nb;
#pragma unroll
    for (int k2 = 0; k2 < KC; k2 += FLUSH) {
      float c[MT][4][4];
      zero<MT, NTN>(c);
#pragma unroll
      for (int kk = k2; kk < k2 + FLUSH; ++kk) {
        float a[MT][4];
        load_frag<LD, MT>(p0, kc + kk, a);
        ktile_mma<MT, NTN>(c, a, w + kk * NT_ALL * 32, lane);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) z[m][nt][e] += c[m][nt][e];
    }
    ring.release(it++);
  }
}

// z = relu(z + b) in place; returns the [z > 0] bits, bit 4 (4m + nt) + e
template <int MT, int NTN>
__device__ __forceinline__ uint32_t bias_relu(float (&z)[MT][4][4],
                                              const float* __restrict__ bias, int nb,
                                              int t) {
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    const float2 b = ldg2(bias, 4 * (nb + nt) + t);  // cols 8(nb+nt) + 2t, +1
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = z[m][nt][e] + ((e & 1) ? b.y : b.x);
        const float r = v > 0.f ? v : 0.f;
        const bool on = r > 0.f;
        z[m][nt][e] = r;
        bits |= (uint32_t)on << (4 * (4 * m + nt) + e);
      }
  }
  return bits;
}

// z *= [h > 0] in place
template <int MT, int NTN>
__device__ __forceinline__ void relu_grad(float (&z)[MT][4][4], uint32_t bits) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!((bits >> (4 * (4 * m + nt) + e)) & 1u)) z[m][nt][e] = 0.f;
}

// the warp's part (its 32 columns from n-tile nb) of d[row] . w[:, j] for
// w (128, 3), for its 2 MT rows a lane (m-tile m, row g + 8r), reduced over
// the row quad, into out[(2m + r) * 3 + j]
template <int MT>
__device__ __forceinline__ void part_dot3(const float (&d)[MT][4][4],
                                          const float* __restrict__ w, int nb, int t,
                                          float (&out)[6 * MT]) {
#pragma unroll
  for (int q = 0; q < 6 * MT; ++q) out[q] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * (nb + nt) + 2 * t + e;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float wj = __ldg(w + 3 * c + j);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            out[(2 * m + r) * 3 + j] = fmaf(d[m][nt][2 * r + e], wj, out[(2 * m + r) * 3 + j]);
      }
    }
#pragma unroll
  for (int q = 0; q < 6 * MT; ++q) out[q] = quad_sum(out[q]);
}

constexpr int PARTS = 4;   // column parts of every layer, one warp each

// floats per row per column part exchanged between the warps of a row group:
// the heads' two partial dots, then (kernel 1) the two xyz row-dots
template <bool GRAD>
__host__ __device__ constexpr int exch_floats() { return GRAD ? 2 + 6 : 2; }

// kernel 1 parks the relu masks of h0, h1 and h2 in shared memory, one word
// per thread each, from the forward until the backward needs them: in
// registers they pushed it past the 128 a thread of a 512-thread block and
// into spills

template <int WARPS, int MT>
__host__ __device__ constexpr int block_rows() { return WARPS / PARTS * 16 * MT; }

template <int WARPS, int MT, bool GRAD, int RING>
__host__ __device__ constexpr int smem_bytes() {
  return RING * SLOT * 16 +
         block_rows<WARPS, MT>() * (LDX + LDA + PARTS * exch_floats<GRAD>()) *
             (int)sizeof(float) +
         (GRAD ? 3 * WARPS * 32 * (int)sizeof(uint32_t) : 0) +
         2 * RING * (int)sizeof(uint64_t);
}

template <int WARPS, int MT, bool GRAD, int RING>
__device__ __forceinline__ void decoder_body(
    const float* __restrict__ latent, const float* __restrict__ rel,
    const float* __restrict__ P, float* __restrict__ sdf_out,
    float* __restrict__ std_out, float* __restrict__ grad_out, int n) {
  constexpr int NTHR = WARPS * 32, BM = block_rows<WARPS, MT>();
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4 + RING * SLOT);   // inputs [BM][LDX]
  float* acts = xs + BM * LDX;                                 // activations [BM][LDA]
  float2* head_x = reinterpret_cast<float2*>(acts + BM * LDA); // [part][BM] (zs, zd)
  float* grad_x = reinterpret_cast<float*>(head_x + PARTS * BM);  // [part][BM][6]
  uint32_t* park = reinterpret_cast<uint32_t*>(grad_x + (GRAD ? PARTS * BM * 6 : 0));  // [3][NTHR]
  uint64_t* bars = reinterpret_cast<uint64_t*>(park + (GRAD ? 3 * NTHR : 0));  // [2][RING]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int part = warp % PARTS;                  // column part of every layer
  const int r0 = warp / PARTS * 16 * MT + g;      // the lane's first row in the block
  const int n0 = blockIdx.x * BM;

  WeightRing<GRAD ? CHUNKS_ALL : CHUNKS_FWD, RING, SLOT, WARPS, DecoderSpan> ring{
      smem4, reinterpret_cast<const float4*>(P + OFF_TC), bars, bars + RING, tid};
  ring.init();
  ring.start();
  for (int idx = tid; idx < BM * DIN; idx += NTHR) {
    const int r = idx / DIN, k = idx % DIN, gr = n0 + r;
    float v = 0.f;
    if (gr < n) v = k < LAT ? latent[(size_t)gr * LAT + k] : rel[(size_t)gr * 3 + k - LAT];
    xs[r * LDX + k] = v;
  }
  __syncthreads();  // the inputs and the ring's barriers are ready
  const float* x0 = xs + r0 * LDX + 2 * t;
  float* a0 = acts + r0 * LDA + 2 * t;
  // the warp's first n-tile at N = 128 and at N = 96
  const int nb = part * (HID / 8 / PARTS), nb2 = part * (H2 / 8 / PARTS);
  constexpr int NQ = HID / 8 / PARTS, NQ2 = H2 / 8 / PARTS;   // 4 and 3 n-tiles a warp

  float z[MT][4][4];
  int it = 0;

  // ---- forward ----
  zero<MT, NQ>(z);
  gemm<DIN / 8, NQ, HID / 8, LDX, MT>(z, x0, nb, ring, it, lane);    // layer 0: x -> 128
  const uint32_t m0 = bias_relu<MT, NQ>(z, P + OFF_B0, nb, t);
  if constexpr (GRAD) park[tid] = m0;
  sync_store<MT, NQ>(z, a0, nb);

  zero<MT, NQ>(z);
  gemm<HID / 8, NQ, HID / 8, LDA, MT>(z, a0, nb, ring, it, lane);    // layer 1
  const uint32_t m1 = bias_relu<MT, NQ>(z, P + OFF_B1, nb, t);
  if constexpr (GRAD) park[NTHR + tid] = m1;
  sync_store<MT, NQ>(z, a0, nb);

  zero<MT, NQ2>(z);
  gemm<HID / 8, NQ2, H2 / 8, LDA, MT>(z, a0, nb2, ring, it, lane);   // layer 2: 128 -> 96
  const uint32_t m2 = bias_relu<MT, NQ2>(z, P + OFF_B2, nb2, t);
  if constexpr (GRAD) park[2 * NTHR + tid] = m2;
  sync_store<MT, NQ2>(z, a0, nb2);

  zero<MT, NQ>(z);
  gemm<H2 / 8, NQ, HID / 8, LDA, MT>(z, a0, nb, ring, it, lane);     // layer 3: [h2 | x]
  gemm<DIN / 8, NQ, HID / 8, LDX, MT>(z, x0, nb, ring, it, lane);
  const uint32_t m3 = bias_relu<MT, NQ>(z, P + OFF_B3, nb, t);

  // heads: sdf = tanh(h3 . w_sdf + b), std = 0.05 + 0.5 softplus(h3 . w_std + b),
  // each dot the sum of the column parts' dots, in part order
  float zs[2 * MT], zd[2 * MT];   // [2m + r]
#pragma unroll
  for (int q = 0; q < 2 * MT; ++q) zs[q] = zd[q] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt) {
    const float2 ws = ldg2(P + OFF_WSDF, 4 * (nb + nt) + t);
    const float2 wd = ldg2(P + OFF_WSTD, 4 * (nb + nt) + t);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = 2 * m + r;
        zs[q] = fmaf(z[m][nt][2 * r + 1], ws.y, fmaf(z[m][nt][2 * r], ws.x, zs[q]));
        zd[q] = fmaf(z[m][nt][2 * r + 1], wd.y, fmaf(z[m][nt][2 * r], wd.x, zd[q]));
      }
  }
#pragma unroll
  for (int q = 0; q < 2 * MT; ++q) {
    zs[q] = quad_sum(zs[q]);
    zd[q] = quad_sum(zd[q]);
    if (t == 0) head_x[part * BM + r0 + 8 * q] = make_float2(zs[q], zd[q]);
  }
  __syncthreads();
  const float b_sdf = __ldg(P + OFF_BHEAD), b_std = __ldg(P + OFF_BHEAD + 1);
  float s[2 * MT];
#pragma unroll
  for (int q = 0; q < 2 * MT; ++q) {  // row r0 + 8q: m-tile q / 2, row g + 8 (q % 2)
    float2 v = head_x[r0 + 8 * q];
#pragma unroll
    for (int pp = 1; pp < PARTS; ++pp) {
      const float2 u = head_x[pp * BM + r0 + 8 * q];
      v.x += u.x;
      v.y += u.y;
    }
    s[q] = tanhf(v.x + b_sdf);
    const float d = v.y + b_std;
    const int row = n0 + r0 + 8 * q;
    if (part == 0 && t == 0 && row < n) {
      sdf_out[row] = s[q];
      std_out[row] = 0.05f + 0.5f * (fmaxf(d, 0.f) + log1pf(expf(-fabsf(d))));
    }
  }
  if constexpr (GRAD) {
    // ---- backward (sdf only) ----
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {                             // dz3
      const float2 ws = ldg2(P + OFF_WSDF, 4 * (nb + nt) + t);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sq = s[2 * m + (e >> 1)];
          z[m][nt][e] = (1.f - sq * sq) * ((e & 1) ? ws.y : ws.x);
        }
    }
    relu_grad<MT, NQ>(z, m3);
    float gx[6 * MT];
    part_dot3<MT>(z, P + OFF_W3XYZ, nb, t, gx);                   // dz3 . W3b[:, xyz]
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < 2 * MT; ++q)
#pragma unroll
        for (int j = 0; j < 3; ++j) grad_x[(part * BM + r0 + 8 * q) * 6 + j] = gx[3 * q + j];
    }
    sync_store<MT, NQ>(z, a0, nb);

    zero<MT, NQ2>(z);                                             // dh2 = dz3 W3a
    gemm<HID / 8, NQ2, H2 / 8, LDA, MT>(z, a0, nb2, ring, it, lane);
    relu_grad<MT, NQ2>(z, park[2 * NTHR + tid]);
    sync_store<MT, NQ2>(z, a0, nb2);

    zero<MT, NQ>(z);                                              // dh1 = dz2 W2
    gemm<H2 / 8, NQ, HID / 8, LDA, MT>(z, a0, nb, ring, it, lane);
    relu_grad<MT, NQ>(z, park[NTHR + tid]);
    sync_store<MT, NQ>(z, a0, nb);

    zero<MT, NQ>(z);                                              // dh0 = dz1 W1
    gemm<HID / 8, NQ, HID / 8, LDA, MT>(z, a0, nb, ring, it, lane);
    relu_grad<MT, NQ>(z, park[tid]);

    part_dot3<MT>(z, P + OFF_W0XYZ, nb, t, gx);                   // dz0 . W0[:, xyz]
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < 2 * MT; ++q)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          grad_x[(part * BM + r0 + 8 * q) * 6 + 3 + j] = gx[3 * q + j];
    }
    __syncthreads();
    if (part == 0 && t == 0) {
#pragma unroll
      for (int q = 0; q < 2 * MT; ++q) {
        const int row = n0 + r0 + 8 * q;
        if (row < n) {
          float g3[3] = {0.f, 0.f, 0.f}, g0[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int pp = 0; pp < PARTS; ++pp) {
            const float* e = grad_x + (pp * BM + r0 + 8 * q) * 6;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              g3[j] += e[j];
              g0[j] += e[3 + j];
            }
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) grad_out[(size_t)row * 3 + j] = g3[j] + g0[j];
        }
      }
    }
  }
}

// Kernel 1: 16 warps of 16 rows x 32 columns, 64 rows a block.  Kernel 3:
// 12 warps of 32 rows x 32 columns, 96 rows a block.  3-4 warps to an SM
// sub-partition hide one another's shared-memory and tensor-core latency.
constexpr int K1_WARPS = 16, K1_MT = 1, K1_RING = 5;
constexpr int K3_WARPS = 12, K3_MT = 2, K3_RING = 4;
static_assert(smem_bytes<K1_WARPS, K1_MT, true, K1_RING>() <= 232448 &&
              smem_bytes<K3_WARPS, K3_MT, false, K3_RING>() <= 232448,
              "a block has 227 KB of shared memory");

__global__ void __launch_bounds__(K1_WARPS * 32, 1)
decode_grad_kernel(const float* __restrict__ latent, const float* __restrict__ rel,
                   const float* __restrict__ P, float* __restrict__ sdf_out,
                   float* __restrict__ std_out, float* __restrict__ grad_out, int n) {
  decoder_body<K1_WARPS, K1_MT, true, K1_RING>(latent, rel, P, sdf_out, std_out,
                                                      grad_out, n);
}

__global__ void __launch_bounds__(K3_WARPS * 32, 1)
decode_fwd_kernel(const float* __restrict__ latent, const float* __restrict__ rel,
                  const float* __restrict__ P, float* __restrict__ sdf_out,
                  float* __restrict__ std_out, int n) {
  decoder_body<K3_WARPS, K3_MT, false, K3_RING>(latent, rel, P, sdf_out, std_out,
                                                       nullptr, n);
}

// the devices whose shared-memory attribute an instance remembers having set
constexpr int MAX_DEVICES = 64;

// one instance's launch on the current device: its shared-memory size set
// once per device (the attribute belongs to the device's context; past
// MAX_DEVICES on every launch), then ceil(n / rows) blocks on `stream`.
// Returns cudaGetLastError().
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), bool (&attr_set)[MAX_DEVICES], int smem, int warps,
           int rows, int n, void* stream, Args... args) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= MAX_DEVICES || !attr_set[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (device < MAX_DEVICES) attr_set[device] = true;
  }
  kernel<<<(n + rows - 1) / rows, warps * 32, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_grad_packed_size() { return PACKED_SIZE; }

// Kernel 1: latent (n, 29), rel (n, 3), packed (PACKED_SIZE,) f32 contiguous
// on the device; writes sdf (n,), std (n,), grad (n, 3).  Returns
// cudaGetLastError().
extern "C" int decode_grad_launch(const float* latent, const float* rel,
                                  const float* packed, float* sdf, float* std_,
                                  float* grad, int n, void* stream) {
  static bool attr_set[MAX_DEVICES] = {};
  return launch(decode_grad_kernel, attr_set,
                smem_bytes<K1_WARPS, K1_MT, true, K1_RING>(), K1_WARPS,
                block_rows<K1_WARPS, K1_MT>(), n, stream, latent, rel, packed, sdf, std_,
                grad, n);
}

// Kernel 3: latent (n, 29), rel (n, 3), packed (PACKED_SIZE,) f32 contiguous
// on the device; writes sdf (n,), std (n,).  Returns cudaGetLastError().
extern "C" int decode_fwd_launch(const float* latent, const float* rel,
                                 const float* packed, float* sdf, float* std_,
                                 int n, void* stream) {
  static bool attr_set[MAX_DEVICES] = {};
  return launch(decode_fwd_kernel, attr_set,
                smem_bytes<K3_WARPS, K3_MT, false, K3_RING>(), K3_WARPS,
                block_rows<K3_WARPS, K3_MT>(), n, stream, latent, rel, packed, sdf, std_, n);
}
