// onet_cbn's kernels (3xTF32 on the tensor cores, f32 accumulation),
// sm_90a: Occupancy Networks' conditional-batch-norm decoder
// (DecoderCBatchNorm, arXiv:1812.03828) with DI-Fusion's sdf and std heads.
// Three kernels:
//
// * cbn_cond_kernel: codes (M, L) -> the folded conditioning (M, NC, 2, H)
//   of every CBN j: gamma' = (W_g c + b_g) s, beta' = (W_g c + b_g) t +
//   (W_b c + b_b), with BN's running statistics folded in (s = 1/sqrt(var +
//   eps), t = -mean s).  One stacked L x (NC 2 H) product; block (i, j)
//   computes CBN j for rows 64 i .. 64 i + 63, its gamma and beta columns
//   side by side (n-tile 2q holds gamma's columns 8q .. 8q + 7, n-tile 2q + 1
//   beta's), so the fold is the product's epilogue.  Rows optionally come
//   from a list (`rows`, the output row too) and a device count (`count`),
//   so a fixed-shape launch conditions only the rows a fusion changed.
// * decode_fwd_kernel_cbn (kernel 3) and decode_grad_kernel_cbn (kernel 1):
//   sites with a row index into the conditioning and voxel-local xyz:
//
//     net = fc_p(xyz);  for i < NB: a = relu(G_2i net + B_2i),
//       a2 = relu(G_2i+1 (W0_i a + b0_i) + B_2i+1),  net += W1_i a2 + b1_i
//     h = relu(G_2NB net + B_2NB);  sdf = tanh(h . w_sdf + b),
//     std = 0.05 + 0.5 softplus(h . w_std + b)
//
//   Kernel 1 also backpropagates the sdf to xyz (the code held constant,
//   relu'(0) = 0): dn = (1 - sdf^2) w_sdf [h > 0] G_2NB, then for i = NB-1
//   .. 0: d = (dn W1_i) [a2 > 0] G_2i+1, dn += (d W0_i) [a > 0] G_2i, and
//   d sdf / d xyz = dn . fc_p's xyz columns.
//
// Design: decoder_wide.cu's (wide_tc.cuh): 64 rows a block, 8 warps of 32
// rows x H/4 columns, the activation tile in shared memory, every H x H
// matrix streamed from L2 a k-tile at a time by TMA through a ring of
// slots, products in 3xTF32 summed two k-tiles at a time from zero.  The
// residual `net` lives in each warp's registers in the accumulator layout
// (the same positions in every layer), so the residual adds and each CBN's
// scale and shift are epilogues: a lane reads G and B of its four rows at
// its columns (float2, through L1) from the row's conditioning.  Rows of one
// block that share a conditioning row (the mesher's sites of one block) hit
// the same lines; the block's rows' conditioning rows wait in shared memory
// (held in registers, four a lane, they pushed kernel 3 into spills, as did
// the epilogue's loads issued row by row).
// Kernel 1 parks the 11 relu masks as bits in shared
// memory from the forward to the backward.
//
// Work at the published widths (L 256, H 256, NB 5): the trunk 1.31 MFLOP a
// point forward and 2.63 with the gradient, counted once; the conditioning
// 2.88 MFLOP a code and 22.5 KB of G and B that each point reads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_tc.cuh"

namespace {

using namespace wide_tc;

// The layout of one instance: widths and the packed buffer's offsets
// (floats), as ops/decoder_fused.CbnLayout lays it out.
template <int L, int H, int NB>
struct Cbn {
  static_assert(H % (8 * PARTS) == 0 && L % 16 == 0 && H % 2 == 0, "widths split into tiles");
  static constexpr int NC = 2 * NB + 1;   // CBNs: two a block and the head's
  static constexpr int COND = NC * 2 * H; // floats of one row's conditioning
  static constexpr int LDA = H + (40 - H % 32) % 32;  // >= H, = 8 mod 32
  static constexpr int LDC = L + (40 - L % 32) % 32;
  static constexpr int NTN = H / (8 * PARTS);       // a warp's n-tiles in the trunk
  static constexpr int NTC = 2 * H / (8 * PARTS);   // and in the conditioning
  static constexpr int PW = (MT * NTN * 4 + 31) / 32;  // mask words a lane a CBN

  static constexpr int OFF_META = 0;                 // L, H, NB, NC
  static constexpr int OFF_WP = 4;                   // [H][4] fc_p: x, y, z, bias
  static constexpr int OFF_W0 = OFF_WP + 4 * H;      // [NB][H][H] (out, in)
  static constexpr int OFF_B0 = OFF_W0 + NB * H * H;
  static constexpr int OFF_W1 = OFF_B0 + NB * H;
  static constexpr int OFF_B1 = OFF_W1 + NB * H * H;
  static constexpr int OFF_WSDF = OFF_B1 + NB * H;
  static constexpr int OFF_WSTD = OFF_WSDF + H;
  static constexpr int OFF_BHEAD = OFF_WSTD + H;     // b_sdf, b_std, 0, 0
  static constexpr int OFF_CW = OFF_BHEAD + 4;       // [NC][2][H][L]
  static constexpr int OFF_CB = OFF_CW + NC * 2 * H * L;  // [NC][2][H]
  static constexpr int OFF_S = OFF_CB + NC * 2 * H;  // [NC][H]
  static constexpr int OFF_T = OFF_S + NC * H;       // [NC][H]
  static constexpr int OFF_FRAG = rup(OFF_T + NC * H, 4);  // the trunk's fragments
  static constexpr int OFF_CFRAG = OFF_FRAG + 4 * NB * H * H;  // the conditioning's
  static constexpr int PACKED = OFF_CFRAG + NC * L * 2 * H;
  static_assert(OFF_B0 % 2 == 0 && OFF_B1 % 2 == 0 && OFF_WSDF % 2 == 0 && OFF_CB % 2 == 0 &&
                    OFF_S % 2 == 0 && OFF_T % 2 == 0,
                "vectors are read as float2");
};

// The trunk's weight stream: the forward's W0_i^T, W1_i^T (i = 0 .. NB-1),
// then the backward's W1_i, W0_i (i = NB-1 .. 0), each H x H, a k-tile a chunk
template <int H, int NB>
struct TrunkStream {
  static constexpr int SLOT = 8 * H;
  static constexpr int CHUNKS_FWD = 2 * NB * (H / 8), CHUNKS_ALL = 2 * CHUNKS_FWD;
  __host__ __device__ static constexpr int s_cols(int) { return H; }
  __host__ __device__ static constexpr int s_ktiles(int) { return H / 8; }
};

// One CBN's stacked (gamma | beta) matrix, L x 2H, a k-tile a chunk
template <int L, int H>
struct CondStream {
  static constexpr int SLOT = 16 * H;
  static constexpr int CHUNKS = L / 8;
  __host__ __device__ static constexpr int s_cols(int) { return 2 * H; }
  __host__ __device__ static constexpr int s_ktiles(int) { return L / 8; }
};

// the lane's fragment row r (m-tile m, half h) within the block
__device__ __forceinline__ int frag_row(int rg, int m, int h, int g) {
  return rg * 16 * MT + 16 * m + g + 8 * h;
}

// the lane's four rows' offsets into the conditioning at CBN j (crow: the
// lane's first fragment row's conditioning row in shared memory, the others
// 8 and 16 m after it; a table of under 2^31 floats)
template <int H, int NC>
__device__ __forceinline__ void cbn_rows(uint32_t (&off)[MT][2], const uint32_t* crow, int j) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) off[m][h] = crow[16 * m + 8 * h] * (NC * 2 * H) + j * 2 * H;
}

// z = relu(G z + B) in place, G and B CBN j's of each row, an n-tile at a
// time (row-major, the G and B loads of all four rows in flight pushed
// kernel 3 into spills); returns the [z > 0] bits as bias_relu does
template <int H, int NC, int NTN>
__device__ __forceinline__ uint4 cbn_relu(float (&z)[MT][NTN][4], const float* __restrict__ cond,
                                          const uint32_t* crow, int j, int nb, int t) {
  uint32_t bits[4] = {};
  uint32_t off[MT][2];
  cbn_rows<H, NC>(off, crow, j);
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    const int col = 8 * (nb + nt) + 2 * t;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 G = __ldg(reinterpret_cast<const float2*>(cond + off[m][h] + col));
        const float2 B = __ldg(reinterpret_cast<const float2*>(cond + off[m][h] + H + col));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * h + c;
          const float v = fmaf(c ? G.y : G.x, z[m][nt][e], c ? B.y : B.x);
          const float r = v > 0.f ? v : 0.f;
          z[m][nt][e] = r;
          const int i = 4 * (NTN * m + nt) + e;
          bits[i >> 5] |= (uint32_t)(r > 0.f) << (i & 31);
        }
      }
  }
  return make_uint4(bits[0], bits[1], bits[2], bits[3]);
}

// z *= [mask] G, G CBN j's of each row: the backward through relu(G x + B)
template <int H, int NC, int NTN>
__device__ __forceinline__ void cbn_grad(float (&z)[MT][NTN][4], const float* __restrict__ cond,
                                         const uint32_t* crow, int j, int nb, int t,
                                         uint4 mask) {
  const uint32_t b[4] = {mask.x, mask.y, mask.z, mask.w};
  uint32_t off[MT][2];
  cbn_rows<H, NC>(off, crow, j);
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 G =
            __ldg(reinterpret_cast<const float2*>(cond + off[m][h] + 8 * (nb + nt) + 2 * t));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * h + c, i = 4 * (NTN * m + nt) + e;
          const bool on = (b[i >> 5] >> (i & 31)) & 1u;
          z[m][nt][e] = on ? z[m][nt][e] * (c ? G.y : G.x) : 0.f;
        }
      }
}

// z += bias (per column)
template <int NTN>
__device__ __forceinline__ void add_bias(float (&z)[MT][NTN][4], const float* __restrict__ bias,
                                         int nb, int t) {
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias) + 4 * (nb + nt) + t);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[m][nt][e] += (e & 1) ? b.y : b.x;
  }
}

template <int NTN>
__device__ __forceinline__ void copy_frag(float (&dst)[MT][NTN][4], const float (&src)[MT][NTN][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[m][nt][e] = src[m][nt][e];
}

template <int NW>
__device__ __forceinline__ void park_bits(uint32_t* park, int layer, int tid, uint4 bits) {
  const uint32_t w[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
  for (int i = 0; i < NW; ++i) park[(layer * NW + i) * NTHR + tid] = w[i];
}

template <int NW>
__device__ __forceinline__ uint4 parked(const uint32_t* park, int layer, int tid) {
  uint32_t w[4] = {};
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = park[(layer * NW + i) * NTHR + tid];
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int L, int H, int NB, bool GRAD, int RING>
__device__ __forceinline__ void cbn_body(const float* __restrict__ cond,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ rel,
                                         const float* __restrict__ P, float* __restrict__ sdf_out,
                                         float* __restrict__ std_out,
                                         float* __restrict__ grad_out, int n) {
  using Lay = Cbn<L, H, NB>;
  using TS = TrunkStream<H, NB>;
  constexpr int LDA = Lay::LDA, NTN = Lay::NTN, NC = Lay::NC, PW = Lay::PW;
  extern __shared__ float4 smem4[];
  float* slots = reinterpret_cast<float*>(smem4);
  float* act = slots + RING * TS::SLOT;                     // [BM][LDA]
  float* s_sdf = act + BM * LDA;                            // [BM]
  uint32_t* s_crow = reinterpret_cast<uint32_t*>(s_sdf + BM);  // [BM] conditioning rows
  uint32_t* park = s_crow + BM;                             // [NC][PW][NTHR]
  uint64_t* bars = reinterpret_cast<uint64_t*>(park + (GRAD ? NC * PW * NTHR : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int part = warp % PARTS, rg = warp / PARTS;
  const int n0 = blockIdx.x * BM, nb = part * NTN;
  float* a0 = act + (rg * 16 * MT + g) * LDA + 2 * t;   // the lane's fragment rows

  Stream<TS, RING> st{slots, P + Lay::OFF_FRAG, bars, bars + RING, tid,
                      GRAD ? TS::CHUNKS_ALL : TS::CHUNKS_FWD};
  st.init();
  st.start();

  // the block's rows' conditioning rows (rows past n: row 0, nothing stored)
  for (int r = tid; r < BM; r += NTHR) s_crow[r] = n0 + r < n ? (uint32_t)__ldg(idx + n0 + r) : 0u;
  const uint32_t* crow = s_crow + rg * 16 * MT + g;   // the lane's first fragment row's

  // the lane's four rows' xyz (rows past n: 0)
  float xr[MT][2][3];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = n0 + frag_row(rg, m, h, g);
#pragma unroll
      for (int k = 0; k < 3; ++k) xr[m][h][k] = gr < n ? __ldg(rel + (size_t)gr * 3 + k) : 0.f;
    }

  // net = fc_p(xyz): three fmas a value, bias first
  float net[MT][NTN][4], z[MT][NTN][4];
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    const int col = 8 * (nb + nt) + 2 * t;
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(P + Lay::OFF_WP) + col);
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(P + Lay::OFF_WP) + col + 1);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 w = (e & 1) ? w1 : w0;
        const float* x = xr[m][e >> 1];
        net[m][nt][e] = fmaf(x[2], w.z, fmaf(x[1], w.y, fmaf(x[0], w.x, w.w)));
      }
  }
  __syncthreads();  // the stream's barriers and the rows' conditioning rows are ready

  int it = 0;
  // ---- forward ----
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    copy_frag<NTN>(z, net);
    uint4 bits = cbn_relu<H, NC, NTN>(z, cond, crow, 2 * i, nb, t);   // a
    if constexpr (GRAD) park_bits<PW>(park, 2 * i, tid, bits);
    __syncthreads();   // every warp has read the activation rows
    store<NTN, NTN, LDA>(z, a0, nb);
    __syncthreads();
    gemm<NTN, NTN, LDA>(z, a0, H / 8, nb, st, it, lane);            // W0_i a
    add_bias<NTN>(z, P + Lay::OFF_B0 + i * H, nb, t);
    bits = cbn_relu<H, NC, NTN>(z, cond, crow, 2 * i + 1, nb, t);   // a2
    if constexpr (GRAD) park_bits<PW>(park, 2 * i + 1, tid, bits);
    __syncthreads();
    store<NTN, NTN, LDA>(z, a0, nb);
    __syncthreads();
    gemm<NTN, NTN, LDA>(z, a0, H / 8, nb, st, it, lane);            // W1_i a2
    add_bias<NTN>(z, P + Lay::OFF_B1 + i * H, nb, t);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) net[m][nt][e] += z[m][nt][e];
  }
  copy_frag<NTN>(z, net);
  {
    const uint4 bits = cbn_relu<H, NC, NTN>(z, cond, crow, 2 * NB, nb, t);   // h
    if constexpr (GRAD) park_bits<PW>(park, 2 * NB, tid, bits);
  }
  __syncthreads();
  store<NTN, NTN, LDA>(z, a0, nb);
  __syncthreads();

  // heads on h: TPR threads a row, half for each head
  {
    constexpr int HALF = TPR / 2;
    const int r = tid / TPR, hd = (tid % TPR) / HALF, q = tid % HALF;
    const float* w = P + (hd ? Lay::OFF_WSTD : Lay::OFF_WSDF);
    float s = 0.f;
    for (int k = q; k < H; k += HALF) s = fmaf(act[r * LDA + k], __ldg(w + k), s);
#pragma unroll
    for (int o = 1; o < HALF; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float b = __ldg(P + Lay::OFF_BHEAD + hd);
    if (q == 0) {
      const int row = n0 + r;
      if (hd == 0) {
        const float sd = tanhf(s + b);
        s_sdf[r] = sd;
        if (row < n) sdf_out[row] = sd;
      } else if (row < n) {
        const float d = s + b;
        std_out[row] = 0.05f + 0.5f * (fmaxf(d, 0.f) + log1pf(expf(-fabsf(d))));
      }
    }
  }

  if constexpr (GRAD) {
    // ---- backward (sdf only): dn in net's registers ----
    __syncthreads();   // s_sdf is written; the heads have read the rows
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const float2 ws =
          __ldg(reinterpret_cast<const float2*>(P + Lay::OFF_WSDF) + 4 * (nb + nt) + t);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sq = s_sdf[frag_row(rg, m, e >> 1, g)];
          net[m][nt][e] = (1.f - sq * sq) * ((e & 1) ? ws.y : ws.x);
        }
    }
    cbn_grad<H, NC, NTN>(net, cond, crow, 2 * NB, nb, t, parked<PW>(park, 2 * NB, tid));
#pragma unroll 1
    for (int i = NB - 1; i >= 0; --i) {
      __syncthreads();   // every warp has read the activation rows
      store<NTN, NTN, LDA>(net, a0, nb);
      __syncthreads();
      gemm<NTN, NTN, LDA>(z, a0, H / 8, nb, st, it, lane);          // dn W1_i
      cbn_grad<H, NC, NTN>(z, cond, crow, 2 * i + 1, nb, t, parked<PW>(park, 2 * i + 1, tid));
      __syncthreads();
      store<NTN, NTN, LDA>(z, a0, nb);
      __syncthreads();
      gemm<NTN, NTN, LDA>(z, a0, H / 8, nb, st, it, lane);          // d W0_i
      cbn_grad<H, NC, NTN>(z, cond, crow, 2 * i, nb, t, parked<PW>(park, 2 * i, tid));
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) net[m][nt][e] += z[m][nt][e];
    }
    __syncthreads();
    store<NTN, NTN, LDA>(net, a0, nb);
    __syncthreads();
    // d sdf / d xyz = dn . fc_p's xyz columns: TPR threads a row
    const int r = tid / TPR, q = tid % TPR;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int k = q; k < H; k += TPR) {
      const float a = act[r * LDA + k];
      const float4 w = __ldg(reinterpret_cast<const float4*>(P + Lay::OFF_WP) + k);
      s0 = fmaf(a, w.x, s0);
      s1 = fmaf(a, w.y, s1);
      s2 = fmaf(a, w.z, s2);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const int row = n0 + r;
    if (q == 0 && row < n) {
      grad_out[(size_t)row * 3] = s0;
      grad_out[(size_t)row * 3 + 1] = s1;
      grad_out[(size_t)row * 3 + 2] = s2;
    }
  }
}

constexpr int K1_RING = 8, K3_RING = 8, COND_RING = 5;

template <int L, int H, int NB>
__global__ void __launch_bounds__(NTHR, 1)
decode_grad_kernel_cbn(const float* __restrict__ cond, const int* __restrict__ idx,
                       const float* __restrict__ rel, const float* __restrict__ P,
                       float* __restrict__ sdf_out, float* __restrict__ std_out,
                       float* __restrict__ grad_out, int n) {
  cbn_body<L, H, NB, true, K1_RING>(cond, idx, rel, P, sdf_out, std_out, grad_out, n);
}

template <int L, int H, int NB>
__global__ void __launch_bounds__(NTHR, 1)
decode_fwd_kernel_cbn(const float* __restrict__ cond, const int* __restrict__ idx,
                      const float* __restrict__ rel, const float* __restrict__ P,
                      float* __restrict__ sdf_out, float* __restrict__ std_out, int n) {
  cbn_body<L, H, NB, false, K3_RING>(cond, idx, rel, P, sdf_out, std_out, nullptr, n);
}

// Block (i, j): CBN j of rows 64 i .. 64 i + 63 of the list (`rows`, or
// the identity), of which the first *count (or n) are live
template <int L, int H, int NB>
__global__ void __launch_bounds__(NTHR, 1)
cbn_cond_kernel(const float* __restrict__ codes, const int* __restrict__ rows,
                const int* __restrict__ count, const float* __restrict__ P,
                float* __restrict__ out, int n) {
  using Lay = Cbn<L, H, NB>;
  using CS = CondStream<L, H>;
  constexpr int LDC = Lay::LDC, NTC = Lay::NTC;
  const int live = count ? min(__ldg(count), n) : n;
  const int n0 = blockIdx.x * BM, j = blockIdx.y;
  if (n0 >= live) return;   // the whole block: before any barrier
  extern __shared__ float4 smem4[];
  float* slots = reinterpret_cast<float*>(smem4);
  float* act = slots + COND_RING * CS::SLOT;                           // [BM][LDC]
  uint64_t* bars = reinterpret_cast<uint64_t*>(act + BM * LDC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int part = warp % PARTS, rg = warp / PARTS;
  Stream<CS, COND_RING> st{slots, P + Lay::OFF_CFRAG + (size_t)j * L * 2 * H, bars,
                           bars + COND_RING, tid, CS::CHUNKS};
  st.init();
  st.start();
  for (int e = tid; e < BM * L; e += NTHR) {
    const int r = e / L, k = e % L, gr = n0 + r;
    float v = 0.f;
    if (gr < live) v = codes[(size_t)(rows ? __ldg(rows + gr) : gr) * L + k];
    act[r * LDC + k] = v;
  }
  __syncthreads();  // the codes and the stream's barriers are ready

  float z[MT][NTC][4];
  int it = 0;
  gemm<NTC, NTC, LDC>(z, act + (rg * 16 * MT + g) * LDC + 2 * t, L / 8, part * NTC, st, it,
                      lane);
  int orow[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = n0 + frag_row(rg, m, h, g);
      orow[m][h] = gr < live ? (rows ? __ldg(rows + gr) : gr) : -1;
    }
#pragma unroll
  for (int p = 0; p < NTC / 2; ++p) {
    const int col = 8 * (part * (NTC / 2) + p) + 2 * t;
    const float2 bg = __ldg(reinterpret_cast<const float2*>(P + Lay::OFF_CB + 2 * j * H + col));
    const float2 bb =
        __ldg(reinterpret_cast<const float2*>(P + Lay::OFF_CB + (2 * j + 1) * H + col));
    const float2 s = __ldg(reinterpret_cast<const float2*>(P + Lay::OFF_S + j * H + col));
    const float2 tt = __ldg(reinterpret_cast<const float2*>(P + Lay::OFF_T + j * H + col));
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (orow[m][h] < 0) continue;
        const float zg0 = z[m][2 * p][2 * h] + bg.x, zg1 = z[m][2 * p][2 * h + 1] + bg.y;
        const float zb0 = z[m][2 * p + 1][2 * h] + bb.x, zb1 = z[m][2 * p + 1][2 * h + 1] + bb.y;
        float* o = out + (size_t)orow[m][h] * Lay::COND + j * 2 * H + col;
        *reinterpret_cast<float2*>(o) = make_float2(zg0 * s.x, zg1 * s.y);
        *reinterpret_cast<float2*>(o + H) = make_float2(fmaf(zg0, tt.x, zb0), fmaf(zg1, tt.y, zb1));
      }
  }
}

template <int L, int H, int NB>
constexpr int trunk_smem(bool grad, int ring) {
  return ring * TrunkStream<H, NB>::SLOT * 4 + BM * Cbn<L, H, NB>::LDA * 4 + 2 * BM * 4 +
         (grad ? Cbn<L, H, NB>::NC * Cbn<L, H, NB>::PW * NTHR * 4 : 0) + 2 * ring * 8;
}

template <int L, int H, int NB>
constexpr int cond_smem() {
  return COND_RING * CondStream<L, H>::SLOT * 4 + BM * Cbn<L, H, NB>::LDC * 4 + 2 * COND_RING * 8;
}

}  // namespace

// One instance's C entry points: its packed size (the wrapper checks it
// against ops/decoder_fused.CbnLayout); the conditioning (codes (M, L), rows
// (n,) int32 or null, count (1,) int32 on the device or null -> out rows of
// (NC, 2, H)); kernel 1 (cond, idx (n,) int32, rel (n, 3), packed -> sdf
// (n,), std (n,), grad (n, 3)) and kernel 3 (-> sdf, std).  Each returns
// cudaGetLastError().
#define CBN_INSTANCE(L, H, NB)                                                                \
  static_assert(trunk_smem<L, H, NB>(true, K1_RING) <= 232448 &&                              \
                    trunk_smem<L, H, NB>(false, K3_RING) <= 232448 &&                         \
                    cond_smem<L, H, NB>() <= 232448,                                          \
                "a block has 227 KB of shared memory");                                       \
  extern "C" int cbn_packed_size_##L##_##H##_##NB() { return Cbn<L, H, NB>::PACKED; }         \
  extern "C" int cbn_cond_launch_##L##_##H##_##NB(const float* codes, const int* rows,        \
                                                  const int* count, const float* packed,      \
                                                  float* out, int n, void* stream) {          \
    static bool attr_set[MAX_DEVICES] = {};                                                   \
    int device = 0;                                                                           \
    cudaError_t err = cudaGetDevice(&device);                                                 \
    if (err != cudaSuccess) return (int)err;                                                  \
    constexpr int smem = cond_smem<L, H, NB>();                                               \
    if (device >= MAX_DEVICES || !attr_set[device]) {                                         \
      err = cudaFuncSetAttribute(cbn_cond_kernel<L, H, NB>,                                   \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);          \
      if (err != cudaSuccess) return (int)err;                                                \
      if (device < MAX_DEVICES) attr_set[device] = true;                                      \
    }                                                                                         \
    const dim3 grid((n + BM - 1) / BM, Cbn<L, H, NB>::NC);                                    \
    cbn_cond_kernel<L, H, NB><<<grid, NTHR, smem, (cudaStream_t)stream>>>(codes, rows, count, \
                                                                          packed, out, n);    \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int decode_grad_cbn_launch_##L##_##H##_##NB(                                     \
      const float* cond, const int* idx, const float* rel, const float* packed, float* sdf,   \
      float* std_, float* grad, int n, void* stream) {                                        \
    static bool attr_set[MAX_DEVICES] = {};                                                   \
    return launch(decode_grad_kernel_cbn<L, H, NB>, attr_set,                                 \
                  trunk_smem<L, H, NB>(true, K1_RING), n, stream, cond, idx, rel, packed,     \
                  sdf, std_, grad, n);                                                        \
  }                                                                                           \
  extern "C" int decode_fwd_cbn_launch_##L##_##H##_##NB(                                      \
      const float* cond, const int* idx, const float* rel, const float* packed, float* sdf,   \
      float* std_, int n, void* stream) {                                                     \
    static bool attr_set[MAX_DEVICES] = {};                                                   \
    return launch(decode_fwd_kernel_cbn<L, H, NB>, attr_set,                                  \
                  trunk_smem<L, H, NB>(false, K3_RING), n, stream, cond, idx, rel, packed,    \
                  sdf, std_, n);                                                              \
  }

// Occupancy Networks' published widths (c_dim 256, hidden_size 256, 5 blocks)
CBN_INSTANCE(256, 256, 5)
