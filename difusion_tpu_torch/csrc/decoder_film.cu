// pigan_film's kernels (3xTF32 on the tensor cores, f32 accumulation,
// sm_90a): pi-GAN's FiLM-SIREN decoder (Chan et al., CVPR 2021,
// arXiv:2012.00926; siren/siren.py's CustomMappingNetwork, FiLMLayer and
// TALLSIREN) with DI-Fusion's sdf and std heads.  None of them replaces a
// TPU kernel: the JAX package runs di_decoder only.  Three kernels:
//
// * film_map_kernel: codes (M, L) -> the modulation (M, NL, 2, H): the
//   mapping network m = W3 lrelu(W2 lrelu(W1 lrelu(W0 z + b0) + b1) + b2) +
//   b3 (leaky slope 0.2), its last layer folded so that row (i, 0) is layer
//   i's frequency gamma_i = 15 f_i + 30 and row (i, 1) its phase beta_i.  A
//   block maps 64 codes through all four layers: the activation tile in
//   shared memory, every matrix streamed a k-tile at a time (the three
//   hidden ones, then the last one as 2 NL column blocks of H), each
//   product's epilogue the bias and leaky relu, or the bias and the store.
//   Rows optionally come from a list and a device count, as onet_cbn's
//   conditioning, so a fixed-shape launch maps only the rows a fusion
//   changed.
// * decode_fwd_kernel_film (kernel 3): sites with a row index into the
//   modulation and voxel-local xyz:
//
//     h_1 = sin(gamma_0 (W0' xyz + b_0) + beta_0)   (W0' = 2 W_0: the box warp)
//     h_{i+1} = sin(gamma_i (W_i h_i + b_i) + beta_i),   i = 1 .. NL-1
//     sdf = tanh(h_NL . w_sdf + b),  std = 0.05 + 0.5 softplus(h_NL . w_std + b)
//
//   64 sites a block, the activation tile in shared memory, each H x H
//   matrix streamed from L2 by TMA through a ring of slots (wide_tc.cuh);
//   each layer's epilogue reads the row's gamma and beta at the lane's
//   columns (float2, through L1) and takes sinf.
// * decode_grad_kernel_film (kernel 1) adds d sdf / d xyz.  The backward of a
//   sine layer needs gamma_i cos(a_i) of every unit, f32 values where a relu
//   needs one bit: 8 x 256 floats a point, 512 KB for a 64-point tile, more
//   than a block's shared memory.  This kernel stages them in global
//   scratch: the forward (kernel 3's, 64 points a block) takes sincosf and
//   writes gamma cos(a) of its fragment as one float4 a lane a fragment
//   (coalesced across the block's threads, 64 MB at 8192 points), then the
//   reverse pass reads each layer's back: dh_NL = (1 - sdf^2) w_sdf, dz_i =
//   dh_{i+1} gamma_i cos(a_i), dh_i = dz_i W_i, d sdf / d xyz = dz_0 W0'.
//   The products are twice the forward's.  PERF.md has it timed against a
//   kernel that carries three forward-mode tangents beside the value (4x the
//   forward's products, no storage).
//
// sinf / sincosf with their full range reduction, never __sinf: the
// arguments reach tens of radians and an error of 1e-3 in one becomes the
// sine's.  Work at the published widths (L 256, H 256, NL 8, MH 256): the
// trunk 0.92 MFLOP a point forward and 1.84 with the gradient, counted once
// (the reverse pass's count); 2,048 sines a point; the mapping 2.49 MFLOP
// and 4,096 floats out a code.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_tc.cuh"

namespace {

using namespace wide_tc;

// The layout of one instance: widths and the packed buffer's offsets
// (floats), as ops/decoder_fused.FilmLayout lays it out.
template <int L, int H, int NL, int MH>
struct Film {
  static_assert(H % (8 * PARTS) == 0 && MH % (8 * PARTS) == 0 && L % 16 == 0 && MH % 16 == 0 &&
                    H % 16 == 0,
                "widths split into tiles");
  static constexpr int MOD = NL * 2 * H;   // floats of one row's modulation
  static constexpr int LDA = H + (40 - H % 32) % 32;   // >= H, = 8 mod 32
  static constexpr int KM = L > MH ? L : MH;
  static constexpr int LDM = KM + (40 - KM % 32) % 32;
  static constexpr int NTN = H / (8 * PARTS);    // a warp's n-tiles in the trunk
  static constexpr int NTM = MH / (8 * PARTS);   // and in the mapping's hidden layers

  static constexpr int OFF_META = 0;                   // L, H, NL, MH
  static constexpr int OFF_WP = 4;                     // [H][4] 2 W_0 (x, y, z), b_0
  static constexpr int OFF_WF = OFF_WP + 4 * H;        // [NL-1][H][H] W_1.. (out, in)
  static constexpr int OFF_BF = OFF_WF + (NL - 1) * H * H;   // [NL-1][H]
  static constexpr int OFF_WSDF = OFF_BF + (NL - 1) * H;
  static constexpr int OFF_WSTD = OFF_WSDF + H;
  static constexpr int OFF_BHEAD = OFF_WSTD + H;       // b_sdf, b_std, 0, 0
  static constexpr int OFF_M0 = OFF_BHEAD + 4;         // [MH][L]
  static constexpr int OFF_MB0 = OFF_M0 + MH * L;
  static constexpr int OFF_M1 = OFF_MB0 + MH;          // [MH][MH]
  static constexpr int OFF_MB1 = OFF_M1 + MH * MH;
  static constexpr int OFF_M2 = OFF_MB1 + MH;
  static constexpr int OFF_MB2 = OFF_M2 + MH * MH;
  static constexpr int OFF_M3 = OFF_MB2 + MH;          // [NL][2][H][MH], folded
  static constexpr int OFF_MB3 = OFF_M3 + MOD * MH;    // [NL][2][H]
  // the trunk's W_i^T (i = 1 .. NL-1), then its W_i (i = NL-1 .. 1)
  static constexpr int OFF_FRAG = rup(OFF_MB3 + MOD, 4);
  static constexpr int OFF_MFRAG = OFF_FRAG + 2 * (NL - 1) * H * H;   // the mapping's
  static constexpr int PACKED = OFF_MFRAG + L * MH + 2 * MH * MH + MH * MOD;
  static_assert(OFF_BF % 2 == 0 && OFF_WSDF % 2 == 0 && OFF_MB0 % 2 == 0 && OFF_MB1 % 2 == 0 &&
                    OFF_MB2 % 2 == 0 && OFF_MB3 % 2 == 0 && OFF_WP % 4 == 0,
                "vectors are read as float2 / float4");
};

// The trunk's weight stream: W_i^T, i = 1 .. NL-1, each H x H, a k-tile a chunk
template <int H, int NL>
struct TrunkStream {
  static constexpr int SLOT = 8 * H;
  static constexpr int CHUNKS = (NL - 1) * (H / 8);
  __host__ __device__ static constexpr int s_cols(int) { return H; }
  __host__ __device__ static constexpr int s_ktiles(int) { return H / 8; }
};

// The mapping's stream: W0^T (L x MH), W1^T, W2^T (MH x MH), then the last
// layer's 2 NL column blocks (MH x H each), a k-tile a chunk
template <int L, int H, int NL, int MH>
struct MapStream {
  static constexpr int SLOT = 8 * (MH > H ? MH : H);
  static constexpr int CHUNKS = L / 8 + 2 * (MH / 8) + 2 * NL * (MH / 8);
  __host__ __device__ static constexpr int s_cols(int s) { return s < 3 ? MH : H; }
  __host__ __device__ static constexpr int s_ktiles(int s) { return s == 0 ? L / 8 : MH / 8; }
};

// the lane's fragment row r (m-tile m, half h) within the block
__device__ __forceinline__ int frag_row(int rg, int m, int h, int g) {
  return rg * 16 * MT + 16 * m + g + 8 * h;
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

// ---- the mapping: 64 codes a block ----

// z = lrelu(z + b) in place (slope 0.2)
template <int NTN>
__device__ __forceinline__ void bias_lrelu(float (&z)[MT][NTN][4], const float* __restrict__ bias,
                                           int nb, int t) {
  add_bias<NTN>(z, bias, nb, t);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[m][nt][e] = z[m][nt][e] > 0.f ? z[m][nt][e] : 0.2f * z[m][nt][e];
}

constexpr int MAP_RING = 6;

// Rows 64 i .. 64 i + 63 of the list (`rows`, or the identity), of which the
// first *count (or n) are live
template <int L, int H, int NL, int MH>
__global__ void __launch_bounds__(NTHR, 1)
film_map_kernel(const float* __restrict__ codes, const int* __restrict__ rows,
                const int* __restrict__ count, const float* __restrict__ P,
                float* __restrict__ out, int n) {
  using Lay = Film<L, H, NL, MH>;
  using MS = MapStream<L, H, NL, MH>;
  constexpr int LDM = Lay::LDM, NTM = Lay::NTM, NTN = Lay::NTN;
  const int live = count ? min(__ldg(count), n) : n;
  const int n0 = blockIdx.x * BM;
  if (n0 >= live) return;   // the whole block: before any barrier
  extern __shared__ float4 smem4[];
  float* slots = reinterpret_cast<float*>(smem4);
  float* act = slots + MAP_RING * MS::SLOT;                          // [BM][LDM]
  uint64_t* bars = reinterpret_cast<uint64_t*>(act + BM * LDM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int part = warp % PARTS, rg = warp / PARTS;
  Stream<MS, MAP_RING> st{slots, P + Lay::OFF_MFRAG, bars, bars + MAP_RING, tid, MS::CHUNKS};
  st.init();
  st.start();
  for (int e = tid; e < BM * L; e += NTHR) {
    const int r = e / L, k = e % L, gr = n0 + r;
    float v = 0.f;
    if (gr < live) v = codes[(size_t)(rows ? __ldg(rows + gr) : gr) * L + k];
    act[r * LDM + k] = v;
  }
  __syncthreads();  // the codes and the stream's barriers are ready

  float* a0 = act + (rg * 16 * MT + g) * LDM + 2 * t;
  int it = 0;
  {
    float z[MT][NTM][4];
    const float* bias[3] = {P + Lay::OFF_MB0, P + Lay::OFF_MB1, P + Lay::OFF_MB2};
#pragma unroll 1
    for (int l = 0; l < 3; ++l) {
      gemm<NTM, NTM, LDM>(z, a0, (l == 0 ? L : MH) / 8, part * NTM, st, it, lane);
      bias_lrelu<NTM>(z, bias[l], part * NTM, t);
      __syncthreads();   // every warp has read the activation rows
      store<NTM, NTM, LDM>(z, a0, part * NTM);
      __syncthreads();
    }
  }
  int orow[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = n0 + frag_row(rg, m, h, g);
      orow[m][h] = gr < live ? (rows ? __ldg(rows + gr) : gr) : -1;
    }
  // the last layer, a column block (layer i's gamma or beta) at a time
#pragma unroll 1
  for (int q = 0; q < 2 * NL; ++q) {
    float z[MT][NTN][4];
    gemm<NTN, NTN, LDM>(z, a0, MH / 8, part * NTN, st, it, lane);
    add_bias<NTN>(z, P + Lay::OFF_MB3 + q * H, part * NTN, t);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (orow[m][h] < 0) continue;
        float* o = out + (size_t)orow[m][h] * Lay::MOD + q * H;
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt)
          *reinterpret_cast<float2*>(o + 8 * (part * NTN + nt) + 2 * t) =
              make_float2(z[m][nt][2 * h], z[m][nt][2 * h + 1]);
      }
  }
}


// ---- kernels 1 and 3: 64 points a block ----

// z = sin(a), a = gamma (z + b) + beta, in place, gamma and beta layer i's
// of each row (b null: z already holds the preactivation); an n-tile at a
// time.  STAGE: also gamma cos(a) of the lane's fragment to `stage`, one
// float4 a (m-tile, n-tile), the block's threads side by side.
template <int H, int NL, int NTN, bool STAGE>
__device__ __forceinline__ void film_sin(float (&z)[MT][NTN][4], const float* __restrict__ mod,
                                         const uint32_t* crow, const float* __restrict__ bias,
                                         int i, int nb, int t, float4* __restrict__ stage) {
  uint32_t off[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) off[m][h] = crow[16 * m + 8 * h] * (NL * 2 * H) + i * 2 * H;
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    const int col = 8 * (nb + nt) + 2 * t;
    const float2 b = bias ? __ldg(reinterpret_cast<const float2*>(bias + col)) : make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float d[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 G = __ldg(reinterpret_cast<const float2*>(mod + off[m][h] + col));
        const float2 B = __ldg(reinterpret_cast<const float2*>(mod + off[m][h] + H + col));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float gm = c ? G.y : G.x;
          const float a = fmaf(gm, z[m][nt][2 * h + c] + (c ? b.y : b.x), c ? B.y : B.x);
          if constexpr (STAGE) {
            float sn, cs;
            sincosf(a, &sn, &cs);
            z[m][nt][2 * h + c] = sn;
            d[2 * h + c] = gm * cs;
          } else {
            z[m][nt][2 * h + c] = sinf(a);
          }
        }
      }
      if constexpr (STAGE) stage[(m * NTN + nt) * NTHR] = make_float4(d[0], d[1], d[2], d[3]);
    }
  }
}

// Kernel 3 (GRAD false): the forward and the heads.  Kernel 1 (GRAD true):
// the forward stages each layer's gamma cos(a) in `scratch`, then the
// reverse pass streams W_i back and reads them.
template <int L, int H, int NL, int MH, bool GRAD, int RING>
__device__ __forceinline__ void film_body(const float* __restrict__ mod,
                                          const int* __restrict__ idx,
                                          const float* __restrict__ rel,
                                          const float* __restrict__ P,
                                          float4* __restrict__ scratch,
                                          float* __restrict__ sdf_out,
                                          float* __restrict__ std_out,
                                          float* __restrict__ grad_out, int n) {
  using Lay = Film<L, H, NL, MH>;
  using TS = TrunkStream<H, NL>;
  constexpr int LDA = Lay::LDA, NTN = Lay::NTN, PER = MT * NTN;
  extern __shared__ float4 smem4[];
  float* slots = reinterpret_cast<float*>(smem4);
  float* act = slots + RING * TS::SLOT;                             // [BM][LDA]
  float* s_sdf = act + BM * LDA;                                    // [BM]
  uint32_t* s_crow = reinterpret_cast<uint32_t*>(s_sdf + BM);       // [BM]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_crow + BM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int part = warp % PARTS, rg = warp / PARTS;
  const int n0 = blockIdx.x * BM, nb = part * NTN;
  float* a0 = act + (rg * 16 * MT + g) * LDA + 2 * t;   // the lane's fragment rows
  // the lane's staged gamma cos(a) of layer 0 (layer i: i PER NTHR after)
  float4* stage = GRAD ? scratch + (size_t)blockIdx.x * NL * PER * NTHR + tid : nullptr;

  // the forward's W_i^T, then (kernel 1) the reverse pass's W_i
  Stream<TS, RING> st{slots, P + Lay::OFF_FRAG, bars, bars + RING, tid,
                      GRAD ? 2 * TS::CHUNKS : TS::CHUNKS};
  st.init();
  st.start();
  for (int r = tid; r < BM; r += NTHR) s_crow[r] = n0 + r < n ? (uint32_t)__ldg(idx + n0 + r) : 0u;
  const uint32_t* crow = s_crow + rg * 16 * MT + g;

  // layer 0's preactivation W0' xyz + b_0: three fmas a value, bias first
  float z[MT][NTN][4];
  {
    float xr[MT][2][3];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = n0 + frag_row(rg, m, h, g);
#pragma unroll
        for (int k = 0; k < 3; ++k) xr[m][h][k] = gr < n ? __ldg(rel + (size_t)gr * 3 + k) : 0.f;
      }
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
          z[m][nt][e] = fmaf(x[2], w.z, fmaf(x[1], w.y, fmaf(x[0], w.x, w.w)));
        }
    }
  }
  __syncthreads();  // the stream's barriers and the rows' modulation rows are ready
  film_sin<H, NL, NTN, GRAD>(z, mod, crow, nullptr, 0, nb, t, stage);

  int it = 0;
#pragma unroll 1
  for (int i = 1; i < NL; ++i) {
    __syncthreads();   // every warp has read the activation rows
    store<NTN, NTN, LDA>(z, a0, nb);
    __syncthreads();
    gemm<NTN, NTN, LDA>(z, a0, H / 8, nb, st, it, lane);   // W_i h_i
    film_sin<H, NL, NTN, GRAD>(z, mod, crow, P + Lay::OFF_BF + (i - 1) * H, i, nb, t,
                               GRAD ? stage + (size_t)i * PER * NTHR : nullptr);
  }
  __syncthreads();
  store<NTN, NTN, LDA>(z, a0, nb);
  __syncthreads();

  // heads on h_NL: TPR threads a row, half for each head
  {
    constexpr int HALF = TPR / 2;
    const int r = tid / TPR, hd = (tid % TPR) / HALF, q = tid % HALF;
    const float* w = P + (hd ? Lay::OFF_WSTD : Lay::OFF_WSDF);
    float s = 0.f;
    for (int k = q; k < H; k += HALF) s = fmaf(act[r * LDA + k], __ldg(w + k), s);
#pragma unroll
    for (int o = 1; o < HALF; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float d = s + __ldg(P + Lay::OFF_BHEAD + hd);
    const int row = n0 + r;
    if (q == 0) {
      if (hd == 0) {
        const float sd = tanhf(d);
        s_sdf[r] = sd;
        if (row < n) sdf_out[row] = sd;
      } else if (row < n) {
        std_out[row] = 0.05f + 0.5f * (fmaxf(d, 0.f) + log1pf(expf(-fabsf(d))));
      }
    }
  }

  if constexpr (GRAD) {
    __syncthreads();   // s_sdf is written; the heads have read the rows
    // dh_NL = (1 - sdf^2) w_sdf; dz_i = dh_{i+1} gamma_i cos(a_i); dh_i = dz_i W_i
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const float2 ws =
          __ldg(reinterpret_cast<const float2*>(P + Lay::OFF_WSDF) + 4 * (nb + nt) + t);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sq = s_sdf[frag_row(rg, m, e >> 1, g)];
          z[m][nt][e] = (1.f - sq * sq) * ((e & 1) ? ws.y : ws.x);
        }
    }
#pragma unroll 1
    for (int i = NL - 1; i >= 0; --i) {
      const float4* dl = stage + (size_t)i * PER * NTHR;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt) {
          const float4 d = dl[(m * NTN + nt) * NTHR];
          z[m][nt][0] *= d.x;
          z[m][nt][1] *= d.y;
          z[m][nt][2] *= d.z;
          z[m][nt][3] *= d.w;
        }
      __syncthreads();
      store<NTN, NTN, LDA>(z, a0, nb);
      __syncthreads();
      if (i > 0) gemm<NTN, NTN, LDA>(z, a0, H / 8, nb, st, it, lane);
    }
    // d sdf / d xyz = dz_0 . W0' (the first layer's xyz columns): TPR threads a row
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

constexpr int K1_RING = 8, K3_RING = 8;

template <int L, int H, int NL, int MH>
__global__ void __launch_bounds__(NTHR, 1)
decode_grad_kernel_film(const float* __restrict__ mod, const int* __restrict__ idx,
                        const float* __restrict__ rel, const float* __restrict__ P,
                        float4* __restrict__ scratch, float* __restrict__ sdf_out,
                        float* __restrict__ std_out, float* __restrict__ grad_out, int n) {
  film_body<L, H, NL, MH, true, K1_RING>(mod, idx, rel, P, scratch, sdf_out, std_out, grad_out,
                                         n);
}

template <int L, int H, int NL, int MH>
__global__ void __launch_bounds__(NTHR, 1)
decode_fwd_kernel_film(const float* __restrict__ mod, const int* __restrict__ idx,
                       const float* __restrict__ rel, const float* __restrict__ P,
                       float* __restrict__ sdf_out, float* __restrict__ std_out, int n) {
  film_body<L, H, NL, MH, false, K3_RING>(mod, idx, rel, P, nullptr, sdf_out, std_out, nullptr,
                                          n);
}


template <int L, int H, int NL, int MH>
constexpr int trunk_smem(int ring) {
  return ring * TrunkStream<H, NL>::SLOT * 4 + BM * Film<L, H, NL, MH>::LDA * 4 + 2 * BM * 4 +
         2 * ring * 8;
}

template <int L, int H, int NL, int MH>
constexpr int map_smem() {
  return MAP_RING * MapStream<L, H, NL, MH>::SLOT * 4 + BM * Film<L, H, NL, MH>::LDM * 4 +
         2 * MAP_RING * 8;
}

// one launch of `blocks` blocks on the current device, the kernel's
// shared-memory size set once per device; returns cudaGetLastError()
template <typename... Params, typename... Args>
int launch_blocks(void (*kernel)(Params...), bool (&attr_set)[MAX_DEVICES], int smem, int blocks,
                  void* stream, Args... args) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= MAX_DEVICES || !attr_set[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (device < MAX_DEVICES) attr_set[device] = true;
  }
  kernel<<<blocks, NTHR, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// One instance's C entry points: its packed size (the wrapper checks it
// against ops/decoder_fused.FilmLayout); the mapping (codes (M, L), rows
// (n,) int32 or null, count (1,) int32 on the device or null -> out rows of
// (NL, 2, H)); kernel 1 (mod, idx (n,) int32, rel (n, 3), packed -> sdf
// (n,), std (n,), grad (n, 3), through scratch of ceil(n / 64) NL H 64
// floats) and kernel 3 (-> sdf, std).  Each returns
// cudaGetLastError().
#define FILM_INSTANCE(L, H, NL, MH)                                                           \
  static_assert(trunk_smem<L, H, NL, MH>(K1_RING) <= 232448 &&                               \
                    trunk_smem<L, H, NL, MH>(K3_RING) <= 232448 &&                            \
                    map_smem<L, H, NL, MH>() <= 232448,                                       \
                "a block has 227 KB of shared memory");                                       \
  extern "C" int film_packed_size_##L##_##H##_##NL##_##MH() {                                 \
    return Film<L, H, NL, MH>::PACKED;                                                        \
  }                                                                                           \
  extern "C" int film_map_launch_##L##_##H##_##NL##_##MH(const float* codes, const int* rows, \
                                                         const int* count,                    \
                                                         const float* packed, float* out,     \
                                                         int n, void* stream) {               \
    static bool attr_set[MAX_DEVICES] = {};                                                   \
    return launch_blocks(film_map_kernel<L, H, NL, MH>, attr_set, map_smem<L, H, NL, MH>(),   \
                         (n + BM - 1) / BM, stream, codes, rows, count, packed, out, n);      \
  }                                                                                           \
  extern "C" int decode_grad_film_launch_##L##_##H##_##NL##_##MH(                             \
      const float* mod, const int* idx, const float* rel, const float* packed,                \
      float* scratch, float* sdf, float* std_, float* grad, int n, void* stream) {            \
    static bool attr_set[MAX_DEVICES] = {};                                                   \
    return launch_blocks(decode_grad_kernel_film<L, H, NL, MH>, attr_set,                     \
                         trunk_smem<L, H, NL, MH>(K1_RING), (n + BM - 1) / BM, stream, mod,   \
                         idx, rel, packed, reinterpret_cast<float4*>(scratch), sdf, std_,     \
                         grad, n);                                                            \
  }                                                                                           \
  extern "C" int decode_fwd_film_launch_##L##_##H##_##NL##_##MH(                              \
      const float* mod, const int* idx, const float* rel, const float* packed, float* sdf,    \
      float* std_, int n, void* stream) {                                                     \
    static bool attr_set[MAX_DEVICES] = {};                                                   \
    return launch_blocks(decode_fwd_kernel_film<L, H, NL, MH>, attr_set,                      \
                         trunk_smem<L, H, NL, MH>(K3_RING), (n + BM - 1) / BM, stream, mod,   \
                         idx, rel, packed, sdf, std_, n);                                     \
  }

// pi-GAN's published widths (latent_dim 256, hidden_dim 256, eight FiLM
// layers, a 256-wide mapping network)
FILM_INSTANCE(256, 256, 8, 256)
