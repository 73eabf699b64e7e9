// Kernels 1 and 3 for decoders too wide for shared memory (3xTF32 on the
// tensor cores, f32 accumulation), sm_90a: the wide instances beside
// decoder_grad.cu's 128-wide ones.  Same functions: kernel 1 is the forward
// plus d(sdf)/d(xyz) for the GN SDF term, kernel 3 the forward for the
// mesher's lattice decode.  They replace, for these widths, the Pallas TPU
// kernels difusion_tpu/ops/decoder_fused.py `_mlp_grad_kernel` and
// `_mlp_kernel`, which the JAX package runs at the 128-wide decoder only.
//
// The decoder (di_decoder at any width): D hidden layers of width H, the
// input x = [latent (L) | xyz (3)] fed again at layer J (the layer before it
// narrowed to H - L - 3 so that the concat is H wide), relu after every
// hidden layer, sdf = tanh(h . w_sdf + b), std = 0.05 + 0.5 softplus(h .
// w_std + b) on the last hidden layer h.  Kernel 1 then backpropagates the
// sdf ONLY to the 3 xyz inputs (the latent is held constant; relu'(0) = 0):
//
//   dz_{D-1} = (1 - sdf^2) w_sdf * [h_{D-1} > 0]
//   dz_{l-1} = (dz_l W_l[:, hidden]) * [h_{l-1} > 0],  l = D-1 .. 1
//   dsdf/dxyz = dz_J W_J[:, xyz] + dz_0 W_0[:, xyz]
//
// Instances: H a multiple of 64 up to 512, one latent_in layer 1 <= J < D;
// instantiated at the end of this file (ops/decoder_fused.WIDE_INSTANCES
// lists them).  DeepSDF's decoder (L 256, 8 x 512, J 4; arXiv:1901.05103):
// layers (259, 512), (512, 512) x 2, (512, 253), (512, 512) x 4, (512, 1).
//
// What bounds them on an H100: arithmetic.  DeepSDF's forward is 1.84 M
// multiply-adds a point and the backward 1.57 M: kernel 3 at a 2^20-site
// dispatch is 3.85 TFLOP, kernel 1 at 8192 points 55.9 GFLOP, counted once;
// 3xTF32 triples the tensor-core work, so at the card's 495 TFLOP/s dense TF32
// (H100 SXM, 700 W) they take at least 23 ms and 0.34 ms.  The weights are
// 7.4 MB in f32 (the 128-wide kernels' hi/lo fragments would be 14.7 MB),
// far past the 227 KB of shared memory a block has: they stream from L2.
//
// Design (wide_tc.cuh holds the machinery below, shared with decoder_cbn.cu;
// mlp_tc.cuh has the fragment algebra the 128-wide kernels use; the
// same m16n8k8 tiling and permuted-row fragments, `ops/decoder_fused.
// _wide_frag`).
// * A block holds 64 rows.  Its activations live in shared memory, [64][LDA]
//   f32 (LDA = 520 at DeepSDF's widths: layer 4's input, 256 + 264 columns
//   after padding; 130 KB).  8 warps: 2 row groups of 32 rows x 4 column
//   parts, so a warp holds 32 rows x H/4 columns of the layer's output as
//   mma accumulators (128 registers at H = 512) until every warp has read
//   the layer's input, then all overwrite it between two barriers.  A
//   k-tile's B fragment feeds 2 m-tiles and its A fragment 16 n-tiles.
// * The weights stream in multiplication order (forward W_0^T .. W_{D-1}^T,
//   then for kernel 1 W_{D-1} .. W_1 restricted to their hidden inputs), one
//   k-tile of a layer (8 rows x all its columns: 16 KB at H = 512) a chunk,
//   as f32 fragments, each chunk one TMA bulk copy into a ring of shared
//   memory slots with (full, empty) mbarriers.  Thread 0 keeps the copies
//   RING - 2 chunks ahead of the chunk it multiplies, so a warp may hold two
//   chunks at once; warps drift apart and one's loads overlap another's mma.
//   Streaming f32 and splitting in registers halves the L2 traffic of a
//   hi/lo pack: every block reads every chunk once, 7.4 MB a block at
//   DeepSDF's widths (121 GB of L2 reads a 2^20-site dispatch).
// * Products in 3xTF32: each operand x splits as hi = tf32(x) (cvt.rna)
//   and lo = x - hi, of which the tensor cores read the top 19 bits; the
//   product accumulates as lo.hi + hi.lo + hi.hi.  The tensor cores add
//   products to their accumulator with truncation, so the 6 mma of two
//   k-tiles sum from zero (the first with a zero accumulator operand) and
//   join the f32 accumulator with a rounded FADD (mlp_tc.cuh says why).
// * Odd widths are zero-padded in the pack: the input to a multiple of 8
//   (259 -> 264), the layer before latent_in to a multiple of 64 (253 ->
//   256); padded columns come out relu(0 + 0) = 0.  The input is read from
//   device memory again at layer J into the columns after h_{J-1}.
// * Heads and xyz row-dots: per row from shared memory (4 threads a row,
//   reduced by shuffles), in a fixed order.  Kernel 1 parks each hidden
//   layer's relu mask bits in shared memory (four words a thread a layer)
//   from the forward until the backward needs them.
//
// On the H100 (PERF.md §6): 255 registers, no spills; kernel 3 80.3 ms at
// 2^20 sites (the plain path 92.9), kernel 1 1.15 ms at 8192 points (1.55):
// ~150 TFLOP/s of TF32 products, as the 128-wide kernels reach.  Tilings
// timed against this one: 8 warps of all 64 rows x 64 columns (76.5-77.0
// and 1.21 ms, spilling), 16 warps of 32 rows x 64 columns (83.1 and 1.20,
// spilling in kernel 1), 16 warps of 16 rows x 128 columns (89.5 and 1.32).
//
// Shared memory at DeepSDF's widths: kernel 1 a ring of 4 slots (64 KB),
// the activations, 64 floats of sdf, 8 parked masks (32 KB) and the
// barriers: 231,744 B; kernel 3 a ring of 5 slots: 215,376 B.  Row strides
// of 8 mod 32 floats put the 8-byte fragment loads and stores of a
// half-warp on distinct banks.  Ragged N: rows past n load zeros and store
// nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_tc.cuh"

namespace {

using namespace wide_tc;

// The layout of one instance: widths, padding and the packed buffer's
// offsets (floats), as ops/decoder_fused.WideLayout lays it out.
template <int L, int H, int D, int J>
struct Wide {
  static_assert(H % 64 == 0 && H <= 512, "the hidden width is a multiple of 64 up to 512");
  static_assert(1 <= J && J < D && L + 3 < H, "one latent_in layer 1 <= J < D");
  static_assert(H % (8 * PARTS) == 0 && rup(H - L - 3, 64) % (8 * PARTS) == 0,
                "every layer's width splits into the column parts' n-tiles");
  static constexpr int IN = L + 3;
  static constexpr int K0 = rup(IN, 8);        // the input, padded
  static constexpr int NJ = rup(H - IN, 64);   // layer J-1's output, padded
  static constexpr int KJ = NJ + K0;           // layer J's input [h_{J-1} | x]
  static constexpr int W = cmax(cmax(H, KJ), K0);
  static constexpr int LDA = W + (40 - W % 32) % 32;  // >= W, = 8 mod 32
  static constexpr int NTN_H = H / (8 * PARTS), NTN_J = NJ / (8 * PARTS);  // n-tiles a warp
  static constexpr int PW = (MT * NTN_H * 4 + 31) / 32;  // words of mask bits a lane a layer

  __host__ __device__ static constexpr int K(int l) { return l == 0 ? K0 : (l == J ? KJ : H); }
  __host__ __device__ static constexpr int N(int l) { return l == J - 1 ? NJ : H; }
  // the hidden part of layer l's input (l >= 1): the backward's width
  __host__ __device__ static constexpr int HK(int l) { return l == J ? NJ : H; }

  static constexpr int OFF_META = 0;  // L, H, D, J: the wrapper reads them on the CPU
  static constexpr int OFF_F = OFF_META + 4;  // W_l^T, l = 0 .. D-1
  __host__ __device__ static constexpr int f_end() {
    int s = 0;
    for (int l = 0; l < D; ++l) s += K(l) * N(l);
    return s;
  }
  __host__ __device__ static constexpr int g_end() {
    int s = 0;
    for (int l = 1; l < D; ++l) s += N(l) * HK(l);
    return s;
  }
  __host__ __device__ static constexpr int off_b(int l) {
    int s = OFF_F + f_end();
    for (int i = 0; i < l; ++i) s += N(i);
    return s;
  }
  static constexpr int OFF_WSDF = off_b(D);
  static constexpr int OFF_WSTD = OFF_WSDF + H;
  static constexpr int OFF_BHEAD = OFF_WSTD + H;  // b_sdf, b_std, 0, 0
  static constexpr int OFF_W0XYZ = OFF_BHEAD + 4;  // W_0[:, xyz]  [N(0)][3]
  static constexpr int OFF_WJXYZ = OFF_W0XYZ + 3 * N(0);  // W_J[:, xyz]  [H][3]
  static constexpr int OFF_FRAG = rup(OFF_WJXYZ + 3 * H, 4);
  static constexpr int PACKED = OFF_FRAG + f_end() + g_end();
  static_assert(OFF_WSDF % 2 == 0, "bias and head vectors are read as float2");

  // the streamed matrices: s < D the forward's W_s^T, s >= D the backward's
  // W_l[:, hidden] for l = 2D - 1 - s; each k-tile one chunk
  __host__ __device__ static constexpr int s_layer(int s) { return s < D ? s : 2 * D - 1 - s; }
  __host__ __device__ static constexpr int s_ktiles(int s) {
    return s < D ? K(s) / 8 : N(s_layer(s)) / 8;
  }
  __host__ __device__ static constexpr int s_cols(int s) {
    return s < D ? N(s) : HK(s_layer(s));
  }
  __host__ __device__ static constexpr int chunks(bool grad) {
    int c = 0;
    for (int s = 0; s < (grad ? 2 * D - 1 : D); ++s) c += s_ktiles(s);
    return c;
  }
  static constexpr int CHUNKS_FWD = chunks(false), CHUNKS_ALL = chunks(true);
  static constexpr int SLOT = 8 * H;  // floats: one k-tile of the widest layer

  template <bool GRAD, int RING>
  static constexpr int smem_bytes() {
    return RING * SLOT * 4 + BM * LDA * 4 + BM * 4 + (GRAD ? D * PW * NTHR * 4 : 0) +
           2 * RING * 8;
  }
};

// the block's 64 input rows x = [latent | xyz | 0 ..] into columns col0 ..
// col0 + K0 - 1 of the activation rows (rows past n: zeros)
template <class Lay, int L>
__device__ __forceinline__ void load_x(float* act, int col0, const float* __restrict__ latent,
                                       const float* __restrict__ rel, int n0, int n, int tid) {
  for (int idx = tid; idx < BM * Lay::K0; idx += NTHR) {
    const int r = idx / Lay::K0, k = idx % Lay::K0, gr = n0 + r;
    float v = 0.f;
    if (gr < n && k < Lay::IN) v = k < L ? latent[(size_t)gr * L + k] : rel[(size_t)gr * 3 + k - L];
    act[r * Lay::LDA + col0 + k] = v;
  }
}

template <int L, int H, int D, int J, bool GRAD, int RING>
__device__ __forceinline__ void wide_body(const float* __restrict__ latent,
                                          const float* __restrict__ rel,
                                          const float* __restrict__ P, float* __restrict__ sdf_out,
                                          float* __restrict__ std_out,
                                          float* __restrict__ grad_out, int n) {
  using Lay = Wide<L, H, D, J>;
  constexpr int LDA = Lay::LDA, NTN_H = Lay::NTN_H, NTN_J = Lay::NTN_J;
  extern __shared__ float4 smem4[];
  float* slots = reinterpret_cast<float*>(smem4);
  float* act = slots + RING * Lay::SLOT;                    // [BM][LDA]
  float* s_sdf = act + BM * LDA;                            // [BM]
  uint32_t* park = reinterpret_cast<uint32_t*>(s_sdf + BM);  // [D][PW][NTHR]
  uint64_t* bars = reinterpret_cast<uint64_t*>(park + (GRAD ? D * Lay::PW * NTHR : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int part = warp % PARTS, rg = warp / PARTS;
  const int n0 = blockIdx.x * BM;
  float* a0 = act + (rg * 16 * MT + g) * LDA + 2 * t;   // the lane's fragment rows

  Stream<Lay, RING> st{slots, P + Lay::OFF_FRAG, bars, bars + RING, tid,
                       GRAD ? Lay::CHUNKS_ALL : Lay::CHUNKS_FWD};
  st.init();
  st.start();
  load_x<Lay, L>(act, 0, latent, rel, n0, n, tid);
  __syncthreads();  // the inputs and the stream's barriers are ready

  float z[MT][NTN_H][4];
  int it = 0;

  // ---- forward ----
#pragma unroll 1
  for (int l = 0; l < D; ++l) {
    const float* bias = P + Lay::off_b(l);
    uint4 bits;
    if (l == J - 1) {
      gemm<NTN_J, NTN_H, LDA>(z, a0, Lay::K(l) / 8, part * NTN_J, st, it, lane);
      bits = bias_relu<NTN_J>(z, bias, part * NTN_J, t);
      __syncthreads();
      store<NTN_J, NTN_H, LDA>(z, a0, part * NTN_J);
      load_x<Lay, L>(act, Lay::NJ, latent, rel, n0, n, tid);   // layer J's input: [h | x]
    } else {
      gemm<NTN_H, NTN_H, LDA>(z, a0, Lay::K(l) / 8, part * NTN_H, st, it, lane);
      bits = bias_relu<NTN_H>(z, bias, part * NTN_H, t);
      __syncthreads();
      store<NTN_H, NTN_H, LDA>(z, a0, part * NTN_H);
    }
    __syncthreads();
    if constexpr (GRAD) {
      const uint32_t w[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
      for (int i = 0; i < Lay::PW; ++i) park[(l * Lay::PW + i) * NTHR + tid] = w[i];
    }
  }

  // heads on the last hidden layer: TPR threads a row, half for each head
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
    // ---- backward (sdf only) ----
    __syncthreads();   // s_sdf is written; the heads have read the rows
    {
      const int nb = part * NTN_H;
#pragma unroll
      for (int nt = 0; nt < NTN_H; ++nt) {   // dz_{D-1}
        const float2 ws =
            __ldg(reinterpret_cast<const float2*>(P + Lay::OFF_WSDF) + 4 * (nb + nt) + t);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sq = s_sdf[rg * 16 * MT + 16 * m + g + 8 * (e >> 1)];
            z[m][nt][e] = (1.f - sq * sq) * ((e & 1) ? ws.y : ws.x);
          }
      }
      uint32_t w[4] = {};
#pragma unroll
      for (int i = 0; i < Lay::PW; ++i) w[i] = park[((D - 1) * Lay::PW + i) * NTHR + tid];
      relu_grad<NTN_H>(z, make_uint4(w[0], w[1], w[2], w[3]));
      store<NTN_H, NTN_H, LDA>(z, a0, nb);
      __syncthreads();
    }
    float gx[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
    for (int l = D - 1; l >= 1; --l) {
      uint32_t w[4] = {};
#pragma unroll
      for (int i = 0; i < Lay::PW; ++i) w[i] = park[((l - 1) * Lay::PW + i) * NTHR + tid];
      const uint4 bits = make_uint4(w[0], w[1], w[2], w[3]);
      if (l == J) {   // dh_{J-1} = dz_J W_J[:, hidden]: NJ wide
        gemm<NTN_J, NTN_H, LDA>(z, a0, Lay::N(l) / 8, part * NTN_J, st, it, lane);
        row_dot3<LDA>(act, P + Lay::OFF_WJXYZ, Lay::N(l), tid, gx);  // dz_J . W_J[:, xyz]
        relu_grad<NTN_J>(z, bits);
        __syncthreads();
        store<NTN_J, NTN_H, LDA>(z, a0, part * NTN_J);
      } else {
        gemm<NTN_H, NTN_H, LDA>(z, a0, Lay::N(l) / 8, part * NTN_H, st, it, lane);
        relu_grad<NTN_H>(z, bits);
        __syncthreads();
        store<NTN_H, NTN_H, LDA>(z, a0, part * NTN_H);
      }
      __syncthreads();
    }
    float g0[3] = {0.f, 0.f, 0.f};
    row_dot3<LDA>(act, P + Lay::OFF_W0XYZ, Lay::N(0), tid, g0);   // dz_0 . W_0[:, xyz]
    const int r = tid / TPR, row = n0 + r;
    if (tid % TPR == 0 && row < n) {
#pragma unroll
      for (int j = 0; j < 3; ++j) grad_out[(size_t)row * 3 + j] = gx[j] + g0[j];
    }
  }
}

constexpr int K1_RING = 4, K3_RING = 5;

template <int L, int H, int D, int J>
__global__ void __launch_bounds__(NTHR, 1)
decode_grad_kernel_wide(const float* __restrict__ latent, const float* __restrict__ rel,
                        const float* __restrict__ P, float* __restrict__ sdf_out,
                        float* __restrict__ std_out, float* __restrict__ grad_out, int n) {
  wide_body<L, H, D, J, true, K1_RING>(latent, rel, P, sdf_out, std_out, grad_out, n);
}

template <int L, int H, int D, int J>
__global__ void __launch_bounds__(NTHR, 1)
decode_fwd_kernel_wide(const float* __restrict__ latent, const float* __restrict__ rel,
                       const float* __restrict__ P, float* __restrict__ sdf_out,
                       float* __restrict__ std_out, int n) {
  wide_body<L, H, D, J, false, K3_RING>(latent, rel, P, sdf_out, std_out, nullptr, n);
}

}  // namespace

// One instance's C entry points: its packed size (the wrapper checks it
// against ops/decoder_fused.WideLayout), kernel 1 (latent (n, L), rel (n, 3),
// packed f32 contiguous on the device -> sdf (n,), std (n,), grad (n, 3)) and
// kernel 3 (-> sdf, std).  Each returns cudaGetLastError().
#define WIDE_INSTANCE(L, H, D, J)                                                             \
  static_assert(Wide<L, H, D, J>::smem_bytes<true, K1_RING>() <= 232448 &&                    \
                    Wide<L, H, D, J>::smem_bytes<false, K3_RING>() <= 232448,                 \
                "a block has 227 KB of shared memory");                                       \
  extern "C" int decode_wide_packed_size_##L##_##H##_##D##_##J() {                            \
    return Wide<L, H, D, J>::PACKED;                                                          \
  }                                                                                           \
  extern "C" int decode_grad_wide_launch_##L##_##H##_##D##_##J(                               \
      const float* latent, const float* rel, const float* packed, float* sdf, float* std_,    \
      float* grad, int n, void* stream) {                                                     \
    static bool attr_set[MAX_DEVICES] = {};                                                   \
    return launch(decode_grad_kernel_wide<L, H, D, J>, attr_set,                              \
                  Wide<L, H, D, J>::smem_bytes<true, K1_RING>(), n, stream, latent, rel,      \
                  packed, sdf, std_, grad, n);                                                \
  }                                                                                           \
  extern "C" int decode_fwd_wide_launch_##L##_##H##_##D##_##J(                                \
      const float* latent, const float* rel, const float* packed, float* sdf, float* std_,    \
      int n, void* stream) {                                                                  \
    static bool attr_set[MAX_DEVICES] = {};                                                   \
    return launch(decode_fwd_kernel_wide<L, H, D, J>, attr_set,                               \
                  Wide<L, H, D, J>::smem_bytes<false, K3_RING>(), n, stream, latent, rel,     \
                  packed, sdf, std_, n);                                                      \
  }

// DeepSDF's decoder (code 256, 8 x 512, latent_in [4])
WIDE_INSTANCE(256, 512, 8, 4)
