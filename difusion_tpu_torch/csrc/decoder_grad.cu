// Fused decoder kernels, f32, sm_90a: kernel 1 (forward + d(sdf)/d(xyz), for
// the GN SDF term) and kernel 3 (forward only, for the mesher's lattice
// decode, at the end of this file).  Both read the same packed weights.
//
// Kernel 1 replaces the Pallas TPU kernel difusion_tpu/ops/decoder_fused.py
// `_mlp_grad_kernel` (reached through `decode_grad_fused_packed`).  Per point
// it runs the whole probabilistic-SDF decoder (5 linears, latent
// re-injection at layer 3, tanh sdf head, std = 0.05 + 0.5 softplus read
// from the last hidden layer) and then backpropagates the sdf ONLY to the 3
// xyz inputs (the latent is stop-gradiented; relu'(0) = 0):
//
//   dz3 = (1 - sdf^2) w_sdf * [h3 > 0]
//   dz2 = (dz3 W3a) * [h2 > 0];  dz1 = (dz2 W2) * [h1 > 0];  dz0 = (dz1 W1) * [h0 > 0]
//   dsdf/dxyz = dz3 W3b[:, xyz] + dz0 W0[:, xyz]
//
// What bounds it on an H100: arithmetic.  Per point the forward is 49,408
// multiply-adds and the backward 41,728 (~0.18 MFLOP), so one 8192-point
// evaluation is ~1.49 GFLOP against ~1.5 MB of input, weights and output.
// At the card's 67 TFLOP/s f32 (non-tensor-core) peak (H100 SXM, 700 W) that
// is >= 22 us, while the bytes need < 1 us.
//
// Design.  The TPU kernel kept the zero-padded (6, 128, 128) f32 weight
// stack resident in VMEM (384 KB); a block here has at most 227 KB of shared
// memory, and even the unpadded live weights are ~190 KB.  So a block of 256
// threads takes 64 points and walks the layers in order, staging ONE layer's
// weights at a time (largest 64 KB) from the L2-resident packed buffer into
// shared memory, next to two 64-point activation buffers and the input rows.
// Every layer is a block GEMM out[64][Nout] = act[64][K] @ W[K][Nout] where
// each thread owns a 4 x (Nout/16) register tile (rows ty+16i, cols tx+16j),
// in plain FP32 FMA: wgmma is bf16/TF32 and would break the f32 parity with
// the JAX reference.  The backward pass needs only the relu masks of h0..h3:
// a thread's backward tile of layer l is exactly its forward tile of layer
// l, so each thread keeps its 32 mask bits per layer in a register and the
// activations never leave the SM.  The packed buffer holds each weight in
// both orientations (W^T for the forward, W for the backward), so every
// stage is a contiguous float4 copy.  Ragged N: rows past n load zeros and
// store nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LAT = 29;
constexpr int DIN = 32;     // latent + xyz
constexpr int HID = 128;
constexpr int H2 = 96;      // layer 2 shrinks so [h2 | x] stays 128 wide
constexpr int BM = 64;      // points per block
constexpr int NT = 256;     // threads per block: 16 x 16 tiles
constexpr int LDA = 144;    // activation row stride: rows r, r+1 land 16 banks apart
constexpr int LDX = DIN + 1;

// packed layout (floats); must match ops/decoder_fused.py:pack_fused_decoder
constexpr int OFF_F0 = 0;                      // W0^T  [32][128]
constexpr int OFF_F1 = OFF_F0 + DIN * HID;     // W1^T  [128][128]
constexpr int OFF_F2 = OFF_F1 + HID * HID;     // W2^T  [128][96]
constexpr int OFF_F3 = OFF_F2 + HID * H2;      // W3^T  [128][128] (rows: h2 | x)
constexpr int OFF_G3 = OFF_F3 + HID * HID;     // W3[:, :96]  [128][96]
constexpr int OFF_G2 = OFF_G3 + HID * H2;      // W2    [96][128]
constexpr int OFF_G1 = OFF_G2 + H2 * HID;      // W1    [128][128]
constexpr int OFF_W3XYZ = OFF_G1 + HID * HID;  // W3[:, 125:128]  [128][3]
constexpr int OFF_W0XYZ = OFF_W3XYZ + HID * 3; // W0[:, 29:32]    [128][3]
constexpr int OFF_B0 = OFF_W0XYZ + HID * 3;
constexpr int OFF_B1 = OFF_B0 + HID;
constexpr int OFF_B2 = OFF_B1 + HID;
constexpr int OFF_B3 = OFF_B2 + H2;
constexpr int OFF_WSDF = OFF_B3 + HID;
constexpr int OFF_WSTD = OFF_WSDF + HID;
constexpr int OFF_BHEAD = OFF_WSTD + HID;      // b_sdf, b_std, 0, 0
constexpr int PACKED_SIZE = OFF_BHEAD + 4;

constexpr int SMEM_FLOATS = HID * HID + 2 * BM * LDA + BM * LDX;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;    // 148,224 B

// copy `count` floats (a multiple of 4, 16-byte aligned) global -> shared
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int count) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < count / 4; i += NT) d4[i] = __ldg(s4 + i);
}

template <int TN, int TM>
__device__ __forceinline__ void zero(float (&acc)[TM][8]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k A[ty+16i][k] * W[k][tx+16j]
template <int TN>
__device__ __forceinline__ void gemm(float (&acc)[4][8], const float* A, int lda,
                                     int K, const float* W, int ldw, int tx,
                                     int ty) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[TN];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = W[k * ldw + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// h = relu(acc + b) -> buf; returns the [h > 0] bits of this thread's tile
template <int TN>
__device__ __forceinline__ uint32_t bias_relu_store(
    const float (&acc)[4][8], const float* __restrict__ bias, float* buf,
    int tx, int ty) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float bj = __ldg(bias + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = acc[i][j] + bj;
      if (v > 0.f) {
        m |= 1u << (i * TN + j);
      } else {
        v = 0.f;
      }
      buf[(ty + 16 * i) * LDA + tx + 16 * j] = v;
    }
  }
  return m;
}

// dz = acc * [h > 0] -> buf
template <int TN>
__device__ __forceinline__ void mask_store(const float (&acc)[4][8], uint32_t m,
                                           float* buf, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      buf[(ty + 16 * i) * LDA + tx + 16 * j] =
          ((m >> (i * TN + j)) & 1u) ? acc[i][j] : 0.f;
}

// row r = tid/4 of buf[.][0:128] dotted with the 3 columns of w[128][3];
// 4 lanes per row, reduced with shuffles (valid in the part-0 lane)
__device__ __forceinline__ void row_dot3(const float* buf, const float* __restrict__ w,
                                         int r, int part, float (&out)[3]) {
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  const float* h = buf + r * LDA;
  for (int c = part * 32; c < part * 32 + 32; ++c) {
    const float d = h[c];
    g0 = fmaf(d, __ldg(w + 3 * c + 0), g0);
    g1 = fmaf(d, __ldg(w + 3 * c + 1), g1);
    g2 = fmaf(d, __ldg(w + 3 * c + 2), g2);
  }
#pragma unroll
  for (int s = 1; s < 4; s <<= 1) {
    g0 += __shfl_xor_sync(0xffffffffu, g0, s);
    g1 += __shfl_xor_sync(0xffffffffu, g1, s);
    g2 += __shfl_xor_sync(0xffffffffu, g2, s);
  }
  out[0] = g0;
  out[1] = g1;
  out[2] = g2;
}

__global__ void __launch_bounds__(NT)
decode_grad_kernel(const float* __restrict__ latent, const float* __restrict__ rel,
                   const float* __restrict__ P, float* __restrict__ sdf_out,
                   float* __restrict__ std_out, float* __restrict__ grad_out,
                   int n) {
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // one layer's weights
  float* bufA = W + HID * HID;                 // activations [64][LDA]
  float* bufB = bufA + BM * LDA;
  float* xs = bufB + BM * LDA;                 // inputs [64][LDX]
  __shared__ float sdf_s[BM];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int hr = tid >> 2, hpart = tid & 3;    // head/xyz reductions: 4 lanes a row
  const int n0 = blockIdx.x * BM;

  for (int idx = tid; idx < BM * DIN; idx += NT) {
    const int r = idx / DIN, k = idx % DIN, g = n0 + r;
    float v = 0.f;
    if (g < n) v = k < LAT ? latent[(size_t)g * LAT + k] : rel[(size_t)g * 3 + k - LAT];
    xs[r * LDX + k] = v;
  }
  stage(W, P + OFF_F0, DIN * HID);
  __syncthreads();

  float acc[4][8];
  // ---- forward ----
  zero<8>(acc);
  gemm<8>(acc, xs, LDX, DIN, W, HID, tx, ty);                 // layer 0
  __syncthreads();
  const uint32_t m0 = bias_relu_store<8>(acc, P + OFF_B0, bufA, tx, ty);
  stage(W, P + OFF_F1, HID * HID);
  __syncthreads();

  zero<8>(acc);
  gemm<8>(acc, bufA, LDA, HID, W, HID, tx, ty);               // layer 1
  __syncthreads();
  const uint32_t m1 = bias_relu_store<8>(acc, P + OFF_B1, bufB, tx, ty);
  stage(W, P + OFF_F2, HID * H2);
  __syncthreads();

  zero<6>(acc);
  gemm<6>(acc, bufB, LDA, HID, W, H2, tx, ty);                // layer 2: 128 -> 96
  __syncthreads();
  const uint32_t m2 = bias_relu_store<6>(acc, P + OFF_B2, bufA, tx, ty);
  stage(W, P + OFF_F3, HID * HID);
  __syncthreads();

  zero<8>(acc);
  gemm<8>(acc, bufA, LDA, H2, W, HID, tx, ty);                // layer 3: [h2 | x]
  gemm<8>(acc, xs, LDX, DIN, W + H2 * HID, HID, tx, ty);
  const uint32_t m3 = bias_relu_store<8>(acc, P + OFF_B3, bufB, tx, ty);
  __syncthreads();

  {  // heads: sdf = tanh(h3 . w_sdf + b), std = 0.05 + 0.5 softplus(h3 . w_std + b)
    float zs = 0.f, zd = 0.f;
    const float* h = bufB + hr * LDA;
    for (int c = hpart * 32; c < hpart * 32 + 32; ++c) {
      zs = fmaf(h[c], __ldg(P + OFF_WSDF + c), zs);
      zd = fmaf(h[c], __ldg(P + OFF_WSTD + c), zd);
    }
#pragma unroll
    for (int s = 1; s < 4; s <<= 1) {
      zs += __shfl_xor_sync(0xffffffffu, zs, s);
      zd += __shfl_xor_sync(0xffffffffu, zd, s);
    }
    if (hpart == 0) {
      zs += __ldg(P + OFF_BHEAD);
      zd += __ldg(P + OFF_BHEAD + 1);
      const float s = tanhf(zs);
      sdf_s[hr] = s;
      const int g = n0 + hr;
      if (g < n) {
        sdf_out[g] = s;
        std_out[g] = 0.05f + 0.5f * (fmaxf(zd, 0.f) + log1pf(expf(-fabsf(zd))));
      }
    }
  }
  stage(W, P + OFF_G3, HID * H2);
  __syncthreads();

  // ---- backward (sdf only) ----
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = sdf_s[ty + 16 * i];
    const float t = 1.f - s * s;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bufA[(ty + 16 * i) * LDA + tx + 16 * j] =
          ((m3 >> (i * 8 + j)) & 1u) ? t * __ldg(P + OFF_WSDF + tx + 16 * j) : 0.f;
  }
  __syncthreads();

  float gx3[3];
  row_dot3(bufA, P + OFF_W3XYZ, hr, hpart, gx3);            // dz3 . W3b[:, xyz]

  zero<6>(acc);
  gemm<6>(acc, bufA, LDA, HID, W, H2, tx, ty);                // dh2 = dz3 W3a
  __syncthreads();
  mask_store<6>(acc, m2, bufB, tx, ty);
  stage(W, P + OFF_G2, H2 * HID);
  __syncthreads();

  zero<8>(acc);
  gemm<8>(acc, bufB, LDA, H2, W, HID, tx, ty);                // dh1 = dz2 W2
  __syncthreads();
  mask_store<8>(acc, m1, bufA, tx, ty);
  stage(W, P + OFF_G1, HID * HID);
  __syncthreads();

  zero<8>(acc);
  gemm<8>(acc, bufA, LDA, HID, W, HID, tx, ty);               // dh0 = dz1 W1
  mask_store<8>(acc, m0, bufB, tx, ty);
  __syncthreads();

  float gx0[3];
  row_dot3(bufB, P + OFF_W0XYZ, hr, hpart, gx0);            // dz0 . W0[:, xyz]
  const int g = n0 + hr;
  if (hpart == 0 && g < n) {
#pragma unroll
    for (int j = 0; j < 3; ++j) grad_out[(size_t)g * 3 + j] = gx3[j] + gx0[j];
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: the decoder forward alone (sdf, std), for the mesher's lattice
// decode.  Replaces the Pallas TPU kernel difusion_tpu/ops/decoder_fused.py
// `_mlp_kernel` (reached through `decode_fused_packed`).
//
// What bounds it: arithmetic.  49,408 multiply-adds a point against 136
// bytes of input and output, so at N = 2^20 lattice sites 103.6 GFLOP need
// >= 1.55 ms at 67 TFLOP/s f32 while the bytes need 0.04 ms.
//
// Design.  The layer walk of kernel 1 over the same packed W^T segments, but
// with no backward there are no relu masks to keep: a block of 256 threads
// takes 128 points (8 rows x 8 columns a thread), which halves the weight
// re-staging per point.  One activation buffer suffices, because every
// layer reads it to the end of its GEMM, syncs, and only then overwrites
// it.  The A operand is read as float4 along k (one 16-byte load feeds 4
// k-steps), so a k-step costs 2 + 8 shared loads for 64 FMAs.  The two
// 1-wide heads reduce straight from the layer-3 registers across the 16
// threads that share a row group (shuffles), so h3 never reaches shared
// memory.  Plain FP32 FMA, as kernel 1.  Ragged N: rows past n load zeros
// and store nothing.
constexpr int FBM = 128;          // points per block
constexpr int FTM = FBM / 16;     // rows per thread
constexpr int FLDX = 36;          // input row stride, float4-aligned
constexpr int FWD_SMEM_BYTES = (HID * HID + FBM * LDA + FBM * FLDX) * 4;  // 157,696 B

// acc[i][j] += sum_k A[ty+16i][k] * W[k][tx+16j], A read 4 k-steps at a time
template <int TN>
__device__ __forceinline__ void gemm4(float (&acc)[FTM][8], const float* A, int lda,
                                      int K, const float* W, int ldw, int tx,
                                      int ty) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[FTM];
#pragma unroll
    for (int i = 0; i < FTM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = W[(k + kk) * ldw + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < FTM; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

// buf = relu(acc + b)
template <int TN>
__device__ __forceinline__ void bias_relu_fwd(const float (&acc)[FTM][8],
                                              const float* __restrict__ bias,
                                              float* buf, int tx, int ty) {
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float bj = __ldg(bias + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < FTM; ++i) {
      const float v = acc[i][j] + bj;
      buf[(ty + 16 * i) * LDA + tx + 16 * j] = v > 0.f ? v : 0.f;
    }
  }
}

__global__ void __launch_bounds__(NT)
decode_fwd_kernel(const float* __restrict__ latent, const float* __restrict__ rel,
                  const float* __restrict__ P, float* __restrict__ sdf_out,
                  float* __restrict__ std_out, int n) {
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // one layer's weights
  float* buf = W + HID * HID;                  // activations [128][LDA]
  float* xs = buf + FBM * LDA;                 // inputs [128][FLDX]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * FBM;

  for (int idx = tid; idx < FBM * DIN; idx += NT) {
    const int r = idx / DIN, k = idx % DIN, g = n0 + r;
    float v = 0.f;
    if (g < n) v = k < LAT ? latent[(size_t)g * LAT + k] : rel[(size_t)g * 3 + k - LAT];
    xs[r * FLDX + k] = v;
  }
  stage(W, P + OFF_F0, DIN * HID);
  __syncthreads();

  float acc[FTM][8];
  zero<8>(acc);
  gemm4<8>(acc, xs, FLDX, DIN, W, HID, tx, ty);               // layer 0
  __syncthreads();
  bias_relu_fwd<8>(acc, P + OFF_B0, buf, tx, ty);
  stage(W, P + OFF_F1, HID * HID);
  __syncthreads();

  zero<8>(acc);
  gemm4<8>(acc, buf, LDA, HID, W, HID, tx, ty);               // layer 1
  __syncthreads();
  bias_relu_fwd<8>(acc, P + OFF_B1, buf, tx, ty);
  stage(W, P + OFF_F2, HID * H2);
  __syncthreads();

  zero<6>(acc);
  gemm4<6>(acc, buf, LDA, HID, W, H2, tx, ty);                // layer 2: 128 -> 96
  __syncthreads();
  bias_relu_fwd<6>(acc, P + OFF_B2, buf, tx, ty);
  stage(W, P + OFF_F3, HID * HID);
  __syncthreads();

  zero<8>(acc);
  gemm4<8>(acc, buf, LDA, H2, W, HID, tx, ty);                // layer 3: [h2 | x]
  gemm4<8>(acc, xs, FLDX, DIN, W + H2 * HID, HID, tx, ty);

  // heads: sdf = tanh(h3 . w_sdf + b), std = 0.05 + 0.5 softplus(h3 . w_std + b)
  float b3[8], ws[8], wd[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    b3[j] = __ldg(P + OFF_B3 + tx + 16 * j);
    ws[j] = __ldg(P + OFF_WSDF + tx + 16 * j);
    wd[j] = __ldg(P + OFF_WSTD + tx + 16 * j);
  }
  const float b_sdf = __ldg(P + OFF_BHEAD), b_std = __ldg(P + OFF_BHEAD + 1);
#pragma unroll
  for (int i = 0; i < FTM; ++i) {
    float zs = 0.f, zd = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float h = acc[i][j] + b3[j];
      h = h > 0.f ? h : 0.f;
      zs = fmaf(h, ws[j], zs);
      zd = fmaf(h, wd[j], zd);
    }
#pragma unroll
    for (int s = 8; s >= 1; s >>= 1) {   // the 16 lanes of a row group
      zs += __shfl_xor_sync(0xffffffffu, zs, s);
      zd += __shfl_xor_sync(0xffffffffu, zd, s);
    }
    const int g = n0 + ty + 16 * i;
    if (tx == i && g < n) {
      zs += b_sdf;
      zd += b_std;
      sdf_out[g] = tanhf(zs);
      std_out[g] = 0.05f + 0.5f * (fmaxf(zd, 0.f) + log1pf(expf(-fabsf(zd))));
    }
  }
}

}  // namespace

extern "C" int decode_grad_packed_size() { return PACKED_SIZE; }

// latent (n, 29), rel (n, 3), packed (PACKED_SIZE,) f32 contiguous on the
// device; writes sdf (n,), std (n,), grad (n, 3).  Returns cudaGetLastError().
extern "C" int decode_grad_launch(const float* latent, const float* rel,
                                  const float* packed, float* sdf, float* std_,
                                  float* grad, int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + BM - 1) / BM;
  decode_grad_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      latent, rel, packed, sdf, std_, grad, n);
  return (int)cudaGetLastError();
}

// Kernel 3: latent (n, 29), rel (n, 3), packed (PACKED_SIZE,) f32 contiguous
// on the device; writes sdf (n,), std (n,).  Returns cudaGetLastError().
extern "C" int decode_fwd_launch(const float* latent, const float* rel,
                                 const float* packed, float* sdf, float* std_,
                                 int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + FBM - 1) / FBM;
  decode_fwd_kernel<<<grid, NT, FWD_SMEM_BYTES, (cudaStream_t)stream>>>(
      latent, rel, packed, sdf, std_, n);
  return (int)cudaGetLastError();
}
