// The tiled 3xTF32 machinery of the wide decoder kernels (decoder_wide.cu)
// and onet_cbn's kernels (decoder_cbn.cu): a block's tiling, the weight
// stream through a ring of shared-memory slots, the 3xTF32 k-tile products,
// the fragment stores and row dots, and the launch.  A layout class `Lay`
// gives the stream its matrices: `s_cols(s)`, `s_ktiles(s)` and `SLOT`.
// decoder_wide.cu's header comment describes the design.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tc.cuh"

namespace wide_tc {

using mlp_tc::bulk_copy;
using mlp_tc::mbar_arrive;
using mlp_tc::mbar_arrive_expect_tx;
using mlp_tc::mbar_init;
using mlp_tc::mbar_wait;
using mlp_tc::mma_tf32;

// the block's tiling: WARPS warps over 64 rows, each MT m-tiles (16 MT
// rows) by a column part; RG row groups x PARTS column parts (PERF.md has
// the tilings timed against this one)
constexpr int WARPS = 8, NTHR = 32 * WARPS, BM = 64, MT = 2;
constexpr int RG = BM / (16 * MT), PARTS = WARPS / RG;
constexpr int TPR = NTHR / BM;   // threads a row in the per-row phases
static_assert(RG * 16 * MT == BM && RG * PARTS == WARPS && TPR >= 4, "the block's tiling");

__host__ __device__ constexpr int rup(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The weight stream: chunk j (one k-tile of a streamed matrix) through RING
// shared-memory slots, one TMA bulk copy each.  Thread 0 is the producer and
// walks the stream in order with a cursor; acquire(j) first issues every
// chunk up to j + RING - 2, then waits for chunk j.  A chunk reuses the slot
// of the chunk RING before it once every warp has released that one; since
// a warp holds at most two chunks (j - 1 and j) when it asks for j, the
// chunk two behind is always released or about to be.
template <class Lay, int RING>
struct Stream {
  float* slots;
  const float* src;   // the fragment segment
  uint64_t* full;     // [RING]
  uint64_t* empty;    // [RING]
  int tid, total;
  int next, s, kt, off;  // producer cursor (thread 0)

  __device__ __forceinline__ void init() {
    next = s = kt = off = 0;
    if (tid == 0) {
      for (int i = 0; i < RING; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, NTHR / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  __device__ __forceinline__ void issue_to(int last) {  // thread 0
    while (next <= last && next < total) {
      const int slot = next % RING, use = next / RING;
      if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
      const uint32_t bytes = 32u * Lay::s_cols(s);
      mbar_arrive_expect_tx(full + slot, bytes);
      bulk_copy(slots + slot * Lay::SLOT, src + off, bytes, full + slot);
      off += 8 * Lay::s_cols(s);
      if (++kt == Lay::s_ktiles(s)) {
        kt = 0;
        ++s;
      }
      ++next;
    }
  }

  __device__ __forceinline__ void start() {
    if (tid == 0) issue_to(RING - 2);
  }

  __device__ __forceinline__ const float2* acquire(int j) {
    if (tid == 0) issue_to(j + RING - 2);
    mbar_wait(full + j % RING, (j / RING) & 1);
    return reinterpret_cast<const float2*>(slots + (j % RING) * Lay::SLOT);
  }

  __device__ __forceinline__ void release(int j) {
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + j % RING);
  }
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi rounded to TF32, lo the exact rest; the tensor cores read
// only the top 19 bits of lo (truncation), which keeps ~22 bits of x
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// this lane's A values of k-tile kt for its MT m-tiles, split: mma register
// order (row g k-pos t, row g+8 k-pos t, row g k-pos t+4, row g+8 k-pos
// t+4), k-position t standing for column 2t and t+4 for 2t+1
template <int LDA>
__device__ __forceinline__ void load_a(const float* a0, int kt, uint32_t (&ah)[MT][4],
                                       uint32_t (&al)[MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* p = a0 + 16 * m * LDA + 8 * kt;
    const float2 r0 = *reinterpret_cast<const float2*>(p);
    const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * LDA);
    split(r0.x, ah[m][0], al[m][0]);
    split(r1.x, ah[m][1], al[m][1]);
    split(r0.y, ah[m][2], al[m][2]);
    split(r1.y, ah[m][3], al[m][3]);
  }
}

// d = a . b (16x8 by 8x8, tf32 in, f32 out) from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// c[m] (+)= A_m . B over one k-tile in 3xTF32, small terms first, the first
// product from zero when FIRST; b: this lane's f32 B values (rows 2t, 2t+1
// of column g of the n-tile)
template <bool FIRST>
__device__ __forceinline__ void mma3(float (&c)[MT][4], const uint32_t (&ah)[MT][4],
                                     const uint32_t (&al)[MT][4], float2 b) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b.x, bh0, bl0);
  split(b.y, bh1, bl1);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (FIRST)
      mma_tf32_zero(c[m], al[m], bh0, bh1);
    else
      mma_tf32(c[m], al[m], bh0, bh1);
    mma_tf32(c[m], ah[m], bl0, bl1);
    mma_tf32(c[m], ah[m], bh0, bh1);
  }
}

template <int NTN, int NTM>
__device__ __forceinline__ void zero(float (&z)[MT][NTM][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[m][nt][e] = 0.f;
}

// z = the activation rows (A, from a0) times the next KT chunks of the
// stream, on the warp's NTN n-tiles from nb.  Two k-tiles at a time: their
// 6 MT mma per n-tile sum from zero, then join z with a rounded FADD.
template <int NTN, int NTM, int LDA, class S>
__device__ __forceinline__ void gemm(float (&z)[MT][NTM][4], const float* a0, int KT, int nb,
                                     S& st, int& it, int lane) {
  zero<NTN>(z);
  const int pairs = KT / 2;
#pragma unroll 1
  for (int p = 0; p < pairs; ++p) {
    const float2* w0 = st.acquire(it) + nb * 32 + lane;
    const float2* w1 = st.acquire(it + 1) + nb * 32 + lane;
    uint32_t ah0[MT][4], al0[MT][4], ah1[MT][4], al1[MT][4];
    load_a<LDA>(a0, 2 * p, ah0, al0);
    load_a<LDA>(a0, 2 * p + 1, ah1, al1);
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      float c[MT][4];
      mma3<true>(c, ah0, al0, w0[nt * 32]);
      mma3<false>(c, ah1, al1, w1[nt * 32]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[m][nt][e] += c[m][e];
    }
    st.release(it);
    st.release(it + 1);
    it += 2;
  }
  if (KT & 1) {
    const float2* w0 = st.acquire(it) + nb * 32 + lane;
    uint32_t ah0[MT][4], al0[MT][4];
    load_a<LDA>(a0, KT - 1, ah0, al0);
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      float c[MT][4];
      mma3<true>(c, ah0, al0, w0[nt * 32]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[m][nt][e] += c[m][e];
    }
    st.release(it);
    it += 1;
  }
}

// z = relu(z + b) in place; returns the [z > 0] bits, bit i = 4 (NTN m + nt)
// + e of the 128 in word i / 32
template <int NTN, int NTM>
__device__ __forceinline__ uint4 bias_relu(float (&z)[MT][NTM][4],
                                           const float* __restrict__ bias, int nb, int t) {
  static_assert(MT * NTN * 4 <= 128, "128 mask bits a lane");
  uint32_t bits[4] = {};
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias) + 4 * (nb + nt) + t);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = z[m][nt][e] + ((e & 1) ? b.y : b.x);
        const float r = v > 0.f ? v : 0.f;
        z[m][nt][e] = r;
        const int i = 4 * (NTN * m + nt) + e;
        bits[i >> 5] |= (uint32_t)(r > 0.f) << (i & 31);
      }
  }
  return make_uint4(bits[0], bits[1], bits[2], bits[3]);
}

// z *= [h > 0] in place
template <int NTN, int NTM>
__device__ __forceinline__ void relu_grad(float (&z)[MT][NTM][4], uint4 bits) {
  const uint32_t b[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * (NTN * m + nt) + e;
        if (!((b[i >> 5] >> (i & 31)) & 1u)) z[m][nt][e] = 0.f;
      }
}

// the warp's output fragments -> the activation rows between two barriers:
// every warp has read the layer's input before (all warps read all of it),
// and sees the whole output after
template <int NTN, int NTM, int LDA>
__device__ __forceinline__ void store(const float (&z)[MT][NTM][4], float* a0, int nb) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      float* p = a0 + 16 * m * LDA + 8 * (nb + nt);
      *reinterpret_cast<float2*>(p) = make_float2(z[m][nt][0], z[m][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * LDA) = make_float2(z[m][nt][2], z[m][nt][3]);
    }
}

// row r's three dots of its `len` activations with w (len, 3), TPR threads
// a row (q = tid % TPR takes columns q, q + TPR, ..), added to g in a fixed
// order
template <int LDA>
__device__ __forceinline__ void row_dot3(const float* act, const float* __restrict__ w, int len,
                                         int tid, float (&g)[3]) {
  const int r = tid / TPR, q = tid % TPR;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int k = q; k < len; k += TPR) {
    const float a = act[r * LDA + k];
    s0 = fmaf(a, __ldg(w + 3 * k), s0);
    s1 = fmaf(a, __ldg(w + 3 * k + 1), s1);
    s2 = fmaf(a, __ldg(w + 3 * k + 2), s2);
  }
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  g[0] += s0;
  g[1] += s1;
  g[2] += s2;
}

constexpr int MAX_DEVICES = 64;

// one launch on the current device: the kernel's shared-memory size set once
// per device (past MAX_DEVICES on every launch), then ceil(n / 64) blocks
// on `stream`.  Returns cudaGetLastError().
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), bool (&attr_set)[MAX_DEVICES], int smem, int n,
           void* stream, Args... args) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= MAX_DEVICES || !attr_set[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (device < MAX_DEVICES) attr_set[device] = true;
  }
  kernel<<<(n + BM - 1) / BM, NTHR, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace wide_tc
