// Warp-level MLP machinery on Hopper's tensor cores in 3xTF32, shared by the
// fused decoder kernels of decoder_grad.cu; decoder_bf16.cu uses its
// mbarrier and TMA helpers.
//
// Products.  mma.sync.m16n8k8 tf32 with f32 accumulation.  Each f32 operand
// x is split as hi = rna_tf32(x), lo = rna_tf32(x - hi) (round to nearest,
// ties away from zero, to TF32's 10 mantissa bits; x - hi is exact in f32),
// and a product is accumulated as lo.hi + hi.lo + hi.hi.  The dropped lo.lo
// term and lo's own rounding leave ~22 significant bits; one TF32 pass is
// off by ~6e-4 in sdf and ~0.2 in the gradient on the study_mixed prior
// (tests/test_torch_tc_precision.py).
// The tensor cores add an mma's products to its accumulator with truncation,
// so chaining the 48 mma of a 128-deep layer into one accumulator biased the
// sums by several times the f32 plain version's error on the H100.  The
// callers therefore sum each few k-tiles' mma from zero and add that partial
// to the running f32 sum with a rounded FADD.
//
// Fragments.  The accumulator fragment of m16n8k8 gives lane (g = lane / 4,
// t = lane % 4) rows g and g+8 at columns 8j + 2t and 8j + 2t + 1 of n-tile
// j; the A fragment of k-tile j wants rows g and g+8 at k-positions t and
// t+4.  Let k-position t stand for column 2t and t+4 for column 2t+1 of each
// 8-wide k-tile, and pack the weights with their rows permuted the same way
// (ops/decoder_fused._tc_frag): then a lane stores its output fragment and
// loads the next layer's A fragment as the same float2 pairs of the same
// rows, and the backward pass, on the same tiling, finds dh_l where h_l was,
// so the relu masks stay bits in registers.
//
// Weights.  Pre-split at pack time into hi/lo and stored in fragment order:
// for each (k-tile, n-tile), lane L's float4 is (hi(W[2t][g]), hi(W[2t+1][g]),
// lo(W[2t][g]), lo(W[2t+1][g])), so one conflict-free 16-byte shared load
// feeds three mma per m-tile.  The kernels stream these k-tiles, a few at a
// time, from L2 through a ring of shared-memory slots with TMA bulk copies,
// ahead of the ones being multiplied and across layer boundaries.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp_tc {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  // cvt.rna.tf32.f32 for finite x: add half of the dropped 13 bits' range to
  // the magnitude, then truncate (ties round away from zero)
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a (16x8, row) . b (8x8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// wait for the phase of `bar` with this parity to complete.  A phase that
// never completes (a fault in the pipeline) traps after ~2 s instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// TMA bulk copy global -> shared of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// acc[m][nt] += A_m . B_nt in 3xTF32 for the warp's MT m-tiles (16 MT rows)
// and NTN n-tiles, over one 8-deep k-tile, on the tensor cores.
// a[m]: this lane's A values of m-tile m in accumulator-fragment order
// (row g: cols 2t, 2t+1; row g+8: cols 2t, 2t+1 of the k-tile); w: the
// warp's first n-tile of the k-tile's B fragments, [nt][lane] float4s in
// shared memory.  One 16-byte B load feeds 3 MT mma.
template <int MT, int NTN>
__device__ __forceinline__ void ktile_mma(float (&acc)[MT][4][4], const float (&a)[MT][4],
                                          const float4* w, int lane) {
  static_assert(NTN <= 4, "a warp holds at most 4 n-tiles");
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    split(a[m][0], ah[m][0], al[m][0]);  // mma a0: row g,   k-position t   (col 2t)
    split(a[m][2], ah[m][1], al[m][1]);  // mma a1: row g+8, k-position t
    split(a[m][1], ah[m][2], al[m][2]);  // mma a2: row g,   k-position t+4 (col 2t+1)
    split(a[m][3], ah[m][3], al[m][3]);  // mma a3: row g+8, k-position t+4
  }
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    const float4 b = w[nt * 32 + lane];
    const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
#pragma unroll
    for (int m = 0; m < MT; ++m) {  // small terms first
      mma_tf32(acc[m][nt], al[m], bh0, bh1);
      mma_tf32(acc[m][nt], ah[m], __float_as_uint(b.z), __float_as_uint(b.w));
      mma_tf32(acc[m][nt], ah[m], bh0, bh1);
    }
  }
}

template <int MT, int NTN>
__device__ __forceinline__ void zero(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NTN; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
}

// A stream of T weight chunks through RING shared-memory slots of SLOT
// float4s, each copied by one TMA bulk copy.  span(j, off, cnt) gives chunk
// j's offset and size in float4s within `src`.  Slot s has a `full` barrier
// (the copy's bytes landed) and an `empty` barrier (all WARPS warps are done
// with it).  Thread 0 is the producer: acquire(j) first issues chunk
// j + RING - 1, into the slot of chunk j - 1 once every warp has released
// that, then waits for chunk j like every thread.  A warp calls release(j)
// when it has read chunk j.  Warps are only held back by data, not by each
// other, so one warp's shared-memory loads overlap another's mma.
template <int T, int RING, int SLOT, int WARPS, class Span>
struct WeightRing {
  float4* slots;
  const float4* src;
  uint64_t* full;   // [RING]
  uint64_t* empty;  // [RING]
  int tid;

  // thread 0; the block passes a barrier before any thread waits
  __device__ __forceinline__ void init() {
    if (tid == 0) {
      for (int s = 0; s < RING; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  __device__ __forceinline__ void issue(int j) {  // thread 0
    if (j >= T) return;
    const int s = j % RING, use = j / RING;
    if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
    int off, cnt;
    Span::span(j, off, cnt);
    mbar_arrive_expect_tx(full + s, cnt * 16);
    bulk_copy(slots + s * SLOT, src + off, cnt * 16, full + s);
  }

  __device__ __forceinline__ void start() {
    if (tid == 0)
      for (int j = 0; j < RING - 1; ++j) issue(j);
  }

  __device__ __forceinline__ const float4* acquire(int j) {
    if (tid == 0) issue(j + RING - 1);
    mbar_wait(full + j % RING, (j / RING) & 1);
    return slots + (j % RING) * SLOT;
  }

  __device__ __forceinline__ void release(int j) {
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + j % RING);
  }
};

}  // namespace mlp_tc
