// Camera frame packing on the card, uint8, sm_90a.
//
// Replaces no Pallas kernel: the JAX package packs a frame on the host
// (difusion_tpu/core/tracker.py `pack_frame`, numpy) before its upload, and so
// did the port.  On an H100's host that numpy pack took 6.1-6.9 ms of every
// tracked frame (the port's spans `slam.feed.pack` / `slam.frame.pack`),
// mostly a uint16 sum over RGB's 3-long inner axis, and set the pace of the
// tracking loop.  This kernel makes the same buffer on the card from the
// camera's own arrays after one upload of them.
//
// Contract.  For K frames of raw uint8 RGB (K, h, w, 3) and uint16 depth
// (K, h, w), each contiguous, it writes the (K, h, 3w) uint8 planes
//   [intensity | depth & 0xFF | depth >> 8],   intensity = (r + g + b + 1) / 3
// in integer arithmetic: byte for byte what ops/frame_pack.frame_pack_plain
// and core/tracker.pack_frame(rgb, depth, dcam_scale) give for such inputs.
// The depth's two bytes are read as bytes (little-endian: low byte first),
// so the depth pointer needs no alignment of its own.
//
// What bounds it on an H100: bytes.  A 640 x 480 frame reads 5 bytes a pixel
// (1.54 MB) and writes 3 (0.92 MB): 2.46 MB, ~0.73 us at 3.35 TB/s.  A few
// integer operations a pixel do not count beside that.
//
// Design.  A thread takes V consecutive pixels of one row and moves them as
// whole words: 3 V bytes of RGB, 2 V of depth in, V bytes to each of the
// three planes out.  V = 16 (16-byte words) where the width is a multiple of
// 16 and every pointer 16-byte aligned, as the SLAM loop's staging buffer
// gives at 640 x 480; V = 1 (bytes) elsewhere.  A grid-stride loop covers
// all K frames in one launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int N, int A>
struct alignas(A) Bytes {
  uint8_t b[N];
};

template <int V>
__global__ void frame_pack_kernel(const uint8_t* __restrict__ rgb,
                                  const uint8_t* __restrict__ depth,
                                  uint8_t* __restrict__ out, int groups, int w) {
  constexpr int A = V == 16 ? 16 : 1;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += gridDim.x * blockDim.x) {
    const int p = g * V;                       // the group's first pixel
    const int row = p / w;                     // of all K * h rows
    const int col = p - row * w;
    const Bytes<3 * V, A> c = *reinterpret_cast<const Bytes<3 * V, A>*>(rgb + 3 * p);
    const Bytes<2 * V, A> d = *reinterpret_cast<const Bytes<2 * V, A>*>(depth + 2 * p);
    Bytes<V, A> in, lo, hi;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const unsigned s = (unsigned)c.b[3 * v] + c.b[3 * v + 1] + c.b[3 * v + 2];
      in.b[v] = (uint8_t)((s + 1u) / 3u);
      lo.b[v] = d.b[2 * v];
      hi.b[v] = d.b[2 * v + 1];
    }
    uint8_t* o = out + 3 * row * w + col;
    *reinterpret_cast<Bytes<V, A>*>(o) = in;
    *reinterpret_cast<Bytes<V, A>*>(o + w) = lo;
    *reinterpret_cast<Bytes<V, A>*>(o + 2 * w) = hi;
  }
}

template <int V>
int launch(const uint8_t* rgb, const uint8_t* depth, uint8_t* out, long long n_pix, int w,
           cudaStream_t stream) {
  const int groups = (int)(n_pix / V);
  const int threads = 256;
  int blocks = (groups + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  frame_pack_kernel<V><<<blocks, threads, 0, stream>>>(rgb, depth, out, groups, w);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int a) { return ((uintptr_t)p % a) == 0; }

}  // namespace

// rgb: n_pix * 3 bytes, depth: n_pix uint16 (any byte alignment), out:
// n_pix * 3 bytes, all contiguous on the current device; n_pix = K * h * w,
// a multiple of w, with 3 * n_pix < 2^31.  One launch on `stream` (none for
// n_pix = 0); returns cudaGetLastError() after it.
extern "C" int frame_pack_launch(const void* rgb, const void* depth, void* out,
                                 long long n_pix, int w, void* stream) {
  if (w < 1 || n_pix < 0 || n_pix % w != 0 || 3 * n_pix >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  const uint8_t* c = static_cast<const uint8_t*>(rgb);
  const uint8_t* d = static_cast<const uint8_t*>(depth);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w % 16 == 0 && aligned(c, 16) && aligned(d, 16) && aligned(o, 16))
    return launch<16>(c, d, o, n_pix, w, s);
  return launch<1>(c, d, o, n_pix, w, s);
}
