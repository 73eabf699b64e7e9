// Sparse marching cubes with cross-block (sdf, std) blending, f32, sm_90a,
// and the splice of an extract's chunks (mc_splice_kernel, at the end).
//
// Replaces no Pallas kernel: the JAX package leaves marching cubes
// (difusion_tpu/ops/marching_cubes.py) to XLA's fusion, and the port's plain
// version (ops/marching_cubes.marching_cubes_sparse_plain) is ~800 small
// PyTorch ops a chunk, which the host launches one by one.  On an H100 the
// mesher's own spans put ~300 ms of a ~395 ms r = 8 export in launching those
// ops, with the card idle ~77% of the time; these three kernels do the same
// work in three launches a chunk.
//
// Contract.  The same inputs and the same result as the plain version, bit
// for bit: the (budget, 13) buffer of triangles (9 vertex coordinates, 3
// vertex stds, the block id's bits) in the plain version's order (triangle
// slab t of 5 outer, then block, then subcell), zeros and block -1 past the
// last triangle written, and the true count of survivors, which may exceed
// the budget.  Every product, sum and quotient is rounded alone
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: nvcc contracts none of
// them into an FMA, and the quotients are IEEE, as PyTorch's f32 division of
// two tensors) and the sums run in the plain version's order: the 8
// neighbour choices of a corner, the sdf_interp chain of an edge (the later
// where wins), pa * (1 - w2) + pb * w2 + bpos.  Skipping an invalid choice
// is exact: the plain version adds +0 there to sums that are never -0.  The
// ramp weights are the plain version's numpy ones: (rmid - c) / r and the
// like in double, rounded to f32, their product in f32 left to right.
//
// What bounds it on an H100: bytes.  A chunk reads each block's (2r)^3 sdf
// and std lattice about once (a corner blends up to 8 lattices, but a
// block's samples are read by its own corners and its neighbours' only near
// the faces they share) and writes the (budget, 13) buffer once: at the
// export's chunk (512 blocks, r = 8, budget 2^20) 16.8 MB + 54.5 MB, ~21 us
// at 3.35 TB/s.  The few hundred operations of a surface subcell do not
// count beside that.
//
// Design.
//  * mc_classify_kernel: one block of threads a marching-cubes block.  27
//    threads resolve the block's 3x3x3 neighbourhood to lattice rows once
//    (bounds, indexer, slot_to_batch), so a corner's 8 choices read shared
//    memory and two lattice values each.  The (r+1)^3 corner sdf, std and
//    valid flag go to a workspace in device memory (the emit kernel reads
//    them again); then a thread a subcell classifies its cube, finds which
//    of its <= 5 table triangles keep every vertex std <= max_std, stores
//    its case and its 5-bit survivor mask, and __syncthreads_count gives
//    the block's survivors of each slab.
//  * mc_scan_kernel: one block scans the 5 x B counts in slab-major order
//    into each (slab, block)'s first output row, and writes the total.
//  * mc_emit_kernel: the same blocks again.  A subcell's rank among its
//    block's survivors of a slab comes from warp ballots and per-warp counts
//    in shared memory; a surviving subcell recomputes the vertices it needs
//    from the corners (cheaper than storing 12 edges a subcell) and writes
//    each triangle below the budget as one 13-float row.  Rows from the
//    total (or the budget) to the budget are filled with zeros and block -1
//    by the same kernel.
//  * r is a run-time value (subcells and corners loop in passes of at most
//    512 threads); every r runs the same body.  No tensor cores: there are
//    no products to batch.
#include <cuda_runtime.h>

namespace {

constexpr int SLABS = 5;          // triangles a case emits at most
constexpr int ROW = 13;           // floats a triangle row: 9 coordinates, 3 stds, block id
constexpr int MAX_THREADS = 512;  // threads a block (subcells a pass)
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

struct McArgs {
  const int* indexer;             // (nx * ny * nz,) slot of a cell, -1 free
  const long long* s2b;           // (n_s2b,) lattice row of a slot, -1 none
  long long n_s2b;
  const int* valid_blocks;        // (n_blocks,) linear cell of each block, -1 padding
  int n_blocks;
  const float* cube_sdf;          // (rows, 2r, 2r, 2r)
  const float* cube_std;
  long long nx, ny, nz;
  int r;
  int interpolate;
  const signed char* tri;         // (256, 16) triangle table, -1 terminated
  float max_std;
  int budget;
  float* csdf;                    // workspace: (n_blocks, (r+1)^3) corner sdf, std, valid
  float* cstd;
  unsigned char* cvalid;
  unsigned short* code;           // (n_blocks, r^3): case | survivor mask << 8
  int* offs;                      // (5, n_blocks): counts, then first rows
  float* packed;                  // (budget, 13) output
  long long* count;               // () total survivors
};

// corner i of a cube (mc_tables.CORNER_OFFSETS): x 0 1 1 0 0 1 1 0,
// y 0 0 1 1 0 0 1 1, z 0 0 0 0 1 1 1 1
__device__ __forceinline__ int corner_dx(int i) { return ((i + 1) >> 1) & 1; }
__device__ __forceinline__ int corner_dy(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int corner_dz(int i) { return i >> 2; }
// edge e's corners (mc_tables.EDGE_CORNERS): the bottom ring, the top ring,
// the four verticals
__device__ __forceinline__ int edge_a(int e) { return e < 8 ? e : e - 8; }
__device__ __forceinline__ int edge_b(int e) {
  return e < 4 ? (e + 1) & 3 : (e < 8 ? 4 + ((e + 1) & 3) : e - 4);
}

// slot_to_batch[slot], where a slot past either end reads as the plain
// version's clip to [-1, n - 2] with -1 wrapping to the table's last entry
__device__ __forceinline__ long long batch_of(const McArgs& a, long long slot) {
  long long i = slot < -1 ? -1 : slot;
  i = i > a.n_s2b - 2 ? a.n_s2b - 2 : i;
  return a.s2b[i < 0 ? a.n_s2b - 1 : i];
}

// block offset, lattice index and ramp weight of corner coordinate g's 'm'
// (ch = 0) or 'p' (ch = 1) sample (marching_cubes._corner_tables)
__device__ __forceinline__ void axis_sample(int g, int ch, int r, int& off, int& idx, float& w) {
  const int rstart = r / 2;
  const double rmid = r / 2.0;
  const bool lower = g <= (r - 1) / 2;
  if (ch == 0) {
    off = lower ? -1 : 0;
    idx = lower ? g + rstart + r : g + rstart;
    w = __double2float_rn(lower ? (rmid - g) / r : (rmid + r - g) / r);
  } else {
    off = lower ? 0 : 1;
    idx = lower ? g + rstart : g + rstart - r;
    w = __double2float_rn(lower ? (g + rmid) / r : (g - rmid) / r);
  }
}

// sdf_interp's weight of corner b on an edge (a, b): the later test wins
__device__ __forceinline__ float edge_weight(float va, float vb) {
  float d = __fsub_rn(vb, va);
  if (fabsf(d) < 1e-30f) d = 1e-30f;
  float w2 = __fdiv_rn(-va, d);
  if (fabsf(__fsub_rn(va, vb)) < 1e-5f) w2 = 0.0f;
  if (fabsf(vb) < 1e-5f) w2 = 1.0f;
  if (fabsf(va) < 1e-5f) w2 = 0.0f;
  return w2;
}

struct Sub {            // a subcell of a block
  int x, y, z;          // in [0, r)
  const float* csdf;    // the block's corners
  const float* cstd;
  int r;
  float bx, by, bz;     // the block's position in grid units
  __device__ __forceinline__ int corner(int i) const {
    const int rp = r + 1;
    return ((x + corner_dx(i)) * rp + (y + corner_dy(i))) * rp + (z + corner_dz(i));
  }
};

// vertex std of edge e (the plain version's edge_std)
__device__ __forceinline__ float edge_std(const Sub& s, int e, float& w2) {
  const int ia = s.corner(edge_a(e)), ib = s.corner(edge_b(e));
  w2 = edge_weight(s.csdf[ia], s.csdf[ib]);
  return __fadd_rn(__fmul_rn(s.cstd[ia], __fsub_rn(1.0f, w2)), __fmul_rn(s.cstd[ib], w2));
}

// one coordinate of edge e's vertex: pa * (1 - w2) + pb * w2 + bpos, with pa
// and pb the numpy f32 quotients (sub + corner offset) / r
__device__ __forceinline__ float edge_coord(int sc, int da, int db, int r, float w2, float bpos) {
  const float pa = __fdiv_rn((float)(sc + da), (float)r);
  const float pb = __fdiv_rn((float)(sc + db), (float)r);
  return __fadd_rn(__fadd_rn(__fmul_rn(pa, __fsub_rn(1.0f, w2)), __fmul_rn(pb, w2)), bpos);
}

__global__ void __launch_bounds__(MAX_THREADS) mc_classify_kernel(McArgs a) {
  const int b = blockIdx.x;
  if (b >= a.n_blocks) return;
  // lattice rows of the 3x3x3 neighbourhood ((ox+1)*9 + (oy+1)*3 + oz+1; -1:
  // none), and [27] the own row as the non-interpolating variant reads it
  __shared__ long long nb[28];
  const int r = a.r, rp = r + 1, rp3 = rp * rp * rp, n = r * r * r, side = 2 * r;
  const long long side3 = (long long)side * side * side;
  const int vb = a.valid_blocks[b];
  const bool block_ok = vb >= 0;
  const long long v = block_ok ? vb : 0;
  const long long bxyz[3] = {v / (a.ny * a.nz), (v / a.nz) % a.ny, v % a.nz};
  const long long nxyz[3] = {a.nx, a.ny, a.nz};
  if (threadIdx.x < 27) {
    const int k = threadIdx.x;
    const int o[3] = {k / 9 - 1, (k / 3) % 3 - 1, k % 3 - 1};
    bool ok = block_ok;
    long long c[3];
    for (int d = 0; d < 3; ++d) {
      c[d] = bxyz[d] + o[d];
      ok = ok && c[d] >= 0 && c[d] < nxyz[d];
    }
    long long row = -1;
    if (ok) {
      const int slot = a.indexer[(c[0] * a.ny + c[1]) * a.nz + c[2]];
      const long long batch = batch_of(a, slot);
      if (slot >= 0 && batch >= 0) row = batch;
    }
    nb[k] = row;
  } else if (threadIdx.x == 27) {
    const long long batch = batch_of(a, a.indexer[v]);
    nb[27] = block_ok && batch >= 0 ? batch : -1;
  }
  __syncthreads();

  float* csdf = a.csdf + (long long)b * rp3;
  float* cstd = a.cstd + (long long)b * rp3;
  unsigned char* cvalid = a.cvalid + (long long)b * rp3;
  const float nan = __int_as_float(0x7fffffff);
  const int rstart = r / 2;
  for (int ci = threadIdx.x; ci < rp3; ci += blockDim.x) {
    const int g[3] = {ci / (rp * rp), (ci / rp) % rp, ci % rp};
    bool valid;
    float sdf = nan, std = nan;
    if (!a.interpolate) {
      const long long row = nb[27];
      valid = row >= 0;
      if (valid) {
        const long long lat = row * side3
            + ((g[0] + rstart) * side + (g[1] + rstart)) * side + (g[2] + rstart);
        sdf = a.cube_sdf[lat];
        std = a.cube_std[lat];
      }
    } else {
      float num = 0.0f, den = 0.0f, wsum = 0.0f;
      bool own_invalid = false;
      for (int ch = 0; ch < 8; ++ch) {
        const int cc[3] = {ch >> 2, (ch >> 1) & 1, ch & 1};
        int off[3], idx[3];
        float wa[3];
        bool is_own = true;
        for (int d = 0; d < 3; ++d) {
          axis_sample(g[d], cc[d], r, off[d], idx[d], wa[d]);
          // the own block's sample is 'p' below the middle, 'm' above it
          is_own = is_own && ((g[d] <= (r - 1) / 2) == (cc[d] == 1));
        }
        const long long row = nb[(off[0] + 1) * 9 + (off[1] + 1) * 3 + off[2] + 1];
        if (row >= 0) {
          const float w = __fmul_rn(__fmul_rn(wa[0], wa[1]), wa[2]);
          const long long lat = row * side3 + (idx[0] * side + idx[1]) * side + idx[2];
          const float wt = __fmul_rn(w, a.cube_std[lat]);
          num = __fadd_rn(num, __fmul_rn(a.cube_sdf[lat], wt));
          den = __fadd_rn(den, wt);
          wsum = __fadd_rn(wsum, w);
        } else {
          own_invalid = own_invalid || is_own;
        }
      }
      valid = !own_invalid && den > 0.0f;
      if (valid) {
        sdf = __fdiv_rn(num, fmaxf(den, 1e-30f));
        std = __fdiv_rn(den, fmaxf(wsum, 1e-30f));
      }
    }
    csdf[ci] = sdf;
    cstd[ci] = std;
    cvalid[ci] = valid;
  }
  __syncthreads();

  Sub s;
  s.csdf = csdf;
  s.cstd = cstd;
  s.r = r;
  int total[SLABS] = {0, 0, 0, 0, 0};
  for (int base = 0; base < n; base += blockDim.x) {
    const int si = base + threadIdx.x;
    int mask = 0, cube = 0;
    if (si < n) {
      s.x = si / (r * r);
      s.y = (si / r) % r;
      s.z = si % r;
      bool ok = true;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = s.corner(i);
        ok = ok && cvalid[c];
        cube |= (csdf[c] < 0.0f) << i;
      }
      if (!ok) cube = 0;
      const signed char* tri = a.tri + cube * 16;
#pragma unroll
      for (int t = 0; t < SLABS; ++t) {
        bool keep = tri[3 * t] >= 0;
        for (int k = 0; k < 3 && keep; ++k) {
          float w2;
          keep = edge_std(s, max((int)tri[3 * t + k], 0), w2) <= a.max_std;
        }
        mask |= keep << t;
      }
      a.code[(long long)b * n + si] = (unsigned short)(cube | mask << 8);
    }
#pragma unroll
    for (int t = 0; t < SLABS; ++t) total[t] += __syncthreads_count((mask >> t) & 1);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < SLABS; ++t) a.offs[(long long)t * a.n_blocks + b] = total[t];
  }
}

// exclusive scan of offs[0 .. len) in place; *count = the sum
__global__ void __launch_bounds__(SCAN_THREADS) mc_scan_kernel(int* offs, int len,
                                                               long long* count) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const int per = (len + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min((int)threadIdx.x * per, len), hi = min(lo + per, len);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += offs[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int mine = warp_sum[lane];
    int scan = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, scan, d);
      if (lane >= d) scan += up;
    }
    warp_sum[lane] = scan - mine;
    if (lane == 31) *count = scan;
  }
  __syncthreads();
  int run = warp_sum[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = offs[i];
    offs[i] = run;
    run += c;
  }
}

__global__ void __launch_bounds__(MAX_THREADS) mc_emit_kernel(McArgs a) {
  // rows from the last triangle (or the budget) to the budget: zeros, block
  // -1; a float a thread, so that a warp's stores are contiguous (budget *
  // 13 < 2^31, so a float's index modulo 13 is a 32-bit one)
  const long long end = (long long)a.budget * ROW;
  for (long long j = min(*a.count, (long long)a.budget) * ROW
                     + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < end; j += (long long)gridDim.x * blockDim.x)
    a.packed[j] = (unsigned)j % ROW == ROW - 1 ? __int_as_float(-1) : 0.0f;

  const int b = blockIdx.x;
  if (b >= a.n_blocks) return;
  __shared__ int warp_count[SLABS][MAX_THREADS / 32];
  const int r = a.r, rp = r + 1, rp3 = rp * rp * rp, n = r * r * r;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int vb = a.valid_blocks[b];
  const long long v = vb >= 0 ? vb : 0;
  Sub s;
  s.csdf = a.csdf + (long long)b * rp3;
  s.cstd = a.cstd + (long long)b * rp3;
  s.r = r;
  s.bx = (float)(v / (a.ny * a.nz));
  s.by = (float)((v / a.nz) % a.ny);
  s.bz = (float)(v % a.nz);
  int first[SLABS], run[SLABS] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < SLABS; ++t) first[t] = a.offs[(long long)t * a.n_blocks + b];
  for (int base = 0; base < n; base += blockDim.x) {
    const int si = base + threadIdx.x;
    const int code = si < n ? a.code[(long long)b * n + si] : 0;
    const int mask = code >> 8;
    int rank[SLABS];
#pragma unroll
    for (int t = 0; t < SLABS; ++t) {
      const unsigned vote = __ballot_sync(FULL, (mask >> t) & 1);
      rank[t] = __popc(vote & below);
      if (lane == 0) warp_count[t][warp] = __popc(vote);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < SLABS; ++t) {
      int before = 0, pass = 0;
      for (int w = 0; w < n_warps; ++w) {
        const int c = warp_count[t][w];
        before += w < warp ? c : 0;
        pass += c;
      }
      rank[t] += first[t] + run[t] + before;
      run[t] += pass;
    }
    __syncthreads();
    if (mask == 0) continue;
    s.x = si / (r * r);
    s.y = (si / r) % r;
    s.z = si % r;
    const signed char* tri = a.tri + (code & 255) * 16;
#pragma unroll
    for (int t = 0; t < SLABS; ++t) {
      if (!((mask >> t) & 1) || rank[t] >= a.budget) continue;
      float* out = a.packed + (long long)rank[t] * ROW;
      for (int k = 0; k < 3; ++k) {
        const int e = max((int)tri[3 * t + k], 0), ea = edge_a(e), eb = edge_b(e);
        float w2;
        out[9 + k] = edge_std(s, e, w2);
        out[3 * k] = edge_coord(s.x, corner_dx(ea), corner_dx(eb), r, w2, s.bx);
        out[3 * k + 1] = edge_coord(s.y, corner_dy(ea), corner_dy(eb), r, w2, s.by);
        out[3 * k + 2] = edge_coord(s.z, corner_dz(ea), corner_dz(eb), r, w2, s.bz);
      }
      out[ROW - 1] = __int_as_float(vb);
    }
  }
}

long long align256(long long x) { return (x + 255) & ~255LL; }

// the workspace's parts, carved from `base` (nullptr: sizes only); returns
// its bytes
long long carve(char* base, int n_blocks, int r, McArgs* a) {
  const long long rp3 = (long long)(r + 1) * (r + 1) * (r + 1), n = (long long)r * r * r;
  long long at = 0;
  const long long corners = align256(rp3 * n_blocks * 4);
  if (a) a->csdf = (float*)(base + at);
  at += corners;
  if (a) a->cstd = (float*)(base + at);
  at += corners;
  if (a) a->cvalid = (unsigned char*)(base + at);
  at += align256(rp3 * n_blocks);
  if (a) a->code = (unsigned short*)(base + at);
  at += align256(n * n_blocks * 2);
  if (a) a->offs = (int*)(base + at);
  at += align256((long long)SLABS * n_blocks * 4);
  return at;
}

}  // namespace

// Bytes of the workspace a chunk of n_blocks blocks at resolution r needs.
extern "C" long long mc_workspace_bytes(int n_blocks, int r) {
  return carve(nullptr, n_blocks, r, nullptr);
}

// indexer (nx * ny * nz,) int32; slot_to_batch (n_s2b,) int64; valid_blocks
// (n_blocks,) int32; cube_sdf, cube_std (rows, 2r, 2r, 2r) f32; tri (256, 16)
// int8; workspace of mc_workspace_bytes(n_blocks, r); packed (budget, 13)
// f32; count () int64.  All contiguous on the current device; 5 * n_blocks *
// r^3 < 2^31 and 13 * budget < 2^31.  Three launches on `stream`; returns the first nonzero
// cudaGetLastError(), else 0.
extern "C" int mc_sparse_launch(const int* indexer, const long long* slot_to_batch,
                                long long n_s2b, const int* valid_blocks, int n_blocks,
                                const float* cube_sdf, const float* cube_std, long long nx,
                                long long ny, long long nz, int r, int interpolate,
                                const signed char* tri, float max_std, int budget,
                                void* workspace, float* packed, long long* count,
                                void* stream) {
  if (r < 1 || n_blocks < 0 || budget < 0 || n_s2b < 1
      || (long long)SLABS * n_blocks * r * r * r >= 0x7fffffffLL
      || (long long)budget * ROW >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  McArgs a;
  a.indexer = indexer;
  a.s2b = slot_to_batch;
  a.n_s2b = n_s2b;
  a.valid_blocks = valid_blocks;
  a.n_blocks = n_blocks;
  a.cube_sdf = cube_sdf;
  a.cube_std = cube_std;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.r = r;
  a.interpolate = interpolate;
  a.tri = tri;
  a.max_std = max_std;
  a.budget = budget;
  a.packed = packed;
  a.count = count;
  carve((char*)workspace, n_blocks, r, &a);
  cudaStream_t s = (cudaStream_t)stream;
  const int n = r * r * r;
  const int threads = n >= MAX_THREADS ? MAX_THREADS : (n + 31) / 32 * 32;
  const int grid = n_blocks > 0 ? n_blocks : 1;
  mc_classify_kernel<<<grid, threads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mc_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(a.offs, SLABS * n_blocks, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mc_emit_kernel<<<grid, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The splice: every chunk's (budget, 13) buffer into the extract's three
// planar outputs, in one launch.
//
// Replaces no Pallas kernel: the JAX package splices its chunks on the host
// in numpy (difusion_tpu/core/meshing.py: concatenation, the world
// transform, the block -> slot lookup).  Done there, the host reads each
// chunk's count, downloads its rows and spends ~75-90 ms an r = 8 export in
// numpy while the card idles; here the host reads one total and downloads
// the finished triangles once.
//
// Contract (ops/marching_cubes.mc_splice_plain, bit for bit).  Chunk k keeps
// its first min(count_k, budget) rows, in chunk order; rows from `cap` on
// are dropped.  Output row t: the 9 vertex coordinates (v + origin) *
// voxel_size + world_origin, each sum and product rounded alone (__fadd_rn /
// __fmul_rn: no FMA, as numpy's three passes round), the 3 stds as they
// are, and the slot table[block] (-1 for a block outside the table).
// totals[0] = the sum of the counts (what marching cubes emitted, which may
// exceed what was kept), totals[1] = the rows written.
//
// What bounds it: bytes.  A kept row is read once (52 bytes) and written
// once (36 + 12 + 8), plus one 8-byte gather from the table: at the r = 8
// export's ~455 k triangles ~53 MB, ~16 us at 3.35 TB/s.
//
// Design.  The grid's y walks the chunks and its x the elements of a
// chunk's kept rows, a thread an element (13 a row), so reads of the
// buffer and writes of the vertex and std planes are contiguous across a
// warp.  A block finds its chunk's first output row by summing the kept
// rows of the chunks before it (a few counts); nothing is carried between
// blocks, so no second pass.
namespace {

constexpr int SPLICE_THREADS = 256;
constexpr int SPLICE_TILES = 128;    // blocks a chunk at most (a grid-stride loop covers the rest)
constexpr int MAX_GRID_Y = 65535;

struct SpliceArgs {
  const float* packed;            // (n_chunks, budget, 13) marching cubes' rows
  const long long* counts;        // (n_chunks,) survivors of each chunk
  int n_chunks;
  int budget;
  long long cap;                  // rows of the outputs
  float origin[3];                // the grid's origin, grid units
  float voxel_size;
  float world_origin[3];
  const long long* table;         // (n_table,) slot of a grid cell, -1 none
  long long n_table;
  float* tris;                    // (cap, 3, 3) world-space vertices
  float* stds;                    // (cap, 3)
  long long* slots;               // (cap,)
  long long* totals;              // (2,) emitted, rows written
};

// the sum over chunks [0, k) of their counts (raw) or kept rows, by the
// whole block (every thread returns it); part: a warp's partial sums
__device__ long long chunk_sum(const SpliceArgs& a, long long* part, int k, bool raw) {
  long long s = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const long long c = a.counts[j];
    s += raw ? c : min(c, (long long)a.budget);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(FULL, s, d);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += part[w];
  __syncthreads();                // part is written again by the next call
  return total;
}

__global__ void __launch_bounds__(SPLICE_THREADS) mc_splice_kernel(SpliceArgs a) {
  __shared__ long long part[SPLICE_THREADS / 32];
  const unsigned stride = gridDim.x * blockDim.x;
  for (int k = blockIdx.y; k < a.n_chunks; k += gridDim.y) {
    const long long first = chunk_sum(a, part, k, false);
    const long long kept = min(a.counts[k], (long long)a.budget);
    // budget * 13 < 2^31, so a chunk's element index (and it plus the
    // stride) fits 32 unsigned bits
    const unsigned n = (unsigned)max(0LL, min(kept, a.cap - first)) * ROW;
    const float* src = a.packed + (long long)k * a.budget * ROW;
    for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
      const unsigned i = e / ROW, j = e - i * ROW;
      const long long t = first + i;
      const float v = src[e];
      if (j < 9) {
        const int c = j % 3;
        a.tris[t * 9 + j] = __fadd_rn(__fmul_rn(__fadd_rn(v, a.origin[c]), a.voxel_size),
                                      a.world_origin[c]);
      } else if (j < ROW - 1) {
        a.stds[t * 3 + (j - 9)] = v;
      } else {
        const int b = __float_as_int(v);
        a.slots[t] = b >= 0 && b < a.n_table ? a.table[b] : -1;
      }
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    const long long emitted = chunk_sum(a, part, a.n_chunks, true);
    const long long kept = chunk_sum(a, part, a.n_chunks, false);
    if (threadIdx.x == 0) {
      a.totals[0] = emitted;
      a.totals[1] = min(kept, a.cap);
    }
  }
}

}  // namespace

// packed (n_chunks, budget, 13) f32; counts (n_chunks,) int64; table
// (n_table,) int64; tris (cap, 3, 3), stds (cap, 3) f32; slots (cap,) int64;
// totals (2,) int64.  All contiguous on the current device; n_chunks >= 1,
// 13 * budget < 2^31, n_table >= 1.  One launch on `stream`; returns
// cudaGetLastError().
extern "C" int mc_splice_launch(const float* packed, const long long* counts, int n_chunks,
                                int budget, long long cap, float ox, float oy, float oz,
                                float voxel_size, float wx, float wy, float wz,
                                const long long* table, long long n_table, float* tris,
                                float* stds, long long* slots, long long* totals, void* stream) {
  if (n_chunks < 1 || budget < 0 || (long long)budget * ROW >= 0x7fffffffLL || cap < 0
      || n_table < 1)
    return (int)cudaErrorInvalidValue;
  SpliceArgs a;
  a.packed = packed;
  a.counts = counts;
  a.n_chunks = n_chunks;
  a.budget = budget;
  a.cap = cap;
  a.origin[0] = ox;
  a.origin[1] = oy;
  a.origin[2] = oz;
  a.voxel_size = voxel_size;
  a.world_origin[0] = wx;
  a.world_origin[1] = wy;
  a.world_origin[2] = wz;
  a.table = table;
  a.n_table = n_table;
  a.tris = tris;
  a.stds = stds;
  a.slots = slots;
  a.totals = totals;
  const long long tiles = ((long long)budget * ROW + SPLICE_THREADS - 1) / SPLICE_THREADS;
  const dim3 grid((unsigned)(tiles < 1 ? 1 : tiles < SPLICE_TILES ? tiles : SPLICE_TILES),
                  (unsigned)(n_chunks < MAX_GRID_Y ? n_chunks : MAX_GRID_Y));
  mc_splice_kernel<<<grid, SPLICE_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
