// A run of captured CUDA graphs joined into one executable graph, with
// device-side loops, sm_90a (needs CUDA >= 12.4 for conditional nodes).
//
// The JAX package runs a tracked frame as one dispatch whose Gauss-Newton
// groups are `lax.while_loop`s (difusion_tpu/core/tracker.py:948-1001): the
// loop's exit test runs on the device.  Here each segment of a program is a
// CUDA graph captured from PyTorch (utils/cudagraph.py).  A plain segment
// becomes a child-graph node.  A loop segment becomes a conditional WHILE
// node whose body is the segment's graph followed by `loop_cond_kernel`: one
// thread reads the `done` flag the body has just written and tells the node
// whether to run the body again.  No exit flag ever travels to the host.
// The kernel also counts the body's runs, so a caller can say afterwards how
// often the kernels recorded in the body were launched.
//
// Given `stamps` (n + 1 int64 on the device), the program also times its
// segments on the device: a one-thread `stamp_kernel` node before the first
// segment and after each one reads the global timer and adds the time since
// the previous stamp to stamps[1 + k] (stamps[0] holds the last reading).  A
// loop's stamps sit outside its WHILE node, so its sum takes every pass.
// Without `stamps` the top level holds one node a segment, as before.
#include <cuda_runtime.h>

#define CK(call)                         \
  do {                                   \
    cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

__global__ void loop_cond_kernel(cudaGraphConditionalHandle handle,
                                 const unsigned char* done, unsigned long long* runs) {
  *runs += 1ull;
  cudaGraphSetConditional(handle, *done ? 0u : 1u);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// acc null: the launch's first stamp, which only reads the timer.
__global__ void stamp_kernel(unsigned long long* last, unsigned long long* acc) {
  unsigned long long t = globaltimer();
  if (acc) *acc += t - *last;
  *last = t;
}

static int add_stamp(cudaGraph_t g, cudaGraphNode_t* prev, unsigned long long* stamps,
                     int k) {
  void* last = stamps;
  void* acc = k < 0 ? nullptr : stamps + 1 + k;
  void* args[2] = {&last, &acc};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)stamp_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t node;
  CK(cudaGraphAddKernelNode(&node, g, *prev ? prev : nullptr, *prev ? 1 : 0, &kp));
  *prev = node;
  return 0;
}

// One thread reads the global timer until it has seen n changes and writes
// each step (ns): the timer's resolution as a kernel sees it.
__global__ void globaltimer_steps_kernel(unsigned long long* out, int n) {
  unsigned long long t0 = globaltimer();
  for (int i = 0; i < n; ++i) {
    unsigned long long t1;
    do {
      t1 = globaltimer();
    } while (t1 == t0);
    out[i] = t1 - t0;
    t0 = t1;
  }
}

extern "C" int globaltimer_steps(void* out, int n, void* stream) {
  globaltimer_steps_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)out, n);
  return (int)cudaGetLastError();
}

// graphs[k]: a cudaGraph_t (cloned into the program, so the caller keeps its
// own).  done[k]: null for a plain segment, else the device address of the
// one-byte flag that ends segment k's loop; runs[k]: where its body's runs
// are counted.  A loop's body runs at least once on every launch.  stamps:
// null, or the segments' device timers (above).  *n_nodes: the top level's
// node count.
extern "C" int graph_program_build(int n, void** graphs, void** done, void** runs,
                                   void* stamps, int* n_nodes, void** out_exec) {
  unsigned long long* st = (unsigned long long*)stamps;
  cudaGraph_t g;
  CK(cudaGraphCreate(&g, 0));
  cudaGraphNode_t prev = nullptr;
  if (st) {
    int err = add_stamp(g, &prev, st, -1);
    if (err) return err;
  }
  for (int k = 0; k < n; ++k) {
    cudaGraphNode_t node;
    const cudaGraphNode_t* deps = prev ? &prev : nullptr;
    size_t n_deps = prev ? 1 : 0;
    if (!done[k]) {
      CK(cudaGraphAddChildGraphNode(&node, g, deps, n_deps, (cudaGraph_t)graphs[k]));
    } else {
      cudaGraphConditionalHandle handle;
      CK(cudaGraphConditionalHandleCreate(&handle, g, 1, cudaGraphCondAssignDefault));
      cudaGraphNodeParams params = {};
      params.type = cudaGraphNodeTypeConditional;
      params.conditional.handle = handle;
      params.conditional.type = cudaGraphCondTypeWhile;
      params.conditional.size = 1;
#if CUDART_VERSION >= 13000
      CK(cudaGraphAddNode(&node, g, deps, nullptr, n_deps, &params));
#else
      CK(cudaGraphAddNode(&node, g, deps, n_deps, &params));
#endif
      cudaGraph_t body = params.conditional.phGraph_out[0];
      cudaGraphNode_t child, cond;
      CK(cudaGraphAddChildGraphNode(&child, body, nullptr, 0, (cudaGraph_t)graphs[k]));
      void* args[3] = {&handle, &done[k], &runs[k]};
      cudaKernelNodeParams kp = {};
      kp.func = (void*)loop_cond_kernel;
      kp.gridDim = dim3(1);
      kp.blockDim = dim3(1);
      kp.kernelParams = args;
      CK(cudaGraphAddKernelNode(&cond, body, &child, 1, &kp));
    }
    prev = node;
    if (st) {
      int err = add_stamp(g, &prev, st, k);
      if (err) return err;
    }
  }
  size_t count = 0;
  CK(cudaGraphGetNodes(g, nullptr, &count));
  *n_nodes = (int)count;
  cudaGraphExec_t exec;
  CK(cudaGraphInstantiate(&exec, g, 0));
  CK(cudaGraphDestroy(g));
  *out_exec = exec;
  return 0;
}

extern "C" int graph_program_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int graph_program_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}
