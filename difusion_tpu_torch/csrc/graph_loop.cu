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

// graphs[k]: a cudaGraph_t (cloned into the program, so the caller keeps its
// own).  done[k]: null for a plain segment, else the device address of the
// one-byte flag that ends segment k's loop; runs[k]: where its body's runs
// are counted.  A loop's body runs at least once on every launch.
extern "C" int graph_program_build(int n, void** graphs, void** done, void** runs,
                                   void** out_exec) {
  cudaGraph_t g;
  CK(cudaGraphCreate(&g, 0));
  cudaGraphNode_t prev = nullptr;
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
  }
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
