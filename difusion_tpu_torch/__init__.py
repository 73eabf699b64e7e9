"""PyTorch/CUDA port of difusion_tpu: RGB-D track + fuse + mesh on an NVIDIA
H100, frame by frame or in chunks of frames that each run as one CUDA-graph
launch (``python -m difusion_tpu_torch.slam``), and the offline mesher
(``python -m difusion_tpu_torch.mesh_tool``).

The JAX package (``difusion_tpu``) is the reference; this package imports
neither it nor ``jax``.  Module names follow the JAX package's layout so each
module's counterpart is easy to find.  The TPU's Pallas kernels are
hand-written CUDA C++ for ``sm_90a`` under ``csrc/`` (built by
:mod:`difusion_tpu_torch.ops._build`); every other operation is plain PyTorch.
"""
