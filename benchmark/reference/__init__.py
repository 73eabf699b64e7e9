"""Plain PyTorch references that decide ``correct``.  Nothing here imports
the port: weights come from the prior's raw npz, frames from the benchmark's
generator, and every map and mesh is worked out again."""
