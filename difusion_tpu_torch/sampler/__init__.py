"""The LIF sample generator: mesh I/O and primitives, the SDF sampler and the
corpus entry point (``python -m difusion_tpu_torch.sampler.generator``)."""
