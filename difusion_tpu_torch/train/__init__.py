"""The prior trainer: losses, learning-rate schedules, the LIF dataset and
the training loop (``python -m difusion_tpu_torch.train.trainer``)."""
