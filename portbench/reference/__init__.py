"""The plain reference the benchmark holds hpfw_tpu_torch's outputs to.

Plain PyTorch on the run's device, float32 with TF32 off, written from the
method and the configuration files: it imports nothing of hpfw_tpu_torch,
hpfw_tpu or jax, and takes nothing the program made (it derives its own CQT
basis, coarse prints and candidates from the inputs the benchmark made).
"""
