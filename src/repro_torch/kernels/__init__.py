"""Hand-written Hopper kernels of the port (CUDA C++ in ``repro_torch/csrc``),
each beside its plain PyTorch version; :mod:`repro_torch.kernels.ops` is the
public surface."""
