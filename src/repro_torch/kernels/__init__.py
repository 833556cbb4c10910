"""Kernels of the PyTorch port: each hand-written CUDA kernel (``csrc/``)
with its wrapper and launch count, beside its plain PyTorch version in
:mod:`repro_torch.kernels.ref`."""
