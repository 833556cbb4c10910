"""The model stack of the port: the dense attention family of
``repro/models``, whose prefill and decode attention run on the
hand-written CUDA kernels of :mod:`repro_torch.kernels.ops`."""
