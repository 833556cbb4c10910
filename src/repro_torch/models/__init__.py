"""The model stack of the port: the dense attention, Mamba-2 and Griffin
families of ``repro/models``, whose prefill and decode attention and
recurrent prefill scans run on the hand-written CUDA kernels of
:mod:`repro_torch.kernels.ops`."""
