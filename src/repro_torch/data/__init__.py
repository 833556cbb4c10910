"""Workload inputs of the PyTorch port: the SeBS-flavoured fleet catalog
(:mod:`repro_torch.data.catalog`)."""
