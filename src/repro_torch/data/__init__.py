"""Workload inputs of the PyTorch port: the SeBS-flavoured fleet catalog
(:mod:`repro_torch.data.catalog`) and the serving platform's request
streams (:mod:`repro_torch.data.workload`)."""
