"""Measurement tools of the port: the kernels' cost model and the roofline
probe (``python3 -m coherent_rtlsdr_tpu_torch.tools.probe_roofline``)."""
