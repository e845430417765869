"""Executables of the port (``python3 -m coherent_rtlsdr_tpu_torch.apps.<name>``)."""
