"""Operating constants of the port.

The values are those of ``coherent_rtlsdr_tpu/constants.py`` (which cites the
reference system for each); they are restated here so that the port loads
nothing of the JAX package. ``tests/test_torch_ops.py`` holds the two files
equal.
"""

# Default complex sample rate per channel (samples/s).
DEFAULT_FS = 2.048e6

# Default block length in complex samples (16384 wire bytes).
DEFAULT_BLOCK_LEN = 8192

# A channel is "synchronized" when |lag| <= this (samples).
SYNC_THRESHOLD = 0.005

# Control law: tanh softness (samples) and the fraction of the lag taken per
# measurement.
CTRL_SCALE = 100.0
CTRL_FRAC_T = 0.90

# Phase-correction EMA weight of the new estimate.
PHASE_EMA_ALPHA = 0.5

# int8 <-> float quantization scale.
IQ_SCALE = 1.0 / 127.0

# Tuner limits of the console's fcenter command (1-1800 MHz), and the
# default centre frequency.
FCENTER_MIN_HZ = 1e6
FCENTER_MAX_HZ = 1800e6
DEFAULT_FCENTER = 1024e6
