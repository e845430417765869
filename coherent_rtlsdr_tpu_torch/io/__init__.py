"""Host edge (copies of the JAX package's jax-free ``io`` modules, with
their imports pointed at this package, plus the streaming server):

  * wire.py     - data frame (hdr0 + seqnums + int8 IQ) and the :5557 debug
                  phase-factor frame
  * config.py   - receiver config files (examplecfg/*.cfg grammar)
  * console.py  - the console command grammar, shared by the local shell
                  and the ZMQ control socket
  * zmq_edge.py - ZMQ PUB data/debug publishers + ROUTER control socket
  * refnoise.py - the reference-noise switch (simulation and char device)
  * streamio.py - raw capture file playback/recording
  * server.py   - ``CoherentServer``, the streaming loop over the port's
                  packed step and scan runner
"""

from coherent_rtlsdr_tpu_torch.io.config import ChannelDef, get_refname, read_config
from coherent_rtlsdr_tpu_torch.io.wire import (
    HDR_BYTES,
    frame_length,
    pack_debug,
    pack_frame,
    unpack_debug,
    unpack_frame,
)

__all__ = [
    "HDR_BYTES",
    "pack_frame",
    "unpack_frame",
    "pack_debug",
    "unpack_debug",
    "frame_length",
    "ChannelDef",
    "read_config",
    "get_refname",
]
