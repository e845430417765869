"""Array-processing models (port of ``coherent_rtlsdr_tpu/models``): the
downstream science the aligned receive matrix feeds (reference:
beamformclient/heatmap2d*.cpp MUSIC clients and
matlabclient/functions/pmusic.m + co-array processing).

Covariances, steering scans and spectra are complex64 tensors on the
device of their inputs (the card by default): batched products, one
``torch.linalg.eigh`` or ``solve``. Array geometries stay numpy, and ESPRIT
and root-MUSIC host-side numpy, as in the JAX package.
"""

from coherent_rtlsdr_tpu_torch.models.geometry import (
    ula_positions,
    ura_positions,
    steering_vectors,
    uv_grid,
)
from coherent_rtlsdr_tpu_torch.models.beamform import (
    sample_covariance,
    music_spectrum,
    bartlett_spectrum,
    mvdr_spectrum,
    music_heatmap,
    esprit_doa,
    root_music_doa,
)
from coherent_rtlsdr_tpu_torch.models.coarray import (
    difference_coarray,
    augmented_covariance,
    coarray_music_spectrum,
    virtual_ura,
)

__all__ = [
    "ula_positions",
    "ura_positions",
    "steering_vectors",
    "uv_grid",
    "sample_covariance",
    "music_spectrum",
    "bartlett_spectrum",
    "mvdr_spectrum",
    "music_heatmap",
    "difference_coarray",
    "augmented_covariance",
    "coarray_music_spectrum",
    "virtual_ura",
]
