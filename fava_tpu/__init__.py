"""fava_tpu: a JAX turbulence-statistics engine for FLASH data.

Ground-up JAX/XLA rebuild of the FAVA analysis package: FLASH HDF5
ingest to device memory, AMR->uniform regridding as on-device gathers,
fused profile/spectra reduction kernels, and pod-sharded FFTs over a
``jax.sharding.Mesh`` — with the reference's model/mesh/analysis API
surface preserved.
"""

from fava_tpu._version import __version__, __version_tuple__
from fava_tpu.models import FLASH, FileSubStem, FileType, Model
from fava_tpu.models.arrays import InMemoryModel, from_arrays
from fava_tpu.mesh import FlashParticles, FlashUniform
from fava_tpu.mesh import FLASH as FlashAMR
from fava_tpu import analysis  # noqa: F401  (registers analyses onto Model)
from fava_tpu import geometry, io, ops, parallel, utils  # noqa: F401

__author__ = "fava_tpu developers"

__all__ = [
    "__version__",
    "__version_tuple__",
    "Model",
    "FLASH",
    "FlashAMR",
    "FlashUniform",
    "FlashParticles",
    "FileSubStem",
    "FileType",
    "InMemoryModel",
    "from_arrays",
    "analysis",
    "geometry",
    "io",
    "ops",
    "parallel",
    "utils",
]
