"""Dense DFT matrices for the streamed (out-of-core) transforms.

The in-core paths use ``jnp.fft`` (cuFFT on the GPU). The streamed
path (ops/outofcore.py) cannot: its x-axis transform couples slabs that
are never resident together, so it applies the DFT as a dense matrix
per axis — the z and y axes slab-locally, the x axis one kx-chunk at a
time — as real einsums on planar (re, im) data. Those einsums run at
the module ``PRECISION`` (see its comment).

The reference computes np.fft.fftn on every MPI rank redundantly
(reference: fava/mesh/FLASH/FlashUniform.py:268).
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

# Precision of the dense-DFT einsums. An f32 dot on the GPU at
# Precision.DEFAULT or HIGH runs on the TF32 tensor cores (10-bit
# mantissa inputs); HIGHEST runs true f32. HIGHEST is the default
# because the streamed spectra must agree with the in-core cuFFT result
# to the package's f32 tolerance (1e-5 scale-normalized), which TF32
# rounding misses; the measured errors of both modes are in PERF.md.
# FAVA_DFT_PRECISION=high (env, read at import) or assigning
# dft.PRECISION selects the TF32 mode for exploratory runs.
_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}
_prec_name = os.environ.get("FAVA_DFT_PRECISION", "highest").strip().lower()
if _prec_name not in _PRECISIONS:
    raise ValueError(
        f"FAVA_DFT_PRECISION={_prec_name!r}: expected one of {sorted(_PRECISIONS)}"
    )
PRECISION = _PRECISIONS[_prec_name]


# The matrix caches hold HOST arrays: caching device arrays would leak
# tracers when first materialized inside a jit trace.


@lru_cache(maxsize=16)
def _rdft_mats(n: int, dtype_name: str):
    """Real-to-halfcomplex DFT matrices: (cos, -sin), each (n, n//2+1)."""
    k = np.arange(n // 2 + 1)
    j = np.arange(n)[:, None]
    ang = 2.0 * np.pi * j * k / n
    dt = np.dtype(dtype_name)
    return np.cos(ang).astype(dt), (-np.sin(ang)).astype(dt)


@lru_cache(maxsize=16)
def _dft_mat(n: int, dtype_name: str):
    """Complex DFT matrix exp(-2*pi*i*j*k/n), (n, n)."""
    j = np.arange(n)[:, None]
    k = np.arange(n)
    ang = -2.0 * np.pi * j * k / n
    cdt = np.complex128 if np.dtype(dtype_name) == np.float64 else np.complex64
    return np.exp(1j * ang).astype(cdt)


def planar_complex_matmul(spec, dr, di, re, im, precision=None):
    """(dr + i*di) applied to planar (re, im) data via REAL einsums.

    One definition for every planar DFT site (both out-of-core stages,
    ops/outofcore.py) so precision plumbing and algebra fixes land
    everywhere at once. The caller keeps its exact einsum ``spec`` —
    the spellings fix the operand layouts of the streamed path.
    """
    precision = PRECISION if precision is None else precision

    def t(m, v):
        return jnp.einsum(spec, m, v, precision=precision)

    return t(dr, re) - t(di, im), t(dr, im) + t(di, re)
