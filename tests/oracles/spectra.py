"""NumPy oracle for kinetic-energy spectra.

Implements the algorithm of fava/mesh/FLASH/FlashUniform.py:229-304:
forward-normalized FFT of sqrt(rho)*v, fftshifted onto a centered
integer k-grid, total/longitudinal/transverse powers, spherical shell
means via scipy.stats.binned_statistic, integral factor k^(d-1)*2pi(d-1).

``federrath_transpose=True`` reproduces the reference's stray ``.T``
in the longitudinal projection (a 2D-ism bug); False is the correct
projection, which is what the device kernel computes.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import scipy.fft
from scipy.stats import binned_statistic


def ke_spectra_oracle(
    dens: np.ndarray,
    vels: Sequence[np.ndarray],
    federrath_transpose: bool = False,
) -> Dict[str, np.ndarray]:
    ndim = dens.ndim
    k_num = np.array(dens.shape)

    k_start = -k_num // 2
    k_end = -k_start - 1
    k = np.array(
        np.meshgrid(*(np.linspace(ks, ke, n) for ks, ke, n in zip(k_start, k_end, k_num)), indexing="ij")
    )
    k_abs = np.abs(k) if ndim == 1 else np.sqrt((k**2).sum(axis=0))

    bins = np.arange(np.max(k_num) // 2) - 0.5

    w = np.sqrt(dens)
    ffts = []
    for v in vels:
        # scipy.fft equals np.fft in f64; workers=-1 uses every core.
        f = np.fft.fftshift(scipy.fft.fftn(w * v, norm="forward", workers=-1))
        ffts.append(f)
    ffts = np.array(ffts)

    power = {"total": 0.5 * (np.abs(ffts) ** 2).sum(axis=0)}

    longi = np.zeros(tuple(k_num), dtype=np.complex128)
    if ndim == 1:
        longi = longi + k * ffts[0]
    else:
        for n in range(ndim):
            contrib = ffts[n].T if federrath_transpose else ffts[n]
            longi = longi + k[n] * contrib
    power["longitudinal"] = np.abs(longi / np.maximum(k_abs, 1e-99)) ** 2
    power["transverse"] = power["total"] - power["longitudinal"]

    spectral: Dict[str, np.ndarray] = {}
    for key, val in power.items():
        stats = binned_statistic(k_abs.flatten(), val.flatten(), bins=bins, statistic="mean")
        if "k" not in spectral:
            spectral["k"] = stats.bin_edges[:-1] + 0.5
        spectral[key] = stats.statistic

    factor = spectral["k"] ** (ndim - 1)
    if ndim > 1:
        factor = factor * 2 * np.pi * (ndim - 1)
    for key in list(spectral.keys()):
        if key != "k":
            spectral[key] = spectral[key] * factor
    return spectral


def signed_wavenumbers(n: int) -> np.ndarray:
    """Unshifted integer wavenumbers of an n-point FFT axis (f64)."""
    k = np.arange(n)
    return np.where(k <= (n - 1) // 2, k, k - n).astype(np.float64)


def shell_sums_oracle(powers: Sequence[np.ndarray], nbins: int):
    """(counts, sums) of full-grid power volumes binned into integer
    |k| shells: shell floor(|k| + 0.5), right-inclusive last edge
    nbins - 0.5 (scipy.stats.binned_statistic with edges
    arange(nbins + 1) - 0.5, as the reference bins)."""
    shape = powers[0].shape
    ks = np.meshgrid(*(signed_wavenumbers(n) for n in shape), indexing="ij")
    k_abs = np.sqrt(sum(k * k for k in ks)).ravel()
    idx = np.clip(np.floor(k_abs + 0.5).astype(np.int64), 0, nbins - 1)
    inside = k_abs <= nbins - 0.5
    counts = np.bincount(idx, weights=inside.astype(np.float64), minlength=nbins)[:nbins]
    sums = np.stack(
        [
            np.bincount(idx, weights=np.where(inside, p.ravel(), 0.0), minlength=nbins)[:nbins]
            for p in powers
        ]
    )
    return counts, sums
