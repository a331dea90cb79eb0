"""Kinetic-energy spectra: 3D FFT + spherical shell binning.

Device-side redesign of the reference's Federrath-derived implementation
(reference: fava/mesh/FLASH/FlashUniform.py:229-304). Differences by
design:

* The FFT is the pod-sharded slab FFT from :mod:`fava_tpu.parallel.fft`
  when a device mesh is active — the reference computes the full
  ``np.fft.fftn`` redundantly on every rank.
* No ``fftshift``: shell binning and the longitudinal projection are
  permutation-invariant in k, so we use the matching unshifted integer
  wavenumber grid. Results are identical for even grid sizes (the
  reference's ``linspace`` k-grid is only integer-valued for even n).
* The reference applies a stray ``.T`` to each velocity FFT in the
  longitudinal projection for ndim>1 (FlashUniform.py:281) — a bug
  inherited from a 2D-specific source. We compute the correct
  projection sum(k_n * w_n); the NumPy oracle covers both behaviors.

Shell binning replicates ``scipy.stats.binned_statistic(..., "mean")``
with edges ``arange(max(n)//2) - 0.5``: right-inclusive last edge,
NaN for empty shells.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.parallel import fft as pfft
from fava_tpu.parallel import runtime
from fava_tpu.utils import accum_dtype


def _wavenumber_grid(shape: Tuple[int, ...], dtype):
    """Unshifted integer wavenumber component grids for an ndim volume."""
    ks = []
    nd = len(shape)
    for axis, n in enumerate(shape):
        k = pfft._wavenumbers(n, dtype)
        kshape = [1] * nd
        kshape[axis] = n
        ks.append(k.reshape(kshape))
    return ks


def _split_nyquist(k, n: int, idx):
    """Signed wavenumbers -> (conjugate-even part, Nyquist magnitude).

    Even extents place the self-conjugate Nyquist mode at idx == n//2
    (signed value -n/2); odd extents have none. Used to keep the
    longitudinal projection exact on rfft half-spectra (see
    rfft_power_volumes).
    """
    if n % 2 == 0:
        is_nyq = idx == n // 2
        zero = jnp.zeros((), dtype=k.dtype)
        return (
            jnp.where(is_nyq, zero, k),
            jnp.where(is_nyq, jnp.asarray(n / 2.0, dtype=k.dtype), zero),
        )
    return k, jnp.zeros_like(k)


def rfft_power_volumes(ffts, full_shape: Tuple[int, int, int], jy=None, ky=None, jx=None, kx=None):
    """(total, longi, trans, k_abs) power volumes of z-rfft half-spectra.

    ``ffts`` are the three velocity transforms with a half z axis
    (length nz//2+1). Shell-binning these with Hermitian weights must
    reproduce the full-grid computation exactly; for the longitudinal
    projection that requires care at Nyquist planes: the full-grid
    convention assigns k = -n/2 at BOTH a Nyquist-component point j and
    its conjugate -j, so the projection is not conjugate-even there.
    Splitting k into a conjugate-even "regular" part and a
    self-conjugate "Nyquist" part, the full-grid pair sum over {j, -j}
    equals 2(|reg.w|^2 + |nyq.w|^2) — so weight-2 (kz>0) planes use
    |reg.w|^2 + |nyq.w|^2 and the kz=0 plane (whose points are full-grid
    points verbatim) uses the plain signed formula |reg.w - nyq.w|^2.
    Validated against full-grid binning in tests/test_spectra.py.

    ``jy``/``ky`` (and ``jx``/``kx``) override the y (x) wavenumbers for
    sharded or chunked k-slabs (1D arrays of global indices / signed
    wavenumbers).
    """
    nx, ny, nz = full_shape
    nzr = ffts[0].shape[-1]
    rdt = ffts[0].real.dtype
    if kx is None:
        kx = pfft._wavenumbers(nx, rdt)
        jx = jnp.arange(nx)
    kx = kx[:, None, None]
    jx = jx[:, None, None]
    if ky is None:
        ky = pfft._wavenumbers(ny, rdt)
        jy = jnp.arange(ny)
    ky = ky[None, :, None]
    jy = jy[None, :, None]
    jz = jnp.arange(nzr)[None, None, :]
    kz = jz.astype(rdt)

    k_abs = jnp.sqrt(kx * kx + ky * ky + kz * kz)
    total = 0.5 * sum(jnp.abs(f) ** 2 for f in ffts)

    kx_r, kx_n = _split_nyquist(kx, nx, jx)
    ky_r, ky_n = _split_nyquist(ky, ny, jy)
    kz_r, kz_n = _split_nyquist(kz, nz, jz)
    reg = kx_r * ffts[0] + ky_r * ffts[1] + kz_r * ffts[2]
    nyq = kx_n * ffts[0] + ky_n * ffts[1] + kz_n * ffts[2]

    guard = jnp.maximum(k_abs, jnp.asarray(1e-30, rdt))
    longi = jnp.where(
        jz == 0,
        jnp.abs((reg - nyq) / guard) ** 2,
        jnp.abs(reg / guard) ** 2 + jnp.abs(nyq / guard) ** 2,
    )
    return total, longi, total - longi, k_abs


@partial(jax.jit, static_argnames=("nbins", "full_nx", "full_nz"))
def shell_bin_rfft(vols, nbins: int, full_nx: int, full_nz: int, kx0=0):
    """Hermitian-weighted shell binning of z-rfft half-spectrum volumes.

    ``vols`` is a tuple of (rows, ny, nz//2+1) power volumes: an
    x-chunk whose first row is global row ``kx0`` (traced int) of a
    (full_nx, ny, full_nz) grid, or the whole half-spectrum with
    ``kx0 = 0``. Interior kz planes carry weight 2 and the kz = 0 /
    kz = n/2 planes weight 1, so the result equals full-grid binning.
    Shell index floor(|k| + 0.5) with the right-inclusive last edge of
    scipy.stats.binned_statistic (reference: FlashUniform.py:286-293).
    Returns (counts (nbins,), sums (len(vols), nbins)); sums over
    x-chunks add up to the whole-volume result.
    """
    rows_x, ny, nzr = vols[0].shape
    dtype = vols[0].dtype
    jx = kx0 + jnp.arange(rows_x)
    kx = jnp.where(jx <= (full_nx - 1) // 2, jx, jx - full_nx).astype(dtype)
    ky = pfft._wavenumbers(ny, dtype)
    kz = jnp.arange(nzr).astype(dtype)
    k_abs = jnp.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2)
    jz = jnp.arange(nzr)
    self_conj = jz == 0
    if full_nz % 2 == 0:  # Nyquist plane exists only for even extents
        self_conj = self_conj | (jz == full_nz // 2)
    weight = jnp.broadcast_to(jnp.where(self_conj, 1.0, 2.0).astype(dtype), k_abs.shape)

    idx = jnp.clip(jnp.floor(k_abs + 0.5).astype(jnp.int32), 0, nbins - 1).ravel()
    w = jnp.where((k_abs <= (nbins - 0.5)).ravel(), weight.ravel(), 0)
    counts = jnp.zeros(nbins, dtype=dtype).at[idx].add(w)
    stacked = jnp.stack([v.ravel() for v in vols]) * w
    sums = jnp.zeros((len(vols), nbins), dtype=dtype).at[:, idx].add(stacked)
    return counts, sums


@lru_cache(maxsize=8)
def rfft_shell_counts(full_shape: Tuple[int, int, int], nbins: int, dtype_name: str) -> np.ndarray:
    """Hermitian shell counts of a full rfft half-spectrum (host NumPy).

    Counts are a pure shape function, so streamed consumers that bin
    values chunk by chunk take them from here. Returned as a HOST
    array: a jnp array made inside a jit trace is a tracer, and caching
    it would leak it into later traces. Integer weights sum exactly in
    f32 (the largest 512^3 shell is ~8e5 << 2^24).
    """
    nx, ny, nz = (int(s) for s in full_shape)
    nzr = nz // 2 + 1
    kx = np.fft.fftfreq(nx, 1.0 / nx)
    ky = np.fft.fftfreq(ny, 1.0 / ny)
    kz = np.arange(nzr, dtype=np.float64)
    k_abs = np.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2)
    self_conj = kz == 0
    if nz % 2 == 0:
        self_conj |= kz == nz // 2
    weight = np.broadcast_to(np.where(self_conj, 1.0, 2.0), k_abs.shape)
    shell = np.clip(np.floor(k_abs + 0.5).astype(np.int64), 0, nbins - 1)
    w = np.where(k_abs <= nbins - 0.5, weight, 0.0)
    return np.bincount(shell.ravel(), weights=w.ravel(), minlength=nbins)[:nbins].astype(dtype_name)


def local_spectra_fn(full_shape, nbins: int, nd: int, axis_name: str):
    """Device-local spectra body for use INSIDE a shard_map over ``axis_name``.

    Returns ``local(d_loc, *v_loc) -> (counts, sums[3])`` where the
    inputs are x-slab shards of one snapshot: local 2D FFT ->
    all_to_all shard transpose -> local 1D FFT -> local k-slab powers
    and shell binning -> psum of the accumulators. Shared by the
    single-snapshot shard_map below and the snap x space pod series
    step (flagship.sharded_series_analysis_step), which calls it from
    inside a lax.scan over the local snapshot batch.
    """
    nx, ny, nz = (int(s) for s in full_shape)
    ntot = nx * ny * nz
    nzr = nz // 2 + 1
    adt = accum_dtype()

    def local(d_loc, *v_loc):
        sd = jnp.sqrt(d_loc)
        ffts = []
        for v in v_loc:
            # Real input: rfft along z halves local FFT work and the
            # all_to_all payload; Hermitian weights below make shell
            # sums exactly equal to the full-grid computation.
            w = jnp.fft.fft(jnp.fft.rfft(sd * v, axis=-1), axis=1)
            w = jax.lax.all_to_all(w, axis_name, split_axis=1, concat_axis=0, tiled=True)
            ffts.append(jnp.fft.fft(w, axis=0) / ntot)

        idx = jax.lax.axis_index(axis_name)
        lo = idx * (ny // nd)
        rdt = ffts[0].real.dtype
        ky_full = pfft._wavenumbers(ny, rdt)
        ky = jax.lax.dynamic_slice(ky_full, (lo,), (ny // nd,))
        jy = lo + jnp.arange(ny // nd)
        total, longi, trans, k_abs = rfft_power_volumes(ffts, (nx, ny, nz), jy=jy, ky=ky)

        jz = jnp.arange(nzr)
        self_conj = jz == 0
        if nz % 2 == 0:  # Nyquist plane exists only for even extents
            self_conj = self_conj | (jz == nz // 2)
        weight = jnp.where(self_conj, 1.0, 2.0).astype(adt)
        weight = jnp.broadcast_to(weight[None, None, :], k_abs.shape)

        bidx = jnp.clip(jnp.floor(k_abs + 0.5).astype(jnp.int32), 0, nbins - 1).ravel()
        mask = (k_abs <= (nbins - 0.5)).ravel()
        w_flat = jnp.where(mask, weight.ravel(), 0)
        counts = jnp.zeros(nbins, dtype=adt).at[bidx].add(w_flat)
        stacked = jnp.stack([total.ravel(), longi.ravel(), trans.ravel()]).astype(adt)
        sums = jnp.zeros((3, nbins), dtype=adt).at[:, bidx].add(stacked * w_flat)
        return jax.lax.psum(counts, axis_name), jax.lax.psum(sums, axis_name)

    return local


def sharded_power_spectra(dens, vels, mesh, nbins: int, axis_name: str = None):
    """(counts, sums[3]) of shell-binned spectral powers over a device mesh.

    One shard_map: per-device local 2D FFT -> all_to_all shard transpose
    -> local 1D FFT -> local k-slab powers and scatter binning -> one
    psum of the (4, nbins) accumulators. The slabs cross the
    interconnect once; no global reshapes or partitioner-inserted
    gathers.
    """
    from fava_tpu.parallel import runtime as prt

    axis_name = axis_name or prt.SPACE_AXIS
    shape = tuple(int(s) for s in dens.shape)
    nd = mesh.shape[axis_name]
    local = local_spectra_fn(shape, nbins, nd, axis_name)

    from jax.sharding import PartitionSpec as P

    spec = P(axis_name, None, None)
    # Replicate over any other mesh axes by naming only the space axis.
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec,) * (1 + len(vels)),
        out_specs=(P(), P()),
    )(dens, *vels)


@lru_cache(maxsize=32)
def _build_spectra_fn(shape: Tuple[int, ...], mesh_key, nbins: int):
    """Jitted spectra core for a given volume shape (cached per shape/mesh)."""
    mesh = mesh_key  # jax.sharding.Mesh is hashable
    ndim = len(shape)
    ntot = int(np.prod(shape))

    from fava_tpu.parallel import runtime as prt

    use_shard_map = (
        mesh is not None
        and ndim == 3
        and prt.SPACE_AXIS in getattr(mesh, "axis_names", ())
        and mesh.shape[prt.SPACE_AXIS] > 1
        and shape[0] % mesh.shape[prt.SPACE_AXIS] == 0
        and shape[1] % mesh.shape[prt.SPACE_AXIS] == 0
    )

    def core(dens, vels):
        adt = accum_dtype()

        if use_shard_map:
            counts, sums = sharded_power_spectra(dens, tuple(vels), mesh, nbins)
            return jnp.where(counts > 0, sums / jnp.maximum(counts, 1), jnp.nan)

        if mesh is None and ndim == 3:
            # Real input: rfft half-spectrum + Hermitian-weighted shell
            # binning — exactly equal to the full-grid result at half
            # the FFT and binning cost.
            nx, ny, nz = shape
            sqrt_d = jnp.sqrt(dens)
            fft3 = jnp.fft.rfftn(jnp.stack([sqrt_d * v for v in vels]), axes=(1, 2, 3)) / ntot
            ffts = [fft3[i] for i in range(len(vels))]
            total, longi, trans, _ = rfft_power_volumes(ffts, (nx, ny, nz))
            counts, sums = shell_bin_rfft(
                (total.astype(adt), longi.astype(adt), trans.astype(adt)), nbins, nx, nz
            )
            return jnp.where(counts > 0, sums / jnp.maximum(counts, 1), jnp.nan)

        sqrt_d = jnp.sqrt(dens)
        ffts = []
        for v in vels:
            w = sqrt_d * v
            if ndim == 3:
                fw = pfft.pfft3(w.astype(jnp.promote_types(w.dtype, jnp.float32)), mesh=mesh)
            else:
                fw = jnp.fft.fftn(w)
            ffts.append(fw / ntot)  # norm="forward"

        ks = _wavenumber_grid(shape, ffts[0].real.dtype)
        k_abs2 = sum(k * k for k in ks)
        k_abs = jnp.sqrt(k_abs2) if ndim > 1 else jnp.abs(ks[0])

        total = 0.5 * sum(jnp.abs(f) ** 2 for f in ffts)

        longitudinal = sum(k * f for k, f in zip(ks, ffts))
        longitudinal = jnp.abs(longitudinal / jnp.maximum(k_abs, jnp.asarray(1e-30, k_abs.dtype))) ** 2
        transverse = total - longitudinal

        # binned_statistic "mean" with edges arange(nbins+1)-0.5.
        # (Only sharded/low-dim volumes reach here: the mesh-is-None 3D
        # case returned through the rfft fast path above, so this is
        # the local scatter-add partitioned over the mesh.)
        stacked = jnp.stack([total.ravel(), longitudinal.ravel(), transverse.ravel()])
        idx = jnp.clip(jnp.floor(k_abs + 0.5).astype(jnp.int32), 0, nbins - 1)
        include = k_abs <= (nbins - 0.5)
        flat_idx = idx.ravel()
        mask = include.ravel()
        counts = jnp.zeros(nbins, dtype=adt).at[flat_idx].add(mask.astype(adt))
        sums = jnp.zeros((3, nbins), dtype=adt).at[:, flat_idx].add(
            jnp.where(mask, stacked.astype(adt), 0)
        )
        means = jnp.where(counts > 0, sums / jnp.maximum(counts, 1), jnp.nan)
        return means

    return jax.jit(core)


def _squeeze_trailing(arr, ndim: int):
    """Drop singleton trailing axes of low-dimensional datasets.

    Raises (not an assert — python -O strips those) when a trailing
    axis is non-singleton, which would otherwise surface later as an
    opaque reshape error."""
    if arr.ndim > ndim:
        squeeze = tuple(range(ndim, arr.ndim))
        if not all(arr.shape[a] == 1 for a in squeeze):
            raise ValueError(
                f"non-singleton trailing axes {tuple(arr.shape[ndim:])} for ndim={ndim}"
            )
        arr = arr.reshape(arr.shape[:ndim])
    return arr


def _shell_integral_factor(nbins: int, ndim: int) -> np.ndarray:
    """k^(d-1) * 2*pi*(d-1) shell factor (reference FlashUniform.py:295-302)
    — ONE definition so KE and scalar spectrum slopes stay comparable."""
    k = np.arange(nbins, dtype=np.float64)
    factor = k ** (ndim - 1)
    if ndim > 1:
        factor = factor * (2.0 * np.pi * (ndim - 1))
    return k, factor


def kinetic_energy_spectra(
    dens: jax.Array,
    vels: Sequence[jax.Array],
    mesh=None,
    ndim: int = None,
) -> Dict[str, np.ndarray]:
    """Total/longitudinal/transverse KE spectra of sqrt(rho)*v.

    Returns {"k", "total", "longitudinal", "transverse"} with the
    reference's integral factor k^(d-1) * 2*pi*(d-1) applied
    (reference: fava/mesh/FLASH/FlashUniform.py:295-302). For 1D/2D
    datasets (singleton trailing axes), pass ``ndim`` so the dimension
    is honored in the wavenumbers and the integral factor.
    """
    mesh = mesh if mesh is not None else runtime.get_mesh()
    ndim = int(ndim) if ndim is not None else len(vels)
    if dens.ndim > ndim:
        dens = _squeeze_trailing(dens, ndim)
        vels = [v.reshape(v.shape[:ndim]) for v in vels]
    shape = tuple(int(s) for s in dens.shape)
    nbins = max(shape) // 2 - 1  # len(bins)-1 with bins = arange(max//2)-0.5

    fn = _build_spectra_fn(shape, mesh, nbins)
    means = np.asarray(fn(dens, tuple(vels)), dtype=np.float64)

    k, integral_factor = _shell_integral_factor(nbins, ndim)

    return {
        "k": k,
        "total": means[0] * integral_factor,
        "longitudinal": means[1] * integral_factor,
        "transverse": means[2] * integral_factor,
    }


@lru_cache(maxsize=32)
def _build_scalar_spectrum_fn(shape: Tuple[int, ...], mesh_key, nbins: int):
    """Jitted scalar power-spectrum core (cached per shape/mesh)."""
    mesh = mesh_key
    ndim = len(shape)
    ntot = int(np.prod(shape))
    adt = accum_dtype()

    def core(field):
        if mesh is not None and ndim == 3:
            # Pod-sharded pencil FFT + GSPMD-partitioned scatter
            # binning, like _build_spectra_fn's generic branch.
            fw = pfft.pfft3(
                field.astype(jnp.promote_types(field.dtype, jnp.float32)), mesh=mesh
            ) / ntot
        elif ndim == 3:
            fw = jnp.fft.rfftn(field) / ntot
            p = (jnp.abs(fw) ** 2).astype(adt)
            counts, sums = shell_bin_rfft((p,), nbins, shape[0], shape[-1])
            return jnp.where(counts > 0, sums[0] / jnp.maximum(counts, 1), jnp.nan)
        else:
            fw = jnp.fft.fftn(field) / ntot

        p = (jnp.abs(fw) ** 2).astype(adt)
        ks = _wavenumber_grid(shape, p.dtype)
        k_abs = jnp.sqrt(sum(k * k for k in ks)) if ndim > 1 else jnp.abs(ks[0])
        idx = jnp.clip(jnp.floor(k_abs + 0.5).astype(jnp.int32), 0, nbins - 1).ravel()
        mask = (k_abs <= (nbins - 0.5)).ravel()
        counts = jnp.zeros(nbins, dtype=adt).at[idx].add(mask.astype(adt))
        sums = jnp.zeros(nbins, dtype=adt).at[idx].add(jnp.where(mask, p.ravel(), 0))
        return jnp.where(counts > 0, sums / jnp.maximum(counts, 1), jnp.nan)

    return jax.jit(core)


def scalar_spectrum(
    field: jax.Array,
    ndim: int = None,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Shell-binned power spectrum of ONE scalar field.

    Beyond the reference (which only computes KE spectra of
    sqrt(rho)*v): density / flame-progress / temperature power spectra
    are standard turbulence diagnostics and reuse the same forward-norm
    transform and scipy-convention shell binning (mean over the shell,
    edges arange(max(n)//2) - 0.5), with the same k^(d-1)*2*pi*(d-1)
    integral factor so slopes are directly comparable with the KE
    spectra. Returns {"k", "power"}.
    """
    mesh = mesh if mesh is not None else runtime.get_mesh()
    ndim = int(ndim) if ndim is not None else field.ndim
    field = _squeeze_trailing(field, ndim)
    shape = tuple(int(s) for s in field.shape)
    nbins = max(shape) // 2 - 1

    fn = _build_scalar_spectrum_fn(shape, mesh, nbins)
    mean = np.asarray(fn(field), dtype=np.float64)

    k, integral_factor = _shell_integral_factor(nbins, ndim)
    return {"k": k, "power": mean * integral_factor}
