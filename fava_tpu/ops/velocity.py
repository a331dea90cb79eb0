"""Spectral velocity-field diagnostics: Helmholtz decomposition,
vorticity, dilatation, and enstrophy/helicity spectra.

Beyond the reference (which stops at kinetic-energy spectra,
fava/mesh/FLASH/FlashUniform.py:229-304): these are the standard
companion diagnostics of compressible-turbulence analysis —
solenoidal/compressive mode separation, enstrophy budgets, and
helicity — and they reuse the transform machinery this framework
already has (jnp.fft half-spectrum transforms and the Hermitian-weighted
shell binning of ops/spectra.py), so each costs a few transforms, not a
new subsystem.

Conventions (documented where they bite):

* Periodic boxes, like every spectral analysis in the package. The
  wavenumber grid is the signed integer grid (``pfft._wavenumbers``);
  physical derivative operators scale axis i by ``2*pi/L_i`` when
  ``lengths`` is given (FLASH domains are physical cm), else the
  2*pi-periodic unit-box convention (factor = integer k) is used.
* Every spectral operator zeroes the Nyquist wavenumber of even axes:
  the array index convention assigns the un-pairable value -n/2 there,
  which breaks the symmetry real inverse transforms require — for odd
  (derivative) operators outright (standard spectral-derivative
  practice, same convention as scipy.fftpack.diff), and for the
  Helmholtz projection through its k_i*k_j cross terms, which are even
  only under flipping ALL components at once. Nyquist modes therefore
  join the k = 0 (mean-flow) mode — whose direction is equally
  undefined — in the solenoidal part.
* Spectra are shell means over the integer-|k| grid with the same
  edges, Hermitian weights, forward-norm 1/N transforms, and
  k^(d-1) * 2*pi*(d-1) integral factor as the KE spectra
  (ops/spectra.py), so slopes are directly comparable.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.utils import accum_dtype


def _phys_factors(lengths: Optional[Sequence[float]], nd: int):
    """Per-axis 2*pi/L factors turning integer wavenumbers into physical
    ones (unit factors when no domain lengths are given)."""
    if lengths is None:
        return (1.0,) * nd
    if len(lengths) != nd:
        raise ValueError(f"lengths must have {nd} entries, got {len(lengths)}")
    return tuple(2.0 * np.pi / float(L) for L in lengths)


def _k_grids(shape: Tuple[int, ...], dtype, lengths, zero_nyquist: bool):
    """Broadcastable wavenumber grids on the trailing-axis rfft
    half-spectrum (2D or 3D volume shape).

    ``zero_nyquist`` is required for odd (derivative) operators — see
    the module docstring.
    """
    nd = len(shape)
    factors = _phys_factors(lengths, nd)

    def signed(n, f):
        # Host-side twin of pfft._wavenumbers (these grids are trace-time
        # constants; no device round trip while tracing).
        j = np.arange(n)
        k = (np.where(j <= (n - 1) // 2, j, j - n) * f).astype(dtype)
        if zero_nyquist and n % 2 == 0:
            k[n // 2] = 0.0
        return k

    grids = []
    for axis, (n, f) in enumerate(zip(shape, factors)):
        if axis == nd - 1:  # half (rfft) axis: non-negative modes only
            kv = np.arange(n // 2 + 1, dtype=dtype) * f
            if zero_nyquist and n % 2 == 0:
                kv[n // 2] = 0.0
        else:
            kv = signed(n, f)
        kshape = [1] * nd
        kshape[axis] = len(kv)
        grids.append(jnp.asarray(kv).reshape(kshape))
    return grids


def _rfft3(v: jax.Array) -> jax.Array:
    return jnp.fft.rfftn(v)


def _irfft3(spec: jax.Array, nz: int) -> jax.Array:
    # numpy semantics: the inverse carries the full 1/N normalization,
    # so unnormalized-forward -> _irfft3 round-trips exactly.
    return jnp.fft.irfftn(spec, s=(*spec.shape[:-1], int(nz)))


def _vorticity_hats(vhats, shape, lengths):
    """i k x v̂ on the half-spectrum grid (Nyquist-zeroed k)."""
    kx, ky, kz = _k_grids(shape, vhats[0].real.dtype, lengths, zero_nyquist=True)
    wx, wy, wz = vhats
    i = jnp.asarray(1j, dtype=vhats[0].dtype)
    return (
        i * (ky * wz - kz * wy),
        i * (kz * wx - kx * wz),
        i * (kx * wy - ky * wx),
    )


def _check_vels(vels, lengths, what: str):
    """Common validation; returns (shape, hashable lengths key)."""
    shape = tuple(int(s) for s in vels[0].shape)
    nd = len(shape)
    if nd not in (2, 3):
        raise ValueError(f"{what} requires 2D or 3D velocity volumes, got {nd}D")
    if len(vels) != nd:
        raise ValueError(f"{what}: {nd}D flow needs {nd} velocity components, got {len(vels)}")
    for i, v in enumerate(vels[1:], start=1):
        # broadcast-compatible mismatches (e.g. an unsqueezed (n, n, 1)
        # component) would silently produce full-shaped wrong fields
        if tuple(int(s) for s in v.shape) != shape:
            raise ValueError(
                f"{what}: velocity component {i} shape {tuple(v.shape)} "
                f"does not match component 0 shape {shape}"
            )
    if lengths is not None and len(lengths) != nd:
        raise ValueError(f"lengths must have {nd} entries, got {len(lengths)}")
    key = None if lengths is None else tuple(float(L) for L in lengths)
    return shape, key


@lru_cache(maxsize=16)
def _helmholtz_fn(shape: Tuple[int, ...], lengths):
    n_last = shape[-1]

    def core(*vels):
        vhats = [_rfft3(v) for v in vels]
        rdt = vhats[0].real.dtype
        ks = _k_grids(shape, rdt, lengths, zero_nyquist=True)
        k2 = sum(k * k for k in ks)
        div = sum(k * w for k, w in zip(ks, vhats)) / jnp.maximum(
            k2, jnp.asarray(1e-30, rdt)
        )
        comp = [_irfft3(k * div, n_last) for k in ks]
        sol = [v - c for v, c in zip(vels, comp)]
        return tuple(sol), tuple(comp)

    return jax.jit(core)


def helmholtz_decompose(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, Dict[str, jax.Array]]:
    """Solenoidal/compressive split of a periodic velocity field.

    The compressive (curl-free) part is the spectral projection onto
    k̂; the solenoidal (divergence-free) part is the remainder — the
    two sum to the input EXACTLY by construction (one inverse-transform
    set, not two). The k = 0 and Nyquist modes land in the solenoidal
    part (module docstring). ``lengths`` scales the projection
    direction for anisotropic physical domains; for a cubic box it
    cancels. 2D flows pass two (nx, ny) components and ``velz=None``.
    Returns {"solenoidal": {velx, vely[, velz]}, "compressive": {...}}.
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "helmholtz_decompose")
    sol, comp = _helmholtz_fn(shape, key)(*vels)
    names = ("velx", "vely", "velz")[: len(vels)]
    return {
        "solenoidal": dict(zip(names, sol)),
        "compressive": dict(zip(names, comp)),
    }


@lru_cache(maxsize=16)
def _vorticity_fn(shape: Tuple[int, ...], lengths):
    n_last = shape[-1]

    def core(*vels):
        vhats = [_rfft3(v) for v in vels]
        if len(shape) == 2:
            # 2D vorticity is the scalar out-of-plane component.
            kx, ky = _k_grids(shape, vhats[0].real.dtype, lengths, zero_nyquist=True)
            i = jnp.asarray(1j, dtype=vhats[0].dtype)
            return _irfft3(i * (kx * vhats[1] - ky * vhats[0]), n_last)
        whats = _vorticity_hats(vhats, shape, lengths)
        return tuple(_irfft3(w, n_last) for w in whats)

    return jax.jit(core)


def vorticity(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    lengths: Optional[Sequence[float]] = None,
):
    """Vorticity ω = ∇ x v via spectral differentiation (periodic).

    3D returns the (ωx, ωy, ωz) component tuple; 2D (``velz=None``)
    returns the scalar out-of-plane vorticity ∂x vy - ∂y vx.
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "vorticity")
    return _vorticity_fn(shape, key)(*vels)


@lru_cache(maxsize=16)
def _dilatation_fn(shape: Tuple[int, ...], lengths):
    n_last = shape[-1]

    def core(*vels):
        vhats = [_rfft3(v) for v in vels]
        ks = _k_grids(shape, vhats[0].real.dtype, lengths, zero_nyquist=True)
        i = jnp.asarray(1j, dtype=vhats[0].dtype)
        theta = i * sum(k * w for k, w in zip(ks, vhats))
        return _irfft3(theta, n_last)

    return jax.jit(core)


def dilatation(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    lengths: Optional[Sequence[float]] = None,
) -> jax.Array:
    """Dilatation θ = ∇ . v via spectral differentiation (periodic)."""
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "dilatation")
    return _dilatation_fn(shape, key)(*vels)


def _bin_rfft_stats(p: jax.Array, full_shape, nbins: int):
    """(counts, sums) Hermitian-weighted shell stats of one power volume
    on the trailing-axis half-spectrum — the scalar-spectrum binning,
    shared by the mean (spectra) and sum (transfer/flux) consumers."""
    adt = accum_dtype()
    if len(full_shape) == 3:
        from fava_tpu.ops.spectra import shell_bin_rfft

        counts, sums = shell_bin_rfft((p.astype(adt),), nbins, full_shape[0], full_shape[-1])
        return counts, sums[0]

    # 2D: Hermitian-weighted scatter-add on the half grid.
    ks = _k_grids(full_shape, np.dtype(adt), None, False)
    k_abs = jnp.sqrt(sum(k * k for k in ks))
    weight = jnp.broadcast_to(_hermitian_weights(full_shape, adt), k_abs.shape)
    bidx = jnp.clip(jnp.floor(k_abs + 0.5).astype(jnp.int32), 0, nbins - 1).ravel()
    mask = (k_abs <= (nbins - 0.5)).ravel()
    w_flat = jnp.where(mask, weight.ravel(), 0)
    counts = jnp.zeros(nbins, dtype=adt).at[bidx].add(w_flat)
    sums = jnp.zeros(nbins, dtype=adt).at[bidx].add(p.astype(adt).ravel() * w_flat)
    return counts, sums


def _bin_rfft_power(p: jax.Array, full_shape, nbins: int):
    """Shell-mean of one Hermitian power volume (NaN for empty shells)."""
    counts, sums = _bin_rfft_stats(p, full_shape, nbins)
    return jnp.where(counts > 0, sums / jnp.maximum(counts, 1), jnp.nan)


@lru_cache(maxsize=16)
def _spectrum_fn(shape: Tuple[int, ...], lengths, which: str, nbins: int):
    ntot = int(np.prod(shape))
    adt = accum_dtype()

    def core(*vels):
        vhats = [_rfft3(v) / ntot for v in vels]
        if len(shape) == 2:  # enstrophy only (helicity vanishes in 2D)
            kx, ky = _k_grids(shape, vhats[0].real.dtype, lengths, zero_nyquist=True)
            wz = 1j * (kx * vhats[1] - ky * vhats[0])
            p = (0.5 * jnp.abs(wz) ** 2).astype(adt)
            return _bin_rfft_power(p, shape, nbins)
        whats = _vorticity_hats(vhats, shape, lengths)
        if which == "enstrophy":
            p = (0.5 * sum(jnp.abs(w) ** 2 for w in whats)).astype(adt)
        else:  # helicity: Re(v̂* . ω̂), signed
            p = sum((jnp.conj(v) * w).real for v, w in zip(vhats, whats)).astype(adt)
        return _bin_rfft_power(p, shape, nbins)

    return jax.jit(core)


def _velocity_spectrum(vels, lengths, which: str) -> Dict[str, np.ndarray]:
    shape, key = _check_vels(vels, lengths, f"{which}_spectrum")
    nd = len(shape)
    nbins = max(shape) // 2 - 1

    mean = np.asarray(_spectrum_fn(shape, key, which, nbins)(*vels), dtype=np.float64)
    k = np.arange(nbins, dtype=np.float64)
    integral_factor = k ** (nd - 1) * (2.0 * np.pi * (nd - 1))
    return {"k": k, "power": mean * integral_factor}


def enstrophy_spectrum(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, np.ndarray]:
    """Shell-binned enstrophy spectrum 0.5 |ω̂|² (mean over shells,
    KE-spectra binning convention and integral factor). 2D flows pass
    two components (ω is the scalar out-of-plane vorticity there)."""
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    return _velocity_spectrum(vels, lengths, "enstrophy")


def _dealias_mask(shape: Tuple[int, ...], dtype):
    """2/3-rule truncation mask on the rfft half grid: keep only modes
    with |k_i| < n_i/3 on EVERY axis (host-side trace-time constant)."""
    nd = len(shape)
    keep = None
    for axis, n in enumerate(shape):
        if axis == nd - 1:
            k = np.arange(n // 2 + 1, dtype=np.float64)
        else:
            j = np.arange(n)
            k = np.abs(np.where(j <= (n - 1) // 2, j, j - n)).astype(np.float64)
        m = k < (n / 3.0)
        kshape = [1] * nd
        kshape[axis] = len(k)
        m = m.reshape(kshape)
        keep = m if keep is None else (keep & m)
    return jnp.asarray(keep.astype(dtype))


def dealiased_nbins(shape: Tuple[int, ...]) -> int:
    """Shell count covering EVERY mode the 2/3-rule mask keeps.

    The kept corner modes reach radial |k| = sqrt(sum_i m_i^2) with
    m_i = (n_i - 1) // 3 (the largest integer < n_i/3) — beyond the
    default max(n)//2 - 1 shells, whose cutoff would silently drop
    their transfer and fake a flux sink at high k. Used by
    ``transfer_spectrum(dealias=True)`` so the zero-sum conservation
    identity holds over the BINNED record, not just the full grid.
    """
    kmax = float(np.sqrt(sum(((n - 1) // 3) ** 2 for n in shape)))
    return int(np.floor(kmax + 0.5)) + 1


@lru_cache(maxsize=16)
def _transfer_fn(shape: Tuple[int, ...], lengths, dealias: bool, nbins: int):
    ntot = int(np.prod(shape))
    n_last = shape[-1]
    nd = len(shape)
    adt = accum_dtype()

    def core(*vels):
        raw = [_rfft3(v) for v in vels]  # unnormalized forward
        rdt = raw[0].real.dtype
        if dealias:
            mask = _dealias_mask(shape, rdt)
            raw = [mask * w for w in raw]
            # Products must be formed from the FILTERED fields or the
            # masked triads reappear through aliasing (_irfft3
            # carries the full 1/N, matching the unnormalized forward).
            vels = [_irfft3(w, n_last) for w in raw]
        vhats = [w / ntot for w in raw]
        ks = _k_grids(shape, rdt, lengths, zero_nyquist=True)
        # Conservative (divergence) form: T(k) = -Re(v̂*_i · i k_j Q̂_ij),
        # Q_ij = u_i u_j symmetric — 6 (3D) / 3 (2D) product transforms.
        qhats = {}
        for i in range(nd):
            for j in range(i, nd):
                qhats[(i, j)] = _rfft3(vels[i] * vels[j]) / ntot
        t_density = None
        i_unit = jnp.asarray(1j, dtype=vhats[0].dtype)
        for i in range(nd):
            adv = sum(
                ks[j] * qhats[(min(i, j), max(i, j))] for j in range(nd)
            )
            term = -(jnp.conj(vhats[i]) * (i_unit * adv)).real
            t_density = term if t_density is None else t_density + term
        # Transfer/flux are shell SUMS — means cannot telescope.
        _, sums = _bin_rfft_stats(t_density.astype(adt), shape, nbins)
        flux = -jnp.cumsum(sums)
        return jnp.stack([sums, flux])  # one fetch

    return jax.jit(core)


def transfer_spectrum(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    lengths: Optional[Sequence[float]] = None,
    dealias: bool = False,
) -> Dict[str, np.ndarray]:
    """Spectral kinetic-energy transfer T(k) and flux Π(k).

    T(k) = -Σ_shell Re(v̂*_i · i k_j F[u_i u_j]) — the shell-SUMMED
    (Hermitian-weighted) nonlinear energy transfer in conservative
    (divergence) form, so for a divergence-free field the nonlinear
    term only redistributes energy across the binned shells:
    Σ_k T(k) = 0, exact in discrete spectral arithmetic whenever every
    active mode is both alias-free and inside the binned range — i.e.
    with ``dealias=True`` (any solenoidal field: the shell count is
    extended to cover the kept corner modes, ``dealiased_nbins``), or
    with ``dealias=False`` for fields band-limited below both the
    aliasing threshold and max(n)//2 - 1.5 radial. Π(k) = -Σ_{k'≤k}
    T(k') is the energy flux through wavenumber k (positive = forward
    cascade).

    Unlike the package's power spectra these are shell sums with NO
    k^(d-1) integral factor: transfer must telescope into flux, which a
    shell-mean convention cannot do. ``dealias`` applies the 2/3-rule
    isotropic truncation (|k_i| < n_i/3 per axis) to the velocity field
    before forming products, removing aliased triads at the cost of
    discarding the outer third of resolved modes (3 extra inverse
    transforms). For compressible flows the divergence form is the
    budget of ∂_t(|u|²/2) under ∂_t u_i = -∂_j(u_i u_j); the advective
    and conservative forms differ by dilatation terms (documented, not
    hidden). 2D flows pass two components and ``velz=None``.

    Returns {"k", "transfer", "flux"} (k in integer shell units).
    Beyond the reference (KE spectra only,
    fava/mesh/FLASH/FlashUniform.py:229-304).
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "transfer_spectrum")
    nbins = dealiased_nbins(shape) if dealias else max(shape) // 2 - 1

    stacked = np.asarray(_transfer_fn(shape, key, bool(dealias), nbins)(*vels), dtype=np.float64)
    return {
        "k": np.arange(nbins, dtype=np.float64),
        "transfer": stacked[0],
        "flux": stacked[1],
    }


def helicity_spectrum(
    velx: jax.Array,
    vely: jax.Array,
    velz: jax.Array,
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, np.ndarray]:
    """Shell-binned helicity spectrum Re(v̂* . ω̂) — signed, so shells
    may be negative (helicity is a signed invariant). 3D only: in 2D
    the velocity lies in-plane while ω points out of it, so helicity
    vanishes identically."""
    return _velocity_spectrum((velx, vely, velz), lengths, "helicity")


@lru_cache(maxsize=16)
def _decomp_spectra_fn(shape: Tuple[int, ...], lengths, weighted: bool, nbins: int):
    ntot = int(np.prod(shape))
    nd = len(shape)
    adt = accum_dtype()

    def core(*vols):
        vels = vols[:nd]
        if weighted:
            # Kida-Orszag variable w = sqrt(rho) u: sum |w_hat|^2 / 2
            # is the true kinetic energy, so the decomposed spectra
            # integrate to the compressible KE budget.
            sq = jnp.sqrt(vols[nd])
            vels = [sq * v for v in vels]
        vhats = [_rfft3(v) / ntot for v in vels]
        rdt = vhats[0].real.dtype
        ks = _k_grids(shape, rdt, lengths, zero_nyquist=True)
        k2 = sum(k * k for k in ks)
        div = sum(k * w for k, w in zip(ks, vhats)) / jnp.maximum(
            k2, jnp.asarray(1e-30, rdt)
        )
        comp_hats = [k * div for k in ks]
        # Pointwise-orthogonal split (comp is the k-parallel projection,
        # sol the remainder) => total == solenoidal + compressive shell
        # by shell, EXACTLY; k = 0 and Nyquist land in sol (module
        # docstring).
        p_tot, p_sol, p_comp = None, None, None
        for w, c in zip(vhats, comp_hats):
            s = w - c
            pt = (0.5 * jnp.abs(w) ** 2).astype(adt)
            ps = (0.5 * jnp.abs(s) ** 2).astype(adt)
            pc = (0.5 * jnp.abs(c) ** 2).astype(adt)
            p_tot = pt if p_tot is None else p_tot + pt
            p_sol = ps if p_sol is None else p_sol + ps
            p_comp = pc if p_comp is None else p_comp + pc
        # one stacked (3, nbins) output -> one fetch
        return jnp.stack(
            [
                _bin_rfft_power(p_tot, shape, nbins),
                _bin_rfft_power(p_sol, shape, nbins),
                _bin_rfft_power(p_comp, shape, nbins),
            ]
        )

    return jax.jit(core)


def _hermitian_weights(shape: Tuple[int, ...], adt):
    """Trailing-axis conjugate-pair weights on the rfft half grid
    (1 for the self-conjugate k=0/Nyquist lanes, 2 otherwise)."""
    n_last = shape[-1]
    j = np.arange(n_last // 2 + 1)
    self_conj = j == 0
    if n_last % 2 == 0:
        self_conj = self_conj | (j == n_last // 2)
    w = np.where(self_conj, 1.0, 2.0)
    kshape = [1] * len(shape)
    kshape[-1] = len(j)
    return jnp.asarray(w.astype(adt).reshape(kshape))


def _axis_bin_matrix(shape: Tuple[int, ...], axis: int):
    """(nbins, n_line) 0/1 fold matrix binning the 1D line of plane-summed
    power along ``axis`` by integer |k_axis| (host trace-time constant).
    Covers EVERY mode (bins 0..n//2 inclusive) so sums conserve energy."""
    nd = len(shape)
    n = shape[axis]
    if axis == nd - 1:
        kabs = np.arange(n // 2 + 1)
    else:
        j = np.arange(n)
        kabs = np.abs(np.where(j <= (n - 1) // 2, j, j - n))
    nbins = n // 2 + 1
    mat = np.zeros((nbins, len(kabs)))
    mat[kabs, np.arange(len(kabs))] = 1.0
    return mat, nbins


def _perp_bin_index(shape: Tuple[int, ...], axis: int):
    """Flattened ring-bin index of the plane perpendicular to ``axis``
    (integer-rounded cylindrical radius), plus its bin count. Covers
    EVERY mode so ring sums conserve energy."""
    nd = len(shape)
    perp_axes = [a for a in range(nd) if a != axis]
    grids = []
    for a in perp_axes:
        n = shape[a]
        if a == nd - 1:
            k = np.arange(n // 2 + 1, dtype=np.float64)
        else:
            j = np.arange(n)
            k = np.abs(np.where(j <= (n - 1) // 2, j, j - n)).astype(np.float64)
        grids.append(k)
    if len(grids) == 1:
        r = grids[0]
    else:
        r = np.sqrt(grids[0][:, None] ** 2 + grids[1][None, :] ** 2)
    bidx = np.floor(r + 0.5).astype(np.int32)
    return bidx.ravel(), int(bidx.max()) + 1


@lru_cache(maxsize=16)
def _aniso_spectra_fn(shape: Tuple[int, ...], axis: int):
    ntot = int(np.prod(shape))
    nd = len(shape)
    adt = accum_dtype()
    fold, _ = _axis_bin_matrix(shape, axis)
    fold = jnp.asarray(fold.astype(adt))
    bidx_host, nperp = _perp_bin_index(shape, axis)
    bidx = jnp.asarray(bidx_host)
    perp_axes = tuple(a for a in range(nd) if a != axis)
    hw = _hermitian_weights(shape, adt)

    def one(p):
        # Parallel: plane-sum -> signed-line fold (tiny 0/1 matmul).
        line = jnp.sum(p, axis=perp_axes)
        epar = jnp.matmul(fold, line, precision=jax.lax.Precision.HIGHEST)
        # Perpendicular: axis-sum -> ring scatter on the small plane.
        plane = jnp.sum(p, axis=axis).ravel()
        eperp = jnp.zeros(nperp, dtype=adt).at[bidx].add(plane)
        return epar, eperp

    def core(*vels):
        p_ax, p_tr = None, None
        for i, v in enumerate(vels):
            w = _rfft3(v) / ntot
            q = (0.5 * jnp.abs(w) ** 2).astype(adt) * hw
            if i == axis:
                p_ax = q if p_ax is None else p_ax + q
            else:
                p_tr = q if p_tr is None else p_tr + q
        out_ax = one(p_ax)
        out_tr = one(p_tr)
        # one packed vector (par_ax, perp_ax, par_tr, perp_tr) -> one fetch
        return jnp.concatenate(out_ax + out_tr)

    return jax.jit(core)


def anisotropic_ke_spectra(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    axis: int = 0,
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, np.ndarray]:
    """Axis-resolved (anisotropic) kinetic-energy spectra.

    The standard diagnostic for flows with a preferred direction —
    Rayleigh-Taylor flames propagate along x (the reference's flame
    window marches that axis, fava/pipeline.py stage 1), so isotropic
    shell spectra mix the buoyancy-driven axial motions with the
    transverse turbulence they feed. This bins the spectral KE two
    ways relative to ``axis``:

    * **parallel** ``E(k_par)``: summed over each perpendicular plane,
      binned by integer |k_axis| (bins 0..n/2 inclusive);
    * **perpendicular** ``E(k_perp)``: summed along the axis, binned by
      the integer-rounded cylindrical radius of the perpendicular
      wavenumbers.

    Each is further split by velocity COMPONENT into ``axial`` (the
    ``axis`` component — the RT "longitudinal" motions) and
    ``transverse`` (the others), with ``total = axial + transverse``.
    Unlike the package's isotropic shell spectra (means times a shell
    integral factor) these are exact SUMS over every Hermitian mode:
    ``sum(par_total) == sum(perp_total) == 0.5*mean(|u|^2)`` to float
    accuracy (Parseval), so anisotropy ratios are energy-exact. Bins
    are grid-integer wavenumbers, as everywhere in the package;
    ``lengths`` is accepted for API symmetry (binning is geometric).
    2D flows pass two components (the perpendicular record is the
    single remaining axis). Beyond the reference (isotropic KE spectra
    only, fava/mesh/FLASH/FlashUniform.py:229-304).

    Returns {"k_par", "par_total", "par_axial", "par_transverse",
    "k_perp", "perp_total", "perp_axial", "perp_transverse"}.
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, _ = _check_vels(vels, lengths, "anisotropic_ke_spectra")
    nd = len(shape)
    if not 0 <= axis < nd:
        raise ValueError(f"axis must be in [0, {nd}), got {axis}")
    packed = np.asarray(_aniso_spectra_fn(shape, axis)(*vels), dtype=np.float64)
    npar = shape[axis] // 2 + 1
    nperp = (len(packed) - 2 * npar) // 2
    par_ax = packed[:npar]
    perp_ax = packed[npar : npar + nperp]
    par_tr = packed[npar + nperp : 2 * npar + nperp]
    perp_tr = packed[2 * npar + nperp :]
    return {
        "k_par": np.arange(len(par_ax), dtype=np.float64),
        "par_total": par_ax + par_tr,
        "par_axial": par_ax,
        "par_transverse": par_tr,
        "k_perp": np.arange(len(perp_ax), dtype=np.float64),
        "perp_total": perp_ax + perp_tr,
        "perp_axial": perp_ax,
        "perp_transverse": perp_tr,
    }


def decomposed_ke_spectra(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    dens: Optional[jax.Array] = None,
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, np.ndarray]:
    """Solenoidal/compressive decomposition of the KE spectrum.

    The Helmholtz projection applied IN SPECTRAL SPACE (no inverse
    transforms): each velocity transform is split into its k-parallel
    (compressive) and k-perpendicular (solenoidal) parts and the three
    power spectra are shell-binned with the package's KE-spectra
    conventions (shell means, k^(d-1) * 2*pi*(d-1) integral factor).
    The split is pointwise orthogonal, so
    ``total == solenoidal + compressive`` holds shell by shell exactly
    — the standard compressible-turbulence diagnostic for the
    compressive-mode fraction. With ``dens`` the Kida-Orszag variable
    w = sqrt(rho) u is transformed instead, making the spectra a true
    decomposition of the compressible kinetic-energy budget. The k = 0
    and Nyquist modes land in the solenoidal part, matching
    :func:`helmholtz_decompose` (so binning the spectra of ITS output
    fields gives the same record). 2D flows pass two components.
    Returns {"k", "total", "solenoidal", "compressive"}. Beyond the
    reference (KE spectra only, fava/mesh/FLASH/FlashUniform.py:229-304).
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "decomposed_ke_spectra")
    if dens is not None and tuple(int(s) for s in dens.shape) != shape:
        raise ValueError(
            f"dens shape {tuple(dens.shape)} does not match velocity shape {shape}"
        )
    nd = len(shape)
    nbins = max(shape) // 2 - 1

    args = list(vels) + ([dens] if dens is not None else [])
    stacked = np.asarray(
        _decomp_spectra_fn(shape, key, dens is not None, nbins)(*args), dtype=np.float64
    )  # (3, nbins), one fetch
    k = np.arange(nbins, dtype=np.float64)
    f = k ** (nd - 1) * (2.0 * np.pi * (nd - 1))
    return {
        "k": k,
        "total": stacked[0] * f,
        "solenoidal": stacked[1] * f,
        "compressive": stacked[2] * f,
    }


@lru_cache(maxsize=16)
def _turbulence_summary_fn(shape: Tuple[int, ...], lengths, has_dens: bool, has_pres: bool):
    ntot = int(np.prod(shape))
    nd = len(shape)
    adt = accum_dtype()
    # Static output order: the jit returns ONE stacked vector so the
    # caller pays one host fetch, not one per scalar.
    names = ["u_rms", "kinetic_energy"]
    if has_dens:
        names += ["kinetic_energy_density", "mean_s", "sigma_s"]
    if has_pres:
        names += ["mach_rms", "mach_max", "sound_speed_mean"]
    names += [
        "integral_scale",
        "taylor_scale",
        "compressive_fraction",
        "solenoidal_fraction",
        "dilatation_rms",
        "vorticity_rms",
    ]

    def core(*vols):
        vels = vols[:nd]
        i = nd
        dens = vols[i] if has_dens else None
        if has_dens:
            i += 1
        pres = vols[i] if has_pres else None
        gamma = vols[i + 1] if has_pres else None

        out = {}
        u2 = sum(v.astype(adt) ** 2 for v in vels)
        out["u_rms"] = jnp.sqrt(jnp.mean(u2))
        out["kinetic_energy"] = 0.5 * jnp.mean(u2)
        if has_dens:
            da = dens.astype(adt)
            out["kinetic_energy_density"] = 0.5 * jnp.mean(da * u2)
            # log-density contrast moments (the lognormality variable;
            # full diagnostics incl. the s-PDF live in ops/volume.density_pdf)
            s = jnp.log(da / jnp.mean(da))
            mu_s = jnp.mean(s)
            out["mean_s"] = mu_s
            out["sigma_s"] = jnp.sqrt(jnp.mean((s - mu_s) ** 2))
        if has_pres:
            cs2 = gamma.astype(adt) * pres.astype(adt) / dens.astype(adt)
            m2 = u2 / cs2
            out["mach_rms"] = jnp.sqrt(jnp.mean(m2))
            out["mach_max"] = jnp.sqrt(jnp.max(m2))
            out["sound_speed_mean"] = jnp.mean(jnp.sqrt(cs2))

        # Spectral moments: one forward-transform set, Hermitian sums.
        vhats = [_rfft3(v) / ntot for v in vels]
        rdt = vhats[0].real.dtype
        hw = _hermitian_weights(shape, adt)
        ks = _k_grids(shape, rdt, lengths, zero_nyquist=True)
        k2 = sum(k * k for k in ks)
        kmag = jnp.sqrt(k2)
        e_mode = sum((0.5 * jnp.abs(w) ** 2).astype(adt) for w in vhats) * hw
        e_sum = jnp.sum(e_mode)
        # Moments exclude the k = 0 (mean-flow) mode: it carries no
        # turbulent scale information and 1/k diverges there.
        inv_k = jnp.where(kmag > 0, 1.0 / jnp.maximum(kmag, 1e-30), 0.0).astype(adt)
        mean_e = e_mode.reshape(-1)[0]  # k = (0,...,0) is the corner mode
        e_fluct = e_sum - mean_e
        m_inv = jnp.sum(e_mode * inv_k)  # k=0 already zeroed by inv_k
        m_2 = jnp.sum(e_mode * k2.astype(adt))
        # Standard isotropic-turbulence definitions on the 3D energy
        # spectrum: L = (3*pi/4) * int E/k dk / int E dk,
        # lambda^2 = 5 * int E dk / int k^2 E dk.
        out["integral_scale"] = (
            (3.0 * np.pi / 4.0 if nd == 3 else np.pi / 2.0)
            * m_inv / jnp.maximum(e_fluct, 1e-30)
        )
        out["taylor_scale"] = jnp.sqrt(
            (5.0 if nd == 3 else 2.0) * e_fluct / jnp.maximum(m_2, 1e-30)
        )

        # Exact Helmholtz energy split (k = 0 / Nyquist -> solenoidal).
        div_amp2 = (
            jnp.abs(sum(k * w for k, w in zip(ks, vhats))) ** 2
        ).astype(adt) / jnp.maximum(k2.astype(adt), 1e-30)
        comp_e = jnp.sum(0.5 * div_amp2 * hw)
        out["compressive_fraction"] = comp_e / jnp.maximum(e_sum, 1e-30)
        out["solenoidal_fraction"] = 1.0 - out["compressive_fraction"]

        # Enstrophy / dilatation rms by Parseval (same Nyquist-zeroed
        # derivative convention as the vorticity/dilatation fields).
        out["dilatation_rms"] = jnp.sqrt(jnp.sum(div_amp2 * k2.astype(adt) * hw))
        if nd == 3:
            whats = _vorticity_hats(vhats, shape, lengths)
            ens = sum((jnp.abs(w) ** 2).astype(adt) for w in whats) * hw
        else:
            kx, ky = ks
            ci = jnp.asarray(1j, dtype=vhats[0].dtype)
            wz = ci * (kx * vhats[1] - ky * vhats[0])
            ens = (jnp.abs(wz) ** 2).astype(adt) * hw
        out["vorticity_rms"] = jnp.sqrt(jnp.sum(ens))
        return jnp.stack([out[k].astype(adt) for k in names])

    return jax.jit(core), tuple(names)


def turbulence_summary(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    dens: Optional[jax.Array] = None,
    pres: Optional[jax.Array] = None,
    gamma=5.0 / 3.0,
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, float]:
    """One-call scalar turbulence report (single jit dispatch).

    Real-space statistics (``u_rms``, specific ``kinetic_energy``, and
    with ``dens`` the ``kinetic_energy_density`` 0.5<rho u^2>; with
    ``pres`` + ``dens`` the per-cell Mach statistics ``mach_rms``/
    ``mach_max``/``sound_speed_mean`` with c_s = sqrt(gamma p / rho),
    ``gamma`` a scalar or a per-cell field like FLASH's gamc) plus the
    spectral-moment scales computed from the same forward transforms:

    * ``integral_scale``   L = (3 pi/4) * sum E/|k| / sum E  (3D;
      pi/2 factor in 2D) — physical |k| when ``lengths`` is given, so
      anisotropic boxes need no cubic assumption;
    * ``taylor_scale``     lambda = sqrt(5 * sum E / sum k^2 E) (3D;
      factor 2 in 2D);
    * ``solenoidal_fraction`` / ``compressive_fraction`` — the exact
      Hermitian-sum Helmholtz energy split (k = 0 and Nyquist modes
      count as solenoidal, matching :func:`helmholtz_decompose`);
    * ``vorticity_rms`` / ``dilatation_rms`` — Parseval of the spectral
      curl/divergence (Nyquist-zeroed derivative convention).

    Scale moments exclude the k = 0 mean-flow mode. Everything is one
    compiled program over the three forward transforms — the
    summary costs barely more than one KE spectrum. Beyond the
    reference (no summary analysis exists;
    fava/mesh/FLASH/FlashUniform.py stops at spectra)."""
    vec, names = turbulence_summary_device(
        velx, vely, velz, dens=dens, pres=pres, gamma=gamma, lengths=lengths
    )
    vals = np.asarray(vec, dtype=np.float64)  # ONE packed fetch
    return dict(zip(names, vals.tolist()))


def turbulence_summary_device(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    dens: Optional[jax.Array] = None,
    pres: Optional[jax.Array] = None,
    gamma=5.0 / 3.0,
    lengths: Optional[Sequence[float]] = None,
) -> Tuple[jax.Array, Tuple[str, ...]]:
    """:func:`turbulence_summary` without the host fetch: returns the
    DEVICE-resident packed stat vector plus its name order. Series
    drivers stack many of these and fetch once — per-snapshot fetches
    each pay a host round trip, while jit dispatch is async so the
    device pipeline stays busy."""
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "turbulence_summary")
    if pres is not None and dens is None:
        raise ValueError("mach statistics need BOTH pres and dens")
    for name, f in (("dens", dens), ("pres", pres)):
        if f is not None and tuple(int(s) for s in f.shape) != shape:
            raise ValueError(f"{name} shape {tuple(f.shape)} does not match velocity shape {shape}")
    args = list(vels)
    if dens is not None:
        args.append(dens)
    if pres is not None:
        g = jnp.asarray(gamma, dtype=vels[0].dtype)
        # a scalar gamma stays 0-d (the jitted elementwise math
        # broadcasts it for free — materializing an n^3 constant costs
        # device memory and a dispatch); a per-cell field must match the volumes
        if g.ndim != 0 and tuple(int(s) for s in g.shape) != shape:
            raise ValueError(
                f"gamma shape {tuple(g.shape)} does not match velocity shape {shape}"
            )
        args += [pres, g]
    fn, names = _turbulence_summary_fn(shape, key, dens is not None, pres is not None)
    return fn(*args), names
