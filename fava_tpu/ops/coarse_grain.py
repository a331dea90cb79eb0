"""Coarse-grained (filtered) kinetic-energy flux: the Favre scale
decomposition of compressible turbulence.

Beyond the reference (which stops at shell spectra,
fava/mesh/FLASH/FlashUniform.py:229-304): the subgrid-scale (SGS)
energy flux Pi_l — "how much kinetic energy crosses filter scale l,
pointwise" — is the physical-space companion of the spectral transfer
T(k) (ops/velocity.py) and the centerpiece of the Favre-filtered
compressible cascade analyses (Aluie-style scale decomposition).
FAVA's whole domain is Favre (density-weighted) statistics; this is
their filtered-equation counterpart.

Definitions (Favre filtering, 2D or 3D periodic boxes):

* ``bar(f)``      = low-pass filter of f at cutoff k_c (spectral
  multiplication by the kernel G, below),
* ``rho_b``       = bar(rho),
* ``u~_i``        = bar(rho u_i) / rho_b          (Favre velocity),
* ``rho_b tau_ij``= bar(rho u_i u_j) - rho_b u~_i u~_j
  (density-weighted SGS stress),
* deformation work (SGS kinetic-energy flux):
  ``Pi_l(x) = - rho_b tau_ij  d_j u~_i``  (sum over i, j),
* baropycnal work (only when a pressure field is given):
  ``Lambda_l(x) = (1 / rho_b) d_j bar(p) [ bar(rho u_j) - rho_b bar(u_j) ]``.

Positive mean Pi_l = forward cascade (energy leaving scales > l).
With ``dens=None`` the constant-density (incompressible) limit is
used: rho == 1, u~ == bar(u), tau_ij = bar(u_i u_j) - bar(u_i) bar(u_j).
For a sharp filter on a divergence-free field the volume mean obeys
the exact discrete identity  <Pi_l> = flux(k_c)  against
``ops.velocity.transfer_spectrum`` (tested).

Device mapping: everything is forward/inverse FFTs plus fused
elementwise algebra — the forward transforms
of rho, rho*u_i, rho*u_i*u_j (and p, u_j) are computed ONCE and the
per-scale work (kernel multiply + ~28 inverse transforms + products)
runs under one ``lax.scan`` over the cutoff list, so an N-scale sweep
is one jit dispatch.

Conventions shared with ops/velocity.py: cutoffs are in INTEGER
wavenumber units (grid-mode index, the package-wide spectra unit);
``lengths`` scales only the physical derivative operators (2*pi/L_i);
derivatives zero the un-pairable Nyquist mode of even axes; filters do
not (they are even operators).

Kernels:

* ``"sharp"``    : G = 1 for |k| <= k_c, else 0 (Galerkin projector).
* ``"gaussian"`` : G = exp(-pi^2 |k|^2 / (24 k_c^2)) — the standard
  second-moment-normalized Gaussian of width l = pi / k_c
  (G = exp(-k^2 l^2 / 24)); attenuation at |k| = k_c is ~0.66.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.ops.velocity import _check_vels, _irfft3, _k_grids, _rfft3
from fava_tpu.utils import accum_dtype

_KERNELS = ("sharp", "gaussian")


def _k2_int(shape: Tuple[int, ...], dtype):
    """|k|^2 on the rfft half grid in INTEGER wavenumber units (no
    Nyquist zeroing: the filter is an even operator)."""
    ks = _k_grids(shape, dtype, None, zero_nyquist=False)
    return sum(k * k for k in ks)


def _filter_gain(k2, kc, kernel: str):
    """Kernel transfer function G(|k|; k_c) from the traced cutoff
    scalar (so a cutoff SWEEP is one compiled scan, not N traces)."""
    if kernel == "sharp":
        return (k2 <= kc * kc).astype(k2.dtype)
    # gaussian, width l = pi / k_c
    return jnp.exp(-(np.pi**2) * k2 / (24.0 * kc * kc))


@lru_cache(maxsize=16)
def _flux_fn(
    shape: Tuple[int, ...],
    lengths,
    kernel: str,
    compressible: bool,
    with_pres: bool,
    fields: bool,
):
    nd = len(shape)
    n_last = shape[-1]
    adt = accum_dtype()

    def core(kcs, *vols):
        vols = list(vols)
        vels = vols[:nd]
        dens = vols[nd] if compressible else None
        pres = vols[-1] if with_pres else None

        rho = dens if compressible else None

        # Forward transforms, ONCE (unnormalized; _irfft3 carries
        # the full 1/N so bar() round-trips exactly under G == 1).
        if compressible:
            f_rho = _rfft3(rho)
            f_mom = [_rfft3(rho * v) for v in vels]
            f_qq = {
                (i, j): _rfft3(rho * vels[i] * vels[j])
                for i in range(nd)
                for j in range(i, nd)
            }
        else:
            f_rho = None
            f_mom = [_rfft3(v) for v in vels]
            f_qq = {
                (i, j): _rfft3(vels[i] * vels[j])
                for i in range(nd)
                for j in range(i, nd)
            }
        if with_pres:
            f_p = _rfft3(pres)
            f_u = [_rfft3(v) for v in vels]

        k2 = _k2_int(shape, f_mom[0].real.dtype)
        dks = _k_grids(shape, f_mom[0].real.dtype, lengths, zero_nyquist=True)
        i_unit = jnp.asarray(1j, dtype=f_mom[0].dtype)

        def one_scale(_, kc):
            g = _filter_gain(k2, kc.astype(k2.dtype), kernel)

            def bar(spec):
                return _irfft3(g * spec, n_last)

            mb = [bar(s) for s in f_mom]  # bar(rho u_i) (or bar(u_i))
            if compressible:
                rb = bar(f_rho)
                ub = [m / rb for m in mb]  # Favre velocity u~_i
                drb = [bar(i_unit * dks[j] * f_rho) for j in range(nd)]
            else:
                ub = mb
            tb = {ij: bar(s) for ij, s in f_qq.items()}

            pi = None
            for i in range(nd):
                for j in range(nd):
                    ii, jj = min(i, j), max(i, j)
                    if compressible:
                        # d_j u~_i from already-filtered transforms:
                        # (d_j bar(rho u_i) - u~_i d_j bar(rho)) / rho_b
                        dmij = bar(i_unit * dks[j] * f_mom[i])
                        duij = (dmij - ub[i] * drb[j]) / rb
                        tau = tb[(ii, jj)] - rb * ub[i] * ub[j]
                    else:
                        duij = bar(i_unit * dks[j] * f_mom[i])
                        tau = tb[(ii, jj)] - ub[i] * ub[j]
                    term = -(tau * duij)
                    pi = term if pi is None else pi + term

            outs = {}
            if with_pres:
                lam = None
                for j in range(nd):
                    dpj = bar(i_unit * dks[j] * f_p)
                    # tau(rho, u_j) = bar(rho u_j) - rho_b bar(u_j)
                    t_ru = mb[j] - rb * bar(f_u[j])
                    t = dpj * t_ru / rb
                    lam = t if lam is None else lam + t
                if fields:
                    outs["baropycnal"] = lam
                else:
                    la = lam.astype(adt)
                    outs["baropycnal_mean"] = jnp.mean(la)
                    outs["baropycnal_rms"] = jnp.sqrt(jnp.mean(la * la))
            if fields:
                outs["pi"] = pi
            else:
                pa = pi.astype(adt)
                outs["pi_mean"] = jnp.mean(pa)
                outs["pi_rms"] = jnp.sqrt(jnp.mean(pa * pa))
            return None, outs

        _, stacked = jax.lax.scan(one_scale, None, kcs)
        if fields:
            return stacked
        # one packed (nstat, ncut) output -> one host fetch; the
        # caller unpacks by the SAME module-level order (fail loudly
        # if a stat is added to one side only)
        order = _flux_stat_names(with_pres)
        assert set(order) == set(stacked), (order, sorted(stacked))
        return jnp.stack([stacked[k] for k in order])

    return jax.jit(core)


def _flux_stat_names(with_pres: bool):
    """Packed row order shared by _flux_fn and filtered_ke_flux."""
    names = ("pi_mean", "pi_rms")
    if with_pres:
        names = ("baropycnal_mean", "baropycnal_rms") + names
    return names


def _prep(vels, dens, pres, cutoffs, kernel, lengths, what, fields=False):
    shape, key = _check_vels(vels, lengths, what)
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {_KERNELS}, got {kernel!r}")
    kcs = np.asarray(cutoffs, dtype=np.float64)
    if kcs.ndim != 1 or kcs.size == 0 or not np.all(kcs > 0):
        raise ValueError("cutoffs must be a non-empty 1D sequence of positive wavenumbers")
    compressible = dens is not None
    if pres is not None and not compressible:
        raise ValueError(
            "baropycnal work needs a density field: pass dens alongside pres "
            "(it vanishes identically at constant density)"
        )
    for name, f in (("dens", dens), ("pres", pres)):
        # broadcast-compatible mismatches (e.g. an unsqueezed (n, n, 1)
        # dens with (n, n) velocities) would silently corrupt Pi_l
        if f is not None and tuple(int(s) for s in f.shape) != shape:
            raise ValueError(
                f"{what}: {name} shape {tuple(f.shape)} does not match "
                f"velocity shape {shape}"
            )
    args = list(vels) + ([dens] if compressible else [])
    if pres is not None:
        args.append(pres)
    fn = _flux_fn(shape, key, kernel, compressible, pres is not None, fields)
    return fn, jnp.asarray(kcs, dtype=vels[0].dtype), args


def filtered_ke_flux(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    *,
    dens: Optional[jax.Array] = None,
    pres: Optional[jax.Array] = None,
    cutoffs: Sequence[float] = (4.0, 8.0, 16.0),
    kernel: str = "gaussian",
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, np.ndarray]:
    """Mean/RMS SGS kinetic-energy flux across a sweep of filter scales.

    Returns ``{"kc", "scale", "pi_mean", "pi_rms"}`` (+
    ``baropycnal_mean``/``baropycnal_rms`` when ``pres`` is given),
    one entry per cutoff; ``scale`` = pi / k_c is the nominal filter
    width in box-fraction units. ``dens=None`` selects the
    constant-density limit. The whole sweep is ONE device dispatch
    (lax.scan over cutoffs; forward transforms hoisted out). See the
    module docstring for definitions and conventions.
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    fn, kcs, args = _prep(vels, dens, pres, cutoffs, kernel, lengths, "filtered_ke_flux")
    packed = np.asarray(fn(kcs, *args), dtype=np.float64)  # (nstat, ncut), one fetch
    names = _flux_stat_names(pres is not None)
    assert packed.shape[0] == len(names), (packed.shape, names)
    res = {
        "kc": np.asarray(kcs, dtype=np.float64),
        "scale": np.pi / np.asarray(kcs, dtype=np.float64),
    }
    res.update(dict(zip(names, packed)))
    return res


def sgs_flux_fields(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    *,
    cutoff: float,
    dens: Optional[jax.Array] = None,
    pres: Optional[jax.Array] = None,
    kernel: str = "gaussian",
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, jax.Array]:
    """Pointwise SGS flux field(s) at ONE filter scale.

    Returns ``{"pi": volume}`` (+ ``"baropycnal"`` when ``pres`` is
    given) as device arrays — the inputs to intermittency statistics
    (PDFs of local flux, conditional averages). Same definitions as
    :func:`filtered_ke_flux`; the scan has length 1 so the leading
    axis is squeezed.
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    fn, kcs, args = _prep(
        vels, dens, pres, (float(cutoff),), kernel, lengths, "sgs_flux_fields", fields=True
    )
    out = fn(kcs, *args)
    return {k: v[0] for k, v in out.items()}
