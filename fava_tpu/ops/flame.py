"""Flame-window centroid fit.

Super-Gaussian fit of the transverse Reynolds-stress profile, locating
the flame centroid (reference: fava/mesh/FLASH/_flash.py:1613-1659).
The fit itself is a tiny 1D Levenberg-Marquardt problem, so it stays on
host via scipy — the heavy work (the stress profiles) happens on device
upstream.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import scipy.optimize

XFACT = 1.0e5  # cm -> km scaling used by the reference fit


def super_gaussian(x, amp, x0, sigma):
    return amp * np.exp(-2.0 * ((x - x0) / sigma) ** 10)


def flame_window(
    radius: np.ndarray,
    stress: Dict[str, np.ndarray],
    mask: Optional[np.ndarray] = None,
) -> float:
    """Flame centroid position from a super-Gaussian fit of Ryy + Rzz."""
    ma = mask if mask is not None else np.where(radius < np.inf)[0]
    rd = radius[ma]
    rs = {key: np.asarray(arr)[ma] for key, arr in stress.items()}

    rspan = rd / XFACT
    rmin = np.min(rspan)

    rsyyzz = rs["Ryy"] + rs["Rzz"]
    rfact = 10.0 ** np.max(np.floor(np.log10(np.maximum(rsyyzz, 1e-300))))
    rsyyzz = rsyyzz / rfact

    opt, _ = scipy.optimize.curve_fit(
        super_gaussian,
        rspan - rmin,
        rsyyzz,
        method="lm",
        p0=(np.max(rsyyzz), rspan[np.argmax(rsyyzz)], np.std(rsyyzz)),
    )
    return float(opt[1] * XFACT)


@lru_cache(maxsize=16)
def _flame_core(deltas, axis: int, nd: int):
    """Jitted gradient-magnitude reductions (cached per geometry).

    Cell counts live in the traced shapes; the physical constants
    (cell volume, plane count) are derived in-trace from the operand
    shape so one cache entry serves one (deltas, axis, nd) geometry.
    """
    import jax
    import jax.numpy as jnp

    plane_axes = tuple(a for a in range(nd) if a != axis)
    cell_vol = float(np.prod(deltas))

    @jax.jit
    def core(vol):
        plane_count = float(np.prod([vol.shape[a] for a in plane_axes]))
        grads = jnp.gradient(vol, *deltas)
        mag = jnp.sqrt(sum(g * g for g in grads))
        sigma = jnp.mean(mag, axis=plane_axes)
        # Hierarchical f32 sum (plane means, then the axis): a flat
        # n^3 accumulation biases ~4e-4 at 128^3 in f32; two levels
        # cut the sequential depth to n^2 (~1e-6 measured).
        total = jnp.sum(sigma) * (cell_vol * plane_count)
        # one packed vector -> one host fetch
        return jnp.concatenate([total.reshape(1), jnp.max(mag).reshape(1), sigma])

    return core


def flame_surface(
    c,
    deltas,
    axis: int = 0,
):
    """Flame surface density diagnostics of a progress variable.

    Coarea-formula surface measure (device, one jit): for c in [0, 1],
    ``integral |grad c| dV = integral_0^1 A(c*) dc*`` — the isolevel-
    averaged flame surface area, the standard resolved surface measure
    of flame-capturing simulations (no marching cubes; exactly what
    flame-surface-density models transport). Gradients are central
    differences with one-sided edges (np.gradient convention — the
    flame axis is NOT periodic in an RT column, so spectral derivatives
    would ring at the front). Beyond the reference, which probes the
    front only through the fractal dimension of one isosurface
    (fava/mesh/FLASH/FlashUniform.py:306-378) and the flame-window fit
    above; this measures the whole front. Returns:

    * ``area``       — integral |grad c| dV (isolevel-mean front area);
    * ``wrinkling``  — area / planar cross-section (the wrinkling
      factor Xi >= 1 of an axis-normal front spanning the box);
    * ``x``, ``sigma`` — slab-resolved surface density profile along
      ``axis``: plane means of |grad c| (surface area per unit volume),
      at cell-center coordinates;
    * ``max_gradient``, ``thickness`` — peak |grad c| and the gradient
      flame thickness 1 / max|grad c| of a unit progress variable.
    """
    shape = tuple(int(s) for s in c.shape)
    nd = len(shape)
    if nd not in (2, 3):
        raise ValueError(f"flame_surface requires a 2D or 3D volume, got {nd}D")
    if len(deltas) != nd:
        raise ValueError(f"deltas must have {nd} entries, got {len(deltas)}")
    if not 0 <= axis < nd:
        raise ValueError(f"axis must be in [0, {nd}), got {axis}")
    deltas = tuple(float(d) for d in deltas)
    # Cross-section of an unwrinkled axis-normal front spanning the box.
    planar = float(
        np.prod([deltas[a] * shape[a] for a in range(nd) if a != axis])
    )
    packed = np.asarray(_flame_core(deltas, int(axis), nd)(c), dtype=np.float64)
    total, gmax = float(packed[0]), float(packed[1])
    sigma = packed[2:]
    x = (np.arange(shape[axis], dtype=np.float64) + 0.5) * deltas[axis]
    return {
        "area": total,
        "wrinkling": total / planar,
        "x": x,
        "sigma": np.asarray(sigma, dtype=np.float64),
        "max_gradient": gmax,
        "thickness": (1.0 / gmax) if gmax > 0 else np.inf,
    }
