"""Line-of-sight projections (column-density-style maps).

P(y, z) = integral f dl along ``axis`` — the standard column map of
FLASH post-processing (column density for f = dens). Exact on the AMR
tree WITHOUT regridding: the line integral of a piecewise-constant
field is a per-cell sum of f * dx_level, so each refinement level is
scatter-added into a map at its own resolution (blocks tile exactly at
their level — integer BCID origins from ops/regrid.RegridPlan) and
then upsampled to the finest grid by replication, which is exact for
a piecewise-constant integrand. One gather + one scatter + one repeat
per level, all device-side; no full uniform volume is materialized
(the from_amr route would need the fine-grid cube in device memory first).

Weighted projections P = integral w f dl / integral w dl project the
numerator and denominator separately — both are linear along the line
of sight, so per-level contributions add exactly.

Beyond the reference (no projection analysis exists; its only
map-like product is the uniform regrid itself, _flash.py:955-1377).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.utils import accum_dtype


@lru_cache(maxsize=16)
def _project_uniform_fn(axis: int, dx: float):
    adt = accum_dtype()

    @jax.jit
    def core(v, w):
        if w is None:
            return jnp.sum(v.astype(adt), axis=axis) * dx
        wa = w.astype(adt)
        num = jnp.sum(v.astype(adt) * wa, axis=axis)
        den = jnp.sum(wa, axis=axis)
        return num / jnp.where(den != 0, den, 1.0)

    return core


def project_uniform(
    vol: jax.Array,
    deltas: Sequence[float],
    axis: int = 0,
    weight: Optional[jax.Array] = None,
) -> np.ndarray:
    """Projection of one uniform volume: integral f dl (or the
    w-weighted line average when ``weight`` is given). 2D volumes
    project to 1D column profiles."""
    nd = vol.ndim
    if nd not in (2, 3):
        raise ValueError(f"projection requires a 2D or 3D volume, got {nd}D")
    if not 0 <= axis < nd:
        raise ValueError(f"axis must be in [0, {nd}), got {axis}")
    return np.asarray(_project_uniform_fn(int(axis), float(deltas[axis]))(vol, weight))


def project_amr(
    plan,
    stacks: Dict[str, jax.Array],
    axis: int = 0,
    weight: Optional[jax.Array] = None,
) -> Tuple[Dict[str, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Exact per-level AMR projection along ``axis``.

    ``plan`` is an ops/regrid.RegridPlan at full depth (it provides the
    integer fine-grid block origins and per-block scales); ``stacks``
    maps field name -> FULL block stack (nB, ncx, ncy, ncz). Returns
    ({field: (n1, n2) map}, (coords1, coords2)) over the two kept axes.
    With ``weight`` (a full block stack of the weight field — it may
    also appear in ``stacks``, e.g. density-weighted density), maps are
    the w-weighted line averages integral(w f dl) / integral(w dl).
    """
    if plan.ndim != 3:
        raise ValueError(f"projection requires a 3D AMR tree, got {plan.ndim}D")
    if not 0 <= axis < 3:
        raise ValueError(f"axis must be in [0, 3), got {axis}")
    if plan.subdomain_flag:
        raise ValueError("projection does not support subdomain crops; project the full domain")

    keep = tuple(a for a in range(3) if a != axis)
    out_cells = tuple(int(plan.total_cells[a]) for a in keep)
    nc = tuple(int(plan.ncells_vec[a]) for a in keep)
    dx_fine = float(plan.grid_delta[axis])
    adt = accum_dtype()

    ids = plan.source_ids
    scales = plan.block_scales[ids]
    offsets = plan.block_offsets[ids]

    def level_project(sel, idx_flat, s, nb, pq_shape):
        # integrand: f * dx at this level, summed along the LOS
        plane = jnp.sum(sel.astype(adt), axis=1 + axis) * (dx_fine * s)
        level = jnp.zeros(pq_shape[0] * pq_shape[1], dtype=adt)
        level = level.at[idx_flat].add(plane.reshape(nb, -1).ravel())
        level = level.reshape(pq_shape)
        # piecewise-constant upsample to the finest grid (exact)
        return jnp.repeat(jnp.repeat(level, s, axis=0), s, axis=1)

    # Numerator maps per requested field (integral f dl, or
    # integral w*f dl when weighted — including field == weight, the
    # standard density-weighted density / clumping map) plus one
    # denominator map (integral w dl), accumulated separately.
    maps: Dict[str, jnp.ndarray] = {}
    den = None
    for s in sorted(set(int(v) for v in scales)):
        sel_np = np.nonzero(scales == s)[0]
        sel_ids = jnp.asarray(ids[sel_np])
        nb = sel_np.size
        P, Q = out_cells[0] // s, out_cells[1] // s
        o1 = offsets[sel_np, keep[0]] // s
        o2 = offsets[sel_np, keep[1]] // s
        i1 = o1[:, None, None] + np.arange(nc[0])[None, :, None]
        i2 = o2[:, None, None] + np.arange(nc[1])[None, None, :]
        idx_flat = jnp.asarray((i1 * Q + i2).reshape(nb, -1).ravel())
        w_sel = None
        if weight is not None:
            w_sel = jnp.take(weight, sel_ids, axis=0)
            contrib = level_project(w_sel, idx_flat, s, nb, (P, Q))
            den = contrib if den is None else den + contrib
        for name in stacks:
            sel = jnp.take(stacks[name], sel_ids, axis=0)
            if w_sel is not None:
                sel = sel * w_sel
            contrib = level_project(sel, idx_flat, s, nb, (P, Q))
            maps[name] = maps.get(name, 0) + contrib

    out: Dict[str, np.ndarray] = {}
    if weight is not None:
        den_safe = jnp.where(den != 0, den, 1.0)
        for name, m in maps.items():
            out[name] = np.asarray(m / den_safe)
    else:
        out = {name: np.asarray(m) for name, m in maps.items()}

    coords = tuple(
        (np.arange(out_cells[k]) + 0.5) * float(plan.grid_delta[a])
        + float(plan.domain_box[a, 0])
        for k, a in enumerate(keep)
    )
    return out, coords
