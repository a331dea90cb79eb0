"""Fractal (box-counting) dimension of a contour surface.

JAX redesign of the reference implementation
(reference: fava/mesh/FLASH/FlashUniform.py:85-227). The reference's
per-cell edge-detect loop marks cell (i,j,k) when val < contour and any
of its six neighbors exceeds the contour: its branch
``int(hidx / (nbr - val)) == 0`` is always true for val < contour < nbr
(the ratio lies in (0,1), truncating to 0), so the "mark neighbor"
branch is dead code — here the detection is the equivalent vectorized
shift-compare, restricted to the interior exactly like the loops.
Box counts at dyadic levels become reshaped any-reductions; the
mean-log2-ratio dimension and regression statistics use the identical
formulas (FlashUniform.py:211-226).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Union

import jax
import jax.numpy as jnp
import numpy as np


def _edge_detect_impl(data: jax.Array, contour: jax.Array) -> jax.Array:
    """int8 mask of contour-surface cells (6-neighbor threshold crossings)."""
    edata = (data == contour).astype(jnp.int8)

    h, w, d = data.shape
    below = data < contour

    interior = jnp.zeros_like(below)
    if d > 1:
        interior = interior.at[1 : h - 1, 1 : w - 1, 1 : d - 1].set(True)
    else:
        interior = interior.at[1 : h - 1, 1 : w - 1, :].set(True)

    crossing = jnp.zeros_like(below)
    shifts = [(1, 0), (-1, 0), (1, 1), (-1, 1)]
    if d > 1:
        shifts += [(1, 2), (-1, 2)]
    gt = data > contour  # roll the 1-byte mask, not the f32 volume
    for shift, axis in shifts:
        crossing = crossing | jnp.roll(gt, -shift, axis=axis)

    marked = below & crossing & interior
    return jnp.where(marked, jnp.int8(1), edata)


# Public jitted form (tests/oracles pin it); fractal_dimension fuses the
# impl into its counts program instead — see _fractal_counts_fn.
edge_detect = jax.jit(_edge_detect_impl)


@lru_cache(maxsize=64)
def _box_counts_all_fn(shape, flength: int):
    """ONE jitted program counting filled boxes at every dyadic level.

    Hierarchical: level L+1's occupancy is a 2x2x2 any-pool of level
    L's boxes, so the full mask is read ONCE and each level costs 8x
    less than the last (total traffic ~1.15x the mask), where
    re-reducing the FULL volume per level would read it flength times.
    A dispatch per level would also pay a host round trip flength
    times."""
    h, w, d = shape

    def pad_to(n, b):
        return (n + b - 1) // b * b

    # Pad ONCE to a multiple of the largest box; zeros = empty boxes.
    top = int(2 ** (flength - 1))
    ph, pw = pad_to(h, top), pad_to(w, top)
    pd = d if d == 1 else pad_to(d, top)

    @jax.jit
    def counts(edata):
        m = (edata > 0).astype(jnp.int32)
        if (ph, pw, pd) != (h, w, d):
            m = jnp.zeros((ph, pw, pd), dtype=jnp.int32).at[:h, :w, :d].set(m)
        window = (2, 2, 1 if d == 1 else 2)
        out = [jnp.sum(m)]
        for _ in range(1, flength):
            m = jax.lax.reduce_window(
                m, jnp.int32(0), jax.lax.max, window, window, "VALID"
            )
            out.append(jnp.sum(m))
        return jnp.stack(out)

    return counts


@lru_cache(maxsize=64)
def _fractal_counts_fn(shape, flength: int, use_mean: bool):
    """Fused edge-detect + dyadic box-count cascade in ONE program.

    Every dispatch pays a host round trip, so running edge_detect as its
    own jit (plus a separate mean fetch for contour=None) would add
    round trips to an analysis whose device compute is a few ms. ``use_mean`` folds the
    contour-from-mean reduction in-trace too."""
    counts = _box_counts_all_fn(shape, flength)

    @jax.jit
    def run(data, contour):
        c = jnp.mean(data) if use_mean else contour
        return counts(_edge_detect_impl(data, c.astype(data.dtype)))

    return run


def fractal_dimension(
    data: np.ndarray | jax.Array,
    contours: Union[float, List[float]] = 0.5,
) -> Dict[str, Dict[str, float]]:
    """Box-counting dimension for each contour level.

    Returns {contour: {"average fractal dimension", "slope", "R2", "curve"}}.
    """
    if contours is None:
        # The loop body supports None-as-mean; accept the obvious
        # spelling, not only [None].
        contour_list = [None]
    elif isinstance(contours, (int, float, np.number)) and not isinstance(contours, bool):
        contour_list = [contours]
    elif isinstance(contours, (list, tuple)):
        contour_list = list(contours)
    else:
        raise ValueError("Contours must be either a float, list of floats, or None")

    data = jnp.asarray(data)
    height, width, depth = data.shape

    largest_dim = min(height, width)
    if depth > 1:
        largest_dim = min(largest_dim, depth)
    flength = int(np.log2(largest_dim)) + 1

    retval: Dict[str, Dict[str, float]] = {}
    for contour in contour_list:
        # ONE fused dispatch per contour: edge detect + every dyadic
        # level's count (and the mean reduction for contour=None)
        # in-trace — each extra dispatch costs a host round trip.
        fn = _fractal_counts_fn((height, width, depth), flength, contour is None)
        c = jnp.asarray(0.0 if contour is None else float(contour), dtype=data.dtype)
        nfilled_all = np.asarray(fn(data, c))

        result = np.zeros((flength, 2))
        for level in range(flength):
            nfilled = int(nfilled_all[level])
            result[level, 0] = flength - level - 1
            result[level, 1] = np.log2(nfilled) if nfilled > 0 else -np.inf

        # Empty levels carry -inf log counts (reference parity: the
        # stats below degrade to NaN exactly like FlashUniform.py's
        # log2(0) pipeline, pinned by test_empty_contour_...); silence
        # numpy's inf/0-division warnings for that documented path —
        # the only non-finite source here is the explicit -inf above.
        with np.errstate(invalid="ignore", divide="ignore"):
            filled_boxes = 2.0 ** result[:, 1]
            cum = np.sum(np.log2(filled_boxes[:-1] / filled_boxes[1:]))
            avg_frac_dim = cum / (filled_boxes.size - 1.0)

            mean = np.mean(result, axis=0)
            std = np.std(result, axis=0)
            rval = np.sum((result[:, 0] - mean[0]) * (result[:, 1] - mean[1])) / (
                np.prod(std) * result.shape[0]
            )
            slope = rval * std[1] / std[0]

        retval[f"{contour}"] = {
            "average fractal dimension": float(avg_frac_dim),
            "slope": float(slope),
            "R2": float(rval**2),
            "curve": float(mean[1] - slope * mean[0]),
        }
    return retval
