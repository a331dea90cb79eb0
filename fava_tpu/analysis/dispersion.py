"""Lagrangian dispersion statistics over a tracer-particle series.

Beyond the reference (whose Lagrangian analyses stop at
autocorrelation and cross-correlation tracking,
reference: fava/analysis/auto_correlations.py:80-112): the two classic
Lagrangian turbulence diagnostics —

* single-particle (Taylor) dispersion ⟨|x_i(t) - x_i(0)|²⟩, whose
  short-time ballistic t² and long-time diffusive 2 D t regimes give
  the Lagrangian integral time scale, and
* pair (Richardson) dispersion ⟨|δ_ij(t)|²⟩ over nearest-neighbor
  pairs at t = 0, whose inertial-range t³ growth is the standard
  two-particle mixing diagnostic.

Design notes:

* Particles are tracked BY TAG (``rows_for_tags``, hard error on a
  missing tag): raw table order is not stable across FLASH snapshots
  (particles migrate between ranks), so positional indexing would
  silently pair different particles.
* Pairs are ``npairs`` deterministic (seeded) anchor particles, each
  paired with its nearest neighbor at t = 0 — nearest-neighbor pairing
  gives the small initial separations Richardson scaling is defined
  for, without requiring a user-chosen separation bin.
* Displacements are raw coordinate differences: FLASH tracer
  coordinates are absolute domain positions and the flame-window
  datasets this package targets are not periodic in the profile axis.
  For fully periodic runs whose particles wrap, dispersion past the
  first crossing is under-counted (documented, not hidden).

Like the reference's particle analyses, the per-snapshot MSD math is
host-side NumPy over the particle tables — the data is tiny next to
the volumes and the cost is file I/O, not math. The one genuinely
quadratic piece, the t = 0 nearest-neighbor search, runs on device
above a work threshold (difference-form distances + top-k, exact f64
host refinement of the finalists).
"""

from __future__ import annotations

import logging
from functools import lru_cache as _lru_cache
from typing import Dict, Optional, Sequence

import numpy as np

from fava_tpu.analysis._catalogs import particle_series_indices
from fava_tpu.mesh.flash_particles import rows_for_tags
from fava_tpu.models.model import Model

LOGGER = logging.getLogger(__name__)

_POS_FIELDS = ("posx", "posy", "posz")


_NN_CHUNK = 256
# Below this many anchor*particle distances the device dispatch and
# transfer cost more than the NumPy loop; above it the device path wins.
_NN_DEVICE_MIN_WORK = 1 << 26


def _nn_host(coords: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Chunked O(A*N) NumPy brute force (small problems / fallback).

    |a-b|^2 = |a|^2 + |b|^2 - 2 a.b: the only chunk*N temporary is the
    matmul output itself (a (256, N, 3) broadcast difference would be
    ~6 GB at a million tracers)."""
    sq = (coords**2).sum(axis=1)
    partners = np.empty(anchors.size, dtype=np.int64)
    for s in range(0, anchors.size, _NN_CHUNK):
        a = anchors[s : s + _NN_CHUNK]
        d2 = sq[a, None] + sq[None, :] - 2.0 * coords[a] @ coords.T
        d2[np.arange(a.size), a] = np.inf  # exclude self
        partners[s : s + _NN_CHUNK] = np.argmin(d2, axis=1)
    return partners


@_lru_cache(maxsize=8)
def _nn_sweep_fn(n: int, k: int):
    """Jitted chunked top-k distance sweep, cached per (n, k) like every
    other op builder (a fresh ``jax.jit`` closure per call would carry
    its own trace cache and recompile on every ``dispersion_statistics``
    invocation)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def f(c, a_idx):
        def chunk(ai):
            diff = c[None, :, :] - c[ai][:, None, :]
            d2 = jnp.sum(diff * diff, axis=-1)
            d2 = jnp.where(jnp.arange(n)[None, :] == ai[:, None], jnp.inf, d2)
            _, idx = lax.top_k(-d2, k)
            return idx

        return lax.map(chunk, a_idx.reshape(-1, _NN_CHUNK))

    return f


def _nn_device_candidates(coords: np.ndarray, anchors: np.ndarray, k: int) -> np.ndarray:
    """Top-k nearest-candidate indices per anchor, computed on device.

    One jit: per 256-anchor chunk, DIFFERENCE-form squared distances
    (sum((a - b)^2), one fused broadcast-square-reduce, no matmul) and
    ``lax.top_k``. Difference form is deliberate: the matmul identity
    |a|^2 + |b|^2 - 2 a.b cancels for close pairs (absolute d2 error
    ~ eps * |c|^2 SWAMPS d2 for clustered tracers — measured 4/300
    wrong partners on a 1e-4-scale cluster), while the difference form
    carries ~eps RELATIVE error, so the true neighbor is inside the
    top-k unless k-1 others sit within ~1e-7 relative of the minimum
    distance. The caller still re-decides the k finalists exactly in
    f64.
    """
    import jax.numpy as jnp

    n = coords.shape[0]
    npad = -anchors.size % _NN_CHUNK
    a_pad = np.concatenate([anchors, np.zeros(npad, dtype=anchors.dtype)])

    cand = _nn_sweep_fn(n, k)(
        jnp.asarray(coords, dtype=jnp.float32),
        jnp.asarray(a_pad, dtype=jnp.int32),
    )
    return np.asarray(cand).reshape(a_pad.size, k)[: anchors.size]


def _nearest_neighbor_pairs(coords: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Index of each anchor's nearest OTHER particle.

    Large problems run the distance sweep on device (difference-form
    d2 + top-k; 74 s -> sub-second at 1024 anchors x 1e6 tracers on
    the single-core host) with the k finalists re-decided exactly in f64
    on host, so the result is identical to the f64 brute force up to
    genuine sub-1e-6 distance ties. Falls back to NumPy below the
    dispatch-floor break-even or if the device path fails.
    """
    n = coords.shape[0]
    k = min(16, n - 1)
    if anchors.size * n < _NN_DEVICE_MIN_WORK or k < 1:
        return _nn_host(coords, anchors)
    try:
        cand = _nn_device_candidates(coords, anchors, k)
    except Exception as exc:  # pragma: no cover - backend-dependent
        LOGGER.warning("device NN search failed (%s); NumPy fallback", exc)
        return _nn_host(coords, anchors)
    # Exact f64 refinement of the device's f32 candidate lists.
    diff = coords[anchors][:, None, :] - coords[cand]
    d2 = (diff**2).sum(axis=-1)
    d2[cand == anchors[:, None]] = np.inf
    return cand[np.arange(anchors.size), d2.argmin(axis=1)]


@Model.register_analysis(use_timer=True)
def dispersion_statistics(
    self,
    npairs: int = 256,
    seed: int = 0,
    file_indices: Optional[Sequence[int]] = None,
    **kwargs,
) -> Dict[str, np.ndarray]:
    """Taylor single-particle + Richardson pair dispersion vs time.

    Returns {"time", "single_msd", "pair_msd",
    "initial_pair_separation_sq", "npairs"}; ``single_msd`` averages
    over EVERY tag present at t = 0 (hard error if one later
    disappears), ``pair_msd`` over the nearest-neighbor pairs.
    """
    file_type = kwargs.setdefault("file_type", "prt")
    # Indices come from the SAME catalog load() resolves file_type
    # against (chk_prt -> checkpoint files): drawing them from
    # prt_files regardless analyzed a different snapshot set than the
    # override requested, or failed mid-series.
    indices = particle_series_indices(self, file_type, file_indices)
    if len(indices) < 2:
        raise ValueError("dispersion statistics need at least 2 particle snapshots")

    load_fields = [*_POS_FIELDS, "tag"]
    self.load(file_index=indices[0], fields=load_fields, **kwargs)
    if self.particles is None:
        raise RuntimeError("dispersion statistics require Lagrangian particles")
    ndim = min(self.particles.ndim or 3, 3)
    pos_fields = _POS_FIELDS[:ndim]

    def coords_and_tags():
        p = self.particles.data
        return np.stack([np.asarray(p[f], dtype=np.float64) for f in pos_fields], axis=1), np.asarray(
            p["tag"]
        )

    x0, tags0 = coords_and_tags()
    nparticles = x0.shape[0]
    npairs_eff = min(int(npairs), nparticles)
    rng = np.random.default_rng(seed)
    anchors = rng.choice(nparticles, size=npairs_eff, replace=False)
    partners = _nearest_neighbor_pairs(x0, anchors)

    delta0 = x0[anchors] - x0[partners]
    out: Dict[str, np.ndarray] = {
        "time": np.zeros(len(indices)),
        "single_msd": np.zeros(len(indices)),
        "pair_msd": np.zeros(len(indices)),
        "initial_pair_separation_sq": float((delta0**2).sum(axis=1).mean()),
        "npairs": npairs_eff,
    }

    for j, i in enumerate(indices):
        if j > 0:
            self.load(file_index=i, fields=load_fields, **kwargs)
        x, tags = coords_and_tags()
        rows = rows_for_tags(tags, tags0, label="tag")
        xt = x[rows]  # aligned with the t=0 tag order
        out["time"][j] = self.particles.time
        out["single_msd"][j] = (((xt - x0) ** 2).sum(axis=1)).mean()
        # rows is aligned with the tags0 order, so the anchor/partner
        # rows are plain gathers — no second/third per-snapshot sort.
        delta = xt[anchors] - xt[partners]
        out["pair_msd"][j] = ((delta**2).sum(axis=1)).mean()
    return out
