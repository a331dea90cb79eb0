"""NumPy oracle for AMR->uniform regridding.

Literal per-cell mapping implementation of the reference from_amr
algorithm (fava/mesh/FLASH/_flash.py:955-1377): integer BCID boxes from
truncated float math, leaf selection (with refine-level truncation and
subdomain intersection), and injection prolongation by 2^(level-diff)
cell replication: each leaf writes source cell i // 2^(level-diff) to
fine cell i, leaf by leaf in block order.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

MESH_MDIM = 3


def from_amr_oracle(
    data: Dict[str, np.ndarray],  # (nB, nx, ny, nz)
    *,
    block_bounds: np.ndarray,
    node_type: np.ndarray,
    refine_level: np.ndarray,
    ncells: np.ndarray,
    nblks: np.ndarray,
    ndim: int = 3,
    refine_to: int = -1,
    subdomain_coords: Optional[np.ndarray] = None,
    fields: Optional[Sequence[str]] = None,
):
    nblocks = len(block_bounds)
    lmax_global = int(refine_level.max())
    ref_lev = min(int(refine_to), lmax_global)
    lmax = ref_lev if ref_lev > 0 else lmax_global

    grid_box = np.zeros((MESH_MDIM, 2))
    grid_box[:, 0] = block_bounds[..., 0].min(axis=0)
    grid_box[:, 1] = block_bounds[..., 1].max(axis=0)

    cellfac = 2 ** (lmax - 1)
    grid_delta = (grid_box[:, 1] - grid_box[:, 0]) / (ncells * nblks * cellfac)
    half = grid_delta * 0.5

    bcids = np.zeros((nblocks, MESH_MDIM, 2), dtype=np.int32)
    for lb in range(nblocks):
        bcids[lb] = (block_bounds[lb] - grid_box[:, 0, None] + half[:, None]) / grid_delta[:, None]

    # Reference sentinel semantics (_flash.py:965): active if ANY row
    # contains no zero — a transverse crop touching 0.0 still crops.
    subdomain_flag = subdomain_coords is not None and any(
        0 not in sdc for sdc in np.asarray(subdomain_coords)
    )
    sub_bcids = np.zeros((MESH_MDIM, 2), dtype=np.int32)
    if subdomain_flag:
        sc = np.asarray(subdomain_coords, dtype=np.float64)
        sub_bcids[:] = (0.5 + (sc - grid_box[:, :1]) / grid_delta[:, None]).astype(np.int32)

    def intersects(lb):
        if not subdomain_flag:
            return True
        return all(
            sub_bcids[n, 0] <= bcids[lb, n, 1] and bcids[lb, n, 0] <= sub_bcids[n, 1]
            for n in range(ndim)
        )

    leaf_ids = []
    for lb in range(nblocks):
        if ref_lev > 0:
            maybe = (node_type[lb] == 1 and refine_level[lb] < ref_lev) or refine_level[lb] == ref_lev
        else:
            maybe = node_type[lb] == 1
        if maybe and intersects(lb):
            leaf_ids.append(lb)

    fine_blks = cellfac * nblks
    if subdomain_flag:
        total_cells = np.ones(MESH_MDIM, dtype=np.int64)
        total_cells[:ndim] = np.diff(sub_bcids[:ndim]).ravel()
    else:
        total_cells = np.ones(MESH_MDIM, dtype=np.int64)
        total_cells[:ndim] = fine_blks[:ndim] * ncells[:ndim]

    # The {dest: (leaf, i, j, k)} mapping, one leaf at a time: along
    # each axis, fine index off + t (t < ncells * scale) reads source
    # cell t // scale; the subdomain keeps the fine indices inside its
    # box. Later leaves overwrite earlier ones, like a dict insert.
    fields = list(fields) if fields is not None else list(data.keys())
    out = {key: np.zeros(tuple(total_cells)) for key in fields}
    for leaf in leaf_ids:
        scale = int(2 ** (lmax - refine_level[leaf]))
        dest, src = [], []
        for n in range(MESH_MDIM):
            off = bcids[leaf, n, 0] if n < ndim else 0
            t = np.arange(int(ncells[n]) * scale)
            ind = off + t
            if subdomain_flag:
                inside = (sub_bcids[n, 0] <= ind) & (ind < sub_bcids[n, 1])
                t, ind = t[inside], ind[inside] - sub_bcids[n, 0]
            dest.append(ind)
            src.append(t // scale)
        for key in fields:
            out[key][np.ix_(*dest)] = data[key][leaf][np.ix_(*src)]
    return out, total_cells
