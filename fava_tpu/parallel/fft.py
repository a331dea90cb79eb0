"""Distributed 3D FFT over the device mesh (slab / pencil decomposition).

The reference computes the full ``np.fft.fftn`` redundantly on every MPI
rank against a node-shared array (reference: fava/mesh/FLASH/FlashUniform.py:268)
— it never landed its planned ``mpi4py-fft`` decomposition. Here the 3D
FFT is genuinely decomposed over the device interconnect:

  input slab-sharded along x:  (nx/d, ny, nz)  per device
    1. batched local FFT over the two resident axes (y, z)
    2. ``all_to_all`` transpose x<->y over the mesh axis
    3. local FFT over the now-resident x axis
  output slab-sharded along y: (nx, ny/d, nz)  per device

All shell-binned spectra downstream are permutation-invariant in k, so
no inverse transpose or fftshift is needed — callers build the matching
unshifted local k-grid from :func:`_wavenumbers` (see
ops/spectra.local_spectra_fn, which slices the y wavenumbers to its
shard the way the output sharding above lays them out).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fava_tpu.parallel import runtime


def _fft_yz_then_transpose_then_x(local, axis_name: str):
    # Local FFT along the fully-resident trailing axes.
    local = jnp.fft.fftn(local, axes=(1, 2))
    # Transpose shards: split y across devices, gather x. (nx/d, ny, nz) -> (nx, ny/d, nz)
    local = jax.lax.all_to_all(local, axis_name, split_axis=1, concat_axis=0, tiled=True)
    # FFT along the now-resident x axis.
    return jnp.fft.fft(local, axis=0)


def pfft3(x: jax.Array, mesh: Optional[Mesh] = None, axis_name: str = runtime.SPACE_AXIS) -> jax.Array:
    """Forward unnormalized 3D FFT of a volume sharded along axis 0.

    Returns the transform sharded along axis 1 (y-slabs), in *unshifted*
    k-order. Falls back to a plain ``jnp.fft.fftn`` without a mesh.
    """
    mesh = mesh if mesh is not None else runtime.get_mesh()
    if mesh is None or axis_name not in mesh.axis_names or mesh.shape[axis_name] == 1:
        return jnp.fft.fftn(x)
    nd = mesh.shape[axis_name]
    if x.shape[0] % nd or x.shape[1] % nd:
        # Shard transpose needs even slabs along both x and y.
        return jnp.fft.fftn(x)

    return jax.shard_map(
        partial(_fft_yz_then_transpose_then_x, axis_name=axis_name),
        mesh=mesh,
        in_specs=P(axis_name, None, None),
        out_specs=P(None, axis_name, None),
    )(x)


def _wavenumbers(n: int, dtype) -> jax.Array:
    """Integer wavenumbers in unshifted FFT order: [0..n/2-1, -n/2..-1]
    — matches ``fftshift`` + linspace on even n (reference:
    fava/mesh/FLASH/FlashUniform.py:244-253)."""
    k = jnp.arange(n)
    return jnp.where(k <= (n - 1) // 2, k, k - n).astype(dtype)
