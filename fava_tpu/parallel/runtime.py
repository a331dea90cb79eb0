"""Device-mesh runtime.

The reference parallelizes with an MPI singleton over node-local
shared-memory windows (reference: fava/util/_mpi.py:17-80): every rank
sees one copy of each big array and collectives reduce small profiles.
The JAX equivalent is single-controller JAX: big arrays are
``jax.Array``s resident in device memory, sharded over a
``jax.sharding.Mesh``; "shared windows" become a single global array,
and ``Allreduce`` becomes ``psum`` over the device interconnect inside
jitted/shard_mapped code.

This module owns the global mesh used by the analysis kernels. With one
device (or no mesh configured) everything runs unsharded; with a mesh,
volumes are slab-sharded along the leading axis ("space") and snapshot
batches can additionally shard over a "snap" axis.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

SPACE_AXIS = "space"
SNAP_AXIS = "snap"

_MESH: Optional[Mesh] = None


def device_count() -> int:
    return len(jax.devices())


def device_memory_bytes() -> float:
    """Bytes one device can hold for arrays.

    An accelerator reports it as ``memory_stats()["bytes_limit"]``; one
    that does not is an error, since every memory-sized choice (in-core
    vs streamed, series batch size) would otherwise rest on a guess.
    The CPU backend has no ``memory_stats``: its arrays live in host
    RAM, so the budget is the host's physical memory.
    """
    import os

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    stats = dev.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(f"{dev.device_kind}: memory_stats() reports no bytes_limit")
    return float(stats["bytes_limit"])


def make_device_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (SPACE_AXIS,),
) -> Mesh:
    """Build a Mesh over the available devices.

    With no ``shape``, all devices go on a single named axis (default
    "space" — the spatial slab axis used by the analysis kernels).
    """
    if shape is None:
        shape = (device_count(),)
    need = int(np.prod(shape))
    avail = jax.devices()
    if need > len(avail):
        # A clear error instead of numpy's "cannot reshape array of
        # size 8 into shape (2, 8)" from the silent truncation below.
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {need} devices but only "
            f"{len(avail)} are available"
        )
    devices = np.asarray(avail[:need]).reshape(tuple(shape))
    return Mesh(devices, tuple(axis_names))


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


@contextmanager
def use_mesh(mesh: Optional[Mesh]):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def space_axis_size(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or SPACE_AXIS not in mesh.axis_names:
        return 1
    return mesh.shape[SPACE_AXIS]


def volume_sharding(mesh: Optional[Mesh] = None, axis: int = 0, ndim: int = 3):
    """NamedSharding slab-sharding a volume along ``axis`` (None if no mesh)."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or SPACE_AXIS not in mesh.axis_names:
        return None
    spec = [None] * ndim
    spec[axis] = SPACE_AXIS
    return NamedSharding(mesh, PartitionSpec(*spec))


def device_axis_total(mesh: Optional[Mesh] = None) -> int:
    """Total device count of the active mesh (1 with no mesh)."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return 1
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))


def block_sharding(mesh: Optional[Mesh] = None, ndim: int = 4):
    """NamedSharding sharding an (nblocks, nx, ny, nz) stack along blocks.

    Blocks are independent work items, so they split over ALL mesh
    axes — on a snap x space pod, AMR profile reductions use every
    device instead of replicating the stack across snap rows.
    """
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or SPACE_AXIS not in mesh.axis_names:
        return None
    spec = [None] * ndim
    names = tuple(mesh.axis_names)
    spec[0] = names if len(names) > 1 else names[0]
    return NamedSharding(mesh, PartitionSpec(*spec))


def snap_axis_size(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or SNAP_AXIS not in mesh.axis_names:
        return 1
    return mesh.shape[SNAP_AXIS]


def is_pod_mesh(mesh: Optional[Mesh] = None) -> bool:
    """True for a 2-axis snap x space mesh (the pod series topology)."""
    mesh = mesh if mesh is not None else _MESH
    return (
        mesh is not None
        and SNAP_AXIS in mesh.axis_names
        and SPACE_AXIS in mesh.axis_names
    )


def ingest_volume_sharding(mesh: Optional[Mesh] = None, ndim: int = 3):
    """Sharding for PREFETCHING one snapshot volume onto the whole mesh.

    The leading axis splits over ALL mesh axes (snap and space alike),
    so each volume crosses the host link exactly once — on a snap x
    space pod, sharding only over "space" would replicate the transfer
    per snap row. The pod series step then redistributes on-device to
    ``P("snap", "space")`` batches (device interconnect, not host link).
    """
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return None
    spec = [None] * ndim
    names = tuple(mesh.axis_names)
    spec[0] = names if len(names) > 1 else names[0]
    return NamedSharding(mesh, PartitionSpec(*spec))


def ingest_sharding_fn(mesh: Optional[Mesh] = None):
    """Shape-aware sharding callback for SnapshotPrefetcher.

    Returns ``fn(name, shape) -> sharding | None``: 3D volumes whose x
    extent divides the full device count prefetch straight into the
    mesh (one host-link crossing); 4D block stacks shard over all axes
    when the block count divides the device count; anything else lands
    unsharded.

    Volume rules additionally require the y extent to divide the
    "space" axis — exactly the eligibility of the sharded analysis
    paths (slab FFT + all_to_all split y). A volume the analysis would
    have to fall back to single-chip for must NOT arrive pre-sharded:
    the single-chip Pallas step cannot consume mesh-sharded inputs.
    """
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return None
    total = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    n_space = space_axis_size(mesh)
    vol = ingest_volume_sharding(mesh)
    names = tuple(mesh.axis_names)
    single_block = NamedSharding(
        mesh, PartitionSpec(None, names if len(names) > 1 else names[0], None, None)
    )
    blocks = block_sharding(mesh)

    def fn(name, shape):
        if len(shape) == 3 and shape[0] % total == 0 and shape[1] % max(n_space, 1) == 0:
            return vol
        if (
            len(shape) == 4
            and shape[0] == 1
            and shape[1] % total == 0
            and shape[2] % max(n_space, 1) == 0
        ):
            # Single-block uniform volume stored (1, nx, ny, nz).
            return single_block
        if len(shape) == 4 and total > 1 and shape[0] % total == 0:
            return blocks
        return None

    return fn


def replicated(mesh: Optional[Mesh] = None):
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return None
    return NamedSharding(mesh, PartitionSpec())


def shard_volume(x, mesh: Optional[Mesh] = None, axis: int = 0):
    """Put a host/device volume onto the mesh slab-sharded along ``axis``."""
    s = volume_sharding(mesh, axis=axis, ndim=np.ndim(x))
    if s is None:
        return jax.device_put(x)
    return jax.device_put(x, s)
