"""FLASH HDF5 file primitives.

Host-side readers/writers for the FLASH file layout: parameter tables
("real scalars", "integer runtime parameters", ...), block metadata
("coordinates", "bounding box", "node type", ...), UNK field datasets
(stored (nblocks, nz, ny, nx) — we swap to (nblocks, nx, ny, nz)), and
particle datasets. Mirrors the behavior of the reference readers
(reference: fava/mesh/FLASH/_flash.py:211-367, 619-799) without the MPI
shared-window machinery: single-controller JAX owns the arrays and
device transfer happens in the mesh layer.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from fava_tpu.utils import HID_T

if TYPE_CHECKING:
    import h5py

PARAMETER_KINDS = ("real", "integer", "logical", "string")

# Canonical long-name -> 4-char UNK field names (reference: fava/mesh/FLASH/_util.py:1-13).
FIELD_MAPPING: Dict[str, str] = {
    "velocity-x": "velx",
    "velocity-y": "vely",
    "velocity-z": "velz",
    "density": "dens",
    "pressure": "pres",
    "temperature": "temp",
    "energy": "ener",
    "flame progress": "flam",
    "ignition time": "igtm",
    "velocity-divergence": "divv",
    "vorticity": "vort",
}

NGUARD: int = 4
MESH_MDIM: int = 3


def _decode(value: Any) -> Any:
    if isinstance(value, bytes):
        return value.decode("utf-8").strip()
    return value


def read_parameter_table(handle: h5py.File, key: str, string_values: bool) -> Dict[str, Any]:
    """One compound (name, value) table -> {stripped name: value}."""
    if key not in handle:
        return {}
    table = handle[key][()]
    names = [_decode(rec["name"]).strip() if isinstance(_decode(rec["name"]), str) else _decode(rec["name"]) for rec in table]
    if string_values:
        values = [_decode(rec["value"]) for rec in table]
    else:
        values = [rec["value"] for rec in table]
    return dict(zip(names, values))


def read_scalars(handle: h5py.File) -> Dict[str, Dict[str, Any]]:
    return {
        kind: read_parameter_table(handle, f"{kind} scalars", string_values=(kind == "string"))
        for kind in PARAMETER_KINDS
    }


def read_runtime_parameters(handle: h5py.File) -> Dict[str, Dict[str, Any]]:
    return {
        kind: read_parameter_table(handle, f"{kind} runtime parameters", string_values=(kind == "string"))
        for kind in PARAMETER_KINDS
    }


def read_unknown_names(handle: h5py.File) -> List[str]:
    names = np.squeeze(handle["unknown names"][()])
    names = np.atleast_1d(names)
    return [_decode(n).strip() if isinstance(_decode(n), str) else str(n) for n in names]


def read_field(handle: h5py.File, name: str, dtype=np.float64) -> np.ndarray:
    """Read one UNK dataset, swapping the grid I and K axes.

    FLASH files store (nblocks, nzb, nyb, nxb); we return
    (nblocks, nxb, nyb, nzb) (or 3D for uniform single-block data),
    promoted to ``dtype`` (reference: fava/mesh/FLASH/_flash.py:306-341).
    The swap+cast runs through the native C++ kernel when available.
    """
    key = f"{name:4s}" if len(name) < 4 else name
    if key not in handle and name in handle:
        key = name
    if key not in handle:
        raise KeyError(f"{name} field not found in dataset")
    raw = handle[key][()]
    if raw.ndim in (3, 4) and raw.dtype in (np.float32, np.float64):
        from fava_tpu.native import swap_axes_cast

        return swap_axes_cast(raw, dtype)
    return np.ascontiguousarray(np.swapaxes(raw.astype(dtype), -1, -3))


def read_field_slab(
    handle: h5py.File, name: str, x0: int, x1: int, dtype=np.float64
) -> np.ndarray:
    """Read an x-slab [x0, x1) of a single-block uniform field.

    The file stores (1, nzb, nyb, nxb), so the slab is a trailing-axis
    hyperslab read (HDF5 partial I/O — the full field never lands in
    host memory); returned as (x1-x0, nyb, nzb) in grid order. Feeds
    the out-of-core streamed analysis (ops/outofcore.py).
    """
    key = f"{name:4s}" if len(name) < 4 else name
    if key not in handle and name in handle:
        key = name
    if key not in handle:
        raise KeyError(f"{name} field not found in dataset")
    dset = handle[key]
    raw = dset[..., x0:x1]
    if raw.ndim == 4:
        if raw.shape[0] != 1:
            # Not an assert (stripped under python -O): silently taking
            # block 0 of multi-block data would make every streamed
            # analysis compute statistics of one block only.
            raise ValueError(
                f"read_field_slab expects single-block uniform data; got {raw.shape[0]} blocks"
            )
        raw = raw[0]
    if raw.dtype in (np.float32, np.float64):
        from fava_tpu.native import swap_axes_cast

        return swap_axes_cast(raw, dtype)
    return np.ascontiguousarray(np.swapaxes(raw.astype(dtype), -1, -3))


def read_block_metadata(handle: h5py.File) -> Dict[str, np.ndarray]:
    """All block bookkeeping datasets present in the file."""
    out: Dict[str, np.ndarray] = {}
    int_keys = {"node type", "refine level", "gid", "which child", "processor number", "bflags"}
    for key in (
        "coordinates",
        "block size",
        "bounding box",
        "node type",
        "refine level",
        "gid",
        "which child",
        "processor number",
        "bflags",
    ):
        if key in handle:
            data = handle[key][()]
            if key in int_keys:
                out[key] = data.astype(np.int64)
            else:
                out[key] = data.astype(np.float64)
    return out


# ---------------------------------------------------------------------------
# Writers


def _write_parameter_table(handle: h5py.File, name: str, params: Dict[str, Any], kind: str) -> None:
    if kind == "real":
        dtype = HID_T.F64_PARAMETER
        conv = float
    elif kind == "integer":
        dtype = HID_T.I32_PARAMETER
        conv = int
    elif kind == "logical":
        dtype = HID_T.BOOL_PARAMETER
        conv = int
    elif kind == "string":
        dtype = HID_T.STR_PARAMETER
        conv = lambda v: f"{v:<256s}".encode()
    else:
        raise ValueError(f"Unknown parameter kind {kind}")

    data = np.array(
        [(f"{k:<256s}".encode(), conv(v)) for k, v in params.items()],
        dtype=dtype,
    )
    handle.create_dataset(name, data=data)


def write_parameters(
    handle: h5py.File,
    scalars: Dict[str, Dict[str, Any]],
    runtime_parameters: Dict[str, Dict[str, Any]],
) -> None:
    for kind in PARAMETER_KINDS:
        _write_parameter_table(handle, f"{kind} runtime parameters", runtime_parameters.get(kind, {}), kind)
        _write_parameter_table(handle, f"{kind} scalars", scalars.get(kind, {}), kind)


def write_block_metadata(
    handle: h5py.File,
    *,
    coordinates: np.ndarray,
    block_size: np.ndarray,
    bounding_box: np.ndarray,
    node_type: np.ndarray,
    refine_level: np.ndarray,
    gid: np.ndarray,
    which_child: np.ndarray,
    bflags: np.ndarray,
    processor_number: Optional[np.ndarray] = None,
    chk_file: bool = False,
) -> None:
    FT = HID_T.F64 if chk_file else HID_T.F32
    handle.create_dataset("coordinates", data=np.asarray(coordinates, dtype=np.float64), dtype=FT)
    handle.create_dataset("block size", data=np.asarray(block_size, dtype=np.float64), dtype=FT)
    handle.create_dataset("bounding box", data=np.asarray(bounding_box, dtype=np.float64), dtype=FT)
    handle.create_dataset("node type", data=np.asarray(node_type, dtype=np.int32), dtype=HID_T.I32)
    handle.create_dataset("refine level", data=np.asarray(refine_level, dtype=np.int32), dtype=HID_T.I32)
    handle.create_dataset("gid", data=np.asarray(gid, dtype=np.int32), dtype=HID_T.I32)
    handle.create_dataset("which child", data=np.asarray(which_child, dtype=np.int32), dtype=HID_T.I32)
    handle.create_dataset("bflags", data=np.asarray(bflags, dtype=np.int32), dtype=HID_T.I32)
    if processor_number is not None:
        handle.create_dataset(
            "processor number", data=np.asarray(processor_number, dtype=np.int32), dtype=HID_T.I32
        )


def write_unknown_names(handle: h5py.File, names: Sequence[str]) -> None:
    # FLASH UNK names are exactly 4 chars (HID_T.UNKNOWN_NAMES is S4):
    # numpy silently TRUNCATES longer names, which would record b'myfi'
    # for a dataset written as 'myfield' — corrupt-on-write, surfacing
    # only as a KeyError on reload. Fail at write time instead.
    too_long = [n for n in names if len(n) > 4]
    if too_long:
        raise ValueError(
            f"FLASH field names must be <= 4 characters (S4 'unknown names' "
            f"records); got {too_long}"
        )
    data = np.array([[f"{n:4s}".encode()] for n in names], dtype=HID_T.UNKNOWN_NAMES)
    handle.create_dataset("unknown names", data=data, dtype=HID_T.UNKNOWN_NAMES)


def write_field(handle: h5py.File, name: str, data: np.ndarray, chk_file: bool = False) -> None:
    """Write one UNK dataset, swapping grid I and K axes back to file order."""
    FT = HID_T.F64 if chk_file else HID_T.F32
    swapped = np.swapaxes(np.asarray(data), -1, -3)
    handle.create_dataset(name, data=swapped, dtype=FT)


def write_mesh_file(
    path: str | Path,
    *,
    scalars: Dict[str, Dict[str, Any]],
    runtime_parameters: Dict[str, Dict[str, Any]],
    metadata: Dict[str, np.ndarray],
    fields: Dict[str, np.ndarray],
    chk_file: bool = False,
) -> None:
    """Write a complete FLASH-layout mesh file (uniform/plt/chk)."""
    import h5py

    with h5py.File(str(path), "w") as f:
        write_parameters(f, scalars, runtime_parameters)
        write_block_metadata(
            f,
            coordinates=metadata["coordinates"],
            block_size=metadata["block size"],
            bounding_box=metadata["bounding box"],
            node_type=metadata["node type"],
            refine_level=metadata["refine level"],
            gid=metadata["gid"],
            which_child=metadata["which child"],
            bflags=metadata["bflags"],
            processor_number=metadata.get("processor number"),
            chk_file=chk_file,
        )
        write_unknown_names(f, list(fields.keys()))
        for name, data in fields.items():
            write_field(f, name, data, chk_file=chk_file)


# ---------------------------------------------------------------------------
# Particles


def read_particle_metadata(handle: h5py.File) -> Dict[str, Any]:
    """Particle-file metadata (reference: fava/mesh/FLASH/FlashParticles.py:74-82)."""
    int_scalars = read_parameter_table(handle, "integer scalars", string_values=False)
    real_scalars = read_parameter_table(handle, "real scalars", string_values=False)
    # atleast_1d: squeeze of a single-column file is 0-d (not iterable).
    names = [_decode(v).strip() for v in np.atleast_1d(np.squeeze(handle["particle names"][()]))]
    return {
        "integer scalars": int_scalars,
        "real scalars": real_scalars,
        "localnp": handle["localnp"][()],
        "particle names": names,
    }


def read_particles(
    handle: h5py.File, field_names: Sequence[str], select: Optional[Iterable[str]] = None
) -> Dict[str, np.ndarray]:
    """Bulk-read the "tracer particles" table into {field: column}."""
    table = handle["tracer particles"][()]
    wanted = list(select) if select is not None else list(field_names)
    out: Dict[str, np.ndarray] = {}
    for k, field in enumerate(field_names):
        if field in wanted:
            out[field] = np.asarray(table[..., k])
    return out


def write_particle_file(
    path: str | Path,
    *,
    int_scalars: Dict[str, int],
    real_scalars: Dict[str, float],
    particles: Dict[str, np.ndarray],
) -> None:
    import h5py

    names = list(particles.keys())
    nparticles = len(next(iter(particles.values()))) if particles else 0
    with h5py.File(str(path), "w") as f:
        _write_parameter_table(f, "integer scalars", int_scalars, "integer")
        _write_parameter_table(f, "real scalars", real_scalars, "real")
        f.create_dataset("localnp", data=np.array([nparticles], dtype=np.int32))
        f.create_dataset(
            "particle names",
            data=np.array([[f"{n:24s}".encode()] for n in names], dtype="S24"),
        )
        table = np.stack([np.asarray(particles[n], dtype=np.float64) for n in names], axis=-1)
        f.create_dataset("tracer particles", data=table)
