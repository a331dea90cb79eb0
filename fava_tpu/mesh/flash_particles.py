"""FLASH tracer-particle mesh.

JAX rebuild of the reference FlashParticles
(reference: fava/mesh/FLASH/FlashParticles.py:32-128): reads the
``tracer particles`` table with field selection, sorts by tag, and
exposes device-resident columns plus vectorized particle statistics
(means/RMS) that the reference lacks.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.io import flash_file
from fava_tpu.mesh.base import Unstructured
from fava_tpu.models.model import Model

# Short particle-column names (as stored in the file) -> long aliases
# accepted in ``fields=`` selections. ONE alias table for the whole
# package (io/flash_file.FIELD_MAPPING, the mesh-field contract) plus
# the particle-only 'id' -> 'tag' alias — two hand-synced copies would
# silently drift. The reference carries a similar table but never
# wires it in (FlashParticles.py:15-28 — requesting a long name there
# silently loads nothing).
_field_mapping = {"tag": "id", **{v: k for k, v in flash_file.FIELD_MAPPING.items()}}
_long_to_short = {v: k for k, v in _field_mapping.items()}


def rows_for_tags(table_tags: np.ndarray, requested: np.ndarray, *, label: str = "tag") -> np.ndarray:
    """Particle-table row indices of the requested tag values.

    Hard error on duplicate or missing tags — a clipped searchsorted
    would silently return an arbitrary particle's row. Shared by
    select_by_tags and the cross-correlation tracking loop.
    """
    table_tags = np.asarray(table_tags)
    requested = np.asarray(requested)
    order = np.argsort(table_tags, kind="stable")
    st = table_tags[order]
    if st.size > 1 and np.any(st[1:] == st[:-1]):
        raise ValueError(f"duplicate particle tags in field {label!r}")
    pos = np.clip(np.searchsorted(st, requested), 0, max(st.size - 1, 0))
    rows = order[pos] if st.size else np.zeros(0, dtype=np.int64)
    missing = st.size == 0 or np.any(table_tags[rows] != requested)
    if missing:
        bad = requested if st.size == 0 else requested[table_tags[rows] != requested]
        raise ValueError(f"particle tags {bad[:5]!r}... not found in {label!r}")
    return rows


@jax.jit
def _stats_fn(c):
    mean = jnp.mean(c, axis=1)
    rms = jnp.sqrt(jnp.mean((c - mean[:, None]) ** 2, axis=1))
    return jnp.stack([mean, rms, jnp.min(c, axis=1), jnp.max(c, axis=1)])


@Model.register_mesh()
class FlashParticles(Unstructured):
    _filename: Optional[Path] = None

    def __init__(self, filename: Optional[str | Path] = None, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._fields: List[str] = []
        self._metadata_loaded = False
        self.data: Dict[str, np.ndarray] = {}
        self.filename = filename

    @classmethod
    def is_this_your_mesh(cls, filename: str | Path, *args, **kwargs) -> bool:
        fn = Path(str(filename))
        return fn.match("*hdf5_part_*") or fn.match("*hdf5_chk_*")

    @property
    def filename(self) -> Optional[Path]:
        return self._filename

    @filename.setter
    def filename(self, filename: Optional[str | Path]) -> None:
        if filename is None:
            return
        fn = Path(filename)
        if not (fn.match("*hdf5_part_*") or fn.match("*hdf5_chk_*")):
            raise ValueError(
                f"FLASH particle files typically have 'hdf5_chk_' or 'hdf5_part_' in the filename: {fn}"
            )
        if fn != self._filename or not self._metadata_loaded:
            # Commit the new path only AFTER metadata loads: if
            # _load_metadata raises (file mid-write), a retry with the
            # same path must re-read it rather than no-op against the
            # previous file's stale field list / time / counts.
            self._metadata_loaded = False
            prev = self._filename
            self._filename = fn
            try:
                self._load_metadata()
            except Exception:
                self._filename = prev
                raise

    # ------------------------------------------------------------------
    def _load_metadata(self) -> None:
        import h5py

        with h5py.File(self._filename, "r") as f:
            meta = flash_file.read_particle_metadata(f)
        self._intscalars = meta["integer scalars"]
        self._realscalars = meta["real scalars"]
        self.localnp = meta["localnp"]
        # chk files without the scalar still carry per-rank counts.
        self.nParticles = int(
            self._intscalars.get("globalnumparticles", int(np.sum(self.localnp)))
        )
        self._fields = meta["particle names"]
        self.ndim = int(self._intscalars["dimensionality"])
        self.dt = float(self._realscalars.get("dt", 0.0))
        self.dtold = float(self._realscalars.get("dtold", 0.0))
        self.time = float(self._realscalars.get("time", 0.0))
        self._metadata_loaded = True

    @property
    def fields(self) -> List[str]:
        return list(self._fields)

    def load(self) -> None:
        self._load_particles()

    def _load_particles(
        self, fields: Optional[Sequence[str]] = None, ordered: bool = True, **kwargs
    ) -> None:
        # Explicit parameters: a *args signature silently ignored a
        # positional fields selection and loaded EVERY column.
        import h5py

        fields = self._fields if fields is None else fields

        # Accept long aliases ("density", "velocity-x") for the file's
        # short column names; warn on names the file does not carry.
        resolved = []
        for name in fields:
            short = name if name in self._fields else _long_to_short.get(name, name)
            if short not in self._fields:
                print(f"[WARNING] {name} particle field variable does not exist in dataset")
                continue
            resolved.append(short)

        with h5py.File(self._filename, "r") as f:
            self.data = flash_file.read_particles(f, self._fields, select=resolved)

        if ordered and "tag" in self.data:
            tidx = np.argsort(self.data["tag"])
            for field in self.data:
                self.data[field] = self.data[field][tidx]

    def get_coords(self) -> np.ndarray:
        coords = np.empty((len(self.data["posx"]), self.ndim))
        coords[:, 0] = self.data["posx"]
        if self.ndim > 1:
            coords[:, 1] = self.data["posy"]
        if self.ndim > 2:
            coords[:, 2] = self.data["posz"]
        return coords

    # ------------------------------------------------------------------
    # Device-resident particle statistics (beyond the reference).
    def device_column(self, field: str) -> jax.Array:
        return jnp.asarray(self.data[field])

    def statistics(self, fields: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
        """Per-field mean / RMS / min / max over all particles.

        Unknown fields are skipped with a warning (mirrors the reference
        loader's behavior, FlashParticles.py:98-100)."""
        fields = list(fields) if fields is not None else [f for f in self.data if f != "tag"]
        present = []
        for f in fields:
            if f not in self.data:
                print(f"[WARNING] {f} particle field variable does not exist in dataset")
                continue
            present.append(f)
        if not present:
            return {}
        # ONE jitted program + ONE fetch for all fields, not one host
        # round trip per scalar (4 x nfields of them per series snapshot).
        cols = jnp.stack([self.device_column(f) for f in present])
        vals = np.asarray(_stats_fn(cols), dtype=np.float64)
        return {
            f: {
                "mean": float(vals[0, i]),
                "rms": float(vals[1, i]),
                "min": float(vals[2, i]),
                "max": float(vals[3, i]),
            }
            for i, f in enumerate(present)
        }

    def structure_functions(self, **kwargs) -> Dict[str, Any]:
        """Velocity structure functions from tracer PAIRS (no grid
        interpolation; ops/structure.pair_structure_functions — beyond
        the reference, whose particle module only loads/sorts tables).
        Keyword arguments pass through (num_pairs, nbins, sep_bounds,
        orders, lengths, seed)."""
        from fava_tpu.ops.structure import pair_structure_functions

        coords = self.get_coords()
        vels = np.stack(
            [self.data[f"vel{a}"] for a in "xyz"[: self.ndim]], axis=-1
        )
        return pair_structure_functions(coords, vels, **kwargs)

    def select_by_tags(self, tags: np.ndarray) -> Dict[str, np.ndarray]:
        """Rows whose tag matches each requested tag (vectorized).

        Raises on tags absent from the file — a clipped searchsorted
        would silently return an arbitrary particle's row (e.g. for a
        particle that left the domain between snapshots)."""
        idx = rows_for_tags(self.data["tag"], tags, label=f"tag ({self._filename})")
        return {f: v[idx] for f, v in self.data.items()}
