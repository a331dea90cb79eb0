"""Model base class: plugin registries and HDF5 result output.

JAX rebuild of the reference Model (reference: fava/model/model.py:12-193):
a directory-backed data model onto which mesh classes and analysis
functions self-register. Unlike the reference, ``load``/``_load_mesh``
actually work here — the mesh is selected by each registered mesh
class's ``is_this_your_mesh`` sniffing hook.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from fava_tpu.utils import NotCallableError, timer
from fava_tpu.utils._exceptions import InvalidMeshError


class Model:
    """A directory of simulation output plus registered meshes/analyses."""

    __meshes: Dict[str, Any] = {}
    _frontend: str = "Generic"

    def __init__(self, directory: str | Path, name: Optional[str] = None):
        self.directory = Path(directory)
        self.name = name

    # ------------------------------------------------------------------
    # Directory / file catalog
    @property
    def directory(self) -> Path:
        return self._directory

    @directory.setter
    def directory(self, directory: str | Path) -> None:
        self._directory = Path(directory)
        if not self._directory.is_dir():
            raise FileNotFoundError(f"Cannot find model directory: {self._directory}")

        self.files = sorted(fn for fn in self._directory.glob("*") if fn.is_file())
        if len(self.files) == 0:
            raise FileNotFoundError(f"The model directory is empty: {self._directory}")
        # Subclass hook: derived state (e.g. FLASH's five file catalogs)
        # must follow a directory reassignment, or nfiles()/load() would
        # silently keep serving the previous directory.
        self._directory_changed()

    def _directory_changed(self) -> None:
        """Called after ``self.files`` is re-globbed; subclasses rebuild
        directory-derived state here."""

    @property
    def name(self) -> str:
        return self._name

    @name.setter
    def name(self, name: Optional[str]) -> None:
        self._name = self._directory.name if name is None else name

    def _filter_files(self, pattern: str) -> List[Path]:
        return [file for file in self.files if file.match(pattern)]

    def nfiles(self) -> int:
        # No swallowed *args/**kwargs: nfiles('plt') on a frontend that
        # does not catalog by type must raise, not return the total.
        return len(self.files)

    # ------------------------------------------------------------------
    # Mesh registry
    @classmethod
    def register_mesh(cls):
        def decorator(mesh_cls):
            cls._Model__meshes[mesh_cls.__name__] = mesh_cls
            return mesh_cls

        return decorator

    @classmethod
    def mesh_names(cls) -> list:
        return sorted(cls._Model__meshes.keys())

    @classmethod
    def get_mesh_class(cls, name: str):
        mesh_cls = cls._Model__meshes.get(name)
        if mesh_cls is None:
            raise InvalidMeshError(name)
        return mesh_cls

    def _load_mesh(self, filename: str | Path, fields: Optional[List[str]] = None) -> None:
        """Sniff the file with every registered mesh class and load it."""
        filename = str(filename)
        for mesh_cls in self._Model__meshes.values():
            if mesh_cls.is_this_your_mesh(filename):
                self.mesh = mesh_cls(filename)
                self.mesh.load()
                if fields:
                    self.mesh.load_data(names=fields)
                return
        raise InvalidMeshError(filename)

    def load(self, filenumber: int = 0) -> None:
        if len(self.files) <= filenumber:
            raise IndexError(
                f"Filenumber {filenumber} is out of bounds for filelist of length {len(self.files)}"
            )
        self._load_mesh(self.files[filenumber])

    # ------------------------------------------------------------------
    # Analysis registry
    @classmethod
    def register_analysis(cls, overwrite: bool = False, use_timer: Optional[bool] = None):
        def decorator(analysis_func):
            if not callable(analysis_func):
                raise NotCallableError(analysis_func)
            name = analysis_func.__name__
            if not hasattr(cls, name) or overwrite:
                setattr(cls, name, timer(analysis_func) if use_timer else analysis_func)
            return analysis_func

        return decorator

    # ------------------------------------------------------------------
    # HDF5 result output
    def save_to_hdf5(self, data: dict, filename: Path | str) -> None:
        """Write a nested dict of results as HDF5 groups/datasets (appending)."""
        import h5py

        _filename = Path(filename)
        mode = "a" if _filename.is_file() else "w"
        with h5py.File(str(_filename), mode) as f:
            self.write_to_hdf5(f, data)

    def write_to_hdf5(self, handle, data: dict) -> None:
        import h5py

        for key, values in data.items():
            if isinstance(values, dict):
                if key in handle and not isinstance(handle[key], h5py.Group):
                    # A previous run stored a DATASET here; recursing
                    # into it would crash — replace like the dataset
                    # branch does.
                    del handle[key]
                group = handle[key] if key in handle else handle.create_group(key)
                self.write_to_hdf5(group, values)
            else:
                if key in handle:
                    del handle[key]
                arr = np.asarray(values)
                if arr.dtype.kind == "U":
                    arr = arr.astype("S")
                handle.create_dataset(key, data=arr)

    def hdf5_key_exists(self, key: str, filename: str | Path) -> bool:
        import h5py

        _filename = Path(filename)
        if not _filename.is_file():
            return False
        with h5py.File(str(_filename), "r") as f:
            return key in f
