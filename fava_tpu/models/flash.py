"""FLASH model frontend: file catalogs and load dispatch.

JAX rebuild of the reference frontend
(reference: fava/model/flash.py:10-169): globs the data directory into
five catalogs (chk/plt/prt/uni/anl), each addressable "by number"
(the 4-digit suffix) or "by index" (sorted position), dispatches
``load`` to FlashAMR / FlashUniform / FlashParticles by file type, and
converts filename stems between types.
"""

from __future__ import annotations

from enum import Enum
from pathlib import Path
from typing import Dict, Optional

from fava_tpu.mesh import FLASH as FlashAMR
from fava_tpu.mesh import FlashParticles, FlashUniform
from fava_tpu.models.model import Model


class FileSubStem(Enum):
    CHK = "chk"
    PLT = "plt_cnt"
    PRT = "part"
    UNI = "uniform"
    ANL = "analysis"


class FileType(Enum):
    CHK = 0
    PLT = 1
    PRT = 2
    CHK_PRT = 3
    PLT_PRT = 4
    UNI = 5
    ANL = 6


_PATTERNS = {
    FileType.CHK: ("*hdf5_chk_????", "hdf5_chk_"),
    FileType.PLT: ("*hdf5_plt_cnt_????", "hdf5_plt_cnt_"),
    FileType.PRT: ("*hdf5_part_????", "hdf5_part_"),
    FileType.UNI: ("*hdf5_uniform_????", "hdf5_uniform_"),
    FileType.ANL: ("*hdf5_analysis_????", "hdf5_analysis_"),
}


class FLASH(Model):
    """Model over a directory of FLASH output files."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        # Catalogs are built by _directory_changed (invoked from the
        # base directory setter during super().__init__, and again on
        # any later directory reassignment).
        self.mesh = None
        self.particles = None

    def _directory_changed(self) -> None:
        def catalog(ftype: FileType) -> Dict[str, Dict[int, Path]]:
            pattern, splitter = _PATTERNS[ftype]
            # The ???? glob matches ANY 4 chars: a stray non-numeric
            # suffix ('..._hdf5_chk_orig') must not crash catalog
            # construction (and with it every FLASH() call) — skip it.
            files = [
                p
                for p in self._filter_files(pattern)
                if str(p).split(splitter)[-1].isdigit()
            ]
            return {
                "by number": {int(str(p).split(splitter)[-1]): p for p in files},
                "by index": dict(enumerate(files)),
            }

        self.chk_files = catalog(FileType.CHK)
        self.plt_files = catalog(FileType.PLT)
        self.prt_files = catalog(FileType.PRT)
        self.uni_files = catalog(FileType.UNI)
        self.anl_files = catalog(FileType.ANL)

    def _catalog(self, ftype: FileType) -> Dict[str, Dict[int, Path]]:
        return {
            FileType.CHK: self.chk_files,
            FileType.PLT: self.plt_files,
            FileType.PRT: self.prt_files,
            FileType.UNI: self.uni_files,
            FileType.ANL: self.anl_files,
        }[ftype]

    def nfiles(self, file_type: FileType | str = FileType.CHK, **kwargs) -> int:
        # Explicit first parameter: a *args signature silently returned
        # the CHK count for positional calls like nfiles('plt').
        ftype = file_type if isinstance(file_type, FileType) else FileType[str(file_type).upper()]
        return len(self._catalog(ftype)["by index"])

    def load(
        self,
        file_index: int = 0,
        file_number: Optional[int] = None,
        file_type: FileType | str = FileType.CHK,
        fields=None,
        *args,
        **kwargs,
    ) -> None:
        ftype = file_type if isinstance(file_type, FileType) else FileType[str(file_type).upper()]
        lookup = "by index" if file_number is None else "by number"
        key = file_index if file_number is None else file_number

        self.mesh = None
        self.particles = None

        def resolve(base: FileType) -> Path:
            catalog = self._catalog(base)
            if key not in catalog[lookup]:
                # Not an assert: user-facing lookup errors must survive
                # python -O (asserts are stripped under optimization).
                raise ValueError(f"{ftype.name} file {lookup} {key} not found")
            return catalog[lookup][key]

        def attach_mesh(base: FileType, mesh_cls) -> Path:
            path = resolve(base)
            self.mesh = mesh_cls(filename=path)
            self.mesh.load()
            if fields:
                self.mesh.load_data(names=fields)
            return path

        def attach_particles(path: Path) -> None:
            particle_kwargs = dict(kwargs)
            if fields is not None:
                particle_kwargs["fields"] = fields
            self.particles = FlashParticles(filename=path)
            self.particles._load_particles(*args, **particle_kwargs)

        match ftype:
            case FileType.CHK | FileType.PLT:
                attach_mesh(ftype, FlashAMR)
            case FileType.UNI:
                attach_mesh(FileType.UNI, FlashUniform)
            case FileType.PRT:
                attach_particles(resolve(FileType.PRT))
            case FileType.CHK_PRT:
                # Checkpoint files carry the particle table themselves.
                attach_particles(attach_mesh(FileType.CHK, FlashAMR))
            case FileType.PLT_PRT:
                attach_mesh(FileType.PLT, FlashAMR)
                attach_particles(resolve(FileType.PRT))
            case _:
                raise ValueError(f"Cannot load file type {ftype}")

    def convert_filename_type(
        self, current_filetype: FileType | str, new_filetype: FileType | str
    ) -> Optional[Path]:
        if self.mesh is None:
            return None
        curr = (
            current_filetype
            if isinstance(current_filetype, FileType)
            else FileType[str(current_filetype).upper()]
        )
        new = new_filetype if isinstance(new_filetype, FileType) else FileType[str(new_filetype).upper()]

        def substem(ft: FileType) -> str:
            # Combined mesh+particle types convert via their mesh substem.
            name = ft.name[:-4] if ft.name.endswith("_PRT") else ft.name
            return FileSubStem[name].value

        # Replace the hdf5_<substem>_ MARKER, not the bare substem: a
        # basename containing the substring (e.g. 'chkboard_hdf5_chk_')
        # must not be mangled (same bug class as from_amr's filename
        # derivation, commit e8df1b4).
        current_stem = self.mesh.filename.stem
        new_stem = current_stem.replace(f"hdf5_{substem(curr)}_", f"hdf5_{substem(new)}_")
        return self.mesh.filename.with_stem(new_stem)
