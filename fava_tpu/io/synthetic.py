"""Synthetic FLASH file generator.

The reference ships no test fixtures at all (SURVEY §4); its integration
"testing" is a hard-coded script against the author's private rtflame
dataset. This module fabricates small, fully self-consistent FLASH
files — AMR plt/chk trees, uniform-grid files, and tracer-particle
files — with the exact dataset names the readers consume
(reference: fava/mesh/FLASH/_flash.py:211-304, FlashParticles.py:74-96),
so the whole test suite and the benchmarks run hermetically.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fava_tpu.io import flash_file

DEFAULT_FIELDS = ("dens", "velx", "vely", "velz", "flam")


def default_field_fn(name: str) -> Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray]:
    """Smooth analytic fields so regrid/analysis results are predictable."""

    def dens(x, y, z):
        return 1.0 + 0.5 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y) + 0.1 * z

    def velx(x, y, z):
        return np.sin(2 * np.pi * y) + 0.3 * np.cos(4 * np.pi * z)

    def vely(x, y, z):
        return np.cos(2 * np.pi * x) * np.sin(2 * np.pi * z)

    def velz(x, y, z):
        return 0.25 * np.sin(4 * np.pi * x) + 0.5 * np.cos(2 * np.pi * y)

    def flam(x, y, z):
        return 1.0 / (1.0 + np.exp((x - 0.5) * 20.0))

    def pres(x, y, z):
        # Strictly positive: sound speeds sqrt(gamc*pres/dens) must be real.
        return 2.0 + 0.5 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * z)

    def gamc(x, y, z):
        return 1.4 + 0.1 * np.cos(2 * np.pi * y)

    def other(x, y, z):
        return np.sin(2 * np.pi * (x + y + z))

    return {
        "dens": dens,
        "velx": velx,
        "vely": vely,
        "velz": velz,
        "flam": flam,
        "pres": pres,
        "gamc": gamc,
    }.get(name, other)


@dataclass
class AmrBlock:
    level: int
    bounds: np.ndarray  # (3, 2)
    node_type: int  # 1 leaf, 2 parent


def build_amr_tree(
    nblks: Tuple[int, int, int],
    domain: np.ndarray,
    refine: Optional[Dict[int, int]] = None,
    refine_fn: Optional[Callable[[np.ndarray, int], int]] = None,
) -> List[AmrBlock]:
    """Build a block tree: root grid at level 1, selected roots refined.

    ``refine`` maps a root block's linear index -> target depth (2 means
    the root is split once into 8 level-2 leaves; 3 additionally splits
    the first child, producing mixed-resolution neighbors).

    ``refine_fn(bounds, level) -> target_level`` refines REGIONS the way
    a production AMR run does (e.g. rtflame refines a band around the
    flame): every leaf whose target exceeds its level is split into all
    8 children, re-evaluated recursively — so a region reaches a
    uniform fine resolution while the rest of the domain stays coarse.
    """
    refine = refine or {}
    blocks: List[AmrBlock] = []
    widths = (domain[:, 1] - domain[:, 0]) / np.asarray(nblks, dtype=np.float64)

    def split_all(block: AmrBlock) -> List[AmrBlock]:
        block.node_type = 2
        half = (block.bounds[:, 1] - block.bounds[:, 0]) / 2.0
        children = []
        for ck in range(2):
            for cj in range(2):
                for ci in range(2):
                    lb = block.bounds[:, 0] + half * np.array([ci, cj, ck], dtype=np.float64)
                    child = AmrBlock(
                        level=block.level + 1,
                        bounds=np.stack([lb, lb + half], axis=1),
                        node_type=1,
                    )
                    blocks.append(child)
                    children.append(child)
        return children

    def split(block: AmrBlock, depth_left: int) -> None:
        first_child = split_all(block)[0]
        if depth_left > 1:
            split(first_child, depth_left - 1)

    roots: List[AmrBlock] = []
    for bk in range(nblks[2]):
        for bj in range(nblks[1]):
            for bi in range(nblks[0]):
                lb = domain[:, 0] + widths * np.array([bi, bj, bk], dtype=np.float64)
                root = AmrBlock(level=1, bounds=np.stack([lb, lb + widths], axis=1), node_type=1)
                blocks.append(root)
                roots.append(root)

    for root_idx, depth in refine.items():
        if depth >= 2:
            split(roots[root_idx], depth - 1)

    if refine_fn is not None:
        queue = [b for b in blocks if b.node_type == 1]
        while queue:
            b = queue.pop()
            if b.level < int(refine_fn(b.bounds, b.level)):
                queue.extend(split_all(b))

    return blocks


def _cell_centers(bounds: np.ndarray, ncells: Tuple[int, int, int]):
    coords = []
    for axis in range(3):
        lo, hi = bounds[axis]
        dx = (hi - lo) / ncells[axis]
        coords.append(lo + (np.arange(ncells[axis]) + 0.5) * dx)
    return np.meshgrid(*coords, indexing="ij")


def _scalars_and_params(
    *,
    ncells: Tuple[int, int, int],
    nblks: Tuple[int, int, int],
    nblocks: int,
    domain: np.ndarray,
    time: float,
    ndim: int = 3,
) -> Tuple[dict, dict]:
    scalars = {
        "real": {"time": float(time), "dt": 1.0e-3},
        "integer": {
            "dimensionality": int(ndim),
            "nxb": ncells[0],
            "nyb": ncells[1],
            "nzb": ncells[2],
            "iprocs": 1,
            "jprocs": 1,
            "kprocs": 1,
            "globalnumblocks": nblocks,
        },
        "logical": {},
        "string": {"geometry": "cartesian"},
    }
    runtime = {
        "real": {
            "xmin": float(domain[0, 0]),
            "xmax": float(domain[0, 1]),
            "ymin": float(domain[1, 0]),
            "ymax": float(domain[1, 1]),
            "zmin": float(domain[2, 0]),
            "zmax": float(domain[2, 1]),
        },
        "integer": {"nblockx": nblks[0], "nblocky": nblks[1], "nblockz": nblks[2]},
        "logical": {},
        "string": {},
    }
    return scalars, runtime


def amr_snapshot(
    *,
    ncells: Tuple[int, int, int] = (8, 8, 8),
    nblks: Tuple[int, int, int] = (2, 2, 2),
    domain: Optional[np.ndarray] = None,
    refine: Optional[Dict[int, int]] = None,
    refine_fn: Optional[Callable[[np.ndarray, int], int]] = None,
    fields: Sequence[str] = DEFAULT_FIELDS,
    field_fns: Optional[Dict[str, Callable]] = None,
    time: float = 0.0,
) -> Dict[str, Any]:
    """In-memory synthetic AMR snapshot: the scalars, runtime parameters,
    block metadata and (nB, *ncells) field stacks that
    :func:`make_amr_file` writes.

    ``refine_fn`` region-refines the tree (see :func:`build_amr_tree`);
    ``field_fns`` overrides :func:`default_field_fn` per field name so a
    series of snapshots can carry time-dependent structure (a moving
    flame, a translating turbulent brush)."""
    domain = (
        np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]], dtype=np.float64)
        if domain is None
        else np.asarray(domain, dtype=np.float64)
    )
    blocks = build_amr_tree(tuple(nblks), domain, refine, refine_fn=refine_fn)
    nblocks = len(blocks)

    bounding_box = np.stack([b.bounds for b in blocks])  # (nB, 3, 2)
    metadata = {
        "coordinates": bounding_box.mean(axis=2),
        "block size": bounding_box[..., 1] - bounding_box[..., 0],
        "bounding box": bounding_box,
        "node type": np.array([b.node_type for b in blocks], dtype=np.int32),
        "refine level": np.array([b.level for b in blocks], dtype=np.int32),
        "gid": -np.ones((nblocks, 15), dtype=np.int32),
        "which child": -np.ones(nblocks, dtype=np.int32),
        "bflags": -np.ones((nblocks, 1), dtype=np.int32),
        "processor number": np.zeros(nblocks, dtype=np.int32),
    }

    field_data: Dict[str, np.ndarray] = {}
    for name in fields:
        fn = (field_fns or {}).get(name) or default_field_fn(name)
        data = np.empty((nblocks, *ncells), dtype=np.float64)
        for lb, b in enumerate(blocks):
            X, Y, Z = _cell_centers(b.bounds, tuple(ncells))
            data[lb] = fn(X, Y, Z)
        field_data[name] = data

    scalars, runtime = _scalars_and_params(
        ncells=tuple(ncells), nblks=tuple(nblks), nblocks=nblocks, domain=domain, time=time
    )
    return {
        "scalars": scalars,
        "runtime_parameters": runtime,
        "metadata": metadata,
        "fields": field_data,
    }


def make_amr_file(path: str | Path, *, chk_file: Optional[bool] = None, **kwargs) -> Path:
    """Write a synthetic FLASH AMR plt/chk file with analytic field data
    (keyword arguments as :func:`amr_snapshot`)."""
    path = Path(path)
    if chk_file is None:
        chk_file = "chk" in path.stem
    snap = amr_snapshot(**kwargs)
    flash_file.write_mesh_file(
        path,
        scalars=snap["scalars"],
        runtime_parameters=snap["runtime_parameters"],
        metadata=snap["metadata"],
        fields=snap["fields"],
        chk_file=chk_file,
    )
    return path


def uniform_field_data(
    ncells: Tuple[int, int, int],
    *,
    fields: Sequence[str] = DEFAULT_FIELDS,
    seed: Optional[int] = None,
    domain: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """The analytic float64 volumes :func:`make_uniform_file` writes;
    with ``seed`` set, a reproducible random perturbation is added."""
    bounds = (
        np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]], dtype=np.float64)
        if domain is None
        else np.asarray(domain, dtype=np.float64)
    )
    rng = np.random.default_rng(seed) if seed is not None else None
    X, Y, Z = _cell_centers(bounds, tuple(ncells))
    field_data = {}
    for name in fields:
        data = default_field_fn(name)(X, Y, Z)
        if rng is not None:
            data = data + 0.05 * rng.standard_normal(size=data.shape)
        if name == "dens":
            data = np.abs(data) + 0.1
        field_data[name] = data
    return field_data


def make_uniform_file(
    path: str | Path,
    *,
    ncells: Tuple[int, int, int] = (16, 16, 16),
    domain: Optional[np.ndarray] = None,
    fields: Sequence[str] = DEFAULT_FIELDS,
    field_data: Optional[Dict[str, np.ndarray]] = None,
    time: float = 0.0,
    seed: Optional[int] = None,
    ndim: int = 3,
) -> Path:
    """Write a synthetic single-block FLASH uniform-grid file.

    ``field_data`` overrides the analytic fields; with ``seed`` set, a
    reproducible random perturbation is added (useful for spectra).
    2D datasets use ncells=(nx, ny, 1) with ndim=2.
    """
    path = Path(path)
    domain = (
        np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]], dtype=np.float64)
        if domain is None
        else np.asarray(domain, dtype=np.float64)
    )
    ncells = tuple(ncells)

    bounds = domain.copy()
    if field_data is None:
        field_data = uniform_field_data(ncells, fields=fields, seed=seed, domain=domain)
    else:
        field_data = {k: np.asarray(v, dtype=np.float64) for k, v in field_data.items()}

    scalars, runtime = _scalars_and_params(
        ncells=ncells, nblks=(1, 1, 1), nblocks=1, domain=domain, time=time, ndim=ndim
    )

    bounding_box = bounds[None, ...]
    flash_file.write_mesh_file(
        path,
        scalars=scalars,
        runtime_parameters=runtime,
        metadata={
            "coordinates": bounding_box.mean(axis=2),
            "block size": (bounding_box[..., 1] - bounding_box[..., 0]),
            "bounding box": bounding_box,
            "node type": np.ones(1, dtype=np.int32),
            "refine level": np.ones(1, dtype=np.int32),
            "gid": -np.ones((1, 15), dtype=np.int32),
            "which child": -np.ones(1, dtype=np.int32),
            "bflags": -np.ones((1, 1), dtype=np.int32),
        },
        fields=field_data,
        chk_file=False,
    )
    return path


def make_particle_file(
    path: str | Path,
    *,
    nparticles: int = 64,
    fields: Sequence[str] = ("tag", "posx", "posy", "posz", "velx", "vely", "velz", "dens"),
    time: float = 0.0,
    seed: int = 0,
) -> Path:
    """Write a synthetic FLASH tracer-particle file."""
    path = Path(path)
    rng = np.random.default_rng(seed)
    particles: Dict[str, np.ndarray] = {}
    tags = rng.permutation(nparticles).astype(np.float64) + 1.0
    for name in fields:
        if name == "tag":
            particles[name] = tags
        elif name.startswith("pos"):
            particles[name] = rng.uniform(0.0, 1.0, nparticles)
        else:
            particles[name] = rng.standard_normal(nparticles)

    flash_file.write_particle_file(
        path,
        int_scalars={"dimensionality": 3, "globalnumparticles": nparticles},
        real_scalars={"time": float(time), "dt": 1.0e-3, "dtold": 1.0e-3},
        particles=particles,
    )
    return path


# ---------------------------------------------------------------------------
# Flame-band AMR catalog: a moving rtflame-style front

FLAME_TIMES = (0.0, 0.25, 0.5)
FLAME_X0, FLAME_SPEED = 0.9, 0.4  # flame front: x_f(t) = X0 + SPEED * t
FLAME_HALF_WIDTH = 0.5  # the extracted window is 2 * 0.5 = 1.0 wide


def flame_front(t: float) -> float:
    return FLAME_X0 + FLAME_SPEED * t


def flame_field_fns(t: float) -> Dict[str, Callable]:
    """Analytic snapshot at time t: sigmoid flame at x_f(t), with a
    turbulent brush whose amplitude peaks on the front (so the
    Reynolds-stress transverse profile the pipeline's window fit
    consumes is a smooth bump riding the flame)."""
    from scipy.special import expit

    xf = flame_front(t)

    def flam(x, y, z):
        return expit(-(x - xf) / 0.02)

    def amp(x):
        return 0.2 + np.exp(-(((x - xf) / 0.15) ** 2))

    def dens(x, y, z):
        return 1.0 + 0.5 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y) + 0.6 * flam(x, y, z)

    def temp(x, y, z):
        return 1.0 + 2.0 * flam(x, y, z)

    def velx(x, y, z):
        return amp(x) * 0.5 * np.sin(2 * np.pi * y) * np.cos(2 * np.pi * z)

    def vely(x, y, z):
        return amp(x) * np.sin(2 * np.pi * z + 0.5 * np.cos(2 * np.pi * x))

    def velz(x, y, z):
        return amp(x) * np.cos(2 * np.pi * y + 0.3 * np.sin(2 * np.pi * x))

    return {"flam": flam, "dens": dens, "temp": temp, "velx": velx, "vely": vely, "velz": velz}


def flame_snapshot_kwargs(n: int = 512, block_cells: int = 32, t: float = 0.0) -> Dict[str, Any]:
    """:func:`amr_snapshot` / :func:`make_amr_file` arguments for the
    flame-band snapshot at time ``t`` whose refined band regrids to an
    ``n``^3 window.

    Domain [0,4]x[0,1]^2 with 8x2x2 root blocks 0.5 wide of
    ``block_cells``^3 cells; blocks within the window half width of the
    front are refined to the level whose cell width is 1/n (4 levels at
    n=512 with 32^3 blocks), so the band tracks the front across
    snapshots like a production AMR run regrids."""
    ratio = n / (2 * block_cells)
    level = int(np.log2(ratio)) + 1
    if level < 1 or 2 ** (level - 1) != ratio:
        raise ValueError(f"n={n} must be 2 * block_cells * 2^k, got block_cells={block_cells}")
    xf = flame_front(t)

    def refine_fn(bounds, lvl):
        near = bounds[0, 1] > xf - FLAME_HALF_WIDTH and bounds[0, 0] < xf + FLAME_HALF_WIDTH
        return level if near else 1

    return {
        "ncells": (block_cells,) * 3,
        "nblks": (8, 2, 2),
        "domain": np.array([[0.0, 4.0], [0.0, 1.0], [0.0, 1.0]]),
        "refine_fn": refine_fn,
        "fields": ("flam", "dens", "temp", "velx", "vely", "velz"),
        "field_fns": flame_field_fns(t),
        "time": t,
    }


def make_flame_catalog(
    data_dir: str | Path,
    n: int = 512,
    block_cells: int = 32,
    times: Sequence[float] = FLAME_TIMES,
) -> List[Path]:
    """Write the plt series of :func:`flame_snapshot_kwargs` snapshots."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    return [
        make_amr_file(
            data_dir / f"rt_hdf5_plt_cnt_{i:04d}", **flame_snapshot_kwargs(n, block_cells, t)
        )
        for i, t in enumerate(times, start=1)
    ]
