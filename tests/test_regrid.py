"""AMR->uniform regrid vs the per-cell mapping oracle."""

import numpy as np
import pytest

import fava_tpu
from fava_tpu.mesh import FLASH as FlashAMR
from fava_tpu.mesh import FlashUniform
from tests.oracles.regrid import from_amr_oracle


@pytest.fixture()
def amr_mesh(tmp_path):
    from fava_tpu.io import synthetic

    path = tmp_path / "rt_hdf5_plt_cnt_0001"
    synthetic.make_amr_file(path, ncells=(4, 4, 4), nblks=(2, 2, 2), refine={0: 2, 5: 3})
    mesh = FlashAMR(path)
    mesh.load()
    mesh.load_data(["dens", "velx"])
    return mesh


def _oracle(mesh, **kwargs):
    data = {k: mesh.host_data(k) for k in ("dens", "velx")}
    return from_amr_oracle(
        data,
        block_bounds=np.asarray(mesh.block_bounds),
        node_type=np.asarray(mesh.node_type),
        refine_level=np.asarray(mesh.refine_level).astype(int),
        ncells=mesh.nCellsVec,
        nblks=mesh.nBlksVec,
        ndim=3,
        fields=["dens", "velx"],
        **kwargs,
    )


def test_full_domain_regrid_matches_oracle(amr_mesh):
    expected, total = _oracle(amr_mesh)
    amr_mesh.from_amr(fields=["dens", "velx"], save_file=False)
    assert tuple(amr_mesh.nCellsVec) == tuple(total)
    for key in ("dens", "velx"):
        np.testing.assert_allclose(
            np.asarray(amr_mesh._data[key]), expected[key], rtol=1e-12, err_msg=key
        )


def test_subdomain_regrid_matches_oracle(amr_mesh):
    sub = np.array([[0.25, 0.75], [0.25, 0.75], [0.25, 0.75]])
    expected, total = _oracle(amr_mesh, subdomain_coords=sub)
    amr_mesh.from_amr(subdomain_coords=sub, fields=["dens", "velx"], save_file=False)
    assert tuple(amr_mesh.nCellsVec) == tuple(total)
    for key in ("dens", "velx"):
        np.testing.assert_allclose(
            np.asarray(amr_mesh._data[key]), expected[key], rtol=1e-12, err_msg=key
        )
    # Collapsed mesh bounds equal the (BCID-snapped) subdomain box.
    np.testing.assert_allclose(amr_mesh.xmin, 0.25, atol=1e-12)
    np.testing.assert_allclose(amr_mesh.xmax, 0.75, atol=1e-12)


def test_subdomain_with_zero_touching_rows_still_crops(amr_mesh):
    """Reference sentinel (_flash.py:965): the subdomain is disabled only
    when EVERY row touches zero. The pipeline's flame window uses
    transverse bounds [0, 1] — those rows touching 0.0 must not silently
    expand the regrid to the whole domain (the r4 all() bug OOMed the
    512^3 on-chip pipeline with a 2048x512x512 full-domain regrid)."""
    sub = np.array([[0.25, 0.75], [0.0, 1.0], [0.0, 1.0]])
    expected, total = _oracle(amr_mesh, subdomain_coords=sub)
    amr_mesh.from_amr(subdomain_coords=sub, fields=["dens", "velx"], save_file=False)
    assert tuple(amr_mesh.nCellsVec) == tuple(total)
    assert amr_mesh.nCellsVec[0] < amr_mesh.nCellsVec[1]  # x actually cropped
    for key in ("dens", "velx"):
        np.testing.assert_allclose(
            np.asarray(amr_mesh._data[key]), expected[key], rtol=1e-12, err_msg=key
        )
    np.testing.assert_allclose(amr_mesh.xmin, 0.25, atol=1e-12)
    np.testing.assert_allclose(amr_mesh.xmax, 0.75, atol=1e-12)


def test_all_zero_touching_rows_is_full_domain_sentinel(amr_mesh):
    """A box whose every row touches zero reads as "no subdomain"
    (the reference's whole-domain sentinel)."""
    sub = np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]])
    expected, total = _oracle(amr_mesh)  # oracle without subdomain
    amr_mesh.from_amr(subdomain_coords=sub, fields=["dens"], save_file=False)
    assert tuple(amr_mesh.nCellsVec) == tuple(total)
    np.testing.assert_allclose(np.asarray(amr_mesh._data["dens"]), expected["dens"], rtol=1e-12)


def test_refine_level_truncation_matches_oracle(amr_mesh):
    # Regrid to level 2: level-3 children excluded, their level-2 parent used.
    expected, total = _oracle(amr_mesh, refine_to=2)
    amr_mesh.from_amr(refine_level=2, fields=["dens", "velx"], save_file=False)
    assert tuple(amr_mesh.nCellsVec) == tuple(total)
    for key in ("dens", "velx"):
        np.testing.assert_allclose(
            np.asarray(amr_mesh._data[key]), expected[key], rtol=1e-12, err_msg=key
        )


def test_from_amr_writes_loadable_uniform_file(amr_mesh, tmp_path):
    out = tmp_path / "rt_hdf5_uniform_0001"
    amr_mesh.from_amr(fields=["dens", "velx"], filename=out)
    assert out.is_file()

    uni = FlashUniform(out)
    uni.load()
    assert tuple(uni.nCellsVec) == tuple(amr_mesh.nCellsVec)
    # plt-derived uniform files are float32 on disk.
    np.testing.assert_allclose(
        np.asarray(uni.data("dens")), np.asarray(amr_mesh._data["dens"]), rtol=1e-6
    )


def test_subdomain_outside_domain_is_noop(amr_mesh):
    before = amr_mesh.nblocks
    sub = np.array([[-0.5, 0.5], [0.25, 0.75], [0.25, 0.75]])
    amr_mesh.from_amr(subdomain_coords=sub, fields=["dens"], save_file=False)
    assert amr_mesh.nblocks == before  # untouched, mirrors reference early-return


def test_regrid_sharded_matches(amr_mesh, eight_device_mesh):
    from fava_tpu.parallel import volume_sharding

    expected, _ = _oracle(amr_mesh)
    sharding = volume_sharding(eight_device_mesh, axis=0, ndim=3)
    amr_mesh.from_amr(fields=["dens"], save_file=False, sharding=sharding)
    np.testing.assert_allclose(np.asarray(amr_mesh._data["dens"]), expected["dens"], rtol=1e-12)


def test_regrid_sharded_subdomain_matches_oracle(amr_mesh, eight_device_mesh):
    """Sharded regrid with a subdomain crop: the output origin is
    nonzero, the extent still divides the space axis (16/8), and values
    match the per-cell oracle."""
    from fava_tpu.parallel import use_mesh

    sub = np.array([[0.25, 0.75], [0.25, 0.75], [0.25, 0.75]])
    expected, total = _oracle(amr_mesh, subdomain_coords=sub)
    assert total[0] % 8 == 0  # crop keeps the sharded path eligible

    with use_mesh(eight_device_mesh):
        amr_mesh.from_amr(subdomain_coords=sub, fields=["dens", "velx"], save_file=False)
    for key in ("dens", "velx"):
        got = amr_mesh._data[key]
        assert len(got.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(got), expected[key], rtol=1e-12, err_msg=key)


def test_regrid_nondivisible_falls_back_with_warning(
    tmp_path, eight_device_mesh, caplog
):
    """Output x extent not divisible by the space axis: from_amr must
    fall back to the replicated single-chip gather, SAY so in the log,
    and still match the oracle."""
    import logging

    from fava_tpu.io import synthetic
    from fava_tpu.parallel import use_mesh

    path = tmp_path / "rt_hdf5_plt_cnt_0002"
    # lmax=1, ncx=4, nbx=1 -> nx = 4, not divisible by 8 devices.
    synthetic.make_amr_file(path, ncells=(4, 4, 4), nblks=(1, 1, 1))
    mesh = FlashAMR(path)
    mesh.load()
    mesh.load_data(["dens"])
    data = {"dens": mesh.host_data("dens")}
    from tests.oracles.regrid import from_amr_oracle

    expected, total = from_amr_oracle(
        data,
        block_bounds=np.asarray(mesh.block_bounds),
        node_type=np.asarray(mesh.node_type),
        refine_level=np.asarray(mesh.refine_level).astype(int),
        ncells=mesh.nCellsVec,
        nblks=mesh.nBlksVec,
        ndim=3,
        fields=["dens"],
    )
    assert total[0] % 8 != 0

    with caplog.at_level(logging.WARNING, logger="fava_tpu.mesh.flash_amr"):
        with use_mesh(eight_device_mesh):
            mesh.from_amr(fields=["dens"], save_file=False)
    assert any("falling back" in r.message for r in caplog.records)
    np.testing.assert_allclose(np.asarray(mesh._data["dens"]), expected["dens"], rtol=1e-12)


def test_sharded_plan_rejects_nondividing_extent(amr_mesh):
    """Direct ShardedRegridPlan use with a non-dividing space axis must
    raise a named error: under ``python -O`` a bare assert strips and
    the integer division silently truncates into a wrong block
    distribution. (from_amr itself checks eligibility and falls back —
    test_regrid_nondivisible_falls_back_with_warning.)"""
    from fava_tpu.ops.regrid import RegridPlan, ShardedRegridPlan

    plan = RegridPlan(
        block_bounds=np.asarray(amr_mesh.block_bounds),
        node_type=np.asarray(amr_mesh.node_type),
        refine_level=np.asarray(amr_mesh.refine_level),
        ncells_vec=amr_mesh.nCellsVec,
        nblks_vec=amr_mesh.nBlksVec,
        ndim=3,
    )
    assert plan.out_shape[0] % 5 != 0  # fixture geometry sanity
    with pytest.raises(ValueError, match=r"space axis \(5\) to divide the output x extent"):
        ShardedRegridPlan(plan, 5)


def test_regrid_mesh_active_distributes_input_blocks(amr_mesh, eight_device_mesh):
    """With an active mesh, from_amr must pool HBM: the source stack is
    distributed as per-device block subsets (each strictly smaller than
    the full stack), the output is x-slab-sharded, and values match the
    per-cell oracle."""
    from fava_tpu.ops.regrid import RegridPlan, ShardedRegridPlan
    from fava_tpu.parallel import use_mesh

    expected, _ = _oracle(amr_mesh)

    plan = RegridPlan(
        block_bounds=np.asarray(amr_mesh.block_bounds),
        node_type=np.asarray(amr_mesh.node_type),
        refine_level=np.asarray(amr_mesh.refine_level),
        ncells_vec=amr_mesh.nCellsVec,
        nblks_vec=amr_mesh.nBlksVec,
        ndim=3,
    )
    splan = ShardedRegridPlan(plan, 8)
    # HBM pooling: every device holds fewer blocks than the full stack.
    assert splan.bmax < len(plan.block_scales)
    # Every output slab's sources are covered by its device list.
    for d in range(8):
        needed = set(splan.block_ids[d].tolist())
        assert needed <= set(range(len(plan.block_scales)))

    with use_mesh(eight_device_mesh):
        amr_mesh.from_amr(fields=["dens", "velx"], save_file=False)
    for key in ("dens", "velx"):
        got = amr_mesh._data[key]
        # Output is sharded over the space axis (not fully replicated).
        assert len(got.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(got), expected[key], rtol=1e-12)


@pytest.mark.parametrize(
    "ncells,refine,plan_kwargs",
    [
        ((8, 8, 8), {0: 2, 5: 3}, {}),  # power-of-two blocks, full domain
        ((8, 8, 8), {0: 2, 5: 3}, {"subdomain_coords": np.array([[0.3, 0.8], [0.25, 0.75], [0.2, 0.7]])}),
        ((8, 8, 8), {1: 3}, {"refine_to": 2}),  # refinement truncated below the finest level
        ((6, 12, 10), {0: 2}, {}),  # non-power-of-two, unequal block extents
    ],
    ids=["pow2_full", "pow2_subdomain", "refine_truncation", "non_pow2"],
)
def test_regrid_fields_gather_matches_oracle(ncells, refine, plan_kwargs):
    """The XLA gather regrid of in-memory block stacks is an exact copy
    of the oracle's per-cell mapping."""
    import jax

    from fava_tpu.io import synthetic
    from fava_tpu.ops import regrid as regrid_ops

    snap = synthetic.amr_snapshot(ncells=ncells, nblks=(2, 2, 2), refine=refine)
    meta = snap["metadata"]
    names = ["dens", "velx"]
    stacks = {k: snap["fields"][k] for k in names}
    plan = regrid_ops.RegridPlan(
        block_bounds=meta["bounding box"],
        node_type=meta["node type"],
        refine_level=meta["refine level"],
        ncells_vec=np.array(ncells),
        nblks_vec=np.array([2, 2, 2]),
        ndim=3,
        **plan_kwargs,
    )
    got = regrid_ops.regrid_fields(plan, {k: jax.device_put(v) for k, v in stacks.items()}, names)
    expected, total = from_amr_oracle(
        stacks,
        block_bounds=meta["bounding box"],
        node_type=meta["node type"],
        refine_level=meta["refine level"].astype(int),
        ncells=np.array(ncells),
        nblks=np.array([2, 2, 2]),
        fields=names,
        **plan_kwargs,
    )
    for key in names:
        assert got[key].shape == tuple(int(t) for t in total)
        np.testing.assert_array_equal(np.asarray(got[key]), expected[key], err_msg=key)
