"""End-to-end pipeline CLI: stages, checkpoint/resume, outputs."""

import json

import h5py
import numpy as np
import pytest

from fava_tpu.io import synthetic
from fava_tpu.pipeline import PIPELINE_CHECKPOINT_NAME, Pipeline, main


@pytest.fixture()
def pipeline_dir(tmp_path):
    data = tmp_path / "data"
    out = tmp_path / "out"
    data.mkdir()
    out.mkdir()
    for i, t in enumerate([0.0, 0.1], start=1):
        synthetic.make_amr_file(
            data / f"rt_hdf5_plt_cnt_{i:04d}",
            ncells=(4, 4, 4),
            nblks=(2, 2, 2),
            refine={0: 2},
            time=t,
        )

    settings = {
        "data folder": str(data),
        "output folder": str(out),
        "basename": "rt_hdf5_plt_cnt",
        "dimension": 3,
        "model": "synthetic",
        "reynolds stress": {"skip": False},
        "extract windows": {"skip": False},
        # Transverse bounds touching 0.0 on purpose: the reference's
        # subdomain sentinel (_flash.py:965) must still crop when any
        # row lacks a zero (regression for the r4 all() bug that
        # regridded the whole domain in the on-chip pipeline).
        "flame window": {"half width": 0.25, "transverse": [0.0, 1.0]},
        "fractal dimension": {"skip": False, "settings": {"field": "flam", "contours": 0.5}},
        "kinetic energy spectra": {"skip": False},
        "structure functions": {
            "skip": False,
            "settings": {"num_seps": 4, "num_points": 32, "sep_bounds": [0.05, 0.3]},
        },
    }
    with (tmp_path / "pipeline_settings.json").open("w") as f:
        json.dump(settings, f)
    return tmp_path, data, out


def test_full_pipeline_run(pipeline_dir):
    workdir, data, out = pipeline_dir
    assert main(workdir) == 0

    anl = sorted(out.glob("*hdf5_analysis_*"))
    uni = sorted(out.glob("*hdf5_uniform_*"))
    assert len(anl) == 2
    assert len(uni) >= 1

    # The extracted window must be the flame window, not the whole
    # domain: x is cropped to 2*half_width (= half the domain), the
    # transverse axes keep their full [0, 1] extent.
    from fava_tpu.mesh import FlashUniform

    um = FlashUniform(uni[0])
    um.load()
    assert um.nCellsVec[0] * 2 == um.nCellsVec[1] == um.nCellsVec[2]

    with h5py.File(anl[0], "r") as f:
        assert "reynolds stresses" in f
        assert "scalars" in f
        assert "window right" in f["scalars"]

    # Uniform analyses were appended to the uniform-file's analysis output.
    with h5py.File(anl[0], "r") as f:
        keys = set(f.keys())
    uni_anl = [p for p in anl if True]
    found = False
    for p in anl:
        with h5py.File(p, "r") as f:
            if "kinetic energy spectra" in f:
                found = True
    assert found

    ckpt = workdir / PIPELINE_CHECKPOINT_NAME
    assert ckpt.is_file()
    state = json.loads(ckpt.read_text())
    assert state["reynolds stress"]["index"] == 2


def test_snap_window_axis0_kills_bcid_tie_wobble():
    """A fit-centered window puts both x bounds exactly on the BCID
    rounding tie int32(0.5 + k + 0.5); 1-ulp noise then decides each end
    independently (a 3-snapshot series extracted 512, 511, 512 wide
    windows — each width wobble recompiles every stage-4 program). The snap must give the exact cell count for every
    tie-landing window, invariant to ulp-scale noise."""
    from fava_tpu.pipeline.pipeline import snap_window_axis0

    delta = 1.0 / 512.0
    dom = np.array([[0.0, 4.0], [0.0, 1.0], [0.0, 1.0]])

    def bcid_width(coords):
        b = (0.5 + (np.asarray(coords[0]) - dom[0, 0]) / delta).astype(np.int32)
        return int(b[1] - b[0])

    rng = np.random.default_rng(11)
    for _ in range(200):
        # Flame centroid on a random cell center -> bounds on half-edges.
        k = int(rng.integers(260, 1780))
        xf = (k + 0.5) * delta
        eps = rng.uniform(-1e-12, 1e-12, size=2)
        sub = np.array(
            [[xf - 0.5 + eps[0], xf + 0.5 + eps[1]], [0.0, 1.0], [0.0, 1.0]]
        )
        snapped = snap_window_axis0(sub, dom, delta)
        assert bcid_width(snapped) == 512
        # Center preserved to within one cell of the request.
        assert abs(0.5 * (snapped[0, 0] + snapped[0, 1]) - xf) <= delta
        # Transverse rows untouched; x row never contains 0.0 (sentinel).
        np.testing.assert_array_equal(snapped[1:], sub[1:])
        assert 0.0 not in snapped[0]


def test_snap_window_axis0_clamps_to_domain():
    from fava_tpu.pipeline.pipeline import snap_window_axis0

    delta = 1.0 / 64.0
    dom = np.array([[0.0, 2.0], [0.0, 1.0], [0.0, 1.0]])

    def bcids(coords):
        return (0.5 + (np.asarray(coords[0]) - dom[0, 0]) / delta).astype(np.int32)

    # Window drifted past the left edge: snapped flush to index 0.
    sub = np.array([[-0.3, 0.7], [0.0, 1.0], [0.0, 1.0]])
    lo, hi = bcids(snap_window_axis0(sub, dom, delta))
    assert lo == 0 and hi == 64

    # Window wider than the domain: clamped to the whole axis.
    sub = np.array([[-1.0, 9.0], [0.0, 1.0], [0.0, 1.0]])
    lo, hi = bcids(snap_window_axis0(sub, dom, delta))
    assert lo == 0 and hi == 128


def test_pipeline_resume_skips_done_work(pipeline_dir):
    workdir, data, out = pipeline_dir
    assert main(workdir) == 0
    mtimes = {p.name: p.stat().st_mtime_ns for p in out.glob("*hdf5_uniform_*")}

    # Second run must be a no-op for extraction (files exist + checkpoint).
    assert main(workdir) == 0
    for p in out.glob("*hdf5_uniform_*"):
        assert p.stat().st_mtime_ns == mtimes[p.name]


def test_pipeline_optional_analyses(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings["favre profiles"] = {"skip": False}
    settings["pdf1d"] = {"skip": False, "settings": {"field": "dens", "nbins": 16}}
    settings["density pdf"] = {"skip": False, "settings": {"nbins": 16, "mach": 1.5}}
    settings["two point correlation"] = {"skip": False, "settings": {"field": "dens"}}
    settings["velocity correlations"] = {"skip": False}
    settings["projection"] = {"skip": False, "settings": {"field": "dens", "axis": 0}}
    settings["scalar spectra"] = {"skip": False, "settings": {"field": "dens"}}
    settings["enstrophy spectra"] = {"skip": False}
    settings["helicity spectra"] = {"skip": False}
    settings["transfer spectra"] = {"skip": False}
    settings["decomposed spectra"] = {"skip": False, "settings": {"weighted": True}}
    settings["anisotropic spectra"] = {"skip": False, "settings": {"axis": 0}}
    settings["flame surface"] = {"skip": False, "settings": {"field": "flam"}}
    settings["turbulence summary"] = {"skip": False}
    settings["velocity gradient statistics"] = {"skip": False}
    settings["gradient invariant pdfs"] = {"skip": False, "settings": {"nbins": [16, 16]}}
    settings["filtered ke flux"] = {"skip": False, "settings": {"cutoffs": [2.0, 4.0]}}
    settings["structure function exponents"] = {
        "skip": False,
        "settings": {"num_seps": 4, "num_points": 32, "sep_bounds": [0.05, 0.3]},
    }
    settings_path.write_text(json.dumps(settings))

    assert main(workdir) == 0
    anl = sorted(out.glob("*hdf5_analysis_*"))
    found_favre = found_pdf = found_sspec = found_dpdf = found_tpc = found_vc = found_proj = False
    found_ens = found_hel = found_tr = found_cg = found_ex = found_dec = found_an = found_fs = found_ts = False
    found_vg = found_qr = False
    for p in anl:
        with h5py.File(p, "r") as f:
            found_favre |= "favre profiles" in f
            found_pdf |= "pdf1d" in f
            found_dpdf = found_dpdf or "density pdf" in f
            found_tpc = found_tpc or "two point correlation" in f
            found_vc = found_vc or "velocity correlations" in f
            found_proj = found_proj or "projection" in f
            found_sspec |= "scalar spectra" in f
            found_ens |= "enstrophy spectra" in f
            found_hel |= "helicity spectra" in f
            found_tr |= "transfer spectra" in f
            found_dec |= "decomposed spectra" in f
            found_an |= "anisotropic spectra" in f
            found_fs |= "flame surface" in f
            found_ts |= "turbulence summary" in f
            found_vg |= "velocity gradient statistics" in f
            if "gradient invariant pdfs" in f:
                assert f["gradient invariant pdfs"]["counts"].shape == (16, 16)
                found_qr = True
            found_cg |= "filtered ke flux" in f
            found_ex |= "structure function exponents" in f
    assert found_favre and found_pdf and found_sspec and found_dpdf and found_tpc and found_vc and found_proj
    assert found_ens and found_hel and found_tr and found_cg and found_ex and found_dec and found_an and found_fs and found_ts
    assert found_vg and found_qr


def test_shipped_settings_template_runs(pipeline_dir):
    """The shipped pipeline_settings.json is a working template: only
    folders/basename and physical scales need editing for a new dataset."""
    from pathlib import Path

    import fava_tpu.pipeline as pipeline_pkg

    workdir, data, out = pipeline_dir
    shipped = Path(pipeline_pkg.__file__).parent / "pipeline_settings.json"
    settings = json.loads(shipped.read_text())

    # Dataset-specific edits a user would make (paths + physical scales).
    settings["data folder"] = str(data)
    settings["output folder"] = str(out)
    settings["basename"] = "rt_hdf5_plt_cnt"
    settings["model"] = "synthetic"
    settings["flame window"] = {"half width": 0.25, "transverse": [0.25, 0.75]}
    settings["structure functions"]["settings"].update(
        {"num_seps": 4, "num_points": 32, "sep_bounds": [0.05, 0.3]}
    )
    (workdir / "pipeline_settings.json").write_text(json.dumps(settings))

    assert main(workdir) == 0
    anl = sorted(out.glob("*hdf5_analysis_*"))
    assert anl
    found_favre = False
    for p in anl:
        with h5py.File(p, "r") as f:
            found_favre |= "favre profiles" in f
    assert found_favre  # shipped template enables the favre extension


def test_pipeline_skip_flags(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings["reynolds stress"]["skip"] = True
    settings["extract windows"]["skip"] = True
    settings_path.write_text(json.dumps(settings))

    pipe = Pipeline(workdir)
    pipe.restart()
    assert pipe.settings["reynolds stress"]["skip"] is True


def test_flagship_series_matches_per_snapshot(tmp_path):
    """flagship_series (batched lax.scan dispatches, including a short
    final batch) must equal per-snapshot flagship_analysis."""
    from fava_tpu.io import synthetic
    import fava_tpu

    for i in (1, 2, 3):
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_000{i}", ncells=(16, 16, 16), seed=10 + i
        )
    m = fava_tpu.FLASH(tmp_path)

    series = m.flagship_series(batch=2)  # batches of 2 + final batch of 1
    assert series["times"].shape == (3,)

    for j in (0, 1, 2):
        m.load(file_type="uni", file_index=j)
        single = m.flagship_analysis()
        for key, val in single.items():
            np.testing.assert_allclose(
                series[key][j], np.asarray(val), rtol=1e-12, atol=1e-13, err_msg=key
            )


def test_flagship_series_oom_fallback(tmp_path, monkeypatch):
    """A RESOURCE_EXHAUSTED batch halves and retries (the cap sticks
    for the rest of the series), and the results still match the
    per-snapshot analysis — no raw OOM reaches the caller."""
    from fava_tpu import flagship
    from fava_tpu.io import synthetic
    import fava_tpu

    for i in (1, 2, 3):
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_000{i}", ncells=(16, 16, 16), seed=20 + i
        )
    m = fava_tpu.FLASH(tmp_path)

    real_step = flagship.jitted_series_step()
    calls = []

    def flaky_step(*stacked):
        calls.append(stacked[0].shape[0])
        if stacked[0].shape[0] > 1:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of device memory (simulated)")
        return real_step(*stacked)

    monkeypatch.setattr(flagship, "jitted_series_step", lambda: flaky_step)
    series = m.flagship_series(batch=3)
    # batch 3 OOMs -> halves to 2 -> OOMs -> singles; cap sticks at 1
    assert calls == [3, 2, 1, 1, 1]
    assert series["times"].shape == (3,)
    for j in (0, 1, 2):
        m.load(file_type="uni", file_index=j)
        single = m.flagship_analysis()
        for key, val in single.items():
            np.testing.assert_allclose(
                series[key][j], np.asarray(val), rtol=1e-12, atol=1e-13, err_msg=key
            )

    # a non-OOM error still propagates
    def broken_step(*stacked):
        raise RuntimeError("some other failure")

    monkeypatch.setattr(flagship, "jitted_series_step", lambda: broken_step)
    with pytest.raises(RuntimeError, match="some other failure"):
        m.flagship_series(batch=2)


def test_flagship_series_pod_oom_fallback_halves_in_padded_units(tmp_path, monkeypatch):
    """On a snap x space pod every dispatch is padded to a multiple of
    the snap rows, so the OOM fallback must halve in PADDED units — a
    cap below n_snap would re-dispatch the identical failing padded
    shape forever — and an OOM at ONE padded snap-row (nothing smaller
    exists) must re-raise instead of recursing."""
    from fava_tpu import flagship
    from fava_tpu.io import synthetic
    from fava_tpu.parallel import make_device_mesh, use_mesh
    import fava_tpu

    for i in (1, 2, 3):
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_000{i}", ncells=(16, 16, 16), seed=30 + i
        )
    m = fava_tpu.FLASH(tmp_path)
    mesh = make_device_mesh((2, 4), ("snap", "space"))
    real = flagship.jitted_sharded_series_step(mesh)
    calls = []

    def flaky(*stacked):
        calls.append(stacked[0].shape[0])
        if stacked[0].shape[0] > 2:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of device memory (simulated)")
        return real(*stacked)

    monkeypatch.setattr(flagship, "jitted_sharded_series_step", lambda mesh: flaky)
    with use_mesh(mesh):
        series = m.flagship_series(batch=4)
    # 3 snapshots pad to a 4-batch -> OOM -> halve in snap-row units
    # (2 rows -> 1 row = 2 snapshots); the remaining single snapshot
    # pads back to a 2-batch, which is the smallest dispatchable shape.
    assert calls == [4, 2, 2]
    assert series["times"].shape == (3,)
    for j in (0, 1, 2):
        m.load(file_type="uni", file_index=j)
        single = m.flagship_analysis()
        for key, val in single.items():
            np.testing.assert_allclose(
                series[key][j], np.asarray(val), rtol=1e-9, atol=1e-12, err_msg=key
            )

    def always_oom(*stacked):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of device memory (simulated)")

    monkeypatch.setattr(flagship, "jitted_sharded_series_step", lambda mesh: always_oom)
    with use_mesh(mesh), pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        m.flagship_series(batch=2)


def test_flagship_series_rejects_multiblock(tmp_path):
    from fava_tpu.io import synthetic
    import fava_tpu
    import pytest as _pytest

    synthetic.make_amr_file(tmp_path / "rt_hdf5_plt_cnt_0001", ncells=(8, 8, 8), nblks=(2, 2, 2))
    m = fava_tpu.FLASH(tmp_path)
    with _pytest.raises(ValueError, match="single-block uniform"):
        m.flagship_series(file_type="plt")


def test_settings_validation_missing_pdf_field(pipeline_dir):
    """Enabling pdf1d without a field name must fail AT STARTUP with
    the offending key named, not as a TypeError mid-stage-4."""
    from fava_tpu.pipeline.pipeline import PipelineSettingsError

    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings["pdf1d"] = {"skip": False, "settings": {"nbins": 16}}
    settings_path.write_text(json.dumps(settings))

    pipe = Pipeline(workdir)
    with pytest.raises(PipelineSettingsError, match="'field'"):
        pipe.restart()


def test_settings_validation_pdf2d_and_shapes(pipeline_dir):
    from fava_tpu.pipeline.pipeline import PipelineSettingsError, validate_settings

    workdir, data, out = pipeline_dir
    base = json.loads((workdir / "pipeline_settings.json").read_text())

    bad = dict(base)
    bad["pdf2d"] = {"skip": False, "settings": {"field1": "dens"}}
    with pytest.raises(PipelineSettingsError, match="'field2'"):
        validate_settings(bad)

    # Skipped analyses are not required to carry their settings.
    ok = dict(base)
    ok["pdf2d"] = {"skip": True}
    validate_settings(ok)

    # Non-dict stage entry fails with the key named.
    bad2 = dict(base)
    bad2["fractal dimension"] = "yes"
    with pytest.raises(PipelineSettingsError, match="fractal dimension"):
        validate_settings(bad2)

    bad3 = dict(base)
    bad3["structure functions"] = {"settings": [1, 2]}
    with pytest.raises(PipelineSettingsError, match="structure functions"):
        validate_settings(bad3)


def test_settings_validation_skipped_stage4_allows_stub_entries(pipeline_dir):
    """A stub optional-analysis entry alongside a SKIPPED stage 4 must
    validate: none of those analyses can run, so their settings need
    not be complete (regression: over-strict rejection)."""
    from fava_tpu.pipeline.pipeline import validate_settings

    workdir, data, out = pipeline_dir
    settings = json.loads((workdir / "pipeline_settings.json").read_text())
    settings["analyze uniform data"] = {"skip": True}
    settings["pdf1d"] = {"settings": {"nbins": 16}}  # missing 'field' — ok, stage off
    del settings["fractal dimension"]
    validate_settings(settings)  # must not raise


def test_settings_validation_unknown_key_warns(pipeline_dir, caplog):
    import logging

    from fava_tpu.pipeline.pipeline import validate_settings

    workdir, data, out = pipeline_dir
    settings = json.loads((workdir / "pipeline_settings.json").read_text())
    settings["spectre functions"] = {"skip": False}
    with caplog.at_level(logging.WARNING, logger="fava_tpu.pipeline.pipeline"):
        validate_settings(settings)
    assert any("spectre functions" in r.message for r in caplog.records)


def test_pipeline_survives_skipped_stage_one(pipeline_dir):
    """Skipping the reynolds-stress stage must not crash stage 2/3 on
    missing window scalars (graceful skip instead of OSError between
    stages)."""
    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings["reynolds stress"] = {"skip": True}
    settings_path.write_text(json.dumps(settings))

    assert main(workdir) == 0
    # No windows can be extracted without a trajectory.
    assert not list(out.glob("*hdf5_uniform_*"))


def test_pipeline_stage4_skip_flag(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings["analyze uniform data"] = {"skip": True}
    settings_path.write_text(json.dumps(settings))

    assert main(workdir) == 0
    ckpt = json.loads((workdir / "fava.checkpoint").read_text())
    # The stage never ran: no resume cursor recorded for it.
    assert "index" not in ckpt.get("analyze uniform data", {})


def test_validated_settings_raise_pipeline_error(pipeline_dir):
    """_validated must raise PipelineSettingsError (asserts are
    stripped under python -O) with the offending key named."""
    import json as _json

    from fava_tpu.pipeline.pipeline import Pipeline, PipelineSettingsError

    workdir, data, out = pipeline_dir
    settings = _json.loads((workdir / "pipeline_settings.json").read_text())
    settings["dimension"] = "3"  # wrong type: str, not int
    (workdir / "pipeline_settings.json").write_text(_json.dumps(settings))
    pipe = Pipeline(workdir)
    with pytest.raises(PipelineSettingsError, match="dimension"):
        pipe.load_settings()

    del settings["basename"]
    settings["dimension"] = 3
    (workdir / "pipeline_settings.json").write_text(_json.dumps(settings))
    pipe = Pipeline(workdir)
    with pytest.raises(PipelineSettingsError, match="basename"):
        pipe.load_settings()


def test_stage3_not_checkpointed_without_trajectory(pipeline_dir, monkeypatch):
    """If stage 1 produced no window trajectory, stage 3 must SKIP
    without advancing its checkpoint — recording undone work as done
    would permanently skip extraction on the fixed re-run."""
    import json as _json

    from fava_tpu.pipeline import pipeline as pl

    workdir, data, out = pipeline_dir
    settings = _json.loads((workdir / "pipeline_settings.json").read_text())
    settings["reynolds stress"] = {"skip": True}  # no anl scalars -> no fit
    (workdir / "pipeline_settings.json").write_text(_json.dumps(settings))

    monkeypatch.chdir(workdir)
    rc = pl.main(workdir)
    assert rc == 0
    ckpt = _json.loads((workdir / "fava.checkpoint").read_text())
    assert "extract windows" not in ckpt  # NOT advanced
    assert not list(out.glob("*hdf5_uniform_*"))

    # Fixed settings: the re-run must now do stages 1-4 from scratch.
    settings["reynolds stress"] = {"skip": False}
    (workdir / "pipeline_settings.json").write_text(_json.dumps(settings))
    rc = pl.main(workdir)
    assert rc == 0
    ckpt = _json.loads((workdir / "fava.checkpoint").read_text())
    assert ckpt["extract windows"]["index"] == 2
    assert len(list(out.glob("*hdf5_uniform_*"))) == 2
