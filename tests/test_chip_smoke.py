"""chip_smoke.py's phases at small sizes on the CPU, and its GPU-only rule."""

import pytest

import chip_smoke


@pytest.fixture(scope="module")
def uniform(tmp_path_factory):
    return chip_smoke.phase_uniform(16, tmp_path_factory.mktemp("smoke_uni"))


def test_phase_uniform_checks_against_oracles(uniform, capsys):
    assert set(uniform) == {"model", "vols", "host", "flagship"}
    assert uniform["flagship"]["spectra_total"].shape == (7,)


def test_phase_series(uniform, capsys):
    chip_smoke.phase_series(16, uniform)
    assert "phase 2 series scan 4 x 16^3" in capsys.readouterr().out


def test_phase_streamed(uniform, capsys):
    chip_smoke.phase_streamed(16, uniform)
    assert "streamed vs in-core" in capsys.readouterr().out


def test_phase_streamed_without_h5py(uniform, capsys, monkeypatch):
    """Without h5py the streamed path reads host-array slabs."""
    monkeypatch.setattr(chip_smoke, "h5py", None)
    chip_smoke.phase_streamed(16, uniform)
    assert "host-array slabs" in capsys.readouterr().out


def test_phase_stage4(uniform, capsys):
    chip_smoke.phase_stage4(16, uniform)
    out = capsys.readouterr().out
    assert "pdf2d counts exact" in out and "turbulence_summary" in out


@pytest.mark.parametrize("with_h5py", [True, False])
def test_phase_amr(tmp_path, capsys, monkeypatch, with_h5py):
    if not with_h5py:
        monkeypatch.setattr(chip_smoke, "h5py", None)
    chip_smoke.phase_amr(16, tmp_path)
    out = capsys.readouterr().out
    assert "16^3 window" in out and "bit-exact" in out


def test_phase_pipeline(tmp_path, capsys):
    chip_smoke.phase_pipeline(16, tmp_path)
    assert "3 windows" in capsys.readouterr().out


def test_phase_pipeline_needs_h5py(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke, "h5py", None)
    chip_smoke.phase_pipeline(16, tmp_path)
    assert "not run, h5py is not installed" in capsys.readouterr().out


def test_phase_sharded(capsys):
    chip_smoke.phase_sharded(16)
    out = capsys.readouterr().out
    assert "over 4 devices" in out and "2x2 mesh" in out and "bit-exact" in out


def test_main_refuses_a_non_gpu_backend(capsys):
    """On the CPU the script exits non-zero and prints no result."""
    assert chip_smoke.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "needs a GPU" in captured.err


@pytest.fixture()
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


@pytest.mark.gpu
def test_main_on_gpu(gpu, capsys):
    assert chip_smoke.main([]) == 0
    assert '"ok": true' in capsys.readouterr().out.splitlines()[-1]
