"""One backend for every device: no device-specific kernels or
branches, no hard dependency on h5py outside the HDF5 readers and
writers, and no guessed device memory size."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

import fava_tpu

PACKAGE = Path(fava_tpu.__file__).resolve().parent


def test_no_pallas_import_or_platform_branch():
    """No module imports Pallas, and the only platform the package
    compares against is "cpu" (the host-RAM memory rule)."""
    pallas = re.compile(r"jax\.experimental\.pallas|from jax\.experimental import pallas")
    branch = re.compile(r"""platform\s*(==|!=|in)\s*\(?\s*["'](?!cpu["'])""")
    offenders = [
        str(path.relative_to(PACKAGE))
        for path in PACKAGE.rglob("*.py")
        if pallas.search(path.read_text()) or branch.search(path.read_text())
    ]
    assert offenders == []


def test_import_and_flagship_without_h5py():
    """`import fava_tpu`, from_arrays and the flagship step work with
    h5py hidden."""
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np, fava_tpu\n"
        "rng = np.random.default_rng(0)\n"
        "m = fava_tpu.from_arrays({k: rng.random((8, 8, 8)) + 1 for k in ('dens', 'velx', 'vely', 'velz')})\n"
        "out = m.flagship_analysis()\n"
        "assert np.isfinite(out['spectra_total']).all()\n"
        "print('ok')\n"
    )
    run = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=PACKAGE.parent,
    )
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().endswith("ok")


def test_device_memory_on_cpu_is_host_memory():
    import os

    from fava_tpu.parallel import runtime

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert runtime.device_memory_bytes() == float(ram)


class _FakeDevice:
    platform = "gpu"
    device_kind = "fake accelerator"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,expected", [({"bytes_limit": 123}, 123.0), ({}, RuntimeError), (None, RuntimeError)])
def test_device_memory_from_bytes_limit(monkeypatch, stats, expected):
    """An accelerator's budget is its bytes_limit; without one, an error."""
    import jax

    from fava_tpu.parallel import runtime

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(stats)])
    if expected is RuntimeError:
        with pytest.raises(RuntimeError, match="bytes_limit"):
            runtime.device_memory_bytes()
    else:
        assert runtime.device_memory_bytes() == expected
