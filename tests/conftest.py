"""Test configuration: CPU backend with 8 virtual devices + float64.

The backend is forced through jax.config before any JAX use, so the
tests run on the CPU whatever accelerator the machine has.
x64 is enabled so device results can be compared tightly against the
float64 NumPy oracles.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from fava_tpu.io import synthetic


@pytest.fixture(scope="session")
def eight_device_mesh():
    from fava_tpu.parallel import make_device_mesh

    return make_device_mesh((8,), ("space",))


@pytest.fixture(scope="session")
def uniform_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("uni") / "rt_hdf5_uniform_0001"
    return synthetic.make_uniform_file(path, ncells=(16, 16, 16), seed=7)


@pytest.fixture(scope="session")
def uniform_file_32(tmp_path_factory):
    path = tmp_path_factory.mktemp("uni32") / "rt_hdf5_uniform_0002"
    return synthetic.make_uniform_file(path, ncells=(32, 32, 32), seed=11)


@pytest.fixture(scope="session")
def amr_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("amr") / "rt_hdf5_plt_cnt_0001"
    return synthetic.make_amr_file(
        path,
        ncells=(8, 8, 8),
        nblks=(2, 2, 2),
        refine={0: 2, 3: 3},
    )


@pytest.fixture(scope="session")
def particle_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("prt") / "rt_hdf5_part_0001"
    return synthetic.make_particle_file(path, nparticles=128, seed=3)
