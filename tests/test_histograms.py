"""Histogram exactness: int32 counting paths (exact to 2^31 per bin),
the scatter-free pdf2d matmul histogram, and the density_pdf hi/lo
count packing. Regression target: f32 per-bin sums silently lose
integer exactness >= 2^24."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fava_tpu.ops import volume as vol


class _f32_config:
    """Temporarily run under the accelerator's f32 config (x64 off)."""

    def __enter__(self):
        self._old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", False)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", self._old)


def test_pdf1d_counts_exact_beyond_2p24_under_f32():
    """Concentrated distribution: > 2^24 samples in ONE bin, f32 config
    (the accelerator accumulation dtype). The int32 counting path must stay
    integer-exact where an f32 per-bin sum rounds."""
    n_big = (1 << 24) + 4097
    with _f32_config():
        v = np.full(n_big + 3, 0.5, dtype=np.float32)
        v[-3:] = [0.1, 0.3, 0.9]  # outliers land outside bin 2 ([0.5, 0.75))
        out = vol.pdf1d(jnp.asarray(v), nbins=4, vrange=(0.0, 1.0), density=False)
    expected, _ = np.histogram(v.astype(np.float64), bins=out["edges"])
    np.testing.assert_array_equal(out["counts"], expected.astype(np.float64))
    assert out["counts"][2] == n_big  # the concentrated bin, exactly


def test_pdf2d_counting_matches_histogram2d():
    rng = np.random.default_rng(11)
    x = rng.random(5000)
    y = rng.random(5000)
    # pin edge semantics: values exactly on interior and final edges
    x[:10] = 0.5
    y[:10] = 1.0
    out = vol.pdf2d(jnp.asarray(x), jnp.asarray(y), nbins=(8, 10), xrange=(0.0, 1.0), yrange=(0.0, 1.0), density=False)
    expected, _, _ = np.histogram2d(x, y, bins=[out["xedges"], out["yedges"]])
    np.testing.assert_array_equal(out["counts"], expected)


def test_pdf2d_counting_exact_beyond_2p24_under_f32():
    n_big = (1 << 24) + 2049
    with _f32_config():
        x = np.full(n_big + 2, 0.25, dtype=np.float32)
        y = np.full(n_big + 2, 0.75, dtype=np.float32)
        x[-2:] = [0.75, 0.9]
        y[-2:] = [0.25, 0.1]
        out = vol.pdf2d(
            jnp.asarray(x), jnp.asarray(y), nbins=(2, 2), xrange=(0.0, 1.0), yrange=(0.0, 1.0), density=False
        )
    assert out["counts"][0, 1] == n_big
    assert out["counts"].sum() == n_big + 2


def test_pdf2d_weighted_matches_histogram2d():
    rng = np.random.default_rng(12)
    x = rng.random(4000)
    y = rng.random(4000)
    w = rng.random(4000)
    out = vol.pdf2d(
        jnp.asarray(x), jnp.asarray(y), weights=jnp.asarray(w), nbins=(6, 5), xrange=(0.0, 1.0), yrange=(0.0, 1.0), density=False
    )
    expected, _, _ = np.histogram2d(x, y, bins=[out["xedges"], out["yedges"]], weights=w)
    np.testing.assert_allclose(out["counts"], expected, rtol=1e-12)


def test_pdf2d_out_of_range_dropped():
    x = np.array([-0.5, 0.2, 1.5, 0.8])
    y = np.array([0.3, 0.3, 0.3, 0.9])
    out = vol.pdf2d(jnp.asarray(x), jnp.asarray(y), nbins=(4, 4), xrange=(0.0, 1.0), yrange=(0.0, 1.0), density=False)
    assert out["counts"].sum() == 2  # only the two in-range points


def test_pdf2d_multi_chunk_padding(monkeypatch):
    """Exercise the data-chunked scan + inf padding with a tiny chunk."""
    monkeypatch.setattr(vol, "_HIST2D_CHUNK", 64)
    vol._hist2d_fn.cache_clear()
    rng = np.random.default_rng(13)
    x = rng.random(301)  # 301 = 4*64 + 45 -> padded final chunk
    y = rng.random(301)
    out = vol.pdf2d(jnp.asarray(x), jnp.asarray(y), nbins=(5, 7), xrange=(0.0, 1.0), yrange=(0.0, 1.0), density=False)
    expected, _, _ = np.histogram2d(x, y, bins=[out["xedges"], out["yedges"]])
    np.testing.assert_array_equal(out["counts"], expected)
    vol._hist2d_fn.cache_clear()


def test_density_pdf_hilo_packing_exact():
    """Unweighted density_pdf counts survive the f32 packed fetch via
    the hi/lo split — exact for bins holding > 2^12 (and odd) counts."""
    rng = np.random.default_rng(14)
    rho = np.exp(rng.standard_normal(40001) * 0.5)  # odd total
    out = vol.density_pdf(jnp.asarray(rho), nbins=8, nsigma=10.0)
    assert out["counts"].sum() == 40001
    np.testing.assert_array_equal(out["counts"], np.round(out["counts"]))


def test_density_pdf_invalid_fixed_srange_raises():
    rho = jnp.asarray(np.full(64, 2.0))
    with pytest.raises(ValueError, match="srange"):
        vol.density_pdf(rho, nbins=4, srange=(1.0, 1.0))
    with pytest.raises(ValueError, match="srange"):
        vol.density_pdf(rho, nbins=4, srange=(2.0, -1.0))


# ---------------------------------------------------------------------------
# Joint histogram: chunk boundaries, bin semantics, weights, traced edges


@pytest.mark.parametrize(
    "case",
    ["ragged_chunks", "closed_last_bin_and_out_of_range", "more_than_128_bins"],
)
def test_pdf2d_counts_exact_vs_histogram2d(case, monkeypatch):
    """Unweighted joint counts are integer-exact against np.histogram2d on
    the same f32 samples and f32-rounded edges."""
    monkeypatch.setattr(vol, "_HIST2D_CHUNK", 1024)
    vol._hist2d_fn.cache_clear()
    rng = np.random.default_rng(21)
    if case == "closed_last_bin_and_out_of_range":
        x = np.array([1.0, 1.0, -0.1, 2.0, 0.5], dtype=np.float32)
        y = np.array([1.0, 0.5, 0.5, 0.5, 1.5], dtype=np.float32)
        nb, xr, yr = (4, 4), (0.0, 1.0), (0.0, 1.0)
    else:
        n = 2 * 1024 + 517  # ragged tail: inf padding lands in no bin
        x = rng.normal(1.5, 0.4, n).astype(np.float32)
        y = rng.normal(-0.2, 1.1, n).astype(np.float32)
        nb = (100, 64) if case == "ragged_chunks" else (150, 130)
        xr = (float(x.min()), float(x.max()))
        yr = (float(y.min()), float(y.max()))
    got = vol.pdf2d(jnp.asarray(x), jnp.asarray(y), nbins=nb, xrange=xr, yrange=yr, density=False)
    vol._hist2d_fn.cache_clear()
    adt = np.dtype(vol.accum_dtype())
    bins = [np.linspace(*r, k + 1).astype(adt).astype(np.float64) for r, k in zip((xr, yr), nb)]
    ref, _, _ = np.histogram2d(x.astype(np.float64), y.astype(np.float64), bins=bins)
    np.testing.assert_array_equal(got["counts"], ref)
    if case == "closed_last_bin_and_out_of_range":
        assert got["counts"].sum() == 2  # top-edge pairs kept, out-of-range dropped
    else:
        assert got["counts"].sum() == x.size


def test_pdf2d_weighted_double_word(monkeypatch):
    """Weighted sums across several chunks: double-word accumulation,
    f64-combined on fetch."""
    monkeypatch.setattr(vol, "_HIST2D_CHUNK", 1024)
    vol._hist2d_fn.cache_clear()
    rng = np.random.default_rng(22)
    n = 3 * 1024 + 301
    x = rng.normal(1.5, 0.4, n)
    y = rng.normal(-0.2, 1.1, n)
    w = np.exp(rng.standard_normal(n))
    xr, yr = (float(x.min()), float(x.max())), (float(y.min()), float(y.max()))
    got = vol.pdf2d(
        jnp.asarray(x), jnp.asarray(y), nbins=(33, 101), xrange=xr, yrange=yr,
        weights=jnp.asarray(w), density=False,
    )
    vol._hist2d_fn.cache_clear()
    ref, _, _ = np.histogram2d(x, y, bins=(33, 101), range=[xr, yr], weights=w)
    np.testing.assert_allclose(got["counts"], ref, rtol=1e-12, atol=1e-12)


def test_hist2d_traced_edges_match_host_edges():
    """The in-trace edge form (fused Q-R and auto-range paths) bins
    exactly like host-passed edges of the same values."""
    rng = np.random.default_rng(23)
    x = jnp.asarray(rng.normal(0.0, 1.0, 4097))
    y = jnp.asarray(rng.normal(0.0, 2.0, 4097))
    xe = jnp.asarray(np.linspace(-3.0, 3.0, 25))
    ye = jnp.asarray(np.linspace(-6.0, 6.0, 17))
    hist = vol._hist2d_fn(24, 16, counting=True)
    host = np.asarray(hist(x, y, x, xe, ye))
    traced = np.asarray(jax.jit(lambda a, b, c, d: hist(a, b, a, c, d))(x, y, xe, ye))
    np.testing.assert_array_equal(traced, host)
    ref, _, _ = np.histogram2d(np.asarray(x), np.asarray(y), bins=(np.asarray(xe), np.asarray(ye)))
    np.testing.assert_array_equal(host, ref)


def test_invariant_pdfs_counts_match_histogram2d():
    """gradient_invariant_pdfs' fused counts equal np.histogram2d of the
    same Q, R fields against the same Q_w-scaled edges, and Q_w
    round-trips through the bitcast row."""
    from fava_tpu.ops import gradients as gr

    rng = np.random.default_rng(24)
    vels = [jnp.asarray(rng.standard_normal((12, 12, 12))) for _ in range(3)]
    got = gr.gradient_invariant_pdfs(*vels, nbins=(16, 12), qr_range=5.0)
    fields = gr._invariant_fields_fn((12, 12, 12), gr._spacings((12, 12, 12), None), "periodic")
    q, r, qw = fields(*vels)
    qe, re = gr.invariant_pdf_edges(qw, 5.0, 16, 12)
    ref, _, _ = np.histogram2d(
        np.asarray(q).ravel(), np.asarray(r).ravel(), bins=(np.asarray(qe), np.asarray(re))
    )
    np.testing.assert_array_equal(got["counts"], ref)
    np.testing.assert_allclose(got["q_w"], float(qw), rtol=1e-12)


def test_pdf2d_auto_range_multi_chunk(monkeypatch):
    """The fused auto-range path over several ragged chunks keeps every
    sample and matches np.histogram2d against the reported edges."""
    monkeypatch.setattr(vol, "_HIST2D_CHUNK", 1024)
    vol._hist2d_fn.cache_clear()
    vol._pdf2d_auto_fn.cache_clear()
    rng = np.random.default_rng(32)
    n = 1024 + 53
    x = rng.normal(0.0, 1.0, n)
    y = rng.normal(0.0, 2.0, n)
    out = vol.pdf2d(jnp.asarray(x), jnp.asarray(y), nbins=(10, 10), density=False)
    vol._hist2d_fn.cache_clear()
    vol._pdf2d_auto_fn.cache_clear()
    assert out["counts"].sum() == n
    ref, _, _ = np.histogram2d(x, y, bins=[out["xedges"], out["yedges"]])
    np.testing.assert_array_equal(out["counts"], ref)


def test_pdf_empty_inputs():
    e = jnp.asarray(np.empty((0,), dtype=np.float64))
    out = vol.pdf2d(e, e, nbins=(4, 5), xrange=(0.0, 1.0), yrange=(0.0, 1.0), density=False)
    np.testing.assert_array_equal(out["counts"], np.zeros((4, 5)))
    with pytest.raises(ValueError, match="auto-range"):
        vol.pdf2d(e, e, nbins=(4, 5))
    with pytest.raises(ValueError, match="auto-range"):
        vol.pdf1d(e, nbins=4)
    out1 = vol.pdf1d(e, nbins=4, vrange=(0.0, 1.0), density=False)
    np.testing.assert_array_equal(out1["counts"], np.zeros(4))


def test_pdf2d_auto_range_fused_matches_histogram2d():
    """Unweighted auto-range takes the ONE-dispatch fused path (traced
    min/max -> traced linspace edges -> histogram, ranges bitcast into
    the counts fetch) and must stay bit-exact vs np.histogram2d's own
    auto-ranging (identical min/max + linspace chain at f64)."""
    rng = np.random.default_rng(31)
    x = rng.normal(2.0, 0.7, 5000)
    y = rng.lognormal(0.0, 0.5, 5000)
    out = vol.pdf2d(jnp.asarray(x), jnp.asarray(y), nbins=(12, 9), density=False)
    ref, xe, ye = np.histogram2d(x, y, bins=(12, 9))
    np.testing.assert_array_equal(out["counts"], ref)
    np.testing.assert_allclose(out["xedges"], xe, rtol=0, atol=0)
    np.testing.assert_allclose(out["yedges"], ye, rtol=0, atol=0)
    assert out["counts"].sum() == 5000  # full range keeps every sample


def test_pdf2d_auto_range_constant_fields():
    x = jnp.asarray(np.full(257, 3.0))
    out = vol.pdf2d(x, x, nbins=(8, 8), density=False)
    # degenerate range widens to lo + 1 on both axes; everything lands
    # in the first bin (np.histogram2d of a constant does the same)
    assert out["counts"].sum() == 257
    assert out["counts"][0, 0] == 257
    np.testing.assert_allclose(out["xedges"][0], 3.0)
    np.testing.assert_allclose(out["xedges"][-1], 4.0)


def test_pdf1d_auto_range_fused_matches_histogram():
    rng = np.random.default_rng(33)
    x = rng.lognormal(0.0, 0.8, 4001)
    out = vol.pdf1d(jnp.asarray(x), nbins=13, density=True)
    ref, edges = np.histogram(x, bins=13)
    np.testing.assert_array_equal(out["counts"], ref)
    np.testing.assert_allclose(out["edges"], edges, rtol=0, atol=0)
    refpdf, _ = np.histogram(x, bins=13, density=True)
    np.testing.assert_allclose(out["pdf"], refpdf, rtol=1e-12)


def test_pdf1d_auto_range_constant_field():
    x = jnp.asarray(np.full(99, -2.0))
    out = vol.pdf1d(x, nbins=5, density=False)
    assert out["counts"][0] == 99 and out["counts"].sum() == 99
    np.testing.assert_allclose(out["edges"][0], -2.0)
    np.testing.assert_allclose(out["edges"][-1], -1.0)


def test_weighted_pdf1d_no_f32_stall_beyond_2p24():
    """Regression: > 2^24 samples of one CONSTANT
    f32 weight concentrated in ONE bin, f32 config. A plain f32
    accumulator stops absorbing w-sized increments past 2^24 * w
    (here the true sum is 2x that stall point — a plain f32 path would
    come back ~33% low); the double-word blocked sum must match the
    f64 oracle within the documented ~6e-5 worst-case bound."""
    n = (1 << 25) + 4097
    w_val = np.float32(0.30000001192092896)
    with _f32_config():
        v = np.full(n + 2, 0.5, dtype=np.float32)
        v[-2:] = [0.1, 0.9]
        w = np.full(n + 2, w_val, dtype=np.float32)
        out = vol.pdf1d(
            jnp.asarray(v), nbins=4, vrange=(0.0, 1.0), weights=jnp.asarray(w), density=False
        )
    ref, _ = np.histogram(v.astype(np.float64), bins=out["edges"], weights=w.astype(np.float64))
    assert ref[2] > (1 << 25) * 0.3  # the stall regime, by construction
    np.testing.assert_allclose(out["counts"], ref, rtol=1e-5)
    # measured behavior is far inside the bound for constant weights
    np.testing.assert_allclose(out["counts"][2], ref[2], rtol=1e-6)


def test_weighted_binned_statistic_no_f32_stall_beyond_2p24():
    """Same stall regime through binned_statistic: the per-bin weight
    sums, sum(w*yc) and sum(w*yc^2) all cross 2^24 * w in one bin."""
    n = (1 << 25) + 17
    with _f32_config():
        x = np.full(n, 0.5, dtype=np.float32)
        y = np.full(n, 2.0, dtype=np.float32)
        y[: n // 2] = 1.0  # nonzero in-bin variance
        w = np.full(n, np.float32(0.25), dtype=np.float32)  # dyadic: products exact
        out = vol.binned_statistic(
            jnp.asarray(x), jnp.asarray(y), nbins=4, vrange=(0.0, 1.0), weights=jnp.asarray(w)
        )
    wf, yf = w.astype(np.float64), y.astype(np.float64)
    np.testing.assert_allclose(out["weight_sums"][2], wf.sum(), rtol=1e-5)
    mean_ref = (wf * yf).sum() / wf.sum()
    var_ref = (wf * (yf - mean_ref) ** 2).sum() / wf.sum()
    np.testing.assert_allclose(out["mean"][2], mean_ref, rtol=1e-6)
    np.testing.assert_allclose(out["std"][2], np.sqrt(var_ref), rtol=1e-5)
    assert np.isnan(out["mean"][[0, 1, 3]]).all()


def test_weighted_pdf2d_xla_path_no_f32_stall_beyond_2p24():
    """The XLA joint-histogram weighted path
    accumulates across 2^21-sample chunks: > 2^24 * w in one bin must
    survive the cross-chunk double-word accumulation."""
    n = (1 << 25) + 33
    with _f32_config():
        x = np.full(n, 0.5, dtype=np.float32)
        y = np.full(n, -1.5, dtype=np.float32)
        w = np.full(n, np.float32(0.30000001192092896), dtype=np.float32)
        out = vol.pdf2d(
            jnp.asarray(x),
            jnp.asarray(y),
            nbins=(4, 3),
            xrange=(0.0, 1.0),
            yrange=(-2.0, 1.0),
            weights=jnp.asarray(w),
            density=False,
        )
    total = n * float(np.float64(w[0]))
    np.testing.assert_allclose(out["counts"][2, 0], total, rtol=1e-5)
    assert out["counts"].sum() == out["counts"][2, 0]


def test_blocked_sum_dd_matches_f64_oracle():
    """Direct contract: f32 double-word blocked sum of a rough
    lognormal weight stream matches the f64 pairwise sum to ~1e-7
    relative (plain f32 at this size is ~1e-4-class, and stalls
    entirely when concentrated)."""
    from fava_tpu.utils import twofloat as tf

    rng = np.random.default_rng(5)
    w = np.exp(rng.standard_normal(1 << 22)).astype(np.float32)
    with _f32_config():
        hi, lo = tf.blocked_sum_dd(jnp.asarray(w))
        got = float(np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64))
    ref = w.astype(np.float64).sum()
    np.testing.assert_allclose(got, ref, rtol=1e-7)
