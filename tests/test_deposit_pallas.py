"""Tiled adaptive deposit vs the f64 oracles, on both routes.

``route="kernel"`` runs the Triton kernel in the Pallas interpreter;
``route="xla"`` is the same layout through XLA's scatter-add (what the CPU
runs by default). The compiled kernel is checked on the card by the
``gpu``-marked tests at the end, which ``chip_smoke.py`` runs there.
"""

import jax
import numpy as np
import pytest

from astro_sph_tools_tpu.ops import deposit_pallas as dp
from astro_sph_tools_tpu.ops.deposit import MapSpec, deposit_2d
from astro_sph_tools_tpu.ops.deposit_pallas import (
    PALLAS_LEVELS,
    deposit_2d_auto,
    deposit_2d_pallas,
    deposit_tiled,
    tile_particles,
)
from oracles import project_oracle, project_oracle_fast


def rel_err(got, expected):
    return np.abs(got - expected).max() / np.abs(expected).max()


def particles(rng, n, box, h_lo, h_hi):
    return (
        rng.uniform(0, box, n),
        rng.uniform(0, box, n),
        rng.uniform(h_lo, h_hi, n),
        rng.uniform(0.5, 2.0, n),
    )


@pytest.fixture(params=["kernel", "xla"])
def interpret(request):
    """Both routes: the interpreted kernel, and XLA's scatter-add."""
    return request.param == "kernel"


class TestPallasDeposit:
    def test_k8_matches_oracle(self, rng, interpret):
        box = 10.0
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
        px = box / 64
        x, y, h, m = particles(rng, 2000, box, 0.5 * px, 1.4 * px)
        got = np.asarray(deposit_2d_pallas(x, y, h, m, spec, interpret=interpret))
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent)
        assert rel_err(got, expected) < 1e-5

    def test_k16_level(self, rng, interpret):
        box = 10.0
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
        px = box / 64
        x, y, h, m = particles(rng, 1000, box, 1.6 * px, 3.4 * px)
        got = np.asarray(
            deposit_2d_pallas(
                x, y, h, m, spec, level=PALLAS_LEVELS[1], interpret=interpret
            )
        )
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent)
        assert rel_err(got, expected) < 1e-5

    def test_multifield(self, rng, interpret):
        box = 10.0
        spec = MapSpec(shape=(32, 32), extent=(0.0, box, 0.0, box))
        px = box / 32
        x, y, h, m = particles(rng, 800, box, 0.5 * px, 1.3 * px)
        t = rng.uniform(1e4, 1e6, 800)
        fields = np.stack([m, m * t], axis=0)  # (F, N)
        got = np.asarray(deposit_2d_pallas(x, y, h, fields, spec, interpret=interpret))
        assert got.shape == (2, 32, 32)
        exp_m = project_oracle(x, y, h, m, spec.shape, spec.extent)
        exp_mt = project_oracle(x, y, h, m * t, spec.shape, spec.extent)
        assert rel_err(got[0], exp_m) < 1e-5
        assert rel_err(got[1], exp_mt) < 1e-5

    def test_periodic(self, rng, interpret):
        box = 8.0
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box), periodic_wrap=True)
        px = box / 64
        n = 600
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        x[:60] = rng.uniform(0, 0.1, 60)  # edge hugging
        h = rng.uniform(0.8, 1.4, n) * px
        m = np.ones(n)
        got = np.asarray(deposit_2d_pallas(x, y, h, m, spec, interpret=interpret))
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent, periodic=True)
        assert rel_err(got, expected) < 1e-5

    def test_auto_mixed_footprints(self, rng, interpret):
        box = 10.0
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
        px = box / 64
        n = 1500
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        h = 10.0 ** rng.uniform(-0.3, 1.2, n) * px  # spans K=8..32 + oversize
        m = rng.uniform(0.5, 2.0, n)
        got = np.asarray(deposit_2d_auto(x, y, h, m, spec, interpret=interpret))
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent)
        assert rel_err(got, expected) < 1e-5

    def test_wendland_kernel(self, rng, interpret):
        box = 10.0
        spec = MapSpec(shape=(32, 32), extent=(0.0, box, 0.0, box))
        px = box / 32
        x, y, h, m = particles(rng, 600, box, 0.5 * px, 1.3 * px)
        got = np.asarray(
            deposit_2d_pallas(
                x, y, h, m, spec, kernel="wendland_c2", interpret=interpret
            )
        )
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent, kernel="wendland_c2")
        assert rel_err(got, expected) < 1e-5

    def test_empty_level_and_corner_origin(self, rng, interpret):
        box = 10.0
        spec = MapSpec(shape=(32, 32), extent=(0.0, box, 0.0, box), pixel_origin="corner")
        px = box / 32
        x, y, h, m = particles(rng, 500, box, 0.5 * px, 1.3 * px)
        got = np.asarray(deposit_2d_pallas(x, y, h, m, spec, interpret=interpret))
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent, pixel_origin="corner")
        assert rel_err(got, expected) < 1e-5


class TestAdviceRegressions:
    def test_auto_periodic_odd_shape_falls_back(self, rng, interpret):
        # a periodic 100x100 map cannot host every level's tiling; those
        # particles must route to the XLA dense fallback, not crash
        box = 5.0
        spec = MapSpec(shape=(100, 100), extent=(0.0, box, 0.0, box), periodic_wrap=True)
        px = box / 100
        n = 400
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        h = rng.uniform(0.8, 1.3, n) * px
        m = np.ones(n)
        got = np.asarray(deposit_2d_auto(x, y, h, m, spec, interpret=interpret))
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent, periodic=True)
        assert rel_err(got, expected) < 1e-5


class TestTiledLayout:
    def test_non_pow2_padding_stays_out_of_oversize(self, rng):
        # size-class padding parks in the smallest level (weight 0), never in
        # the oversize fallback, and the oversize slice excludes the slack
        box = 10.0
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
        px = box / 64
        n = 3000  # not a power of two
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        h = 10.0 ** rng.uniform(-0.3, 1.2, n) * px  # includes real oversize
        m = rng.uniform(0.5, 2.0, n)
        tp = tile_particles(x, y, h, m, spec)
        n_real_oversize = int((2.0 * h / px > 31).sum())  # beyond K=64 window
        assert tp.n_oversize == n_real_oversize
        got = np.asarray(deposit_tiled(tp))[0]
        exp = project_oracle(x, y, h, m, spec.shape, spec.extent)
        assert rel_err(got, exp) < 1e-5

    def test_with_values_reuses_layout(self, rng):
        box = 10.0
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
        px = box / 64
        n = 2500
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        h = 10.0 ** rng.uniform(-0.3, 0.8, n) * px
        m = rng.uniform(0.5, 2.0, n)
        tp = tile_particles(x, y, h, m, spec)
        m2 = rng.uniform(1.0, 3.0, n)
        got = np.asarray(deposit_tiled(tp.with_values(m2)))[0]
        exp = project_oracle(x, y, h, m2, spec.shape, spec.extent)
        assert rel_err(got, exp) < 1e-5

    def test_need_perm_false_renders_identically(self, rng):
        box = 10.0
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
        px = box / 64
        n = 2500
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        h = 10.0 ** rng.uniform(-0.3, 0.8, n) * px
        m = rng.uniform(0.5, 2.0, n)
        tp_full = tile_particles(x, y, h, m, spec)
        tp_lean = tile_particles(x, y, h, m, spec, need_perm=False)
        assert tp_lean.perm is None
        a = np.asarray(deposit_tiled(tp_full))
        b = np.asarray(deposit_tiled(tp_lean))
        np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="need_perm"):
            tp_lean.with_values(m)


def test_integrated_projection_matches_xla(interpret):
    """projection='integrated' (line-integrated kernel) through the tiles."""
    rng = np.random.default_rng(2)
    n, box = 4000, 10.0
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.exp(rng.normal(np.log(0.2), 0.6, n)).clip(0.06, 1.0)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    spec = MapSpec(shape=(64, 64), extent=(0, box, 0, box), periodic_wrap=True)

    ref = np.asarray(deposit_2d(x, y, h, m, spec, projection="integrated"))
    got = np.asarray(
        deposit_2d_auto(x, y, h, m, spec, projection="integrated", interpret=interpret)
    )
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-5

    # integrated columns conserve mass (kernel3d, the reference convention,
    # deliberately does not)
    px = box / 64
    assert abs(got.sum() * px * px - m.sum()) / m.sum() < 5e-3


# --- the kernel (interpret mode) level by level, against the f64 oracle and
# the plain XLA deposit -------------------------------------------------------


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("level", range(len(PALLAS_LEVELS)))
def test_kernel_each_level(level, periodic):
    """One footprint level through the interpreted kernel; non-periodic
    cases carry one field, periodic ones five."""
    cfg = PALLAS_LEVELS[level]
    rng = np.random.default_rng(100 + level)
    box, npix = 8.0, 128
    px = box / npix
    spec = MapSpec(shape=(npix, npix), extent=(0, box, 0, box), periodic_wrap=periodic)
    n = (1200, 400, 150, 60)[level]
    s_lo = 0.2 if level == 0 else PALLAS_LEVELS[level - 1].max_s_pix + 0.1
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = rng.uniform(s_lo, cfg.max_s_pix - 0.05, n) * px / 2.0  # s = 2h
    n_fields = 5 if periodic else 1
    vals = rng.uniform(0.5, 2.0, (n_fields, n))
    got = np.asarray(
        deposit_2d_pallas(x, y, h, vals, spec, level=cfg, interpret=True)
    ).reshape(n_fields, npix, npix)
    for f in range(n_fields):
        exp = project_oracle_fast(x, y, h, vals[f], spec.shape, spec.extent, periodic=periodic)
        assert rel_err(got[f], exp) < 1e-5
    # f32 inputs: both paths round the same global pixel coordinates
    x, y, h, vals = (np.float32(a) for a in (x, y, h, vals))
    got = np.asarray(
        deposit_2d_pallas(x, y, h, vals, spec, level=cfg, interpret=True)
    ).reshape(n_fields, npix, npix)
    plain = np.moveaxis(np.asarray(deposit_2d(x, y, h, vals.T, spec)), -1, 0)
    assert rel_err(got, plain.reshape(n_fields, npix, npix)) < 1e-5


def test_kernel_integrated_projection():
    rng = np.random.default_rng(7)
    box, npix, n = 8.0, 64, 1500
    px = box / npix
    spec = MapSpec(shape=(npix, npix), extent=(0, box, 0, box))
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.exp(rng.normal(np.log(1.2 * px), 0.5, n)).clip(0.2 * px, 7 * px)
    m = rng.uniform(0.5, 2.0, n)
    got = np.asarray(
        deposit_2d_auto(x, y, h, m, spec, projection="integrated", interpret=True)
    )
    exp = project_oracle_fast(x, y, h, m, spec.shape, spec.extent, projection="integrated")
    assert rel_err(got, exp) < 1e-5


@pytest.mark.parametrize("periodic", [False, True])
def test_subpixel_smoothing_lengths_hold_budget(rng, interpret, periodic):
    """h down to 0.04 px puts a particle's whole support inside ~0.08 px of
    a sample point, so the f32 rounding of its tile-local position decides
    its weight; local coordinates centred on the accumulator keep that
    rounding inside the 1e-5 budget even when one particle sets the map's
    maximum."""
    box, npix, n = 4.0, 128, 3000
    px = box / npix
    spec = MapSpec(shape=(npix, npix), extent=(0, box, 0, box), periodic_wrap=periodic)
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.exp(rng.uniform(np.log(0.04), np.log(0.6), n)) * px
    m = rng.uniform(0.5, 2.0, n) * 10.0 ** rng.uniform(0, 2, n)
    got = np.asarray(deposit_2d_auto(x, y, h, m, spec, interpret=interpret))
    exp = project_oracle_fast(x, y, h, m, spec.shape, spec.extent, periodic=periodic)
    assert rel_err(got, exp) < 1e-5


def test_kernel_off_extent_particles():
    """Halo-cutout inputs: particles outside a non-periodic extent still
    spill their in-extent share, and nothing wraps."""
    rng = np.random.default_rng(8)
    box, npix, n = 4.0, 48, 1500
    px = box / npix
    spec = MapSpec(shape=(npix, npix), extent=(1.0, 1.0 + box, 1.0, 1.0 + box))
    x = rng.uniform(0.6, 1.4 + box, n)
    y = rng.uniform(0.6, 1.4 + box, n)
    h = np.exp(rng.normal(np.log(1.5 * px), 0.6, n)).clip(0.3 * px, 12 * px)
    m = rng.uniform(0.5, 2.0, n)
    exp = project_oracle_fast(x, y, h, m, spec.shape, spec.extent)
    got = np.asarray(deposit_2d_auto(x, y, h, m, spec, interpret=True))
    assert rel_err(got, exp) < 1e-5
    got_f32 = np.asarray(
        deposit_2d_auto(
            np.float32(x), np.float32(y), np.float32(h), np.float32(m), spec,
            interpret=True,
        )
    )
    assert rel_err(got_f32, exp) < 1e-4  # f32 global->local conversion noise


def _dense_tile(rng, n):
    """``n`` particles inside the first 8 x 8 tile of a 16^2 map."""
    box, npix = 4.0, 16
    px = box / npix
    spec = MapSpec(shape=(npix, npix), extent=(0, box, 0, box))
    x = rng.uniform(1.0, 1.0 + 4 * px, n)
    y = rng.uniform(1.0, 1.0 + 4 * px, n)
    h = rng.uniform(0.3, 1.2, n) * px
    m = rng.uniform(0.5, 2.0, n)
    return x, y, h, m, spec


def test_kernel_dense_tile_spans_units():
    """A tile holding more than one unit's particles is split across kernel
    programs whose slots the tile-sum kernel adds up."""
    n = dp._UNIT + 1500
    x, y, h, m, spec = _dense_tile(np.random.default_rng(9), n)
    tp = tile_particles(x, y, h, m, spec, levels=(PALLAS_LEVELS[0],))
    n_tiles = tp.geoms[0][0].n_tiles
    pstart = np.zeros(n_tiles, np.int32)
    pcount = np.zeros(n_tiles, np.int32)
    pcount[0] = n
    units, spans = (np.asarray(a) for a in dp._units(pstart, pcount, 8))
    assert int((units[:, 1] > 0).sum()) == 2 and list(spans[0]) == [0, 2]
    got = np.asarray(deposit_tiled(tp, interpret=True))[0]
    exp = project_oracle_fast(x, y, h, m, spec.shape, spec.extent)
    assert rel_err(got, exp) < 1e-5


def test_tile_sum_adds_units_in_order():
    """The tile-sum kernel adds a tile's slots first to last, so its result
    is the sequential f32 sum, bit for bit, whatever order the deposit's
    programs ran in."""
    cfg = PALLAS_LEVELS[0]
    rng = np.random.default_rng(12)
    # slot magnitudes spread over 2^30 so that any other order rounds
    # differently
    parts = (rng.normal(size=(5, cfg.R, cfg.S)) * 2.0 ** rng.integers(-15, 15, (5, 1, 1)))
    parts = parts.astype(np.float32)
    spans = np.array([[0, 3], [3, 3], [3, 5]], np.int32)
    (got,) = dp._tile_sum_call(cfg, 3, 1, True)(spans, parts)
    got = np.asarray(got)
    seq = np.zeros((cfg.R, cfg.S), np.float32)
    for j in range(3):
        seq = seq + parts[j]
    np.testing.assert_array_equal(got[0], seq)
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(got[2], parts[3] + parts[4])


# --- the wrapper's tiling, padding and unit logic -----------------------------


def test_units_split_and_dead_rows():
    U = dp._UNIT
    pcount = np.array([0, U, U + 1, 5, 0, 3 * U], np.int32)
    pstart = np.concatenate([[0], np.cumsum(pcount)[:-1]]).astype(np.int32)
    n_units = int(pcount.sum()) // U + len(pcount)
    units, spans = (np.asarray(a) for a in dp._units(pstart, pcount, n_units))
    # each tile's span holds units that cover its particles exactly once,
    # in order, each within _UNIT
    assert list(spans[:, 1] - spans[:, 0]) == [0, 1, 2, 1, 0, 3]
    assert spans[0, 0] == 0 and (spans[1:, 0] == spans[:-1, 1]).all()
    for t, (a, b) in enumerate(spans):
        firsts, ends = units[a:b, 0], units[a:b, 1]
        assert (ends - firsts <= U).all() and (firsts < ends).all()
        if b > a:
            assert firsts[0] == pstart[t] and ends[-1] == pstart[t] + pcount[t]
            assert (firsts[1:] == ends[:-1]).all()
    # the rows past the last span are empty
    assert (units[spans[-1, 1]:, 0] == units[spans[-1, 1]:, 1]).all()


@pytest.mark.parametrize("c", [1, 2048, 2049, 16384, 16385, 100_000, 1 << 27])
def test_level_bucket_classes(c):
    b = dp._level_bucket(c)
    assert b >= c and b % dp._ALIGN == 0
    assert b <= max(dp._ALIGN, 2 * c) and (c <= 8 * dp._ALIGN or b <= 1.125 * c)
    assert dp._level_bucket(b) == b


def test_level_geometry_is_pow2_and_periodic_safe():
    for cfg in PALLAS_LEVELS:
        for dim in (cfg.R, cfg.S, cfg.C):
            assert dim & (dim - 1) == 0  # Triton register tiles
        assert cfg.R * cfg.C <= 4096
    g = dp._level_geometry(PALLAS_LEVELS[1], MapSpec((64, 48), (0, 1, 0, 1), periodic_wrap=True))
    assert 48 % g.tx == 0 and g.tx > PALLAS_LEVELS[1].M
    with pytest.raises(ValueError):
        dp._level_geometry(PALLAS_LEVELS[3], MapSpec((100, 100), (0, 1, 0, 1), periodic_wrap=True))


def test_use_kernel_routes(monkeypatch):
    assert dp._use_kernel(True) is True
    assert dp._use_kernel(False) is False  # the test backend is the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert dp._use_kernel(False) is True
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="gpu"):
        dp._use_kernel(False)


# --- the compiled kernel, on the card ----------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("projection", ["kernel3d", "integrated"])
def test_compiled_kernel_matches_oracle(gpu, projection):
    rng = np.random.default_rng(11)
    box, npix, n = 10.0, 256, 200_000
    px = box / npix
    spec = MapSpec(shape=(npix, npix), extent=(0, box, 0, box), periodic_wrap=True)
    x = rng.uniform(0, box, n)
    y = rng.uniform(0, box, n)
    h = np.exp(rng.normal(np.log(1.0 * px), 0.8, n)).clip(0.05 * px, 15 * px)
    vals = rng.uniform(0.5, 2.0, (2, n))
    got = np.asarray(deposit_2d_auto(x, y, h, vals, spec, projection=projection))
    for f in range(2):
        exp = project_oracle_fast(
            x, y, h, vals[f], spec.shape, spec.extent, periodic=True,
            projection=projection,
        )
        assert rel_err(got[f], exp) < 1e-5


@pytest.mark.gpu
def test_compiled_kernel_is_deterministic(gpu):
    """Dense tiles that span several units, compiled: three renders agree
    bit for bit, and with the f64 oracle."""
    from astro_sph_tools_tpu.utils.determinism import assert_deterministic

    rng = np.random.default_rng(13)
    box, npix = 10.0, 256
    px = box / npix
    spec = MapSpec(shape=(npix, npix), extent=(0, box, 0, box), periodic_wrap=True)
    # 40 tiles of 3-6 units each inside a uniform background
    n_bg, per_clump = 100_000, 5 * dp._UNIT
    cx = rng.uniform(0, box, 40).repeat(per_clump)
    cy = rng.uniform(0, box, 40).repeat(per_clump)
    x = np.concatenate([rng.uniform(0, box, n_bg), (cx + rng.uniform(0, 4 * px, cx.size)) % box])
    y = np.concatenate([rng.uniform(0, box, n_bg), (cy + rng.uniform(0, 4 * px, cy.size)) % box])
    h = np.exp(rng.normal(np.log(0.8 * px), 0.5, x.size)).clip(0.1 * px, 3 * px)
    vals = rng.uniform(0.5, 2.0, (2, x.size))
    tp = tile_particles(x, y, h, vals, spec)
    counts = np.bincount(np.asarray(tp.sorted_tile[: tp.geoms[0][3]]))
    assert counts.max() > 2 * dp._UNIT
    assert_deterministic(lambda: np.asarray(deposit_tiled(tp)), n_runs=3)
    got = np.asarray(deposit_2d_auto(x, y, h, vals, spec))
    for f in range(2):
        exp = project_oracle_fast(x, y, h, vals[f], spec.shape, spec.extent, periodic=True)
        assert rel_err(got[f], exp) < 1e-5
