"""Seeded cross-engine fuzz: the sorted engine on both of its routes, the
plain stencil engine and the dense oracle must agree on random
configurations — shapes, periodicity, field counts, input order, h dynamic
range, off-extent particles. Complements the targeted cases in
test_deposit_pallas.py with combinatorial coverage."""

import numpy as np
import pytest

from astro_sph_tools_tpu.ops.deposit import MapSpec, deposit_2d
from astro_sph_tools_tpu.ops.deposit_pallas import deposit_2d_auto

from oracles import project_oracle_fast

# compile-heavy (interpret-mode Pallas / shard_map meshes): slow lane
pytestmark = pytest.mark.slow


def _random_case(seed: int):
    rng = np.random.default_rng(seed)
    box = float(rng.uniform(5.0, 50.0))
    res = int(rng.choice([64, 96, 128, 256]))
    periodic = bool(rng.integers(0, 2))
    n_fields = int(rng.integers(1, 4))
    n = int(rng.integers(3_000, 40_000))
    px = box / res
    order = rng.choice(["morton", "random", "half"])

    cx = rng.uniform(0, box, n)
    cy = rng.uniform(0, box, n)
    if order != "random":
        cell = (
            np.floor(cy / (box / 16)).astype(int) * 16
            + np.floor(cx / (box / 16)).astype(int)
        )
        idx = np.argsort(cell, kind="stable")
        if order == "half":  # partially coherent: shuffle a random slice
            cut = n // 3
            idx[:cut] = rng.permutation(idx[:cut])
        cx, cy = cx[idx], cy[idx]
    h = np.clip(
        np.exp(rng.normal(np.log(0.5 * px), rng.uniform(0.3, 1.2), n)),
        0.02 * px,
        14.0 * px,
    ).astype(np.float32)
    x = cx.astype(np.float32)
    y = cy.astype(np.float32)
    if not periodic and rng.integers(0, 2):
        x[:: int(rng.integers(50, 200))] += box  # off-extent support
    vals = rng.uniform(0.1, 2.0, (n_fields, n)).astype(np.float32)
    spec = MapSpec(
        shape=(res, res), extent=(0.0, box, 0.0, box), periodic_wrap=periodic
    )
    return x, y, h, vals, spec


@pytest.mark.parametrize("seed", range(4))
def test_grid3d_auto_random_configs(seed):
    """The 3D deposit vs the f64 voxel oracle on random shapes,
    periodicity, field counts, and h ranges (incl. the oversize dense
    fallback)."""
    from astro_sph_tools_tpu.ops import GridSpec, deposit_3d_auto
    from oracles import grid3d_oracle

    rng = np.random.default_rng(100 + seed)
    box = float(rng.uniform(4.0, 20.0))
    res = int(rng.choice([12, 16, 24]))
    periodic = bool(rng.integers(0, 2))
    n_fields = int(rng.integers(1, 3))
    n = int(rng.integers(300, 3_000))
    vox = box / res
    pos = rng.uniform(0, box, (n, 3))
    h = 10.0 ** rng.uniform(-0.6, rng.uniform(0.5, 1.0), n) * vox * 0.4
    vals = rng.uniform(0.1, 2.0, (n_fields, n))
    spec = GridSpec(
        shape=(res, res, res), extent=(0.0, box) * 3, periodic_wrap=periodic
    )
    got = np.asarray(deposit_3d_auto(pos, h, vals, spec))
    if got.ndim == 3:
        got = got[None]
    for f in range(n_fields):
        ref = grid3d_oracle(
            pos, h, vals[f], spec.shape, spec.extent, periodic=periodic
        )
        rel = np.abs(got[f] - ref).max() / np.abs(ref).max()
        assert rel < 1e-5, (seed, f, rel)


@pytest.mark.parametrize("seed", range(6))
def test_engines_agree_on_random_configs(seed):
    x, y, h, vals, spec = _random_case(seed)
    imgs = {
        # the sorted layout on both routes: XLA's scatter-add (what the CPU
        # runs) and the Triton kernel in the Pallas interpreter
        "sorted-xla": np.asarray(deposit_2d_auto(x, y, h, vals, spec)),
        "sorted-kernel": np.asarray(
            deposit_2d_auto(x, y, h, vals, spec, interpret=True)
        ),
        "plain": np.moveaxis(
            np.asarray(deposit_2d(x, y, h, vals.T, spec)), -1, 0
        ).reshape(vals.shape[0], *spec.shape),
    }
    ref = np.stack(
        [
            project_oracle_fast(
                x, y, h, vals[f], spec.shape,
                tuple(float(e) for e in spec.extent),
                periodic=spec.periodic_wrap,
            )
            for f in range(vals.shape[0])
        ]
    )
    scale = np.abs(ref).max()
    for name, img in imgs.items():
        assert img.shape == ref.shape, name
        rel = np.abs(img - ref).max() / scale
        # f32 engines vs f64 oracle: accumulation drift scales with the
        # per-pixel contribution count (seed 2 piles thousands of large-h
        # contributions per pixel of a 64^2 map -> ~1e-4; the engines land
        # on the same value to ~2e-7)
        assert rel < 5e-4, (name, rel)
    # engines must agree with each other much tighter than with the oracle
    for a, b in (("sorted-kernel", "sorted-xla"), ("sorted-xla", "plain")):
        rel = np.abs(imgs[a] - imgs[b]).max() / scale
        assert rel < 1e-5, (a, b, rel)
