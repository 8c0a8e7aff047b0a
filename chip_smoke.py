"""Smoke run of the system on a GPU: the main path once, compiled, checked.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --four-gpus  # the sharded path on a four-GPU mesh

One process drives the card(s); no phase catches its own failure, so any
failed check ends the run with a traceback and a non-zero exit code, and the
final line is printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases on one GPU:

1. compile — the adaptive deposit's per-level Triton kernels at the 1024^2
   map's real widths, with the memory analysis of the whole render step;
2. main — the north-star per-card proxy (2^27 Morton-ordered clustered
   particles, lognormal density-correlated h over every footprint level,
   2 fields, a 1024^2 periodic map) through ``deposit_2d_auto``, compared
   at full size with the plain XLA ``deposit_2d`` and, on a seeded subset
   of 2^20 particles, with the f64 oracle (``tests/oracles.py``); both to
   ``max|got - ref| / max|ref| <= 1e-5`` per field;
3. reach — a 3D voxel cube, sightline columns, Voigt spectra and an
   ion-weighted map, each against its reference;
4. gpu tests — the ``gpu``-marked tests, in this process.

The machine with the card has no h5py, so no phase reads or writes a
snapshot file; the IO layer is covered by the CPU tests.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUDGET = 1e-5  # the project's fidelity metric (benchmarks/fidelity_check.py)
BOX = 25.0
SHAPE = (1024, 1024)
N_MAIN = 1 << 27  # the north-star per-card proxy
N_SUB = 1 << 20  # the main phase's f64-oracle subset
N_CARD = 250_000_000  # --four-gpus: the 1e9 north star over 4 cards
N_CARD_CUT = 1 << 27  # ... per card, should that not fit
N3, G3 = 1 << 24, 512  # --four-gpus: the slab-sharded cube
N_IDS = 1 << 24  # --four-gpus: the distributed reorder


def rel_err(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def check(name: str, err: float, limit: float = BUDGET) -> None:
    print(f"  {name}: max|d|/max|ref| = {err:.3e} (limit {limit:.0e})", flush=True)
    if not err <= limit:
        raise AssertionError(f"{name}: {err:.3e} > {limit:.0e}")


def nvidia_smi() -> str:
    """Each card's name and power limit, one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# one GPU
# ---------------------------------------------------------------------------


def phase_compile_and_main(card: str) -> None:
    import jax
    import numpy as np

    from astro_sph_tools_tpu.ops import deposit_pallas as dp
    from astro_sph_tools_tpu.ops.deposit import MapSpec, deposit_2d
    from northstar_proxy import build_particles
    from oracles import project_oracle_fast

    spec = MapSpec(shape=SHAPE, extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    n = N_MAIN
    x, y, h, fields = build_particles(n, BOX, SHAPE, order="morton")

    print("[compile] per-level kernels at the 1024^2 map's widths", flush=True)
    tp, t_layout = timed(lambda: dp.tile_particles(x, y, h, fields, spec))
    for geom, _, bucket, count in tp.geoms:
        c = geom.cfg
        print(f"  K={c.K}: {count} particles, bucket {bucket}, tile {c.TY}x{geom.tx}, "
              f"accumulator {c.R}x{c.S} in {c.R // c.RB} band(s), chunk {c.C}", flush=True)
    print(f"  oversize (dense XLA path): {tp.n_oversize}", flush=True)
    fn, args = dp._layout_program(tp, "kernel3d", True, False)
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    print(f"  render step compiled in {time.perf_counter() - t0:.1f} s; "
          f"memory_analysis: {compiled.memory_analysis()}", flush=True)
    del tp, compiled
    tp, t_layout_warm = timed(lambda: dp.tile_particles(x, y, h, fields, spec))
    jax.block_until_ready(tp.sorted_values)
    _, t_deposit_warm = timed(lambda: dp.deposit_tiled(tp))
    print(f"  warm: layout {t_layout_warm:.4f} s, deposit (all levels, overlap-add "
          f"included) {t_deposit_warm:.4f} s", flush=True)
    del tp

    print(f"[main] deposit_2d_auto, {n} particles, 2 fields, 1024^2 "
          f"periodic ({card})", flush=True)
    first, t_first = timed(lambda: dp.deposit_2d_auto(x, y, h, fields, spec))
    got, t_warm = timed(lambda: dp.deposit_2d_auto(x, y, h, fields, spec))
    got = np.asarray(got)
    print(f"  first call {t_first:.3f} s, warm call {t_warm:.4f} s "
          f"(layout alone, first: {t_layout:.3f} s)", flush=True)
    if got.shape != (2,) + SHAPE or not np.isfinite(got).all():
        raise AssertionError(f"bad map: shape {got.shape}")
    if not np.array_equal(np.asarray(first), got):
        raise AssertionError("two renders of one input differ: the deposit "
                             "is not bitwise reproducible")
    print("  the two renders are bitwise equal", flush=True)
    del first

    xs, ys, hs, fs = (np.asarray(a) for a in (x, y, h, fields))
    with jax.default_matmul_precision("highest"):
        ref, t_ref = timed(lambda: deposit_2d(xs, ys, hs, fs.T, spec))
    ref = np.moveaxis(np.asarray(ref), -1, 0)
    print(f"  plain XLA deposit_2d (reference) {t_ref:.2f} s", flush=True)
    for f in range(2):
        check(f"field {f} vs plain deposit_2d, full size", rel_err(got[f], ref[f]))
    del ref

    n_sub = N_SUB
    sub = np.random.default_rng(0).choice(n, n_sub, replace=False)
    xs, ys, hs, fs = xs[sub].astype(np.float64), ys[sub].astype(np.float64), hs[sub], fs[:, sub]
    got = np.asarray(dp.deposit_2d_auto(xs, ys, hs, fs, spec))
    for f in range(2):
        exp = project_oracle_fast(xs, ys, hs, fs[f], SHAPE, spec.extent, periodic=True)
        check(f"field {f} vs f64 oracle, {n_sub}-particle subset", rel_err(got[f], exp))
    print(f"  peak device memory: "
          f"{(jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')} bytes",
          flush=True)


def phase_reach() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from astro_sph_tools_tpu.data_structures.ionisation import IonisationTableBase
    from astro_sph_tools_tpu.ops.deposit import MapSpec
    from astro_sph_tools_tpu.ops.deposit_pallas import deposit_2d_auto
    from astro_sph_tools_tpu.ops.grid3d import GridSpec, deposit_3d_auto
    from astro_sph_tools_tpu.ops.interp import regular_grid_interpolate
    from astro_sph_tools_tpu.ops.sightlines import column_integrate, column_integrate_binned
    from astro_sph_tools_tpu.ops.spectra import absorption_spectra, absorption_spectra_binned
    from oracles import grid3d_oracle_fast, project_oracle_fast
    from scipy.interpolate import RegularGridInterpolator

    rng = np.random.default_rng(1)

    n, g = 1 << 19, 128
    print(f"[reach] 3D voxel cube: {n} particles, {g}^3 periodic", flush=True)
    spec3 = GridSpec(shape=(g,) * 3, extent=(0.0, BOX) * 3, periodic_wrap=True)
    vox = BOX / g
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    h = np.exp(rng.normal(np.log(1.5 * vox), 0.5, n)).clip(0.2 * vox, 6 * vox)
    m = rng.uniform(0.5, 2.0, n)
    cube, dt = timed(lambda: deposit_3d_auto(pos, h, m, spec3))
    print(f"  deposit_3d {dt:.2f} s (first call)", flush=True)
    exp = grid3d_oracle_fast(pos.astype(np.float64), h, m, spec3.shape,
                             spec3.extent, periodic=True)
    check("cube vs f64 oracle", rel_err(cube, exp))

    n, n_rays = 1 << 20, 4096
    print(f"[reach] sightline columns: {n} particles, {n_rays} rays "
          "(config 4 is 1e7 x 1e4)", flush=True)
    x, y = rng.uniform(0, BOX, n), rng.uniform(0, BOX, n)
    h = np.exp(rng.normal(np.log(0.05), 0.5, n)).clip(0.01, 0.5)
    m = rng.uniform(0.5, 2.0, n)
    rx, ry = rng.uniform(0, BOX, n_rays), rng.uniform(0, BOX, n_rays)
    cols, dt = timed(lambda: column_integrate_binned(x, y, h, m, rx, ry, periodic_box=BOX))
    dense = column_integrate(x, y, h, m, rx, ry, periodic_box=BOX)
    print(f"  binned engine {dt:.2f} s (first call)", flush=True)
    check("binned columns vs dense engine", rel_err(cols, dense))

    n, n_rays = 1 << 18, 256
    print(f"[reach] Voigt spectra: {n} particles, {n_rays} rays, 256 bins", flush=True)
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    h = np.exp(rng.normal(np.log(0.1), 0.5, n)).clip(0.02, 0.6).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    vlos = rng.normal(0.0, 80.0, n).astype(np.float32)
    temp = rng.uniform(1e4, 1e6, n).astype(np.float32)
    rx, ry = rng.uniform(0, BOX, n_rays), rng.uniform(0, BOX, n_rays)
    kw = dict(box_size=BOX, n_bins=256, profile="voigt", gamma=6.265e8)
    (tau, _), dt = timed(lambda: absorption_spectra_binned(pos, h, m, vlos, temp, rx, ry, **kw))
    tau_ref, _ = absorption_spectra(pos, h, m, vlos, temp, rx, ry, **kw)
    print(f"  binned engine {dt:.2f} s (first call)", flush=True)
    check("binned Voigt spectra vs dense engine", rel_err(tau, tau_ref))

    n = 1 << 20
    print(f"[reach] ion-weighted map: {n} particles, HM01-schema table, "
          "512^2", flush=True)
    # an HM01-schema table built in memory (the schema of
    # io.ionisation.write_synthetic_hm01_table, which needs h5py)
    log_nh = np.linspace(-8.0, 0.0, 16)
    log_t = np.linspace(2.0, 8.0, 20)
    zs = np.linspace(0.0, 8.0, 8)
    D, T, Z = np.meshgrid(log_nh, log_t, zs, indexing="ij")
    table = IonisationTableBase(
        -((T - 4.5) ** 2) / 2.0 + 0.2 * D - 0.1 * Z, log_nh, log_t, zs,
        redshift_input_index=2,
    )
    axes2, grid2 = table.table_at_redshift(0.5)
    spec = MapSpec(shape=(512, 512), extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    px = BOX / 512
    x, y = rng.uniform(0, BOX, n), rng.uniform(0, BOX, n)
    h = np.exp(rng.normal(np.log(1.2 * px), 0.5, n)).clip(0.1 * px, 14 * px)
    mass = np.exp(rng.normal(0.0, 0.3, n))
    gas = np.stack([rng.normal(-4.0, 1.2, n), rng.normal(4.8, 0.6, n)], axis=1)

    @jax.jit
    def ion_mass(gas_state, mass):
        logf = regular_grid_interpolate(
            tuple(a.astype(jnp.float32) for a in axes2), grid2.astype(jnp.float32),
            gas_state, fill_value=-jnp.inf,
        )
        return mass * jnp.power(10.0, logf)

    def render():
        w = ion_mass(jnp.asarray(gas, jnp.float32), jnp.asarray(mass, jnp.float32))
        return deposit_2d_auto(x, y, h, w, spec)

    got, dt = timed(render)
    print(f"  interp + deposit {dt:.2f} s (first call)", flush=True)
    f64 = RegularGridInterpolator(
        tuple(np.asarray(a, np.float64) for a in axes2), np.asarray(grid2, np.float64),
        bounds_error=False, fill_value=-np.inf,
    )(gas)
    exp = project_oracle_fast(x, y, h, mass * 10.0**f64, spec.shape, spec.extent, periodic=True)
    check("ion-weighted map vs f64 (scipy interp + oracle)", rel_err(got, exp))


def phase_gpu_tests() -> None:
    import pytest

    class Count:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call":
                self.passed += report.passed
                self.failed += report.failed

    count = Count()
    print("[gpu tests] pytest -m gpu", flush=True)
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_deposit_pallas.py")],
        plugins=[count],
    )
    if rc != 0 or count.failed or not count.passed:
        raise AssertionError(f"gpu tests: rc={rc}, {count.passed} passed, {count.failed} failed")


# ---------------------------------------------------------------------------
# four GPUs
# ---------------------------------------------------------------------------


def phase_four_gpus(card: str) -> None:
    """The sharded path on a 4-device mesh and what it is compared with:
    the 2D map against the host sum of single-device renders of each shard,
    the 3D cube against a single-device deposit, the distributed reorder
    against NumPy."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from astro_sph_tools_tpu.ops.deposit import MapSpec
    from astro_sph_tools_tpu.ops.deposit_pallas import _ALIGN, deposit_2d_auto
    from astro_sph_tools_tpu.ops.grid3d import GridSpec, deposit_3d
    from astro_sph_tools_tpu.parallel.reorder import distributed_reorder
    from astro_sph_tools_tpu.parallel.sharded import (
        deposit_2d_sharded,
        deposit_3d_sharded,
        make_mesh,
        partition_particles_by_slab,
    )
    from northstar_proxy import build_particles

    devs = jax.devices()
    if len(devs) != 4:
        raise AssertionError(f"--four-gpus needs 4 devices, found {len(devs)}")
    mesh = make_mesh(4)
    sharded = NamedSharding(mesh, P("data"))
    spec = MapSpec(shape=SHAPE, extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)

    def shards(n):
        """Each device draws its own shard of one snapshot in place."""
        out = []
        for d, dev in enumerate(devs):
            with jax.default_device(dev):
                x, y, h, f = build_particles(n, BOX, SHAPE, order="morton",
                                             shard=d, n_shards=4)
                out.append((x, y, h, f.T))
        return out

    def global_array(parts):
        n = sum(p.shape[0] for p in parts)
        return jax.make_array_from_single_device_arrays(
            (n,) + parts[0].shape[1:], sharded, parts
        )

    def render(n):
        parts = shards(n)
        arrays = [global_array([p[i] for p in parts]) for i in range(4)]
        fn = jax.jit(lambda x, y, h, v: deposit_2d_sharded(x, y, h, v, spec, mesh, K=64))
        return parts, arrays, fn

    n_card = -(-N_CARD // _ALIGN) * _ALIGN
    n3, g3, n_ids = N3, G3, N_IDS
    parts, arrays, fn = render(n_card)
    mem = fn.lower(*arrays).compile().memory_analysis()
    need = (mem.temp_size_in_bytes + mem.argument_size_in_bytes
            + mem.output_size_in_bytes)
    limit = (devs[0].memory_stats() or {}).get("bytes_limit", float("inf"))
    print(f"[4 gpus] 2D sharded render at {n_card} particles per card: "
          f"memory_analysis needs {need} of {limit} bytes per card", flush=True)
    if need > 0.9 * limit:
        n_card = N_CARD_CUT
        print(f"  too large: cut to {n_card} particles per card", flush=True)
        del parts, arrays
        parts, arrays, fn = render(n_card)
    img, t_first = timed(lambda: fn(*arrays))
    img, t_warm = timed(lambda: fn(*arrays))
    img = np.moveaxis(np.asarray(img), -1, 0)
    print(f"  deposit_2d_sharded: {4 * n_card} particles, 2 fields, 1024^2 "
          f"periodic: first {t_first:.2f} s, warm {t_warm:.4f} s ({card})", flush=True)
    ref = np.zeros_like(img, np.float64)
    for x, y, h, v in parts:
        ref += np.asarray(deposit_2d_auto(x, y, h, v.T, spec))
    del parts, arrays
    for f in range(2):
        check(f"field {f} vs host sum of single-card renders", rel_err(img[f], ref[f]))

    print(f"[4 gpus] 3D slab-sharded cube: {n3} particles, {g3}^3 periodic", flush=True)
    rng = np.random.default_rng(3)
    spec3 = GridSpec(shape=(g3,) * 3, extent=(0.0, BOX) * 3, periodic_wrap=True)
    pos = rng.uniform(0, BOX, (n3, 3)).astype(np.float32)
    h = np.full(n3, 0.45 * BOX / g3, np.float32)  # support inside the K=4 stencil
    m = rng.uniform(0.5, 2.0, n3).astype(np.float32)
    pp, hp, mp = partition_particles_by_slab(pos, h, m, spec3, 4, chunk=4096)
    # host arrays: voxel frames in f64, as the single-device deposit_3d
    cube, dt = timed(lambda: deposit_3d_sharded(pp, hp, mp, spec3, mesh, K=4, chunk=4096))
    print(f"  deposit_3d_sharded {dt:.2f} s (first call)", flush=True)
    check("sharded cube vs single-card deposit_3d",
          rel_err(cube, deposit_3d(pos, h, m, spec3)))

    print(f"[4 gpus] distributed_reorder: {n_ids} IDs", flush=True)
    data = rng.normal(size=n_ids).astype(np.float32)
    for label, src in (
        ("int32", rng.permutation(n_ids).astype(np.int32)),
        ("int64 (hi, lo)", np.int64(2) ** 40 + rng.permutation(n_ids).astype(np.int64) * 3),
    ):
        tgt = rng.permutation(src)
        (out, matched, overflow), dt = timed(lambda: distributed_reorder(src, data, tgt, mesh))
        expect = data[np.argsort(src)][np.searchsorted(np.sort(src), tgt)]
        if not (bool(np.asarray(matched).all()) and not bool(overflow)
                and np.array_equal(np.asarray(out), expect)):
            raise AssertionError(f"distributed_reorder ({label}) differs from NumPy")
        print(f"  {label}: equal to NumPy, {dt:.2f} s (first call)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded path on a four-GPU mesh")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks"), os.path.join(ROOT, "tests")]
    from astro_sph_tools_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    try:
        import h5py  # noqa: F401

        has_h5py = True
    except ImportError:
        has_h5py = False
    smi = nvidia_smi()
    card = smi.splitlines()[0]  # the first card, beside every time printed
    dev = jax.devices()[0]
    print(f"devices: {jax.devices()}", flush=True)
    print(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
          f"h5py importable: {has_h5py}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    if args.four_gpus:
        phase_four_gpus(card)
    else:
        phase_compile_and_main(card)
        phase_reach()
        phase_gpu_tests()
    print(f"all phases passed in {time.perf_counter() - t0:.0f} s ({card})", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
