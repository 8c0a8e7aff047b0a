"""Benchmark: adaptive-h particle deposits/sec onto a 1024^2 two-field map.

The workload is the north-star per-card proxy of
``benchmarks/northstar_proxy.py``: 2^27 Morton-ordered clustered particles
with density-correlated lognormal smoothing lengths over every footprint
level, a two-field stack on a 1024^2 periodic map. The timed window is
layout + deposit, end to end, best of three, on the route the platform
chooses (the Triton kernel on a GPU); the same layout feeding XLA's
scatter-add is timed beside it.

    python bench.py [--log2-n 27] [--repeats 3]

Needs a GPU: on any other backend it exits non-zero and prints no result.
Prints one JSON line naming the platform, device kind and count, and the
card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-n", type=int, default=27)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    sys.path[:0] = [_REPO, os.path.join(_REPO, "benchmarks")]
    from astro_sph_tools_tpu.utils.compile_cache import use_compile_cache
    from northstar_proxy import run

    use_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    n = 1 << args.log2_n
    kernel = run(n, "morton", args.repeats, use_kernel=True)
    xla = run(n, "morton", args.repeats, use_kernel=False)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "adaptive-h particle-deposits/sec, 1024^2 2-field map "
                  "(layout + deposit, Morton-ordered clustered workload)",
        "value": n / kernel["wall_s"],
        "unit": "deposits/sec",
        "n_particles": n,
        "wall_s": kernel["wall_s"],
        "walls_s": kernel["walls_s"],
        "xla_route_wall_s": xla["wall_s"],
        "xla_route_walls_s": xla["walls_s"],
        "level_counts": kernel["level_counts"],
        "n_oversize": kernel["n_oversize"],
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
