"""Even shard rebalancing over the device mesh.

TPU-native parity for the reference's ``mpi_redistribute_array_evenly``
(`/root/reference/src/astro_sph_tools/io/EAGLE/_SnapshotEAGLE.py:19,132-142`
— used so rank-local reads of uneven halo cutouts don't leave MPI ranks
with wildly different particle counts): a halo-centric or region-restricted
read on a mesh leaves shards with unequal valid counts, and every
``shard_map`` engine then runs at the slowest shard's pace.

Design: the repartition is ORDER-PRESERVING and fully static. Each valid
element's global rank r (shard offsets + local index) maps to destination
shard ``r // per_new``; the elements a shard sends to one destination are
a CONTIGUOUS local slice landing at a contiguous destination range, so the
exchange is one ``lax.all_to_all`` of per-destination buckets built by a
roll + range-mask (no gather/scatter anywhere). Receivers combine their
n_dev buckets by summation — the nonzero ranges are disjoint by
construction. Costs 2x the payload in flight; everything jit-compiled.
"""

from __future__ import annotations


from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def rebalance_evenly(
    arrays: Sequence[Array],
    counts,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    pad_values: Optional[Sequence[float]] = None,
):
    """Repartition axis-0-sharded arrays so every shard holds an equal
    share of the valid elements.

    Parameters
    ----------
    arrays : sequence of global jax.Arrays sharded along axis 0 over
        ``mesh``; each shard holds its ``counts[i]`` valid elements first,
        padding after (the :mod:`.sharded_io` layout).
    counts : (n_dev,) valid element count per shard (host array ok).
    pad_values : per-array fill for slots beyond the new valid count
        (default 0.0; pass 1.0 for smoothing lengths).

    Returns ``(arrays_rebalanced, new_counts)`` — same global shapes and
    shardings; ``new_counts`` is the host-side (n_dev,) even partition
    (``total // n_dev``, the first ``total % n_dev`` shards one more —
    spread is always <= 1).
    """
    n_dev = mesh.devices.size
    counts_h = np.asarray(jax.device_get(counts)).astype(np.int64)
    if counts_h.shape != (n_dev,):
        raise ValueError(f"counts must be ({n_dev},), got {counts_h.shape}")
    total = int(counts_h.sum())
    new_counts = np.full(n_dev, total // n_dev, np.int64)
    new_counts[: total % n_dev] += 1
    shard_len = arrays[0].shape[0] // n_dev
    if any(a.shape[0] != arrays[0].shape[0] for a in arrays):
        raise ValueError(
            "all arrays must share the sharded leading dimension; got "
            f"{[a.shape[0] for a in arrays]}"
        )
    if new_counts.max() > shard_len:
        raise ValueError(
            f"even share {int(new_counts.max())} exceeds the shard capacity "
            f"{shard_len}; grow the global padding before rebalancing"
        )
    if pad_values is None:
        pad_values = [0.0] * len(arrays)

    offsets = np.concatenate([[0], np.cumsum(counts_h)[:-1]])
    bounds = np.concatenate([[0], np.cumsum(new_counts)])  # dest rank edges
    sharding = NamedSharding(mesh, P(axis_name))
    meta = jnp.asarray(
        np.concatenate([
            np.stack([counts_h, offsets, new_counts]).reshape(-1),
            bounds,
        ]).reshape(1, -1),
        jnp.int32,
    )  # replicated run metadata

    def local_fn(meta_r, *blocks):
        i = jax.lax.axis_index(axis_name)
        meta_f = meta_r[0]
        c_i = meta_f[i]
        off_i = meta_f[n_dev + i]
        b_lo = meta_f[3 * n_dev :]
        idx = jnp.arange(shard_len, dtype=jnp.int32)
        outs = []
        for block, pad_value in zip(blocks, pad_values):
            buckets = []
            for d in range(n_dev):
                # contiguous local slice bound for destination d:
                # global ranks [bounds[d], bounds[d + 1])
                lo = jnp.clip(b_lo[d] - off_i, 0, c_i)
                hi = jnp.clip(b_lo[d + 1] - off_i, 0, c_i)
                p_start = jnp.maximum(off_i - b_lo[d], 0)
                # element at local lo must land at bucket position p_start
                shifted = jnp.roll(block, p_start - lo, axis=0)
                pos = idx
                mask = (pos >= p_start) & (pos < p_start + (hi - lo))
                mask = mask.reshape(
                    (shard_len,) + (1,) * (block.ndim - 1)
                )
                buckets.append(jnp.where(mask, shifted, 0))
            send = jnp.stack(buckets, axis=0)  # (n_dev, shard_len, ...)
            recv = jax.lax.all_to_all(
                send, axis_name, split_axis=0, concat_axis=0, tiled=False
            )  # (n_dev, shard_len, ...): bucket from each source
            combined = recv.sum(axis=0)
            n_new_i = meta_f[2 * n_dev + i]
            live = (idx < n_new_i).reshape(
                (shard_len,) + (1,) * (block.ndim - 1)
            )
            outs.append(
                jnp.where(live, combined, jnp.asarray(pad_value, block.dtype))
            )
        return tuple(outs)

    in_specs = (P(),) + tuple(P(axis_name) for _ in arrays)
    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=tuple(P(axis_name) for _ in arrays),
        )
    )
    meta_g = jax.device_put(meta, NamedSharding(mesh, P()))
    outs = fn(meta_g, *arrays)
    return list(outs), new_counts
