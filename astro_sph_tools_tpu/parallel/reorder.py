"""Distributed ID-matched reorder over a device mesh.

The TPU-native replacement for ``ArrayReorder_MPI``
(`/root/reference/src/astro_sph_tools/tools/_ArrayReorder.py:262-656`): the
reference root-gathers both ID orders, builds a per-element rank assignment
(~12 minutes at 3.4e9 IDs, `:572`), and moves data pair-wise through a
round-robin ``comm.sendrecv`` tournament (`:48-84,299-373`). Here the plan
*is* the exchange: a deterministic owner shard per ID and two
``lax.all_to_all`` hops between devices, everything jit-compiled:

1. every ID is owned by a shard derived from its low bits;
2. sources bucket their (id, value) pairs by owner and exchange
   (``all_to_all``); owners hold a directory of their IDs' values;
3. targets send their wanted IDs to the owners the same way; owners answer
   by a sort-join lookup; the reverse ``all_to_all`` returns values in the
   exact slot layout of the request, so the requester finishes with a pure
   local gather — no scatter anywhere.

**int64 IDs without x64 mode**: the reference's ID contract is int64
(`io/data_structures/_SnapshotBase.py:28-41`, EAGLE/TNG IDs routinely exceed
2^31). IDs travel as (hi, lo) int32 channel pairs; ownership hashes both
halves and matching is an exact lexicographic sort-join — full 2^63 range on
a TPU mesh that only has 32-bit integers.

Static shapes throughout: per-destination buckets are padded to
``capacity = ceil(N_shard / n_dev * capacity_factor)``; an overflow flag is
returned instead of silent truncation (matches-by-construction workloads —
near-uniform ID hashing — keep the factor small).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def _owner_of(id_channels, n_dev):
    """Deterministic owner shard per ID (uniform-ish for hashed/serial IDs)."""
    if len(id_channels) == 1:
        return jnp.abs(id_channels[0]) % n_dev
    hi, lo = id_channels
    return jnp.abs(lo ^ hi) % n_dev


def _bucket_pack(id_channels, valid, payloads, n_dev, cap):
    """Sort local elements by owner shard and pack (n_dev, cap) send buffers.

    Returns (packed id channels, packed valid, packed payloads, slot index
    per local element, overflow flag). Padding slots carry valid = 0.
    """
    n = id_channels[0].shape[0]
    owner = _owner_of(id_channels, n_dev)
    order = jnp.argsort(owner)
    owner_sorted = owner[order]
    starts = jnp.searchsorted(owner_sorted, jnp.arange(n_dev, dtype=owner.dtype))
    counts = (
        jnp.searchsorted(owner_sorted, jnp.arange(n_dev, dtype=owner.dtype), side="right")
        - starts
    )
    overflow = jnp.any(counts > cap)
    pos_in_bucket = jnp.arange(n) - starts[owner_sorted]
    slot_sorted = owner_sorted * cap + pos_in_bucket
    ok = pos_in_bucket < cap

    def pack(a, fill=0):
        buf = jnp.full((n_dev * cap,) + a.shape[1:], fill, dtype=a.dtype)
        buf = buf.at[jnp.where(ok, slot_sorted, n_dev * cap)].set(a[order], mode="drop")
        return buf.reshape((n_dev, cap) + a.shape[1:])

    packed_ids = [pack(c) for c in id_channels]
    packed_valid = pack(valid.astype(jnp.int32))
    packed_payloads = [pack(p) for p in payloads]

    slot_of_element = jnp.zeros(n, dtype=jnp.int32)
    slot_of_element = slot_of_element.at[order].set(slot_sorted.astype(jnp.int32))
    return packed_ids, packed_valid, packed_payloads, slot_of_element, overflow


def _sort_join_lookup(owned_ids, owned_valid, owned_values, q_ids, q_valid, default_value):
    """For each query ID, the owned value (or default) — exact lexicographic
    sort-join over 1- or 2-channel (int64-pair) IDs.

    Sort (id..., role) with role 0 = owned, 1 = query, 2 = invalid; every
    query then matches the latest preceding owned entry of the same ID (a
    cumulative-max scan), so duplicate queries all resolve.
    """
    n_o = owned_ids[0].shape[0]
    n_q = q_ids[0].shape[0]
    n = n_o + n_q
    role = jnp.concatenate(
        [
            jnp.where(owned_valid > 0, 0, 2).astype(jnp.int32),
            jnp.where(q_valid > 0, 1, 2).astype(jnp.int32),
        ]
    )
    chans = [
        jnp.concatenate([o, q]) for o, q in zip(owned_ids, q_ids)
    ]
    idx = jnp.concatenate(
        [jnp.arange(n_o, dtype=jnp.int32), jnp.arange(n_q, dtype=jnp.int32)]
    )
    sorted_ops = jax.lax.sort(chans + [role, idx], num_keys=len(chans) + 1)
    s_chans = sorted_ops[: len(chans)]
    s_role = sorted_ops[len(chans)]
    s_idx = sorted_ops[len(chans) + 1]

    # last owned position at or before each slot
    pos = jnp.arange(n, dtype=jnp.int32)
    own_pos = jnp.where(s_role == 0, pos, -1)
    last_own = jax.lax.associative_scan(jnp.maximum, own_pos)
    last_own_c = jnp.maximum(last_own, 0)
    same = last_own >= 0
    for c in s_chans:
        same = same & (c[last_own_c] == c)
    hit_sorted = (s_role == 1) & same

    # scatter answers back into query order
    src = s_idx[last_own_c]  # owned index supplying each slot (where hit)
    qslot = jnp.where(s_role == 1, s_idx, n_q)
    values = jnp.zeros((n_q,) + owned_values.shape[1:], owned_values.dtype)
    values = values + jnp.asarray(default_value, owned_values.dtype)
    picked = jnp.where(
        hit_sorted.reshape((-1,) + (1,) * (owned_values.ndim - 1)),
        owned_values[src],
        jnp.asarray(default_value, owned_values.dtype),
    )
    values = values.at[jnp.where(hit_sorted, qslot, n_q)].set(picked, mode="drop")
    hits = jnp.zeros(n_q, bool).at[jnp.where(hit_sorted, qslot, n_q)].set(
        True, mode="drop"
    )
    return values, hits


def _split_int64(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 -> (hi, lo) int32 channel pair (bit-exact, sign-safe)."""
    ids = np.asarray(ids, np.int64)
    hi = (ids >> 32).astype(np.int32)
    lo = (ids & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo


def distributed_reorder(
    source_ids,
    source_data: Array,
    target_ids,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    default_value: float = 0.0,
    capacity_factor: Optional[float] = None,
) -> tuple[Array, Array, Array]:
    """Reorder ``source_data`` (ordered by ``source_ids``) into the order of
    ``target_ids``, all three sharded along axis 0 over *mesh*.

    IDs may be int32 device arrays OR int64 NumPy arrays — int64 IDs travel
    as (hi, lo) int32 pairs (full 2^63 range, no x64 mode). Returns
    (reordered data, matched mask, overflow flag). Unmatched target slots
    carry ``default_value``. Shapes must divide evenly over the mesh.

    ``capacity_factor=None`` (default) sizes the exchange buckets exactly by
    a host pass over the IDs; pass a float (e.g. 1.3) to skip that pass and
    size buckets as ``ceil(N_shard / n_dev * factor)`` — the overflow flag
    reports if any bucket spilled (results are then incomplete).
    """
    n_dev = mesh.shape[axis_name]
    # host arrays go straight to their shards, never whole onto one device
    sharded = NamedSharding(mesh, P(axis_name))

    def channels(ids):
        if isinstance(ids, np.ndarray) and ids.dtype == np.int64:
            return [jax.device_put(c, sharded) for c in _split_int64(ids)]
        return [jax.device_put(ids, sharded)]

    src_ch = channels(source_ids)
    tgt_ch = channels(target_ids)
    if len(src_ch) != len(tgt_ch):
        raise ValueError("source and target IDs must share a dtype family")

    ns_local = src_ch[0].shape[0] // n_dev
    nt_local = tgt_ch[0].shape[0] // n_dev

    def _exact_cap(ch, n_local):
        host = [np.asarray(c).reshape(n_dev, n_local) for c in ch]
        if len(host) == 1:
            owner = np.abs(host[0]) % n_dev
        else:
            owner = np.abs(host[1] ^ host[0]) % n_dev
        worst = 1
        for shard in owner:
            worst = max(worst, int(np.bincount(shard, minlength=n_dev).max()))
        return worst

    if capacity_factor is None:
        cap_s = _exact_cap(src_ch, ns_local)
        cap_t = _exact_cap(tgt_ch, nt_local)
    else:
        cap_s = max(1, int(np.ceil(ns_local / n_dev * capacity_factor)))
        cap_t = max(1, int(np.ceil(nt_local / n_dev * capacity_factor)))

    n_ch = len(src_ch)
    id_specs = tuple(P(axis_name) for _ in range(n_ch))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(id_specs, P(axis_name), id_specs),
        out_specs=(P(axis_name), P(axis_name), P()),
    )
    def step(src_ids, src_data, tgt_ids):
        ones_s = jnp.ones(src_ids[0].shape[0], jnp.int32)
        ones_t = jnp.ones(tgt_ids[0].shape[0], jnp.int32)

        def exchange(a):
            return jax.lax.all_to_all(
                a, axis_name, split_axis=0, concat_axis=0, tiled=False
            )

        # 1) sources -> owners
        packed_ids, packed_valid, (packed_data,), _, overflow_s = _bucket_pack(
            src_ids, ones_s, [src_data], n_dev, cap_s
        )
        owned_ids = [exchange(c).reshape(-1) for c in packed_ids]
        owned_valid = exchange(packed_valid).reshape(-1)
        owned_data = exchange(packed_data).reshape((-1,) + packed_data.shape[2:])

        # 2) targets -> owners (requests)
        req_ids, req_valid, _, slot_of_target, overflow_t = _bucket_pack(
            tgt_ids, ones_t, [], n_dev, cap_t
        )
        owner_queries = [exchange(c).reshape(-1) for c in req_ids]
        owner_q_valid = exchange(req_valid).reshape(-1)

        # 3) owners answer by sort-join
        answers, hits = _sort_join_lookup(
            owned_ids, owned_valid, owned_data,
            owner_queries, owner_q_valid, default_value,
        )
        answers = answers.reshape((n_dev, cap_t) + answers.shape[1:])
        hits = hits.reshape(n_dev, cap_t)

        # 4) reverse exchange: responses land in the request slot layout
        back_values = exchange(answers).reshape((-1,) + answers.shape[2:])
        back_hits = exchange(hits).reshape(-1)

        out = back_values[slot_of_target]
        matched = back_hits[slot_of_target]
        overflow = jax.lax.pmax(overflow_s | overflow_t, axis_name)
        return out, matched, overflow

    return step(tuple(src_ch), jax.device_put(source_data, sharded), tuple(tgt_ch))
