"""ID-matched array reordering and mapping.

Parity target: the ``ArrayReorder`` family
(`/root/reference/src/astro_sph_tools/tools/_ArrayReorder.py:813-1171`):
given a *source* ID ordering and a *target* ID ordering, build a reusable
operator that reorders any data array from source order to target order,
honouring optional boolean filters on either side and a default value for
unmatched output slots. ``ArrayReorder`` (both ID sets unique, invertible via
``.reverse``) and ``ArrayMapping`` (unique source IDs, possibly-duplicated
target IDs) keep the reference's call semantics:

    out[target_matched] = data[matched source positions in target ID order]
    out[~target_matched] = default_value  (or pre-existing output values)

plus the same introspection surface (input/output lengths, matched counts,
lossless/reduction/expansion flags).

The construction is re-architected for device execution: instead of the
reference's argsort-of-argsort + ``np.isin`` chains (and, in MPI form, a
root-gather plan build measured at ~12 min for 3.4e9 IDs,
`_ArrayReorder.py:536-572`), matching is one sort of the source IDs plus a
``searchsorted`` of the target IDs — O((N+M) log N) with
accelerator-friendly primitives. The multi-device equivalent lives in
``astro_sph_tools_tpu.parallel`` (sharded sort + all-to-all).

Works over NumPy (default: host-side, exact int64 IDs) or ``jax.numpy``
(device-side; mind int64 requires x64 mode) via the ``xp`` argument.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..units import UnitArray


@dataclass(frozen=True)
class MatchPlan:
    """The result of matching target IDs against source IDs.

    Attributes
    ----------
    source_matched : (N,) bool — source elements that matched some target.
    target_matched : (M,) bool — target elements that matched some source.
    gather_index : (M,) int — for every target slot, the index into the
        *source data array* supplying its value (arbitrary where unmatched).
    """

    source_matched: Any
    target_matched: Any
    gather_index: Any

    @property
    def n_matched(self) -> int:
        return int(np.asarray(self.target_matched).sum())


def match_ids(
    source_ids,
    target_ids,
    source_filter=None,
    target_filter=None,
    xp=np,
) -> MatchPlan:
    """Match target IDs to source IDs (sort + searchsorted).

    Semantics follow ``ArrayReorder.create`` (`_ArrayReorder.py:987-1038`):
    filters exclude elements from matching without changing shapes.
    Requires filtered source IDs to be unique (duplicated target IDs are
    fine — that is the ``ArrayMapping`` case).
    """
    source_ids = xp.asarray(source_ids)
    target_ids = xp.asarray(target_ids)

    def _sentinel(ids):
        # a key that cannot match any real ID, preserving sortability
        np_dtype = np.asarray(ids[:0] if hasattr(ids, "__getitem__") else ids).dtype
        if np.issubdtype(np_dtype, np.integer):
            return xp.asarray(np.iinfo(np_dtype).max, dtype=ids.dtype)
        return xp.asarray(np.inf, dtype=ids.dtype)

    if source_filter is not None:
        source_filter = xp.asarray(source_filter)
        source_keys = xp.where(source_filter, source_ids, _sentinel(source_ids))
    else:
        source_keys = source_ids

    order = xp.argsort(source_keys)
    sorted_keys = source_keys[order]

    # forward lookup: locate each target ID among the sorted source keys
    pos = xp.searchsorted(sorted_keys, target_ids)
    pos_clipped = xp.clip(pos, 0, sorted_keys.shape[0] - 1)
    hit = sorted_keys[pos_clipped] == target_ids
    if target_filter is not None:
        hit = hit & xp.asarray(target_filter)
    gather_index = order[pos_clipped]

    # source membership: a source element is "matched" when its ID occurs in
    # the (filtered) target set — all duplicates count, mirroring the
    # reference's np.isin semantics (_ArrayReorder.py:1066-1067)
    if target_filter is not None:
        target_keys = xp.where(xp.asarray(target_filter), target_ids, _sentinel(target_ids))
    else:
        target_keys = target_ids
    tsorted = xp.sort(target_keys)
    spos = xp.clip(xp.searchsorted(tsorted, source_ids), 0, tsorted.shape[0] - 1)
    source_matched = tsorted[spos] == source_ids
    if source_filter is not None:
        source_matched = source_matched & source_filter

    return MatchPlan(source_matched=source_matched, target_matched=hit, gather_index=gather_index)


class _ReorderBase:
    """Shared call semantics for ArrayReorder/ArrayMapping."""

    def __init__(self, plan: MatchPlan, xp=np):
        self._plan = plan
        self._xp = xp
        self._n_in = int(plan.source_matched.shape[0])
        self._n_out = int(plan.target_matched.shape[0])
        self._n_matched = plan.n_matched
        self._exact = self._n_matched == self._n_out

    # -- introspection (parity with _ArrayReorder.py:862-930) -----------------
    @property
    def input_filter(self):
        return self._plan.source_matched

    source_filter = input_filter

    @property
    def output_filter(self):
        return self._plan.target_matched

    target_filter = output_filter

    @property
    def input_length(self) -> int:
        return self._n_in

    @property
    def output_length(self) -> int:
        return self._n_out

    def __len__(self) -> int:
        return self._n_in

    @property
    def matched_items(self) -> int:
        return self._n_matched

    @property
    def uses_all_inputs(self) -> bool:
        return self._n_in == self._n_matched

    @property
    def all_outputs_matched(self) -> bool:
        return self._exact

    @property
    def lossless(self) -> bool:
        return self.uses_all_inputs and self._exact

    @property
    def matches_are_reduction(self) -> bool:
        return self._n_in > self._n_matched

    @property
    def results_are_expansion(self) -> bool:
        return self._n_out > self._n_matched

    @property
    def results_are_subset(self) -> bool:
        return self.matches_are_reduction and self._exact

    @property
    def results_are_superset(self) -> bool:
        return self.results_are_expansion and self.uses_all_inputs

    # -- application -------------------------------------------------------------
    def __call__(self, source_data, output_array=None, default_value=None):
        """Reorder *source_data* into target order.

        Matches the reference call contract (`_ArrayReorder.py:932-959`):
        unmatched output slots take *default_value*, or keep the values of
        *output_array* when given; if neither is supplied and some outputs
        are unmatched, raise. Functional: a new array is returned.
        """
        if isinstance(source_data, UnitArray):
            raw = self.__call__(
                source_data.value,
                None if output_array is None else UnitArray(output_array, source_data.units).to_value(source_data.units),
                None if default_value is None else UnitArray(default_value, source_data.units).to_value(source_data.units)
                if isinstance(default_value, UnitArray)
                else default_value,
            )
            return UnitArray(raw, source_data.units)

        xp = self._xp
        source_data = xp.asarray(source_data)
        if not self._exact and output_array is None and default_value is None:
            raise ValueError(
                "More output elements expected than matches but no default value "
                "provided and no output target array to write matches to."
            )
        gathered = source_data[self._plan.gather_index]
        matched = self._plan.target_matched
        # broadcast the mask over trailing dims
        mask = matched.reshape(matched.shape + (1,) * (gathered.ndim - 1))
        if output_array is not None:
            base = xp.asarray(output_array)
            if default_value is not None:
                base = xp.where(mask, base, default_value)
        elif default_value is not None:
            base = xp.broadcast_to(
                xp.asarray(default_value, dtype=source_data.dtype),
                gathered.shape,
            )
        else:
            base = gathered  # exact: every slot overwritten anyway
        return xp.where(mask, gathered, base)


class ArrayMapping(_ReorderBase):
    """One-way map from unique source IDs onto a (possibly duplicating) target
    order (parity: `_ArrayReorder.py:1042-1171`)."""

    def __init__(self, source_ids, target_ids, source_id_filter=None, target_id_filter=None, xp=np):
        plan = match_ids(source_ids, target_ids, source_id_filter, target_id_filter, xp=xp)
        # duplicate-source detection (reference raises IndexError,
        # _ArrayReorder.py:1074-1075)
        sids = np.asarray(source_ids)
        smask = np.asarray(plan.source_matched)
        matched_ids = sids[smask]
        if matched_ids.size and np.unique(matched_ids).size < matched_ids.size:
            raise IndexError(
                "Duplicate matched detected in filtered source array. Source ID "
                "array must contain unique elements (after optional filter is applied)."
            )
        super().__init__(plan, xp=xp)

    @staticmethod
    def create(source_IDs, target_IDs, source_ID_filter=None, target_ID_filter=None, xp=np):
        return ArrayMapping(source_IDs, target_IDs, source_ID_filter, target_ID_filter, xp=xp)


class ArrayReorder(_ReorderBase):
    """Invertible reorder between two unique ID orderings
    (parity: `_ArrayReorder.py:813-1038`). Use :meth:`create`; access the
    inverse via :attr:`reverse`."""

    def __init__(self, plan: MatchPlan, xp=np):
        super().__init__(plan, xp=xp)
        self._reverse: Optional["ArrayReorder"] = None

    @property
    def reverse(self) -> "ArrayReorder":
        return self._reverse

    @staticmethod
    def create(
        source_order,
        target_order,
        source_order_filter=None,
        target_order_filter=None,
        xp=np,
    ) -> "ArrayReorder":
        forward_plan = match_ids(source_order, target_order, source_order_filter, target_order_filter, xp=xp)
        backward_plan = match_ids(target_order, source_order, target_order_filter, source_order_filter, xp=xp)
        forward = ArrayReorder(forward_plan, xp=xp)
        backward = ArrayReorder(backward_plan, xp=xp)
        forward._reverse = backward
        backward._reverse = forward
        return forward
