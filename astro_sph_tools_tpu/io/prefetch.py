"""Host->device streaming with background prefetch.

The device analogue of the reference's thread-level IO overlap (async
field getters via ThreadPoolExecutor,
`io/data_structures/_SnapshotBase.py:937-1007`) extended into a streaming
pipeline (SURVEY.md §2.8: "host async prefetch pipeline feeding device
puts"): particle fields are read from HDF5 in chunks on a background thread
and transferred to the device ahead of consumption, so deposit compute
overlaps both disk reads and host-to-device transfers.

Usage::

    for block in stream_particle_blocks(snap, ParticleType.gas,
                                        ["positions", "masses"],
                                        chunk_size=1 << 22):
        image = deposit_into(image, block["positions"], block["masses"], ...)
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from ..data_structures.particle_types import ParticleType
from ..units import UnitArray
from .snapshot import SnapshotBase

_SENTINEL = object()


def stream_particle_blocks(
    snapshot: SnapshotBase,
    particle_type: ParticleType,
    fields: Sequence[str],
    *,
    chunk_size: int = 1 << 22,
    prefetch_depth: int = 2,
    dtype=None,
    device_put: bool = True,
) -> Iterator[dict]:
    """Yield dicts of field chunks, read + transferred ahead of consumption.

    ``fields`` name ``get_*`` getters without the prefix. Each yielded dict
    maps field -> jnp array (or NumPy when ``device_put=False``) of at most
    ``chunk_size`` particles, plus ``"start"``/``"stop"`` global indices.
    A background thread keeps ``prefetch_depth`` chunks in flight; exceptions
    propagate to the consumer.
    """
    import jax
    import jax.numpy as jnp

    dtype = dtype or jnp.float32

    # Read full columns once (h5py slicing per chunk would re-open files;
    # backends already concatenate per process) then stream slices. For
    # out-of-core snapshots a per-chunk reader hook can replace this.
    host: dict[str, np.ndarray] = {}
    for name in fields:
        value = getattr(snapshot, f"get_{name}")(particle_type)
        if isinstance(value, UnitArray):
            value = value.value
        host[name] = np.asarray(value)
    n = host[fields[0]].shape[0]

    work: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_depth))
    abandoned = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer abandoned the
        stream — a producer blocked forever on queue.put outlives its test/
        request and races later device work (observed: segfault in a JAX
        compile-cache write with a leaked producer mid-device_put)."""
        while not abandoned.is_set():
            try:
                work.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for start in range(0, n, chunk_size):
                if abandoned.is_set():
                    return
                stop = min(start + chunk_size, n)
                block = {"start": start, "stop": stop}
                for name in fields:
                    chunk = host[name][start:stop]
                    if device_put:
                        block[name] = jax.device_put(jnp.asarray(chunk, dtype))
                    else:
                        block[name] = chunk
                if not _put(block):
                    return
            _put(_SENTINEL)
        except Exception as err:  # propagate to consumer
            _put(err)

    thread = threading.Thread(target=producer, name="ast-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = work.get()
            if item is _SENTINEL:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        abandoned.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                work.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)


def streamed_deposit_2d(
    snapshot: SnapshotBase,
    particle_type: ParticleType,
    spec,
    *,
    axis=None,
    K: int = 8,
    chunk_size: int = 1 << 22,
    device_chunk: int = 8192,
    kernel: str = "cubic_spline",
):
    """Streaming surface-density deposit: IO chunks overlap device compute.

    Uses the jittable fixed-level engine per block (suits bounded-h
    streaming ingest); returns the accumulated (ny, nx) map.
    """
    import jax.numpy as jnp

    from ..data_structures.particle_types import CoordinateAxes
    from ..ops.deposit import _stencil_level_pass

    axis = axis or CoordinateAxes.Z
    i, j = axis.projection_plane
    ny, nx = spec.shape
    image_flat = jnp.zeros((ny * nx, 1), jnp.float32)

    static = dict(
        K=K,
        shape=spec.shape,
        extent=tuple(float(v) for v in spec.extent),
        offset=spec.sample_offset,
        periodic=spec.periodic_wrap,
        kernel_name=kernel,
        projection="kernel3d",
        chunk=device_chunk,
    )

    for block in stream_particle_blocks(
        snapshot, particle_type,
        ["positions", "smoothing_lengths", "masses"],
        chunk_size=chunk_size,
    ):
        pos = block["positions"]
        n = pos.shape[0]
        n_pad = max(device_chunk, ((n + device_chunk - 1) // device_chunk) * device_chunk)
        pad = n_pad - n
        x = jnp.pad(pos[:, i], (0, pad))
        y = jnp.pad(pos[:, j], (0, pad))
        h = jnp.pad(block["smoothing_lengths"], (0, pad), constant_values=1.0)
        m = jnp.pad(block["masses"], (0, pad))[:, None]
        image_flat = _stencil_level_pass(image_flat, x, y, h, m, None, **static)

    return image_flat.reshape(ny, nx)


def stream_macro_chunks(
    read_chunk,
    n_chunks: int,
    *,
    prefetch_depth: int = 1,
    to_device=None,
    n_readers: int = 1,
) -> Iterator:
    """Macro-chunk pipeline: read + unit-convert + **host->device transfer**
    of chunk k+1 overlap the device compute of chunk k.

    ``read_chunk(ci)`` returns a pytree of NumPy arrays (an HDF5 macro-chunk
    read; h5py/numpy release the GIL). The background thread immediately
    pushes it to the device (``to_device`` hook, default ``jax.device_put``
    of every leaf), so by the time the consumer asks for chunk k+1 its H2D
    transfer is already done or in flight — the e2e wall becomes
    max(transfer, compute) instead of their sum. ``prefetch_depth`` bounds
    the number of resident in-flight chunks (device memory!).

    The streaming analogue of SURVEY.md §2.8's "thread-level IO overlap"
    row, replacing per-benchmark ad-hoc reader pools.

    ``n_readers > 1`` fans the read+pack stage over a thread pool — on
    multi-core hosts the per-chunk h5py reads and the C/numpy pack passes
    (which release the GIL) run concurrently; chunks are still DELIVERED
    in order, and the single producer thread serialises the H2D puts (two
    concurrent device transfers would just contend for the one link).
    This is the rank-parallel-read analogue of the reference's
    ``pyread_eagle.split_selection`` MPI striping
    (`_SnapshotEAGLE.py:119-130`) at thread granularity.
    """
    import jax

    if to_device is None:
        def to_device(host):
            return jax.tree_util.tree_map(jax.device_put, host)

    work: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_depth))
    abandoned = threading.Event()

    def _put(item) -> bool:
        # see stream_particle_blocks._put: never block forever after the
        # consumer abandoned the stream
        while not abandoned.is_set():
            try:
                work.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if n_readers > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(
                    max_workers=n_readers, thread_name_prefix="ast-reader"
                ) as pool:
                    # keep at most n_readers + prefetch_depth chunks in
                    # flight; deliver strictly in order
                    pending = {}
                    next_submit = 0
                    for ci in range(n_chunks):
                        while (
                            next_submit < n_chunks
                            and len(pending) < n_readers + prefetch_depth
                        ):
                            pending[next_submit] = pool.submit(
                                read_chunk, next_submit
                            )
                            next_submit += 1
                        if abandoned.is_set():
                            return
                        host = pending.pop(ci).result()
                        if not _put(to_device(host)):
                            return
            else:
                for ci in range(n_chunks):
                    if abandoned.is_set():
                        return
                    dev = to_device(read_chunk(ci))
                    if not _put(dev):
                        return
            _put(_SENTINEL)
        except Exception as err:  # propagate to consumer
            _put(err)

    thread = threading.Thread(
        target=producer, name="ast-macro-prefetch", daemon=True
    )
    thread.start()
    try:
        while True:
            item = work.get()
            if item is _SENTINEL:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        abandoned.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                work.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)
