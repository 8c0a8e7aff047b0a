"""Profiling helpers: JAX traces + phase timing (SURVEY.md §5 tracing parity).

The reference's instrumentation is Stopwatch laps and MPI barrier-skew probes
(`io/EAGLE/_CatalogueSUBFIND.py:41-64`); the TPU-native equivalents are
``jax.profiler`` device traces plus the per-phase wall clocks in
``utils.console`` (``timed_phase``, ``Stopwatch.process_skew``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def device_trace(log_dir: str, *, host_profiling: bool = False) -> Iterator[None]:
    """Capture a JAX profiler trace (XLA ops, Pallas kernels, copies, collectives).

    View with TensorBoard or Perfetto (``xprof``). Usage::

        with device_trace("/tmp/ast-trace"):
            image = deposit_2d_pallas(...)
            image.block_until_ready()
    """
    import jax

    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir, create_perfetto_trace=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Accumulating per-phase wall-clock: IO, sort, deposit, collectives.

    Phases re-enterable; ``report()`` returns {phase: seconds}. Device work
    must be synchronised by the caller (block_until_ready) for honest times.
    """

    def __init__(self) -> None:
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def report(self) -> dict[str, float]:
        return dict(self._totals)

    def summary(self) -> str:
        total = sum(self._totals.values()) or 1.0
        lines = [
            f"  {name:<20s} {secs:8.3f}s ({secs / total * 100:5.1f}%)  x{self._counts[name]}"
            for name, secs in sorted(self._totals.items(), key=lambda kv: -kv[1])
        ]
        return "phase timings:\n" + "\n".join(lines)


@contextlib.contextmanager
def count_compilations() -> Iterator[list]:
    """Count XLA compilations inside the block (the warm-up budget needs the number of distinct programs a render
    compiles, not a guess).

    Yields a list that fills with one entry (the jit name logged by
    ``jax_log_compiles``) per compilation that happened inside the block.
    Counts genuine backend compilations — persistent-cache *hits* also log
    (they still build a new executable for this process), which is exactly
    the per-process warm-up cost being budgeted. Usage::

        with count_compilations() as progs:
            render(...)
        print(len(progs), progs)
    """
    import logging

    import jax

    progs: list = []
    seen: set = set()

    class _Handler(logging.Handler):
        def emit(self, record: logging.LogRecord) -> None:
            # the same record propagates from jax._src.dispatch up to the
            # "jax" root logger — dedupe so it counts once
            if id(record) in seen:
                return
            seen.add(id(record))
            msg = record.getMessage()
            if "Finished XLA compilation" in msg:
                progs.append(msg.split("\n", 1)[0][:200])

    handler = _Handler(level=logging.DEBUG)
    # attach to both the module logger JAX currently uses AND the "jax"
    # root logger: a JAX version that moves the log to another private
    # module still reaches "jax" via propagation instead of silently
    # reporting zero compilations
    loggers = [logging.getLogger("jax._src.dispatch"), logging.getLogger("jax")]
    prev = jax.config.jax_log_compiles
    jax.config.update("jax_log_compiles", True)
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.addHandler(handler)
        lg.setLevel(logging.DEBUG)
    try:
        yield progs
    finally:
        jax.config.update("jax_log_compiles", prev)
        for lg, lv in zip(loggers, levels):
            lg.removeHandler(handler)
            lg.setLevel(lv)
