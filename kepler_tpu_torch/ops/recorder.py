"""Hooks through which a program recorder sees what the port's programs do
beyond their aten ops.

The device tier of the port's analysis (``analysis/device``) runs each
registered program once under a recorder that counts the aten ops it
dispatches. Three kinds of event need the code that makes them to report
them here:

- a hand kernel's wrapper records one ``kernel:<name>`` op and runs
  unrecorded inside (:func:`records_kernel`), so a B1, B2 or B3 call reads the
  same whether its plain version ran (CPU tensors) or the kernel
  launched (CUDA tensors);
- a collective of ``parallel.collectives`` reports its name
  (:func:`collective`), the counterpart of a ``lax`` collective in a
  jaxpr;
- a per-shard body reports the index of its shard (:func:`shard`), the
  counterpart of a ``shard_map``.

The recorder is per thread. With none active each hook is one
thread-local read.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Iterator, TypeVar

F = TypeVar("F", bound=Callable[..., Any])

_LOCAL = threading.local()


def active() -> Any:
    """The recorder of this thread, or None."""
    return getattr(_LOCAL, "recorder", None)


@contextlib.contextmanager
def recording(recorder: Any) -> Iterator[Any]:
    """Make ``recorder`` this thread's recorder for the block."""
    prev = active()
    _LOCAL.recorder = recorder
    try:
        yield recorder
    finally:
        _LOCAL.recorder = prev


def records_kernel(name: str) -> Callable[[F], F]:
    """Decorate a kernel wrapper: under a recorder a call is one
    ``kernel:<name>`` op, with nothing recorded inside it."""
    def wrap(fn: F) -> F:
        @functools.wraps(fn)
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            rec = active()
            if rec is None:
                return fn(*args, **kwargs)
            with rec.kernel(name):
                return fn(*args, **kwargs)

        return wrapped  # type: ignore[return-value]

    return wrap


def collective(name: str, n_shards: int) -> None:
    """A collective over ``n_shards`` shards of one mesh axis ran."""
    rec = active()
    if rec is not None:
        rec.collective(name, n_shards)


def shard(index: int) -> None:
    """A per-shard body ran on the shard at ``index``."""
    rec = active()
    if rec is not None:
        rec.shard(index)
