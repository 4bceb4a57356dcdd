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
  jaxpr, and its cross-process leg is one ``crossing:<name>`` op with
  nothing recorded inside (:func:`crossing`), whatever ``torch.distributed``
  calls and staging copies it makes;
- a per-shard body reports the index of its shard (:func:`shard`), the
  counterpart of a ``shard_map``.

The recorder is per thread, and reaches the threads that run under its
dispatch mode: autograd runs a CUDA backward on a thread of its own,
which inherits the mode but not the caller's thread-locals. With none
active each hook is one thread-local read and one test of an empty set.

:class:`OutputShapes` is a recorder of another kind, for structural
checks of a run: the shape of every floating-point tensor each aten op
returns, views left out (the sequence-parallel programs are held to
``T/n`` ticks an op with it).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Iterator, TypeVar

from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _get_current_dispatch_mode)
from torch.utils._pytree import tree_flatten

F = TypeVar("F", bound=Callable[..., Any])

_LOCAL = threading.local()
_RECORDING: dict[int, Any] = {}  # id → every recorder inside recording()


def active() -> Any:
    """The recorder of this thread, or else the recorder whose dispatch
    mode this thread runs under (an autograd thread), or None."""
    rec = getattr(_LOCAL, "recorder", None)
    if rec is None and _RECORDING:
        mode = _get_current_dispatch_mode()
        rec = _RECORDING.get(id(mode))
    return rec


@contextlib.contextmanager
def recording(recorder: Any) -> Iterator[Any]:
    """Make ``recorder`` this thread's recorder for the block."""
    prev = getattr(_LOCAL, "recorder", None)
    _LOCAL.recorder = recorder
    _RECORDING[id(recorder)] = recorder
    try:
        yield recorder
    finally:
        _LOCAL.recorder = prev
        if prev is not recorder:
            _RECORDING.pop(id(recorder), None)


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


@contextlib.contextmanager
def crossing(name: str) -> Iterator[None]:
    """The cross-process leg of collective ``name``: under a recorder
    with a ``crossing`` hook, one ``crossing:<name>`` op and nothing
    recorded inside."""
    hook = getattr(active(), "crossing", None)
    if hook is None:
        yield
        return
    with hook(name):
        yield


def shard(index: int) -> None:
    """A per-shard body ran on the shard at ``index``."""
    rec = active()
    if rec is not None:
        rec.shard(index)


class OutputShapes(TorchDispatchMode):
    """``with OutputShapes() as rec:`` → ``rec.shapes``, one ``(op name,
    shape)`` per floating-point tensor an aten op returned in the block,
    in dispatch order. Ops that return a view of an input move no data
    and are left out. Inside a hand kernel's wrapper it sees what runs
    there: the plain version's ops on the CPU, the output's allocation
    on the card."""

    def __init__(self) -> None:
        super().__init__()
        self.shapes: list[tuple[str, tuple[int, ...]]] = []

    def __torch_dispatch__(self, func: Any, types: Any, args: tuple = (),
                           kwargs: dict | None = None) -> Any:
        out = func(*args, **(kwargs or {}))
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns):
            return out
        name = func.overloadpacket.__name__
        for t in tree_flatten(out)[0]:
            if getattr(t, "is_floating_point", None) and t.is_floating_point():
                self.shapes.append((name, tuple(t.shape)))
        return out
