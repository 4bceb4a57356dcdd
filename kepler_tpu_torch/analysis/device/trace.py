"""Recorded runs for the device tier: what one registered program did.

The reference package stages its programs abstractly into jaxprs. The
port's programs are Python over tensors with hand kernels behind ctypes,
which no abstract tracer can stage, so :func:`trace_case` RUNS a program
once, on seeded inputs at the case's tiny shapes, inside a
``TorchDispatchMode`` recorder (:class:`OpRecorder`) that sees every aten
op the run dispatches, its backward included. The run happens on the
device the caller names: ``cuda`` by default, ``cpu`` only when asked.
A CPU run takes the card's route for the half-operand products
(``models.nn.card_route``), so that both record the same program: the
recorder counts the hi/lo split's plain version as the card's
``kernel:hi_lo``.

What a run yields (:class:`TraceReport`):

- the **op histogram**: aten op names, overloads stripped, with view and
  alias ops (:data:`UNSTABLE_OPS` and every op whose schema returns a
  view of an input) left out, so the histogram pins the program's
  compute and data movement and not torch's aliasing bookkeeping;
- **kernels**: a hand kernel's wrapper records one ``kernel:<name>`` op
  and nothing inside it (``ops.recorder.records_kernel``), so B1, B2 and
  B3 read the same whether the plain version ran (CPU) or the kernel
  launched (card); an optimizer step is one ``optimizer:<kind>`` op the
  same way (torch picks its multi-tensor kernels per device);
- the **collective set** and the **shards** that ran a body: reported by
  ``parallel.collectives`` and ``aggregator_core.shard_by_node``
  (KTL122);
- **dtype-flow facts**: every half-precision cast pair (``_to_copy`` with
  a dtype, or a cross-dtype ``copy_``), every product whose OUTPUT is
  half, every reduction over half operands (KTL120);
- **in-place facts** for KTL121: per flat argument leaf, whether the run
  advanced its version counter (an in-place update), and every op that
  copied a whole leaf into other storage.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Iterator, TYPE_CHECKING

import torch
from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                   register_optimizer_step_pre_hook)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from kepler_tpu_torch.ops import recorder as hooks

if TYPE_CHECKING:  # registry imports stay import-light at runtime
    from kepler_tpu_torch.analysis.device.registry import (ProgramCase,
                                                           ProgramSpec)

#: ops whose counts are torch-version or aliasing noise, not program
#: structure (ops that return a view of an input are dropped by schema
#: too): left out of the histogram so the KTL123 ratchet pins compute
#: and data movement
UNSTABLE_OPS = frozenset({
    "detach", "detach_", "alias", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "is_same_size", "_has_compatible_shallow_copy_type",
    "set_", "resize_", "_reshape_alias", "_unsafe_view", "view",
    "as_strided", "_to_dense", "record_stream", "scalar_tensor",
})

#: products whose OUTPUT dtype must not be half precision
PRODUCT_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv",
    "addmv",
})

#: reductions whose operand dtype must not be half precision
REDUCE_OPS = frozenset({
    "sum", "mean", "cumsum", "cumsum_", "index_add", "index_add_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
})

#: ops that write a (functional) copy of their input into new storage —
#: a donated leaf passed through one of these is copied, not updated
COPY_OPS = frozenset({
    "clone", "_to_copy", "copy", "copy_", "where", "index_put",
    "index_copy", "scatter", "masked_scatter",
})

HALF_DTYPES = ("float16", "bfloat16")


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _is_view(func: Any) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def flat_leaves(arg: Any) -> list[torch.Tensor]:
    """Every tensor of one program argument, in a fixed order: tensors,
    mappings (in key order), sequences and named tuples, and an
    optimizer's per-parameter state. Another object's tensors are not
    leaves (a mesh, a layout)."""
    out: list[torch.Tensor] = []
    seen: set[int] = set()

    def walk(x: Any) -> None:
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, dict):
            for k in x:
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.optim.Optimizer):
            for group in x.param_groups:
                for p in group["params"]:
                    walk(p)
                    walk(dict(sorted(x.state.get(p, {}).items())))

    walk(arg)
    return out


def _aval(t: torch.Tensor) -> str:
    return f"{dtype_name(t.dtype)}[{','.join(str(d) for d in t.shape)}]"


class OpRecorder(TorchDispatchMode):
    """Counts what a run dispatches (see the module docstring)."""

    def __init__(self, donated: list[torch.Tensor]) -> None:
        super().__init__()
        self.ops: dict[str, int] = {}
        self.half_casts: dict[str, int] = {}
        self.half_products: list[str] = []
        self.half_reduces: list[str] = []
        self.collectives: set[str] = set()
        self.shards: set[int] = set()
        self.copies: list[str] = []
        self._suspended = 0
        self._donated = {_storage(t): t.numel() for t in donated}

    def _count(self, name: str) -> None:
        self.ops[name] = self.ops.get(name, 0) + 1

    def kernel(self, name: str):
        """One ``kernel:<name>`` op; nothing recorded inside."""
        return self._one_op(f"kernel:{name}")

    def crossing(self, name: str):
        """One ``crossing:<name>`` op (a collective's cross-process leg);
        nothing recorded inside."""
        return self._one_op(f"crossing:{name}")

    @contextlib.contextmanager
    def _one_op(self, label: str) -> Iterator[None]:
        if self._suspended:
            yield
            return
        self._count(label)
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def collective(self, name: str, n_shards: int) -> None:
        if self._suspended:
            return
        self.collectives.add(name)
        self.shards.update(range(n_shards))

    def shard(self, index: int) -> None:
        if not self._suspended:
            self.shards.add(index)

    def optimizer_pre(self, opt: Any, *_: Any) -> None:
        if not self._suspended:
            self._count(f"optimizer:{type(opt).__name__}")
        self._suspended += 1

    def optimizer_post(self, *_: Any) -> None:
        self._suspended -= 1

    def __torch_dispatch__(self, func: Any, types: Any, args: tuple = (),
                           kwargs: dict | None = None) -> Any:
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        name = func.overloadpacket.__name__
        if name not in UNSTABLE_OPS and not _is_view(func):
            self._count(name)
        ins = _tensors((args, kwargs))
        if name == "_to_copy" and kwargs.get("dtype") is not None:
            self._cast(ins[0].dtype, kwargs["dtype"])
        elif name == "copy_" and len(args) > 1 \
                and isinstance(args[1], torch.Tensor):
            self._cast(args[1].dtype, args[0].dtype)
        elif name in PRODUCT_OPS:
            res = _tensors(out)
            if res and dtype_name(res[0].dtype) in HALF_DTYPES:
                operands = "/".join(dtype_name(t.dtype) for t in ins)
                self.half_products.append(
                    f"{name}({operands}) -> {dtype_name(res[0].dtype)}")
        elif name in REDUCE_OPS:
            half = [dtype_name(t.dtype) for t in ins
                    if dtype_name(t.dtype) in HALF_DTYPES]
            if half:
                self.half_reduces.append(f"{name}({half[0]})")
        if name in COPY_OPS and self._donated:
            self._note_copy(name, args, ins, out)
        return out

    def _cast(self, src: torch.dtype, dst: torch.dtype) -> None:
        s, d = dtype_name(src), dtype_name(dst)
        if s != d and (s in HALF_DTYPES or d in HALF_DTYPES):
            pair = f"{s}->{d}"
            self.half_casts[pair] = self.half_casts.get(pair, 0) + 1

    def _note_copy(self, name: str, args: tuple, ins: list, out: Any
                   ) -> None:
        if name == "copy_":
            ins = [args[1]] if isinstance(args[1], torch.Tensor) else []
        elif name == "_to_copy" and any(t.dtype != ins[0].dtype
                                        for t in _tensors(out)):
            return  # a cast reads the leaf (an operand), it copies nothing
        read = {_storage(t) for t in ins} & set(self._donated)
        for key in read:
            for t in _tensors(out):
                if _storage(t) != key and t.numel() >= self._donated[key]:
                    self.copies.append(
                        f"{name} copies a donated {self._donated[key]}-"
                        f"element leaf into new storage")
                    return


@dataclass
class TraceReport:
    """Everything the KTL120-123 checks read about one recorded case."""

    spec: "ProgramSpec"
    case: "ProgramCase"
    in_avals: tuple[str, ...] = ()
    out_avals: tuple[str, ...] = ()
    op_counts: dict[str, int] = field(default_factory=dict)
    collectives: set[str] = field(default_factory=set)
    shards: set[int] = field(default_factory=set)
    half_casts: dict[str, int] = field(default_factory=dict)
    half_products: list[str] = field(default_factory=list)
    half_reduces: list[str] = field(default_factory=list)
    arg_leaves: tuple[int, ...] = ()  # flat leaves per user-level arg
    updated_args: set[int] = field(default_factory=set)  # flat indices
    copies: list[str] = field(default_factory=list)
    outputs: tuple[torch.Tensor, ...] = ()  # output leaves, on the CPU

    @property
    def key(self) -> str:
        return f"{self.spec.name}/{self.case.name}"

    @property
    def has_shard_map(self) -> bool:
        return bool(self.shards)

    def flat_indices_of_arg(self, user_arg: int) -> set[int]:
        start = sum(self.arg_leaves[:user_arg])
        return set(range(start, start + self.arg_leaves[user_arg]))


def trace_case(spec: "ProgramSpec", case: "ProgramCase",
               device: str | torch.device = "cuda") -> TraceReport:
    """Build one registry case on ``device`` and run it once under the
    recorder → its report."""
    from kepler_tpu_torch.device import resolve_device
    from kepler_tpu_torch.models.nn import card_route

    dev = resolve_device(device)
    with card_route(dev):
        return _trace(spec, case, dev)


def _trace(spec: "ProgramSpec", case: "ProgramCase",
           dev: torch.device) -> TraceReport:
    fn, args = spec.build(case, dev)
    leaves = [flat_leaves(a) for a in args]
    flat = [t for group in leaves for t in group]
    donated = [flat[i] for user_arg in spec.donates
               for i in range(sum(map(len, leaves[:user_arg])),
                              sum(map(len, leaves[:user_arg + 1])))]
    versions = [t._version for t in flat]
    rec = OpRecorder(donated)
    handles = [register_optimizer_step_pre_hook(rec.optimizer_pre),
               register_optimizer_step_post_hook(rec.optimizer_post)]
    try:
        with hooks.recording(rec), rec:
            out = fn(*args)
    finally:
        for h in handles:
            h.remove()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out_leaves = flat_leaves(out)
    return TraceReport(
        spec=spec, case=case,
        in_avals=tuple(_aval(t) for t in flat),
        out_avals=tuple(_aval(t) for t in out_leaves),
        op_counts=rec.ops, collectives=rec.collectives, shards=rec.shards,
        half_casts=rec.half_casts, half_products=rec.half_products,
        half_reduces=rec.half_reduces,
        arg_leaves=tuple(len(g) for g in leaves),
        updated_args={i for i, t in enumerate(flat)
                      if t._version != versions[i]},
        copies=rec.copies,
        outputs=tuple(t.detach().to("cpu", copy=True) for t in out_leaves))


def fingerprint(report: TraceReport) -> dict:
    """Normalized structural fingerprint for the KTL123 ratchet: the
    argument and output signatures, the op histogram (kernels included),
    the collective set, the half-precision cast pairs, the number of
    shards that ran a body, and which flat args were updated in place.
    Nothing in it depends on the device the run took place on."""
    return {
        "in_avals": list(report.in_avals),
        "out_avals": list(report.out_avals),
        "ops": dict(sorted(report.op_counts.items())),
        "collectives": sorted(report.collectives),
        "half_casts": dict(sorted(report.half_casts.items())),
        "shards": len(report.shards),
        "donated_args": sorted(report.updated_args),
    }
