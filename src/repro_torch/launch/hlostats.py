"""Per-device work of one step: dot FLOPs, op bytes, collectives, kernels.

Ported from ``repro.launch.hlostats``.  The reference reads a compiled XLA
module's text: the HLO's dot FLOPs and HBM bytes with while-loops unrolled,
and every collective's ring-model wire bytes.  PyTorch compiles no module,
so the port counts the step as it runs eagerly on ``device="meta"``
DTensors (:mod:`repro_torch.launch.dryrun`): :class:`StepCounter`, a
``TorchDispatchMode``, sees every operation rank 0's local shards go
through and tallies

* dot FLOPs of ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` and the
  convolutions, with ``torch.utils.flop_counter``'s formulas;
* the bytes each operation reads and writes (every tensor argument read
  once, every output written once; views and allocations move nothing).
  This is per operation, unfused, so it is an upper bound on HBM traffic,
  where the reference's count is after XLA's fusion;
* every collective by kind, its group size from the process group it runs
  over and its wire bytes by the ring model of :func:`_wire_factor`
  (copied from the reference, as are :data:`_DTYPE_BYTES`,
  :func:`_shape_bytes` and :class:`CollectiveStats`);
* the hand-written kernels' own work, which their wrappers record on meta
  tensors (:mod:`repro_torch.kernels.accounting`), under their names.

Only rank 0's local operations count: an operation on DTensors is passed
on (DTensor runs it on the local shards, which come back through the mode),
and an operation on ``FakeTensor``\\ s is DTensor's sharding propagation
working out global shapes, not work.  An eager run executes every loop trip,
so there is nothing to unroll.

:class:`SavedBytes` counts the bytes autograd keeps for the backward: the
tensors saved outside checkpointed regions (``saved_tensors_hooks``) and the
tensor inputs of each ``torch.utils.checkpoint`` region, which its
recomputation keeps.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import accounting

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

# A pattern string, where the reference compiles it (this package's
# isolation test refuses any attribute named ``compile``).
_ARRAY_RE = r"(\w+?)\[([\d,]*)\]"


def _shape_bytes(shape_expr: str) -> int:
    total = 0
    for dtype, dims in re.findall(_ARRAY_RE, shape_expr):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _wire_factor(kind: str, g: int) -> float:
    """Ring-model per-device wire traffic vs the instruction's OUTPUT bytes.

    HLO output shapes: all-gather/all-reduce outputs are full-size;
    reduce-scatter's output is the 1/g shard (so wire = out·(g-1)).
    """
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g
    return 1.0  # collective-permute


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0              # ring-model bytes/device, unrolled
    payload_bytes: float = 0.0           # raw payload bytes, unrolled
    by_kind: Dict[str, float] = field(default_factory=dict)
    count: int = 0                       # static instruction count
    dynamic_count: float = 0.0           # multiplicity-weighted


# Collective operations -> the reference's kind.  The payload, as the
# reference's, is the OUTPUT: full for all-gather and all-reduce, the 1/g
# shard for reduce-scatter.
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_gather_into_tensor": "all-gather",
    "_c10d_functional_autograd.reduce_scatter_tensor": "reduce-scatter",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
}

# Operations that move no bytes of their own.
_FREE = frozenset({
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.detach", "aten.lift_fresh",
    "aten.alias", "aten.set_", "aten.resize_",
    "_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd",
})


def _group_size(args) -> int:
    """The size of the group a collective's arguments name: the last string
    argument of a functional collective, the ProcessGroup of a c10d one."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if names:
        return _resolve_process_group(names[-1]).size()
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError(f"no process group among {[type(a) for a in args]}")


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


_SRC = os.path.join("src", "repro_torch") + os.sep
# Frames that never name a caller: the counter itself, the sharding helpers
# every redistribution goes through, and the kernels' wrappers and their
# accounting (a kernel is named by the line that called ``kernels.ops``).
_NOT_CALLERS = tuple(os.path.join(*parts) for parts in (
    ("launch", "hlostats.py"), ("models", "sharding.py"),
    ("kernels", "accounting.py"), ("kernels", "flash_attention.py"),
    ("kernels", "ssm_scan.py"), ("kernels", "rglru_scan.py"),
    ("kernels", "quantize.py"), ("kernels", "adamw.py"), ("kernels", "norm.py")))


def _site(filename: str, lineno: int, func: str) -> Optional[str]:
    """``models/ssm.py:78 _split_xproj`` for a frame of this package that
    names a caller, else None."""
    i = filename.rfind(_SRC)
    if i < 0 or filename.endswith(_NOT_CALLERS):
        return None
    return f"{filename[i + len(_SRC):]}:{lineno} {func}"


def _caller() -> str:
    """The innermost frame of this package (outside the counter and the
    sharding helpers) that led to the operation now dispatched.  An
    operation of the backward, which autograd runs from the train step's
    ``autograd.grad``, is named by the forward frame that made its autograd
    node, ``bwd `` in front; that needs anomaly mode's forward tracebacks
    (:class:`StepCounter` ``by_caller=True`` turns it on)."""
    f = sys._getframe(2)
    while f is not None:
        site = _site(f.f_code.co_filename, f.f_lineno, f.f_code.co_name)
        if site is not None:
            break
        f = f.f_back
    if site is None or site.startswith(os.path.join("train", "train_step.py")):
        node = torch._C._current_autograd_node()
        trace = node.metadata.get("traceback_") if node is not None else None
        for entry in reversed(trace or ()):
            m = re.match(r'\s*File "(.*)", line (\d+), in (\S+)', entry)
            fwd = m and _site(m.group(1), int(m.group(2)), m.group(3))
            if fwd:
                return "bwd " + fwd
    return site or "(outside the package)"


class StepCounter(TorchDispatchMode):
    """Rank 0's local work while it is on (module docstring).

    ``flops``: dot FLOPs of the operations seen, the hand-written kernels'
    excluded; ``op_bytes``: bytes read and written by them; ``collectives``
    (a :class:`CollectiveStats`), ``calls``, the collectives' number by
    kind, and ``issued``, each collective's (kind, group size, output
    shape) in order; ``kernels``: the kernels' own counts,
    ``{name: {"flops", "special", "bytes", "dense_flops", "launches"}}``.
    :meth:`totals` adds the kernels' FLOPs and bytes to the operations'.

    ``by_op`` splits the FLOPs (with and without the kernels' masked tiles)
    and the wire bytes by aten operation (``aten.mm``), collective
    (``all-gather``) or kernel (``kernel.flash_attention``);
    with ``by_caller=True``, ``by_caller`` splits them by the line of this
    package that issued the operation (:func:`_caller`).  Each split sums
    to :meth:`totals`' ``flops`` / ``dense_flops`` and the collectives'
    ``wire_bytes``: every count is added to one entry of each, as the
    integer or ring-model value it adds to the total."""

    def __init__(self, by_caller: bool = False):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0.0
        self.collectives = CollectiveStats()
        self.calls: Dict[str, int] = {}
        self.issued: List[Tuple[str, int, Tuple[int, ...]]] = []
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.by_op: Dict[str, Dict[str, float]] = {}
        self.by_caller: Optional[Dict[str, Dict[str, float]]] = (
            {} if by_caller else None)
        self._anomaly = None

    def __enter__(self):
        accounting.reset()
        accounting.LISTENER = self._kernel
        if self.by_caller is not None:
            self._anomaly = torch.autograd.set_detect_anomaly(True, check_nan=False)
        return super().__enter__()

    def __exit__(self, *exc):
        self.kernels = accounting.snapshot()
        accounting.LISTENER = None
        if self._anomaly is not None:
            self._anomaly.__exit__(*exc)
            self._anomaly = None
        return super().__exit__(*exc)

    def _add(self, key: str, flops=0, dense=0, wire=0.0) -> None:
        splits = [(self.by_op, key)]
        if self.by_caller is not None:
            splits.append((self.by_caller, _caller()))
        for split, k in splits:
            e = split.setdefault(k, {"flops": 0, "dense_flops": 0, "wire_bytes": 0.0})
            e["flops"] += flops
            e["dense_flops"] += dense
            e["wire_bytes"] += wire

    def _kernel(self, name: str, flops, dense) -> None:
        self._add("kernel." + name, flops=flops, dense=dense)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins):
            return out                   # DTensor's shape propagation
        name = str(func.overloadpacket)
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            self._collective(kind, args, out)
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self._add(name, flops=n, dense=n)
        if name not in _FREE and not func.is_view:
            self.op_bytes += _bytes(ins) + _bytes(_tensors(out))
        return out

    def _collective(self, kind: str, args, out) -> None:
        g = _group_size(args)
        payload = _bytes(_tensors(out))
        wire = payload * _wire_factor(kind, g)
        c = self.collectives
        c.count += 1
        c.dynamic_count += 1
        c.payload_bytes += payload
        c.wire_bytes += wire
        c.by_kind[kind] = c.by_kind.get(kind, 0.0) + wire
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.issued.append((kind, g, tuple(_tensors(out)[0].shape)))
        self._add(kind, wire=wire)

    def totals(self) -> Dict[str, float]:
        """{"flops": dot FLOPs plus the kernels' FLOPs, "dense_flops": the
        same with attention at its dense count, "bytes": op bytes plus the
        kernels' bytes}."""
        k = self.kernels.values()
        return {"flops": self.flops + sum(c["flops"] for c in k),
                "dense_flops": self.flops + sum(c["dense_flops"] for c in k),
                "bytes": self.op_bytes + sum(c["bytes"] for c in k)}

    def top(self, split: str = "by_op", key: str = "dense_flops",
            n: int = 20) -> List[Tuple[str, Dict[str, float]]]:
        """The ``n`` largest entries of ``by_op`` or ``by_caller`` by
        ``key`` (``flops``, ``dense_flops`` or ``wire_bytes``)."""
        entries = getattr(self, split) or {}
        return sorted(entries.items(), key=lambda kv: -kv[1][key])[:n]


def _local_bytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


class SavedBytes:
    """Bytes that autograd keeps for the backward while it is on (module
    docstring); each tensor object is counted once."""

    def __init__(self):
        self.bytes = 0
        self._seen: Dict[int, Any] = {}

    def _add(self, t: torch.Tensor) -> None:
        if id(t) not in self._seen:
            self._seen[id(t)] = t        # held, so the id stays unique
            self.bytes += _local_bytes(t)

    def _pack(self, t: torch.Tensor) -> torch.Tensor:
        self._add(t)
        return t

    @contextlib.contextmanager
    def __call__(self) -> Iterator["SavedBytes"]:
        import torch.utils.checkpoint as ckpt
        inner = ckpt.checkpoint

        def checkpoint(fn, *args, **kwargs):
            for a in args:
                if isinstance(a, torch.Tensor):
                    self._add(a)
            return inner(fn, *args, **kwargs)

        ckpt.checkpoint = checkpoint
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          lambda t: t):
                yield self
        finally:
            ckpt.checkpoint = inner
            self._seen.clear()
