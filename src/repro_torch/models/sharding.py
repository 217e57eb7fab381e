"""Logical-axis sharding: rules, activation constraints, spec resolution.

Ported from ``repro.models.sharding``.  Param/activation specs in the model
code use LOGICAL names:

=========  ==============================================================
batch      activation batch dim (data parallel; + model axis under "dp")
model      tensor-parallel dim (heads / ffn / experts / vocab slices)
model_kv   KV-head dim -- model axis iff the dim divides, else replicated
fsdp       weight storage sharding (ZeRO-3-ish); gathered on use
vocab      embedding-table vocab dim
seq        sequence dim (KV-cache seq sharding for decode)
expert     MoE expert dim
=========  ==============================================================

:func:`rules_for` maps logical -> physical per (policy, multi_pod).
:func:`resolve_spec` / :func:`resolve_tree` bind them to a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's two safety
rules: an axis is DROPPED for a dim it does not divide, and an axis already
used earlier in the same spec is dropped (left wins).

A spec is a :class:`P`, a tuple with one entry per tensor dim (``None``, a
name or a tuple of names), as the reference's ``PartitionSpec``.  Where the
reference builds a ``NamedSharding``, :func:`placements` gives the DTensor
placements: one per mesh dim, ``Shard(i)`` where resolved entry ``i`` holds
that mesh dim's axis, else ``Replicate()``.  :func:`distribute_tree` and
:func:`distribute_model` place a tree of tensors, or a module's parameters,
on the mesh as DTensors; :func:`shard` and :func:`shard_tree` redistribute
a DTensor to its resolved placements, which is what the reference's
``with_sharding_constraint`` asks GSPMD for (``Partial -> Shard`` is a
reduce-scatter, ``Partial -> Replicate`` an all-reduce).  Both are no-ops
unless :func:`active_rules` is on; with rules on, :func:`shard` refuses a
plain tensor, and :func:`active_rules` lets a plain tensor meet a DTensor in
an operation as a replicated one (``implicit_replication``), as a constant
does under GSPMD.

One layout difference from the reference: DTensor shards one tensor dim
over several mesh dims in MESH-DIM order, while the reference shards it in
the rule's tuple order (``("data", "pod")``: pod last).  That changes which
rank holds which rows, never a result.

:func:`use_sync_gloo_all_gather` repairs a collective of the gloo backend
for CUDA tensors (see there).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)

Rules = Dict[str, Union[str, Tuple[str, ...], None]]

# (rules, mesh) while active_rules is on.  Process-wide, not per thread: on
# the card autograd runs the backward, and with it the recomputation of
# checkpointed blocks, on a thread of its own.
_ctx: Optional[Tuple[Rules, object]] = None


class P(tuple):
    """A logical (or resolved) partition spec: one entry per tensor dim,
    each ``None``, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def rules_for(policy: str, multi_pod: bool, fsdp: bool = False) -> Rules:
    # "pod" goes LAST in every composite: resolution is cumulative left to
    # right, and a batch of 256 must claim (data=16, model=16) before the pod
    # axis makes the product 512.
    pod: Tuple[str, ...] = ("pod",) if multi_pod else ()
    if policy == "tp":
        return {
            "batch": ("data",) + pod,
            "model": "model",
            "model_kv": "model",
            "fsdp": (("data",) + pod) if fsdp else None,
            "vocab": "model",
            "seq": "model",
            "expert": "model",
        }
    if policy == "fsdp":
        # ZeRO-3 full-DP: every activation batch-shards over data AND model;
        # weights store sharded over every axis and are gathered on use.
        return {
            "batch": ("data", "model") + pod,
            "model": None,
            "model_kv": None,
            "fsdp": ("data", "model") + pod,
            "vocab": ("data", "model") + pod,
            "seq": "model",
            "expert": None,
        }
    if policy == "dp":
        return {
            "batch": ("data", "model") + pod,
            "model": None,
            "model_kv": None,
            "fsdp": None,
            "vocab": None,
            "seq": None,
            "expert": None,
        }
    raise ValueError(f"unknown policy {policy!r}")


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication`` that restores the previous setting
    on exit (DTensor's own resets it to off, which would end an enclosing
    one); the setting is per thread."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


@contextlib.contextmanager
def active_rules(rules: Rules, mesh):
    """Enable logical-axis resolution (and implicit replication of plain
    tensors that meet DTensors) inside model code."""
    global _ctx
    prev, _ctx = _ctx, (rules, mesh)
    try:
        with _implicit_replication():
            yield
    finally:
        _ctx = prev


def current_context():
    """(rules, mesh) if model code runs under :func:`active_rules`, else None."""
    return _ctx


def under_rules(fn):
    """``fn`` with implicit replication on whenever rules are active, in
    whatever thread it runs: wrap a function that ``torch.utils.checkpoint``
    recomputes, since the backward's thread does not inherit it."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _ctx is None:
            return fn(*args, **kwargs)
        with _implicit_replication():
            return fn(*args, **kwargs)
    return wrapped


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _resolve_entry(entry, rules: Rules, used: set,
                   sizes: Dict[str, int], dim: Optional[int]):
    """One spec entry -> physical axes (tuple), one axis, or None."""
    if entry is None:
        return None
    logical = entry if isinstance(entry, (tuple, list)) else (entry,)
    phys: list = []
    for name in logical:
        mapped = rules.get(name, None) if name in rules else name
        if mapped is None:
            continue
        for ax in (mapped if isinstance(mapped, tuple) else (mapped,)):
            if ax in used or ax not in sizes:
                continue
            cur = 1
            for a in phys:
                cur *= sizes[a]
            if dim is not None and dim % (cur * sizes[ax]) != 0:
                continue  # divisibility fallback: drop this axis
            phys.append(ax)
            used.add(ax)
    if not phys:
        return None
    return tuple(phys) if len(phys) > 1 else phys[0]


def resolve_spec(spec: Sequence, rules: Rules, mesh,
                 shape: Optional[Tuple[int, ...]] = None) -> P:
    sizes = axis_sizes(mesh)
    used: set = set()
    out = []
    for i, entry in enumerate(spec):
        dim = shape[i] if shape is not None and i < len(shape) else None
        out.append(_resolve_entry(entry, rules, used, sizes, dim))
    return P(*out)


def placements(spec: Sequence, mesh) -> Tuple[Placement, ...]:
    """DTensor placements of a RESOLVED spec: for each mesh dim, ``Shard(i)``
    where entry ``i`` holds that dim's axis, else ``Replicate()``."""
    out: List[Placement] = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def resolve_placements(spec: Sequence, rules: Rules, mesh,
                       shape: Tuple[int, ...]) -> Tuple[Placement, ...]:
    """Placements of a logical spec for a tensor of ``shape``."""
    return placements(resolve_spec(spec, rules, mesh, shape), mesh)


def _map2(fn, specs, tree):
    """Apply ``fn(spec, leaf)`` over matching nested dicts / lists whose
    leaves in ``specs`` are :class:`P`."""
    if isinstance(specs, P):
        return fn(specs, tree)
    if isinstance(specs, Mapping):
        return {k: _map2(fn, specs[k], tree[k]) for k in specs}
    return [_map2(fn, s, t) for s, t in zip(specs, tree)]


def resolve_tree(spec_tree, abstract_tree, rules: Rules, mesh):
    """Resolve a tree of logical specs against matching tensors (meta
    tensors serve) into a tree of placements."""
    return _map2(lambda s, a: resolve_placements(s, rules, mesh,
                                                 tuple(a.shape)),
                 spec_tree, abstract_tree)


def distribute(x: torch.Tensor, spec: Sequence, rules: Rules,
               mesh) -> DTensor:
    """``x``, the same whole tensor on every rank, as a DTensor at its
    resolved placements.  Each rank keeps its own slice; nothing is sent."""
    pl = resolve_placements(spec, rules, mesh, tuple(x.shape))
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def distribute_tree(tree, spec_tree, rules: Rules, mesh):
    """:func:`distribute` leaf by leaf over matching trees."""
    return _map2(lambda s, x: distribute(x, s, rules, mesh), spec_tree, tree)


def distribute_model(model: nn.Module, specs: Mapping[str, Sequence],
                     rules: Rules, mesh) -> nn.Module:
    """Replace each parameter of ``model`` (named as ``named_parameters``
    names it) by a DTensor parameter at its resolved placements, in place;
    ``requires_grad`` is kept."""
    for name, p in list(model.named_parameters()):
        set_parameter(model, name, distribute(p.detach(), specs[name], rules, mesh),
                      p.requires_grad)
    return model


def set_parameter(model: nn.Module, name: str, t: torch.Tensor,
                  requires_grad: bool) -> None:
    """Replace ``model``'s parameter ``name`` (as ``named_parameters``
    names it) by a new parameter holding ``t``."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    new = nn.Parameter(t, requires_grad=requires_grad)
    if isinstance(mod, nn.ParameterDict):
        mod[leaf] = new
    else:
        setattr(mod, leaf, new)


def _constrain(x: torch.Tensor, spec: Sequence, rules: Rules, mesh):
    if not isinstance(x, DTensor):
        raise TypeError(
            f"shard{tuple(spec)}: a plain {tuple(x.shape)} tensor under "
            "active_rules; model inputs must be DTensors on the mesh "
            "(sharding.distribute_tree)")
    pl = resolve_placements(spec, rules, mesh, tuple(x.shape))
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def shard(x: torch.Tensor, *logical) -> torch.Tensor:
    """Redistribute ``x`` to the resolved logical spec (no-op without
    active rules)."""
    ctx = current_context()
    if ctx is None:
        return x
    return _constrain(x, logical, *ctx)


def shard_tree(tree, spec_tree):
    """Redistribute every leaf of ``tree`` to its logical spec (no-op
    without rules).  The train step pins each microbatch's gradients to the
    parameter sharding with it: ``Partial -> Shard`` is a reduce-scatter
    into the fsdp shard, not a full-gradient all-reduce."""
    ctx = current_context()
    if ctx is None:
        return tree
    return _map2(lambda s, x: _constrain(x, s, *ctx), spec_tree, tree)


def local_offset(x: DTensor, dim: int) -> int:
    """Global index of the first element of this rank's shard of ``x``
    along ``dim`` (even shards; mesh dims in order, as DTensor splits)."""
    mesh, size, off = x.device_mesh, x.shape[dim], 0
    coord = mesh.get_coordinate()
    for m, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            size //= mesh.size(m)
            off += coord[m] * size
    return off


def keep_shards(x: DTensor, dims: Sequence[int]) -> Tuple[Placement, ...]:
    """x's placements with only the shards of ``dims`` kept (where the dim
    divides evenly); every other mesh dim ``Replicate()``."""
    mesh = x.device_mesh
    return tuple(pl if isinstance(pl, Shard) and pl.dim in dims
                 and x.shape[pl.dim] % mesh.size(m) == 0 else Replicate()
                 for m, pl in enumerate(x.placements))


def to_local_at(t: Optional[torch.Tensor], mesh, pl, grad_pl=None):
    """This rank's shard of ``t`` at placements ``pl`` (a plain tensor is
    taken as replicated); differentiable, with gradient placements
    ``grad_pl`` (default ``pl``)."""
    if t is None:
        return None
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim)
    return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)


def from_local_even(t: torch.Tensor, mesh, pl) -> DTensor:
    """A DTensor of this rank's ``t`` (even shards at ``pl``)."""
    shape = list(t.shape)
    for m, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(m)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t.contiguous(), mesh, pl, shape=torch.Size(shape),
                              stride=stride)


def local_shape(shape: Sequence[int], mesh, pl) -> Tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape`` at placements
    ``pl`` (even shards)."""
    out = list(shape)
    for m, p in enumerate(pl):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(m)
    return tuple(out)


def zeros(shape: Sequence[int], dtype: torch.dtype, device,
          spec: Sequence) -> torch.Tensor:
    """Zeros of ``shape``; under :func:`active_rules` a DTensor at ``spec``'s
    resolved placements, made on the shards, never whole (a serving cache
    of 32 K positions does not fit on one card whole)."""
    ctx = current_context()
    if ctx is None:
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    rules, mesh = ctx
    pl = resolve_placements(spec, rules, mesh, tuple(shape))
    return from_local_even(torch.zeros(local_shape(shape, mesh, pl), dtype=dtype,
                                       device=device), mesh, pl)


def like_placed(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``new`` at ``old``'s placements when ``old`` is a DTensor (a cache
    leaf keeps its sharding when a step replaces it), else ``new``."""
    if not isinstance(old, DTensor):
        return new
    if tuple(new.placements) == tuple(old.placements):
        return new
    return new.redistribute(old.device_mesh, old.placements)


def product(x: torch.Tensor, w: torch.Tensor, n: int = 1) -> torch.Tensor:
    """``torch.tensordot(x, w, n)``: x's last ``n`` dims contracted with w's
    first ``n``.  Between DTensors it runs as one local product on each
    rank's shards, forward and backward, in the tensor-parallel plan the
    reference's GSPMD gives it; DTensor left to itself plans the product and
    each of its gradient products op by op, and may repeat one over a mesh
    axis.  Per mesh dim, after a partial-sum ``x`` is reduced:

    * ``x`` sharded on a leading (batch or sequence) dim: ``w`` is gathered
      there, as an fsdp-stored weight is gathered on use, and the output
      keeps the shard (a one-position ``x`` that meets ``w`` sharded on a
      contracted dim is gathered instead: it moves fewer bytes);
    * ``x`` sharded on a contracted dim: ``w`` takes the same shard and the
      output is a partial sum (row parallel);
    * ``x`` whole: a shard of ``w``'s other dims shards the output (column
      parallel); a shard of its contracted dims is gathered (fsdp on use),
      or, for a one-position ``x``, takes the same slice of ``x`` (no data
      moves) and gives a partial sum;
    * both whole, ``x`` one position a sequence: both take a slice of the
      first contracted dim and the output is a partial sum (a mesh dim
      that a decode of too few sequences leaves idle).

    Each input's gradient is a partial sum where the input is whole and
    the output is not.  Plain tensors give ``torch.tensordot``."""
    if not isinstance(x, DTensor):
        return torch.tensordot(x, w, n)
    mesh, lead = x.device_mesh, x.ndim - n
    if isinstance(w, DTensor):
        wpl = list(w.placements)
    else:
        wpl = [Replicate()] * mesh.ndim
    xpl = [Replicate() if p.is_partial() else p for p in x.placements]
    one_position = x.ndim < 3 or x.shape[1] == 1
    opl: List[Placement] = []
    for m in range(mesh.ndim):
        xp, wp = xpl[m], wpl[m]
        # a slice of the first contracted dim nested inside those already
        # taken, and none left to a later mesh dim
        outer = math.prod(mesh.size(d) for d in range(m) if xpl[d] == Shard(lead))
        idle = (one_position and Shard(lead) not in x.placements[m + 1:]
                and Shard(0) not in wpl[m + 1:]
                and x.shape[lead] % (outer * mesh.size(m)) == 0)
        if isinstance(xp, Shard) and xp.dim < lead and (
                one_position and isinstance(wp, Shard) and wp.dim < n):
            xp = xpl[m] = Replicate()
        if isinstance(xp, Shard) and xp.dim < lead:
            wpl[m] = Replicate()
            opl.append(xp)
        elif isinstance(xp, Shard):
            wpl[m] = Shard(xp.dim - lead)
            opl.append(Partial())
        elif isinstance(wp, Shard) and wp.dim < n and one_position:
            xpl[m] = Shard(lead + wp.dim)
            opl.append(Partial())
        elif isinstance(wp, Shard) and wp.dim < n:
            wpl[m] = Replicate()
            opl.append(Replicate())
        elif isinstance(wp, Shard):
            opl.append(Shard(lead + wp.dim - n))
        elif idle:
            xpl[m], wpl[m] = Shard(lead), Shard(0)
            opl.append(Partial())
        else:
            opl.append(Replicate())
    xpl, wpl = tuple(xpl), tuple(wpl)
    out = torch.tensordot(to_local_at(x, mesh, xpl, partial_where(opl, xpl)),
                          to_local_at(w, mesh, wpl, partial_where(opl, wpl)), n)
    return from_local_even(out, mesh, tuple(opl))


def mesh_group(mesh, axis: str):
    """The process group of mesh axis ``axis``."""
    return mesh.get_group(mesh.mesh_dim_names.index(axis))


def partial_where(sharded: Sequence[Placement],
                  held: Sequence[Placement]) -> Tuple[Placement, ...]:
    """Gradient placements of an input held at ``held`` and used by a
    per-rank computation whose other operands are at ``sharded``: Partial on
    each mesh dim where ``held`` replicates and ``sharded`` shards (the
    ranks of that dim saw different parts of the work), else ``held``."""
    return tuple(Partial() if isinstance(h, Replicate) and isinstance(s, Shard)
                 else h for s, h in zip(sharded, held))


# ---------------------------------------------------------------------------
# gloo on CUDA tensors
# ---------------------------------------------------------------------------
_gloo_lib = None


def _sync_all_gather(inp: torch.Tensor, group_size: int, group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    inp = inp.contiguous()
    out = inp.new_empty((group_size * inp.shape[0],) + tuple(inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp, group=_resolve_process_group(group_name))
    return out


def _sync_all_gather_coalesced(inputs, group_size: int, group_name):
    return [_sync_all_gather(t, group_size, group_name) for t in inputs]


def use_sync_gloo_all_gather() -> None:
    """Route the functional all-gather of CUDA tensors (DTensor's
    ``Shard -> Replicate``) through the blocking ``all_gather_into_tensor``.

    With several ranks on one card only gloo works (NCCL refuses two ranks
    on one device), and gloo's functional ``all_gather_into_tensor`` on CUDA
    tensors crashes the process (SIGSEGV in its wait, torch 2.11 on an H100),
    while the blocking call, and the functional all-reduce, reduce-scatter
    and all-to-all, work.  The result is the same tensor.  Call it once per
    process, after the process group is up; it changes the CUDA kernel of
    that op for the whole process."""
    global _gloo_lib
    if _gloo_lib is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _sync_all_gather, "CUDA")
    lib.impl("all_gather_into_tensor_coalesced", _sync_all_gather_coalesced,
             "CUDA")
    _gloo_lib = lib
