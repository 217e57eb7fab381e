"""``repro_torch.launch.hlostats`` and the kernels' meta branch.

* The copied pieces of ``repro.launch.hlostats`` (``_DTYPE_BYTES``,
  ``_shape_bytes``, ``_wire_factor``) equal the reference's.
* Each kernel wrapper, given meta tensors, returns outputs, and under
  autograd gradients, of the shapes and dtypes its plain version gives on
  the CPU, and records the kernel's work (``repro_torch.kernels.accounting``)
  by the counts ``chip_smoke.py``'s bound column uses.
* A CPU tensor never reaches the meta branch: it takes the plain version
  and records nothing; a CUDA tensor launches its kernel and records
  nothing (marked ``gpu``).
* ``StepCounter`` counts dot FLOPs by ``torch.utils.flop_counter``'s
  formulas and op bytes, and on a fake process group (in a subprocess: the
  group is process-wide) rank 0's local product and the all-gather of a
  redistribution, with the reference's ring model.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.kernels import accounting as acc
from repro_torch.kernels import ops, ref
from repro_torch.launch import hlostats as H

KINDS = ("all-reduce", "reduce-scatter", "all-gather", "all-to-all",
         "collective-permute")


def test_copied_pieces_equal_the_reference():
    from repro.launch import hlostats as RH
    assert H._DTYPE_BYTES == RH._DTYPE_BYTES
    for expr in ("f32[4,8]", "bf16[3]", "(s8[2,2], f32[])", "pred[7,1]"):
        assert H._shape_bytes(expr) == RH._shape_bytes(expr)
    for kind in KINDS:
        for g in range(1, 17):
            assert H._wire_factor(kind, g) == RH._wire_factor(kind, g), (kind, g)


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


def _cpu(gen, *shape, dtype=torch.float32, grad=False, fn=None):
    x = torch.randn(shape, generator=gen)
    x = fn(x) if fn else x
    return x.to(dtype).requires_grad_(grad)


def _sig(ts):
    return [None if t is None else (tuple(t.shape), t.dtype) for t in ts]


def _both(fn, make):
    """fn's outputs and the gradients of their sum on meta and on the CPU:
    (meta signature, CPU signature)."""
    out = []
    for dev in ("meta", "cpu"):
        ins = make(dev)
        ys = fn(*ins)
        loss = sum(y.float().sum() for y in ys if y.is_floating_point())
        grads = torch.autograd.grad(loss, [t for t in ins if t.requires_grad])
        out.append(_sig(ys) + _sig(grads))
    return out


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 3])
def test_flash_meta_shapes_equal_plain(dtype, window):
    B, T, S, H_, K, D = 2, 6, 9, 4, 2, 8

    def make(dev):
        g = torch.Generator().manual_seed(0)
        f = _meta if dev == "meta" else (lambda *s, **k: _cpu(g, *s, **k))
        return (f(B, T, H_, D, dtype=dtype, grad=True),
                f(B, S, K, D, dtype=dtype, grad=True),
                f(B, S, K, D, dtype=dtype, grad=True))

    acc.reset()
    meta, cpu = _both(lambda q, k, v: (ops.flash_attention(q, k, v, window=window),),
                      make)
    assert meta == cpu
    pairs = acc.visible_pairs(T, S, True, window)
    c = acc.snapshot()
    assert c["flash_attention"]["flops"] == 4 * D * pairs * B * H_
    assert c["flash_attention"]["dense_flops"] == 4 * D * T * S * B * H_
    assert c["flash_attention_bwd"]["flops"] == 10 * D * pairs * B * H_
    assert c["flash_attention"]["launches"] == c["flash_attention_bwd"]["launches"] == 1


@pytest.mark.parametrize("T,S,causal,window", [(5, 5, True, 0), (3, 8, True, 0),
                                               (8, 3, True, 0), (7, 7, False, 0),
                                               (9, 12, True, 4), (6, 6, False, 2)])
def test_visible_pairs_equals_the_plain_mask(T, S, causal, window):
    """The closed form counts what ``attention_ref``'s mask lets through."""
    qpos = np.arange(T)[:, None] + (S - T)
    kpos = np.arange(S)[None, :]
    mask = np.ones((T, S), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    assert acc.visible_pairs(T, S, causal, window) == int(mask.sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_meta_shapes_equal_plain(dtype, with_h0):
    Bt, T, I, N = 2, 7, 6, 4

    def make(dev):
        g = torch.Generator().manual_seed(1)
        if dev == "meta":
            f = _meta
        else:
            def f(*s, **k):
                return _cpu(g, *s, **k)
        ins = [f(Bt, T, I, dtype=dtype, grad=True), f(Bt, T, I, grad=True),
               f(I, N, grad=True), f(Bt, T, N, dtype=dtype, grad=True),
               f(Bt, T, N, dtype=dtype, grad=True), f(I, grad=True)]
        if dev == "cpu":         # dt > 0, A < 0, as the mixer gives them
            with torch.no_grad():
                ins[1].abs_().mul_(0.1)
                ins[2].abs_().neg_()
        if with_h0:
            ins.append(f(Bt, I, N, grad=True))
        return ins

    acc.reset()
    meta, cpu = _both(lambda *a: ops.ssm_scan(*a), make)
    assert meta == cpu
    c = acc.snapshot()
    assert c["ssm_scan"]["flops"] == Bt * T * I * (6 * N + 3)
    assert c["ssm_scan_bwd"]["flops"] == Bt * T * I * N * 20
    assert c["ssm_scan"]["special"] == Bt * T * I * N


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_meta_shapes_equal_plain(dtype, with_h0):
    B, T, L = 2, 7, 6

    def make(dev):
        g = torch.Generator().manual_seed(2)
        if dev == "meta":
            f = _meta
        else:
            def f(*s, **k):
                return _cpu(g, *s, **k)
        ins = [f(B, T, L, dtype=dtype, grad=True) for _ in range(3)]
        ins.append(f(L, grad=True))
        if with_h0:
            ins.append(f(B, L, grad=True))
        return ins

    acc.reset()
    meta, cpu = _both(lambda *a: ops.rglru(*a), make)
    assert meta == cpu
    c = acc.snapshot()
    assert c["rglru_scan"]["flops"] == B * T * L * 12
    assert c["rglru_scan_bwd"]["special"] == B * T * L * 8


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_meta_shapes_equal_plain(dtype):
    acc.reset()
    meta = ops.quantize(_meta(5, 12, dtype=dtype))
    cpu = ops.quantize(torch.randn(5, 12).to(dtype))
    assert _sig(meta) == _sig(cpu)
    assert acc.snapshot()["quantize"]["flops"] == 6 * 5 * 12


def test_cpu_tensors_never_reach_the_meta_branch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the meta branch")

    monkeypatch.setattr(acc, "record", refuse)
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 4, 2, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 4, 2, 8, generator=g, requires_grad=True)
    o = ops.flash_attention(q, k, k)
    torch.testing.assert_close(o, ref.attention_ref(q, k, k))
    o.sum().backward()
    x = torch.randn(1, 5, 3, generator=g, requires_grad=True)
    y, _ = ops.ssm_scan(x, x.abs(), -torch.ones(3, 2), torch.randn(1, 5, 2),
                        torch.randn(1, 5, 2), torch.ones(3))
    y.sum().backward()
    hs, _ = ops.rglru(x, x, x, torch.zeros(3))
    hs.sum().backward()
    ops.quantize(torch.randn(3, 4))


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_meta_branch(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the meta branch")

    monkeypatch.setattr(acc, "record", refuse)
    q = torch.randn(1, 16, 2, 16, device="cuda", requires_grad=True)
    before = fa.LAUNCHES
    o = ops.flash_attention(q, q, q)
    o.sum().backward()
    assert fa.LAUNCHES == before + 1
    x = torch.randn(1, 5, 3, device="cuda", requires_grad=True)
    y, _ = ops.ssm_scan(x, x.abs(), -torch.ones(3, 2, device="cuda"),
                        torch.randn(1, 5, 2, device="cuda"),
                        torch.randn(1, 5, 2, device="cuda"),
                        torch.ones(3, device="cuda"))
    y.sum().backward()
    hs, _ = ops.rglru(x, x, x, torch.zeros(3, device="cuda"))
    hs.sum().backward()
    ops.quantize(torch.randn(3, 4, device="cuda"))


def test_step_counter_counts_dot_flops_and_op_bytes():
    a, b, z = torch.randn(6, 8), torch.randn(8, 5), torch.zeros(2, 6, 5)
    with H.StepCounter() as c:
        y = a @ b
        torch.baddbmm(z, a.expand(2, 6, 8), b.expand(2, 8, 5))
        y.view(30)                          # a view moves nothing
    assert c.flops == 2 * 6 * 8 * 5 * 3
    assert c.op_bytes == 4 * (6 * 8 + 8 * 5 + 6 * 5) + 4 * (2 * 6 * 5 * 2 + 2 * 6 * 8
                                                            + 2 * 8 * 5)
    assert c.collectives.count == 0 and c.kernels == {}


FAKE = textwrap.dedent("""
    import json, torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import hlostats as H, mesh as M
    M.fake_world(256)
    mesh = M.make_mesh((16, 16), ("data", "model"), "cpu")

    def meta(shape, pl):
        loc = list(shape)
        for m, p in enumerate(pl):
            if isinstance(p, Shard):
                loc[p.dim] //= mesh.size(m)
        return DTensor.from_local(torch.empty(loc, device="meta"), mesh, pl,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    a = meta((256, 4096), (Shard(0), Replicate()))
    b = meta((4096, 8192), (Replicate(), Shard(1)))
    with H.StepCounter() as c:
        y = (a @ b).redistribute(mesh, (Shard(0), Replicate()))
    import tempfile
    import torch.distributed as dist
    M.fake_world(8)                 # a fake group is replaced
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method="file://" + tempfile.mktemp(),
                            rank=0, world_size=1)
    try:
        M.fake_world(4)
        refused = False
    except RuntimeError:
        refused = True
    print(json.dumps({"flops": c.flops, "count": c.collectives.count,
                      "payload": c.collectives.payload_bytes,
                      "wire": c.collectives.wire_bytes,
                      "by_kind": c.collectives.by_kind,
                      "local": list(y.to_local().shape), "refused": refused}))
""")


def test_step_counter_on_a_fake_group_counts_rank_0():
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                                   "src"))
    r = subprocess.run([sys.executable, "-c", FAKE], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = __import__("json").loads(r.stdout.strip().splitlines()[-1])
    # Rank 0's (16, 4096) @ (4096, 512) block, not the whole product.
    assert got["flops"] == 2 * 16 * 4096 * 512
    # One all-gather of the (16, 512) f32 block over the model axis's 16.
    assert got["count"] == 1 and got["local"] == [16, 8192]
    assert got["payload"] == 16 * 16 * 512 * 4
    assert got["wire"] == got["payload"] * 15 / 16
    assert set(got["by_kind"]) == {"all-gather"}
    assert got["refused"]                    # a real group is not replaced


BREAKDOWN = textwrap.dedent("""
    import json
    from repro_torch.configs.registry import tiny_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import ShapeCell
    rec = D.run_cell("qwen3-32b", "t", "single", verbose=False,
                     cfg=tiny_config("qwen3-32b"),
                     mesh_shape=D.MeshShape(("data", "model"), (2, 4)),
                     cell=ShapeCell("t", 32, 8, "train"), by_op=True)
    print(json.dumps({k: rec[k] for k in ("by_op", "by_caller", "flops_per_device",
                                          "dense_flops_per_device", "collectives")}))
""")


def test_breakdown_sums_to_the_totals():
    """qwen3 TINY train on a fake (2, 4) group: the split by operation and
    the split by issuing line each add up to the step's FLOPs (with and
    without the kernels' masked tiles) and its wire bytes, exactly."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                                   "src"))
    r = subprocess.run([sys.executable, "-c", BREAKDOWN], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = __import__("json").loads(r.stdout.strip().splitlines()[-1])
    for split in ("by_op", "by_caller"):
        entries = rec[split].values()
        assert sum(e["flops"] for e in entries) == rec["flops_per_device"], split
        assert sum(e["dense_flops"] for e in entries) == rec["dense_flops_per_device"]
        assert (sum(e["wire_bytes"] for e in entries)
                == rec["collectives"]["wire_bytes_per_device"]), split
    assert rec["dense_flops_per_device"] > rec["flops_per_device"] > 0
    assert rec["collectives"]["wire_bytes_per_device"] > 0
    ops = rec["by_op"]
    assert {"aten.mm", "kernel.flash_attention", "kernel.flash_attention_bwd",
            "all-reduce"} <= set(ops)
    # the backward's products are named by the forward lines that made them
    assert any(k.startswith("bwd models/layers.py") for k in rec["by_caller"])
