#!/usr/bin/env python3
"""Where a kernel spends its instructions and its time, on one CUDA card.

    python3 tools/ablate_kernels.py --kernel scan_bwd|flash_fwd|flash_bwd [--src DIR]
        [--sass-only] [--dump DIR]

For the kernel's sources in the tree at DIR (default: this checkout's
``src/``), one table of ``TARGETS``:

- ``scan_bwd``: ``ssm_scan_bwd.cu`` and ``rglru_scan_bwd.cu``, timed at the
  training shapes with ``bench_scans``' calls.
- ``flash_fwd``: the bf16 wgmma forward of ``flash_attention.cu``, timed
  through its C entry point (serving's call, no log-sum-exp) at qwen3-32b's
  prefill, starcoder2-3b's training shape, whisper-small's encoder,
  granite-moe's prefill (head dims 128 and 64), paligemma-3b's training
  shape and recurrentgemma-9b's local shape (head dim 256), with
  ``chip_smoke``'s inputs.
- ``flash_bwd``: the bf16 wgmma backward of ``flash_attention_bwd.cu``
  (head dims 64, 128 and 256), timed through its C entry point from one
  forward's saved tensors at whisper-small's encoder (head dim 64),
  starcoder2-3b's training shape (128), paligemma-3b's and
  recurrentgemma-9b's local training shapes (256).

1. What ptxas says (``-Xptxas -v``) of the counted kernels: registers,
   spills and any warning, such as wgmma instructions it had to serialize.
2. SASS counts (``cuobjdump -sass``) of the counted kernels.  ``scan_bwd``:
   by class (shared loads and stores, shuffles, special functions, f32
   arithmetic, barriers), of each innermost loop that holds an exponential
   (``MUFU.EX2``) in the bf16 kernel (the ``NMAX = 16`` one for the
   selective scan), and per element, an element being one (step, state) of
   one lane: a loop iteration covers ``SEG`` steps times ``GROUP`` states
   (``GROUP`` is 1 where the source does not state it).  ``flash_fwd``: the
   whole of each wgmma kernel's HGMMA, warpgroup arrive and dependency
   barriers, MUFU.EX2, SHFL, SYNCS (the mbarrier operations) and BAR.
   ``flash_bwd``: the whole of each wgmma kernel (dK/dV and dQ blocks
   in one launch): HGMMA, warpgroup arrive and dependency barriers, SYNCS,
   HMMA, LDSM, MUFU.EX2, LDGSTS, STS, LDS, BAR, and STL / LDL (local
   memory: spills).
3. Ablations.  Copies the tree's ``csrc/`` under ``build/ablate/<name>/``,
   applies the text substitutions the table lists for that source (an
   ablation whose text is not in the source is reported as not
   applicable), builds the copies in parallel and times each beside the
   unchanged source, in turns.  An ablated kernel computes wrong values on
   purpose: its time says what the removed work costs, nothing else.

The copies live under ``build/`` and are never part of the repository.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (source file, [(text, replacement), ...]).  Each text must occur in
# the source; every occurrence is replaced.
SCAN_BWD_ABLATIONS = {
    # The earlier selective-scan backward (16-step segments, one state per
    # pass of the state loop), for --src on a tree that has it.
    "ssm: no dB/dC reduce-scatter": ("ssm_scan_bwd.cu", [
        ("int base = reduce_scatter(v, ch);", "int base = 0;"),
        ("base = reduce_scatter(v, ch);", "base = 0;")]),
    "ssm: dt, x, dy read once per chunk": ("ssm_scan_bwd.cu", [
        ("float ddt[SEG], dxs[SEG];",
         "float ddt[SEG], dxs[SEG];\n"
         "  const float dt0 = *at_seg<float, CH, SEG>(dts, g, 0, c);\n"
         "  const float x0 = to_f32(*at_seg<T, CH, SEG>(xs, g, 0, c));\n"
         "  const float dy0 = to_f32(*at_seg<T, CH, SEG>(dys, g, 0, c));"),
        ("*at_seg<float, CH, SEG>(dts, g, s, c)", "dt0"),
        ("to_f32(*at_seg<T, CH, SEG>(xs, g, s, c))", "x0"),
        ("to_f32(*at_seg<T, CH, SEG>(dys, g, s, c))", "dy0")]),
    "ssm: no per-state barrier and block sum": ("ssm_scan_bwd.cu", [
        ("    __syncthreads();                    // this state's warp sums are written\n"
         "    block_sum(rb, out, n, NMAX);\n", "")]),
    "ssm: all three": ("ssm_scan_bwd.cu", [
        ("int base = reduce_scatter(v, ch);", "int base = 0;"),
        ("base = reduce_scatter(v, ch);", "base = 0;"),
        ("float ddt[SEG], dxs[SEG];",
         "float ddt[SEG], dxs[SEG];\n"
         "  const float dt0 = *at_seg<float, CH, SEG>(dts, g, 0, c);\n"
         "  const float x0 = to_f32(*at_seg<T, CH, SEG>(xs, g, 0, c));\n"
         "  const float dy0 = to_f32(*at_seg<T, CH, SEG>(dys, g, 0, c));"),
        ("*at_seg<float, CH, SEG>(dts, g, s, c)", "dt0"),
        ("to_f32(*at_seg<T, CH, SEG>(xs, g, s, c))", "x0"),
        ("to_f32(*at_seg<T, CH, SEG>(dys, g, s, c))", "dy0"),
        ("    __syncthreads();                    // this state's warp sums are written\n"
         "    block_sum(rb, out, n, NMAX);\n", "")]),
    # The selective-scan backward of this tree (8-step segments, states in
    # pairs).
    "ssm: no dB/dC channel sums": ("ssm_scan_bwd.cu", [
        ("    channel_sums(dA, h, ch, red + (grp & 1) * RED_HALF, w, g);\n", "")]),
    "ssm: no lane scans": ("ssm_scan_bwd.cu", [
        ("      lane_scans(P[j], hc[j], Q[j], hin[j], qin[j], g, ch, hstart[j], q[j], "
         "first[j]);\n",
         "      hstart[j] = hin[j], q[j] = qin[j], first[j] = Q[j];\n")]),
    "ssm: no per-pair barrier and block sum": ("ssm_scan_bwd.cu", [
        ("    __syncthreads();                    // this pair's warp sums are written\n"
         "    block_sum(red + (grp & 1) * RED_HALF, out, n0, L::OSTR);\n", "")]),
    "ssm: B, C rows read as broadcasts": ("ssm_scan_bwd.cu", [
        ("*bc_at<NMAX>(bcs, g, s, grp)", "*bc_at<NMAX>(bcs, 0, s, grp)")]),
    "ssm: loads and stores only": ("ssm_scan_bwd.cu", [
        ("    bwd_chunk<T, NMAX>(st, a2s, qc, dAs, red, out, ds, N, g, c, w, ch,\n"
         "                       nt - g * SEG, dD);\n", "")]),
    # The RG-LRU backward of this tree (4-step segments over 16 lanes).
    "rglru: loads and stores only": ("rglru_scan_bwd.cu", [
        ("    const float first = bwd_chunk<T>(st, neg_c_lam, qc, g, c, ch, nt - g * SEG, lam);\n",
         "    const float first = qc;\n")]),
    "rglru: 4 stages": ("rglru_scan_bwd.cu", [
        ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")]),
    "rglru: 64 channels a block of 32 warps": ("rglru_scan_bwd.cu", [
        ("constexpr int WARPS = 16;", "constexpr int WARPS = 32;"),
        ("__launch_bounds__(THREADS, 2) rglru_scan_bwd_kernel(",
         "__launch_bounds__(THREADS, 1) rglru_scan_bwd_kernel(")]),
}
FA = "flash_attention.cu"
FLASH_FWD_ABLATIONS = {
    "no exp2 in the softmax": (FA, [
        ("const float p = exp2_ftz(fmaf(sc[4 * n + i], scale_log2, -mb[r]));",
         "const float p = fmaf(sc[4 * n + i], scale_log2, -mb[r]);")]),
    "no softmax (P = S)": (FA, [
        ("const float p = exp2_ftz(fmaf(sc[4 * n + i], scale_log2, -mb[r]));",
         "const float p = sc[4 * n + i];"),
        ("const bool full = k0 >= full_lo && k0 + BN <= full_hi;",
         "const bool full = true;"),
        ("corr[r] = exp2_ftz(m[r] * scale_log2 - mb[r]);", "corr[r] = 1.f;")]),
    "no P.V products": (FA, [
        ("wgmma_m64n64k16_rs_tn(acc, pa[kk], dv, 1);", "(void)dv;"),
        ("wgmma_m64n128k16_rs_tn(acc, pa[kk], dv, 1);", "(void)dv;"),
        ("wgmma_m64n128k16_rs_tn(*reinterpret_cast<float(*)[64]>(acc), pa[kk], dv, 1);",
         "(void)dv;"),
        ("wgmma_m64n128k16_rs_tn(*reinterpret_cast<float(*)[64]>(acc + 64), pa[kk], dv_hi, 1);",
         "(void)dv_hi;")]),
    "no Q.K products": (FA, [
        ("if constexpr (BN == 64) wgmma_m64n64k16_ss(sc, dq, dk, kk > 0);\n"
         "        else wgmma_m64n128k16_ss(sc, dq, dk, kk > 0);",
         "(void)dq; (void)dk;")]),
}
FAB = "flash_attention_bwd.cu"
# The wgmma backward's products and the pieces around them, each taken out:
# at head dims 64 and 128 and (the D=256 texts) in the 64-key dK/dV blocks,
# where warpgroup 0 computes S and P and warpgroup 1 dP, and in the D=256 dQ
# blocks.  A removed product keeps its commit, so the waits still count the
# same groups.
FLASH_BWD_ABLATIONS = {
    "wgmma: no softmax recompute (P = S)": (FAB, [
        ("float p = exp2_ftz(fmaf(st[4 * n + i], scale_log2, nl[col]));",
         "float p = st[4 * n + i];"),
        ("float p = exp2_ftz(fmaf(x[4 * n + i], scale_log2, nl[col]));",
         "float p = x[4 * n + i];"),
        ("float p = exp2_ftz(fmaf(sc[4 * n + i], scale_log2, nl[r]));",
         "float p = sc[4 * n + i];"),
        ("const bool all = (!causal || kwarp + 15 <= qp0) &&\n"
         "                         (window <= 0 || kwarp > qp0 + BQ - 1 - window);",
         "const bool all = true;"),
        ("const bool all = k0 >= full_lo && k0 + BN <= full_hi;", "const bool all = true;")]),
    "wgmma: no S products": (FAB, [
        ("product_ss<BQ, D, BN>(st, Ks, Qs);", "wgmma_commit();"),
        ("product_ss<BQ, D, BN>(x, rows, wg ? Os : Qs);",
         "if (wg) product_ss<BQ, D, BN>(x, rows, Os); else wgmma_commit();"),
        ("product_ss<BN, D, BM>(sc, Qs, Ks);", "wgmma_commit();")]),
    "wgmma: no dP products": (FAB, [
        ("product_ss<BQ, D, BN>(dpt, Vs, Os);", "wgmma_commit();"),
        ("product_ss<BQ, D, BN>(x, rows, wg ? Os : Qs);",
         "if (!wg) product_ss<BQ, D, BN>(x, rows, Qs); else wgmma_commit();"),
        ("product_ss<BN, D, BM>(dp, Os, Vs);", "wgmma_commit();")]),
    "wgmma: no dV products": (FAB, [
        ("product_rs<BQ, D>(dv_acc, pa, Os);", "wgmma_commit();"),
        ("product_rs<BQ, HALF>(dv_acc, pa, Os + 2 * wg * BQ * 128);", "wgmma_commit();")]),
    "wgmma: no dK products": (FAB, [
        ("product_rs<BQ, D>(dk_acc, da, Qs);", "wgmma_commit();"),
        ("product_rs<BQ, HALF>(dk_acc, da, Qs + 2 * wg * BQ * 128);", "wgmma_commit();")]),
    "wgmma: no dQ products": (FAB, [
        ("product_rs<BN, D>(acc, da, Ks);", "wgmma_commit();"),
        ("product_rs<BN, HALF>(acc[0], da, Ks);\n"
         "      product_rs<BN, HALF>(acc[1], da, Ks + 2 * BN * 128);", "wgmma_commit();")]),
    "wgmma: no dQ pass (its blocks not launched)": (FAB, [
        ("kern<<<(unsigned)(kv_blocks + q_blocks), THREADS", "kern<<<(unsigned)kv_blocks, THREADS")]),
    "wgmma: no dK/dV group sum (reduce not launched)": (FAB, [
        ("  tc::bwd_reduce_kernel<<<(unsigned)blocks, tc::REDUCE_THREADS, 0, stream>>>(\n"
         "      reinterpret_cast<const float4*>(dk_part),\n"
         "      reinterpret_cast<const float4*>(dv_part), static_cast<uint2*>(dk),\n"
         "      static_cast<uint2*>(dv), n4, groups, scale);\n", "(void)blocks;\n")]),
    # D=256 only: the consumers' exchange of P^T and dP^T (its shared-memory
    # round trip and both barriers; each warpgroup keeps its own tile), and a
    # dQ ring of two slots, one K/V stage (a correct variant).
    "wgmma D=256: no exchange": (FAB, [
        ("if (!first) consumers_sync(1);", "(void)first;"),
        ("      consumers_sync(2);\n", ""),
        ("        mine[n * 128] = make_float4(x[4 * n], x[4 * n + 1], x[4 * n + 2], x[4 * n + 3]);",
         "        (void)mine;"),
        ("const float4 o = theirs[n * 128];",
         "const float4 o = make_float4(x[4 * n], x[4 * n + 1], x[4 * n + 2], x[4 * n + 3]);"
         " (void)theirs;")]),
    "wgmma D=256: dQ ring of 2 slots": (FAB, [
        ("DQ_BN = 64, DQ_STAGES = 3; };", "DQ_BN = 64, DQ_STAGES = 2; };")]),
}

# Instruction classes by opcode prefix, in the order they are tried.
CLASSES = (("LDS", ("LDS", "LDSM")), ("STS", ("STS",)), ("SHFL", ("SHFL",)),
           ("MUFU", ("MUFU",)), ("FP32", ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL",
                                          "FSETP", "FSWZADD")),
           ("BAR", ("BAR",)), ("global", ("LDG", "STG", "LDGSTS", "LDGDEPBAR")))
FLASH_COUNTED = ("HGMMA", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR", "MUFU.EX2", "SHFL",
                 "SYNCS", "BAR")
FLASH_BWD_COUNTED = ("HGMMA", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR", "SYNCS", "HMMA", "LDSM",
                     "MUFU.EX2", "LDGSTS", "STS", "LDS", "BAR", "STL", "LDL")
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")


def sass_functions(lib: Path, tools) -> dict:
    """{demangled kernel name: [(address, opcode, operands)]} of a library."""
    text = subprocess.run([tools["cuobjdump"], "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = []
            funcs[m.group(1)] = cur
            continue
        m = LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    names = subprocess.run([tools["cu++filt"]], input="\n".join(funcs),
                           capture_output=True, text=True).stdout.splitlines()
    return dict(zip(names, funcs.values()))


def loop_counts(code, source_text: str) -> dict:
    """Counts by class, and per element, of each innermost loop (a backward
    branch's span) that holds a MUFU.EX2."""
    per_iteration = constant(source_text, "SEG", 1) * constant(source_text, "GROUP", 1)
    loops = []
    for addr, op, rest in code:
        m = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            body = [o for a, o, _ in code if lo <= a <= addr]
            if any(o.startswith("MUFU.EX2") for o in body):
                loops.append((lo, addr, body))
    inner = [lp for lp in loops if not any(
        o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    out = []
    for lo, hi, body in inner:
        counts = {"all": len(body)}
        for name, prefixes in CLASSES:
            counts[name] = sum(1 for o in body if o.startswith(prefixes))
        out.append({"span": [hex(lo), hex(hi)], "count": counts,
                    "per_element": {k: round(v / per_iteration, 3)
                                    for k, v in counts.items()}})
    return {"elements_per_iteration": per_iteration, "loops": out}


def op_counts(code, source_text: str, counted=FLASH_COUNTED) -> dict:
    """Counts of ``counted`` opcodes (``FLASH_COUNTED`` by default) over a
    whole kernel."""
    return {k: sum(1 for _, op, _ in code if op == k or op.startswith(k + "."))
            for k in counted}


def constant(src: str, name: str, default: int) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    return int(m.group(1)) if m else default


def scan_bwd_calls(torch, cs) -> dict:
    """{label: (source, call with a library, iterations)}: each scan backward
    at its training shape, the library loaded in place of the wrapper's."""
    sys.path.insert(0, str(ROOT / "tools"))
    from bench_scans import backward_calls
    from repro_torch.kernels import _build, rglru_scan, ssm_scan

    def with_lib(call, source):
        def bind(lib: Path):
            _build._LOADED[source] = ctypes.CDLL(str(lib))
            ssm_scan._bwd_fns.cache_clear()
            rglru_scan._bwd_fn.cache_clear()
            return call
        return bind

    return {name: (f"{name}.cu", with_lib(call, f"{name}.cu"), iters) for name, (call, iters)
            in backward_calls(torch, cs, ssm_scan, rglru_scan).items()}


def flash_fwd_calls(torch, cs) -> dict:
    """{label: (source, call with a library, iterations)}: the forward's C
    entry point of a library at six main shapes (head dims 64, 128, 256)."""
    from repro_torch.kernels import flash_attention as fa
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, shape in (("qwen3", cs.MAIN_SHAPE), ("starcoder2_train", cs.TRAIN_SHAPE),
                         ("whisper_encoder", cs.WHISPER_ENC_SHAPE),
                         ("granite", cs.GRANITE_SHAPE),
                         ("paligemma_train", cs.PALI_TRAIN_SHAPE),
                         ("recurrentgemma_local", cs.LOCAL_SHAPE)):
        B, T, S, H, K, D, causal, window = shape
        q, k, v = cs.attn_inputs(torch, shape, torch.bfloat16, seed=99)
        o = torch.empty_like(q)

        def bind(lib: Path, q=q, k=k, v=v, o=o, B=B, T=T, S=S, H=H, K=K, D=D,
                 causal=causal, window=window):
            fn = ctypes.CDLL(str(lib)).repro_flash_attention_fwd
            fn.argtypes = fa.ARGTYPES
            fn.restype = ctypes.c_int

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
                         None, 1, B, T, S, H, K, D, int(causal), window, D ** -0.5,
                         stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: {err}")
            return call

        out[f"{label} {list(shape)}"] = (FA, bind, 20)
    return out


def flash_bwd_calls(torch, cs) -> dict:
    """{label: (source, call with a library, iterations)}: the backward's C
    entry point of a library, from one forward's saved tensors (the tree's
    forward kernel), at whisper-small's encoder, starcoder2-3b's training
    shape, paligemma-3b's and recurrentgemma-9b's local training shape."""
    from repro_torch.kernels import flash_attention as fa
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, shape, iters in (("whisper_encoder", cs.WHISPER_ENC_SHAPE, 20),
                                ("starcoder2_train", cs.TRAIN_SHAPE, 20),
                                ("paligemma_train", cs.PALI_TRAIN_SHAPE, 20),
                                ("recurrentgemma_local_train", cs.LOCAL_TRAIN_SHAPE, 5)):
        B, T, S, H, K, D, causal, window = shape
        q, k, v = cs.attn_inputs(torch, shape, torch.bfloat16, seed=96)
        dout = cs.randn(torch, torch.Generator(device="cuda").manual_seed(95),
                        q.shape, torch.bfloat16)
        o, lse, o_lo = fa._forward(q, k, v, causal, window, D ** -0.5, with_lse=True)
        groups = fa.bwd_groups(B, S, H, K, D)
        partial = torch.empty(2 * groups * B * S * K * D, dtype=torch.float32,
                              device="cuda")
        delta = torch.empty((B, H, T), dtype=torch.float32, device="cuda")
        grads = [torch.empty_like(x) for x in (q, k, v)]
        ptrs = [x.data_ptr() for x in (q, k, v, o, o_lo, dout, lse, delta, partial,
                                       *grads)]

        def bind(lib: Path, ptrs=ptrs, B=B, T=T, S=S, H=H, K=K, D=D, groups=groups,
                 causal=causal, window=window):
            fn = ctypes.CDLL(str(lib)).repro_flash_attention_bwd
            fn.argtypes = fa.BWD_ARGTYPES
            fn.restype = ctypes.c_int

            def call():
                err = fn(*ptrs, 1, B, T, S, H, K, D, groups, int(causal), window,
                         D ** -0.5, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: {err}")
            return call

        out[f"{label} {list(shape)}"] = (FAB, bind, iters)
    return out


# kernel -> its ablations, the kernels whose SASS is counted (source ->
# demangled-name pattern), how, which ptxas lines are kept, and its calls.
TARGETS = {
    "scan_bwd": dict(
        ablations=SCAN_BWD_ABLATIONS,
        kernels={"ssm_scan_bwd.cu": r"ssm_scan_bwd_kernel<__nv_bfloat16, (\(int\))?16>",
                 "rglru_scan_bwd.cu": r"rglru_scan_bwd_kernel<__nv_bfloat16"},
        count=loop_counts, ptxas=r"spill|warning", calls=scan_bwd_calls),
    "flash_fwd": dict(
        ablations=FLASH_FWD_ABLATIONS,
        kernels={FA: r"fa_fwd_wgmma_kernel"},
        count=op_counts, ptxas=r"wgmma|warning|setmaxnreg", calls=flash_fwd_calls),
    "flash_bwd": dict(
        ablations=FLASH_BWD_ABLATIONS,
        kernels={FAB: r"bwd_wgmma_kernel<(\(int\))?(64|128|256)>"},
        count=lambda code, text: op_counts(code, text, FLASH_BWD_COUNTED),
        ptxas=r"wgmma|warning|setmaxnreg", calls=flash_bwd_calls),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True, choices=sorted(TARGETS))
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sass-only", action="store_true",
                    help="count instructions of the tree's sources; build and time no ablation")
    ap.add_argument("--dump", default=None,
                    help="write each counted kernel's SASS into this directory")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    target = TARGETS[args.kernel]
    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    bindir = Path(_build.find_nvcc()).parent
    tools = {t: str(bindir / t) for t in ("cuobjdump", "cu++filt")}
    csrc = _build.CSRC
    out = {"src": args.src, "kernel": args.kernel, "ptxas": {}, "sass": {},
           "ablations": {}}

    # Every variant's csrc: the tree's own and one copy per ablation.
    variants = {"as is": (csrc, tuple(target["kernels"]))}
    for name, (source, subs) in ({} if args.sass_only else target["ablations"]).items():
        text = (csrc / source).read_text()
        missing = [old for old, _ in subs if old not in text]
        if missing:
            out["ablations"][name] = "not applicable: text not in this source"
            continue
        for old, new in subs:
            text = text.replace(old, new)
        d = ROOT / "build" / "ablate" / re.sub(r"\W+", "-", name).strip("-") / "csrc"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        (d / source).write_text(text)
        variants[name] = (d, (source,))

    def compile_one(item):
        """Build one variant's sources with nvcc, into build/ablate/."""
        name, (d, sources) = item
        libs, logs = {}, {}
        for s in sources:
            lib = ROOT / "build" / "ablate" / (
                re.sub(r"\W+", "-", f"{name}-{Path(s).stem}").strip("-") + ".so")
            lib.parent.mkdir(parents=True, exist_ok=True)
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                   str(lib), str(d / s)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name} {s}:\n{proc.stderr[-3000:]}")
            libs[s], logs[s] = lib, proc.stderr
        return name, libs, logs

    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        built = list(pool.map(compile_one, variants.items()))
    libs = {name: by_source for name, by_source, _ in built}

    for source, log in built[0][2].items():
        out["ptxas"][source] = [ln.strip() for ln in log.splitlines()
                                if re.search(target["ptxas"], ln, re.IGNORECASE)]
        for ln in out["ptxas"][source]:
            print("ptxas:", ln[:300], flush=True)
    for name, by_source in libs.items():
        for source, lib in by_source.items():
            text = (variants[name][0] / source).read_text()
            funcs = sass_functions(lib, tools)
            pattern = target["kernels"][source]
            found = [f for f in funcs if re.search(pattern, f)]
            for fn in found:
                out["sass"][f"{name}: {fn}"] = target["count"](funcs[fn], text)
                if args.dump:
                    dump = Path(args.dump) / (re.sub(r"\W+", "-", f"{name}-{fn}")[:120]
                                              + ".sass")
                    dump.parent.mkdir(parents=True, exist_ok=True)
                    dump.write_text("\n".join(f"{a:06x} {o}{r}" for a, o, r in funcs[fn]))
            if not found:
                out["sass"][f"{name}: {source}"] = "kernel not found"

    if args.sass_only:
        print(json.dumps(out), flush=True)
        return 0
    calls = target["calls"](torch, cs)
    times = {}
    order = [n for n in libs if n != "as is"]
    for rnd in range(2):                     # as is, variants, ..., in turns
        for name in ["as is"] + (order if rnd == 0 else order[::-1]):
            for label, (source, bind, iters) in calls.items():
                if source in libs[name]:
                    times.setdefault(f"{name}: {label}", []).append(
                        cs.time_ms(torch, bind(libs[name][source]), iters=iters))
    for key, ms in times.items():
        print(f"{key}: {', '.join(f'{t:.4f}' for t in ms)} ms", flush=True)
    out["ablations"].update(times)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
