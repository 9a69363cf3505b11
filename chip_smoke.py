#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``langstream_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (every one unguarded: any failure exits non-zero):

1. set-up: require CUDA, print the card's name and power limit, build the
   kernels from ``langstream_tpu_torch/ops/csrc`` (one ``nvcc`` per source,
   started together) and print the build time;
2. each kernel against its plain PyTorch version at Llama-3-8B width
   (H=32, Kh=8, D=128) in bf16 and f32, with its time (the card's alone:
   a CUDA graph of the calls replayed; the eager time, host included,
   beside it), the plain version's time (eager), its bound and, for flash,
   ``scaled_dot_product_attention`` as the library yardstick (graph-timed
   as the kernel; timed here only, the port never calls it) — flash at S=512 and 2048 (bf16 through
   the wgmma kernel, f32 through the FMA kernel), the decode read over 64
   ragged slots (bf16/f32 and int8 pools through the split read, 256-row
   spans plus a combine launch; int8 with bf16 queries through mma.sync,
   with f32 ones through FMAs), the multi-query history read at the
   chunk's T=512, the prefix hits' T=64 and T=16, and the speculative
   verify's T=5 at B=8 (history split) and B=64 (bf16 through the wgmma
   kernel with its plan of warpgroups and history spans; f32 through the
   FMA kernel); and at Mixtral-8x7B's context (path G), flash at S=4096,
   the bf16 and int8 decode reads over 4,096 history rows and the
   multi-query read over histories to 3,584 rows;
3. main path A: ``TorchServingEngine`` serving the chat example's resource
   (llama3-8b, int8 weights, 64 slots, 2048 context, decode-chunk 32, dense
   KV) answering concurrent greedy requests, launch counters set to 0 just
   before and read just after (as for every path);
4. main path B: the same with ``kv-layout: paged``, ``kv-quantize: int8``
   (a profiled second wave, as path A);
   main path C: paged bf16 KV with the prefix cache and ``prefill-chunk:
   512``, three waves in turn over a shared ~1,100-token preamble (chunked
   prefills, then prefix hits, then a repeated prompt), printing the
   (batch, T) of each multi-query call;
   main path D: paged bf16 KV with ``speculative-drafts: 4``, one wave of
   six greedy prompts that repeat a phrase and two sampled ones: the
   speculative stats, the (batch, T) of the verify's multi-query calls,
   TTFT and tokens per step; then the greedy prompts with speculation off
   and the share of tokens that match (printed, not required);
   main path E: the chat example's resource (``CHAT_EXAMPLE_RESOURCE``:
   dense bf16 KV, ``decode-chunk-light: 8``, ``warmup-on-start``) through
   the port's provider, as the ``ai-chat-completions`` agent reaches it:
   the first chat runs the warmup; a streamed wave of 8 (light regime, at
   most 8 steps per decode dispatch) and one of 24 (heavy, more than 8);
   a stop string; an ``adapter`` and a spent ``deadline`` refused before
   they queue; then the embeddings service (minilm-l6) on the card against
   the CPU within 1e-4;
   main path F: the saturated load, 96 greedy requests (30-600 byte tokens,
   max-tokens cycling 48/96/128/160) on 64 slots, four times: F1 the chat
   example's resource (dense bf16 KV) with the pipelined loop, F2 the same
   with ``pipeline: false``, F3/F4 paged int8 KV pipelined/sequential; per
   run decode tok/s, ms per step, steps per dispatch,
   ``host_fetches_per_chunk`` (must be 1.0), the flight split (device,
   exposed host, stall, overlapped host) and idle share, the attribution's expected against achieved decode ms at
   the card's bandwidth, device-cache counts and peak memory; F1's greedy
   streams against F2's (recorded); the block manager idle after F3/F4;
   main path G: Mixtral-8x7B (``moe-8x7b``, 16 of its 32 layers, full width, random
   int8 weights) at the ``moe-mixtral-ep`` resource without its mesh (32
   slots, 4,096 context): G1 with the example's dense bf16 KV, a wave of 8
   (one ~3,000-token prompt: flash at the 4,096 bucket), a wave of 32
   (pipelined) and a profiled wave of 32 (prompts of one bucket, 17
   tokens each; device busy time by group: dequant, GEMMs, the expert
   FFN's routing/dispatch/activation/combine, flash, paged read); G2 paged int8 KV, a wave
   of 32; per run ms per step, decode tok/s, TTFT, the attribution's
   expected against achieved ms and peak memory;
   main path H: the admission and delivery planes at llama3-8b, the chat
   example's resource with paged int8 KV, ``streaming: true``, a ``qos``
   section (three classes, a ``bulk`` tenant's request bucket) and an
   ``slo`` section, the pool sized so the batch wave reserves 94% of it:
   48 batch requests (300-600 tokens, 256 generated) decode, 16
   interactive ones arrive through the provider's streaming branch with
   stream keys (four cancelled through the stream registry after their
   second chunk) and batch victims are preempted and resume, 16 further
   bulk submissions are throttled; H1 with QoS, H2 the same traffic FIFO.
   Per run TTFT and TBT by class, preemptions, resume waits, sheds,
   cancelled against reclaimed, decode tok/s, ``health()`` and the SLO
   burn; exits non-zero unless every request that was neither shed nor
   cancelled completes and tiles its stream, preemptions equal resumes,
   reclaimed equals cancelled, the block manager ends idle,
   ``host_fetches_per_chunk`` is 1.0 and H1's ``health()`` ends ok;
   the preempted streams against H2's (recorded);
5. the tiny f32 engine on the card against the same engine on the CPU with
   the same params, two waves in turn: greedy tokens must be identical
   (the HF fixture ``tests/fixtures/llama_tiny_golden`` loaded through
   ``checkpoint:``, dense, whose greedy tokens must also equal the
   fixture's, and paged with int8 KV; random weights dense, paged, int8
   KV, and paged with the prefix cache, with chunked
   prefill and with int8 KV; speculative on bf16/f32 and int8 KV, a
   repetitive prompt added so drafts land, the f32 streams also equal to
   speculation off; moe-tiny dense, paged int8 KV, prefix cache with
   chunked prefill, and speculative; the pipelined loop, dense and paged
   int8 KV, and moe-tiny dense, under a mixed-length load of 8 requests
   on 3 slots, where moe-tiny's capacity drops choices; a QoS layout, 8
   blocks of 16 on 2 slots, where a batch request is preempted by an
   interactive one and resumes to its unpreempted tokens);
6. one ``{"kernels": [...]}`` JSON line (launches summed over paths A-H),
   then the last line
   ``{"ok": true, "device": {...}}``.

Weights are random, made from a seed (path E's LM head keeps only the
printable ASCII columns, so its greedy text is not empty), apart from the
tiny HF fixture in the repository; nothing is downloaded.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
TOL_BF16 = 2e-2
TOL_F32 = 1e-4
TOL_EMBED = 1e-4
# examples/applications/chat-completions/configuration.yaml's resource, as
# yaml.safe_load reads it (written out: the card may lack PyYAML; a CPU
# test holds the two equal)
CHAT_EXAMPLE_RESOURCE = {
    "type": "tpu-serving-configuration",
    "name": "tpu",
    "configuration": {
        "model": "llama3-8b",
        "slots": 64,
        "max-seq-len": 2048,
        "decode-chunk": 32,
        "decode-chunk-light": 8,
        "warmup-on-start": True,
        "quantize": "int8",
    },
}


def ptxas_report(logs: dict) -> list[str]:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output: its
    (mangled) name, registers and spills."""
    out = []
    for lib, log in sorted(logs.items()):
        fn = spill = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line.strip()
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and fn:
                out.append(f"ptxas [{lib}] {fn}: {line.split(':', 1)[-1].strip()}; {spill}")
                fn = spill = None
    return out


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2, graph: bool = False) -> float:
    """Mean ms per call between CUDA events. ``graph``: the calls are
    captured once in a CUDA graph and replayed, so the time is the card's
    alone (a wrapper's host work between launches is left out; without it
    a call shorter than its host work measures the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(torch, fn, iters: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches (a split read and
    its combine, say), from a torch.profiler capture of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].split()[-1]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / iters / 1e3
    return {k: round(v, 4) for k, v in out.items()}


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def paged_case(torch, *, B, H, Kh, D, bs, max_len, dtype, int8, dense, seed):
    """Ragged slots (0, a sub-block, a block-exact and a full-length one
    among them) over a pool with shuffled block tables, or the dense view
    (identity tables over a (B, max_len) cache)."""
    from langstream_tpu_torch.models.kvquant import quantize_rows

    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, max_len + 1, (B,), generator=g)
    lengths[:4] = torch.tensor([0, bs // 2 + 5, 2 * bs, max_len])
    max_blocks = -(-max_len // bs)
    if dense:
        nb = B * max_blocks
        tables = (torch.arange(B)[:, None] * max_blocks + torch.arange(max_blocks)[None, :])
    else:
        nb = int(sum(-(-int(n) // bs) for n in lengths)) + 1
        perm = (torch.randperm(nb - 1, generator=g) + 1).tolist()
        tables = torch.zeros((B, max_blocks), dtype=torch.int64)
        for b in range(B):
            for j in range(-(-int(lengths[b]) // bs)):
                tables[b, j] = perm.pop()
    KhD = Kh * D
    q = torch.randn((B, H, D), generator=g).to(dtype)
    pools = [torch.randn((nb, bs, KhD), generator=g).to(dtype) for _ in range(2)]
    if int8:  # rows quantized as the engine stores them
        pools = [
            {"q": r["q"].reshape(nb, bs, KhD), "s": r["s"]}
            for r in (quantize_rows(p.reshape(nb, bs, Kh, D)) for p in pools)
        ]

    def cuda(x):
        if isinstance(x, dict):
            return {k: v.cuda() for k, v in x.items()}
        return x.cuda()

    return (cuda(q), cuda(pools[0]), cuda(pools[1]),
            tables.to(torch.int32).cuda(), lengths.to(torch.int32).cuda(),
            max_blocks)


def check_paged(torch, name, fn, plain, case, *, kv_heads, head_dim, tol):
    from langstream_tpu_torch.ops.paged_attention import (
        NEG_INF, merge_partial_attention,
    )

    q, kp, vp, tables, lengths, nrb = case
    kw = dict(num_read_blocks=nrb, kv_heads=kv_heads, head_dim=head_dim)
    got = fn(q, kp, vp, tables, lengths, **kw)
    want = plain(q, kp, vp, tables, lengths, **kw)
    torch.cuda.synchronize()
    for t in got:
        if not torch.isfinite(t[lengths > 0]).all():
            fail(f"{name}: non-finite partials")
    zero = (lengths == 0).nonzero().flatten()
    acc, m, l = got
    if len(zero) and not (
        (m[zero] == NEG_INF).all() and (l[zero] == 0).all() and (acc[zero] == 0).all()
    ):
        fail(f"{name}: a length-0 slot must give m=NEG_INF, l=0, acc=0")
    err = (merge_partial_attention([got]) - merge_partial_attention([want])).abs().max().item()
    if not err <= tol:
        fail(f"{name}: normalised max abs error {err} > {tol}")
    return err


def phase_kernels(torch) -> dict:
    from langstream_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, flash_kernel_route,
    )
    from langstream_tpu_torch.ops.paged_attention import (
        _paged_attention_partial_q8, paged_attention_partial,
        paged_attention_reference, paged_read_splits,
    )

    F = torch.nn.functional
    H, Kh, D, B = 32, 8, 128, 64
    rows, at_4096 = {}, {}

    # -- kernels 2 and 3: paged decode reads --------------------------------
    cases = [
        ("paged_attention", "bs64 bf16", paged_attention_partial,
         dict(bs=64, dtype=torch.bfloat16, int8=False, dense=False), TOL_BF16),
        ("paged_attention", "dense bs128 bf16", paged_attention_partial,
         dict(bs=128, dtype=torch.bfloat16, int8=False, dense=True), TOL_BF16),
        ("paged_attention_q8", "bs64 int8", _paged_attention_partial_q8,
         dict(bs=64, dtype=torch.bfloat16, int8=True, dense=False), TOL_BF16),
        ("paged_attention", "bs64 f32", paged_attention_partial,
         dict(bs=64, dtype=torch.float32, int8=False, dense=False), TOL_F32),
        ("paged_attention_q8", "bs64 int8 f32-q", _paged_attention_partial_q8,
         dict(bs=64, dtype=torch.float32, int8=True, dense=False), TOL_F32),
        # Mixtral-8x7B's context (path G): 4,096 history rows, 16 spans
        ("paged_attention", "dense bs128 bf16 4096", paged_attention_partial,
         dict(bs=128, dtype=torch.bfloat16, int8=False, dense=True, max_len=4096),
         TOL_BF16),
        ("paged_attention_q8", "bs64 int8 4096", _paged_attention_partial_q8,
         dict(bs=64, dtype=torch.bfloat16, int8=True, dense=False, max_len=4096),
         TOL_BF16),
    ]
    for name, label, fn, spec, tol in cases:
        spec = {"max_len": 2048, **spec}
        case = paged_case(torch, B=B, H=H, Kh=Kh, D=D, seed=7, **spec)
        err = check_paged(torch, f"{name} {label}", fn, paged_attention_reference,
                          case, kv_heads=Kh, head_dim=D, tol=tol)
        q, kp, vp, tables, lengths, nrb = case
        kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
        ms = cuda_ms(torch, lambda: fn(q, kp, vp, tables, lengths, **kw), graph=True)
        eager_ms = cuda_ms(torch, lambda: fn(q, kp, vp, tables, lengths, **kw))
        plain_ms = cuda_ms(torch, lambda: paged_attention_reference(
            q, kp, vp, tables, lengths, **kw), iters=3, warmup=1)
        n_rows = int(lengths.clamp(max=nrb * spec["bs"]).sum())
        elem = 1 if spec["int8"] else (2 if spec["dtype"] == torch.bfloat16 else 4)
        nbytes = (
            2 * n_rows * Kh * D * elem + (2 * n_rows * Kh * 4 if spec["int8"] else 0)
            + q.numel() * q.element_size() + B * H * (D + 2) * 4
            + tables.numel() * 4 + B * 4
        )
        flops = 4.0 * H * D * n_rows
        peak = BF16_FLOPS_PER_S if spec["dtype"] == torch.bfloat16 else F32_FLOPS_PER_S
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        spans = f"spans={paged_read_splits(nrb, spec['bs'])}"
        if spec["int8"]:  # the int8 read's products: mma.sync for bf16 q, FMAs for f32
            spans += f" kernel={'mma' if spec['dtype'] == torch.bfloat16 else 'fma'}"
        print(f"kernel {name} [{label}] B={B} H={H} Kh={Kh} D={D} rows={n_rows} {spans}: "
              f"max_abs_err={err:.3e} ms={ms:.4f} eager_ms={eager_ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"achieved={nbytes / ms / 1e6:.1f} GB/s by_kernel="
              f"{device_ms_by_kernel(torch, lambda: fn(q, kp, vp, tables, lengths, **kw))}",
              flush=True)
        timing = dict(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if label in ("bs64 bf16", "bs64 int8"):
            rows[name] = timing
        elif label.endswith("4096"):
            at_4096[name] = {"case": label, **timing}

    # -- kernel 1: flash prefill ---------------------------------------------
    g = torch.Generator().manual_seed(11)
    for S, dtype, tol, label in (
        (512, torch.bfloat16, TOL_BF16, "bf16"),
        (2048, torch.bfloat16, TOL_BF16, "bf16"),
        (4096, torch.bfloat16, TOL_BF16, "bf16"),  # path G's longest bucket
        (512, torch.float32, TOL_F32, "f32"),
    ):
        Bf = 2 if S == 4096 else 4  # the plain version holds B*H*S*S f32 scores
        true_len = torch.tensor([S, S - 37, S // 2 + 3, 17])[:Bf]
        valid = (torch.arange(S)[None, :] < true_len[:, None])[:, :, None, None]
        q = (torch.randn((Bf, S, H, D), generator=g) * valid).to(dtype).cuda()
        k = (torch.randn((Bf, S, Kh, D), generator=g) * valid).to(dtype).cuda()
        v = (torch.randn((Bf, S, Kh, D), generator=g) * valid).to(dtype).cuda()
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail(f"flash_attention S={S} {label}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol:
            fail(f"flash_attention S={S} {label}: max abs error {err} > {tol}")
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v, causal=True), graph=True)
        eager_ms = cuda_ms(torch, lambda: flash_attention(q, k, v, causal=True))
        plain_ms = cuda_ms(torch, lambda: flash_attention_reference(q, k, v, causal=True),
                           iters=2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), graph=True)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True).transpose(1, 2)
        lib_err = (lib_out.float() - want.float()).abs().max().item()
        elem = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem
        flops = 4.0 * Bf * H * D * S * (S + 1) / 2
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        print(f"kernel flash_attention [{label}] B={Bf} S={S} H={H} Kh={Kh} D={D} "
              f"kernel={flash_kernel_route(dtype, D)}: "
              f"max_abs_err={err:.3e} ms={ms:.4f} eager_ms={eager_ms:.4f} "
              f"plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (library err {lib_err:.2e}) "
              f"bound_ms={b_ms:.4f} ({b_by}) "
              f"achieved={flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        timing = dict(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
        if S == 2048:
            rows["flash_attention"] = timing
        elif S == 4096:
            at_4096["flash_attention"] = {"case": f"B={Bf} S=4096 bf16", **timing}
        del q, k, v, got, want, qt, kt, vt, lib_out
        torch.cuda.empty_cache()
    for name, timing in at_4096.items():  # beside each row of the kernels line
        rows[name]["mixtral_4096"] = timing
    return rows


def mq_case(torch, B: int, seed: int, max_len: int = 2048):
    """Ragged history over shuffled tables for the multi-query read: B
    slots, starts 0, a sub-block, block-exact and ``max_len - 512`` among
    them."""
    bs, top = 64, max_len - 512
    g = torch.Generator().manual_seed(seed)
    starts = torch.randint(1, top + 1, (B,), generator=g)
    starts[:4] = torch.tensor([0, bs // 2 + 5, 2 * bs, top])
    nrb = -(-int(starts.max()) // bs)
    nb = int(sum(-(-int(n) // bs) for n in starts)) + 1
    perm = (torch.randperm(nb - 1, generator=g) + 1).tolist()
    tables = torch.zeros((B, max_len // bs), dtype=torch.int32)
    for b in range(B):
        for j in range(-(-int(starts[b]) // bs)):
            tables[b, j] = perm.pop()
    return g, starts, tables.cuda(), starts.to(torch.int32).cuda(), nrb, nb


def phase_mq_kernel(torch) -> dict:
    """Kernel 4: the multi-query history read at Llama-3-8B width, ragged
    history over shuffled tables: B=8 slots at T=16, the prefix hits' T=64
    and the chunk's T=512; the speculative verify's T=5 (four drafts + 1)
    at B=8 (history split) and B=64 (the 64-slot verify, unsplit); bf16
    and f32."""
    from langstream_tpu_torch.ops.paged_attention import (
        NEG_INF, _multiquery_plan, merge_partial_attention, multiquery_kernel_route,
        paged_attention_multiquery_partial, paged_attention_multiquery_reference,
    )

    H, Kh, D, bs = 32, 8, 128, 64
    cases = {B: mq_case(torch, B, seed) for B, seed in ((8, 13), (64, 17))}
    cases["8 at 4096"] = mq_case(torch, 8, 19, max_len=4096)  # Mixtral's context
    row, verify = None, {}
    for B, T, dtype, tol, label in ((8, 16, torch.bfloat16, TOL_BF16, "bf16"),
                                    ("8 at 4096", 64, torch.bfloat16, TOL_BF16, "bf16"),
                                    (8, 64, torch.bfloat16, TOL_BF16, "bf16"),
                                    (8, 512, torch.bfloat16, TOL_BF16, "bf16"),
                                    (8, 5, torch.bfloat16, TOL_BF16, "bf16"),
                                    (64, 5, torch.bfloat16, TOL_BF16, "bf16"),
                                    (8, 16, torch.float32, TOL_F32, "f32"),
                                    (8, 64, torch.float32, TOL_F32, "f32"),
                                    (8, 512, torch.float32, TOL_F32, "f32"),
                                    (8, 5, torch.float32, TOL_F32, "f32"),
                                    (64, 5, torch.float32, TOL_F32, "f32")):
        g, starts, tables, starts_d, nrb, nb = cases[B]
        history = B
        B = tables.shape[0]
        n_rows = int(starts.sum())
        q = torch.randn((B, T, H, D), generator=g).to(dtype).cuda()
        kp, vp = (torch.randn((nb, bs, Kh * D), generator=g).to(dtype).cuda()
                  for _ in range(2))
        args = (q, kp, vp, tables, starts_d)
        kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
        route = multiquery_kernel_route(dtype, D)
        want = paged_attention_multiquery_reference(*args, **kw)
        got = paged_attention_multiquery_partial(*args, **kw)
        torch.cuda.synchronize()
        acc, m, l = got
        tag = f"paged_attention_multiquery B={B} T={T} {label}"
        if not (torch.isfinite(acc[1:]).all() and torch.isfinite(l[1:]).all()):
            fail(f"{tag}: non-finite partials")
        if not ((m[0] == NEG_INF).all() and (l[0] == 0).all() and (acc[0] == 0).all()):
            fail(f"{tag}: a starts == 0 slot must give m=NEG_INF, l=0, acc=0")
        err = (merge_partial_attention([got]) - merge_partial_attention([want])
               ).abs().max().item()
        if not err <= tol:
            fail(f"{tag}: normalised max abs error {err} > {tol}")
        call = lambda: paged_attention_multiquery_partial(*args, **kw)  # noqa: E731
        ms = cuda_ms(torch, call, graph=True)
        eager_ms = cuda_ms(torch, call)
        kept_wg, spans, _ = _multiquery_plan(B, T, H // Kh, Kh, nrb, bs)
        plain_ms = cuda_ms(torch, lambda: paged_attention_multiquery_reference(*args, **kw),
                           iters=2, warmup=1)
        elem = q.element_size()
        nbytes = (2 * n_rows * Kh * D * elem + q.numel() * elem
                  + B * T * H * (D + 2) * 4 + tables.numel() * 4 + B * 4)
        flops = 4.0 * T * H * D * n_rows
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        print(f"kernel paged_attention_multiquery [T={T} {label}] B={B} H={H} Kh={Kh} "
              f"D={D} bs={bs} history_rows={n_rows} kernel={route} "
              f"warpgroups={kept_wg if route == 'wgmma' else '-'} "
              f"spans={spans if route == 'wgmma' else 1}: "
              f"max_abs_err={err:.3e} "
              f"ms={ms:.4f} eager_ms={eager_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) achieved={flops / ms / 1e9:.1f} TFLOP/s "
              f"by_kernel={device_ms_by_kernel(torch, call)} "
              f"library_ms=none (no PyTorch call returns these partials from a "
              f"block table)", flush=True)
        timing = dict(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if history == "8 at 4096":
            at_4096 = {"case": f"B=8 T={T} history to {int(starts.max())} bf16", **timing}
        elif T == 512 and dtype == torch.bfloat16:
            row = timing
        elif T == 5 and dtype == torch.bfloat16:
            verify[f"B{B}"] = {"spans": spans, **timing}
        del q, kp, vp, args, want, got, acc, m, l
        torch.cuda.empty_cache()
    # the row of the kernels line: T=512 (path C's chunk) as in earlier
    # runs, the verify's T=5 beside it
    return {"paged_attention_multiquery": {**row, "verify_t5_bf16": verify,
                                           "mixtral_4096": at_4096}}


# ---------------------------------------------------------------------------
# phases 3-5: the engine
# ---------------------------------------------------------------------------


def _wrappers() -> dict:
    """Each kernel's wrapper (its launch counter) by kernel name."""
    from langstream_tpu_torch.ops.flash_attention import flash_attention
    from langstream_tpu_torch.ops.paged_attention import (
        _paged_attention_partial_q8, paged_attention_multiquery_partial,
        paged_attention_partial,
    )

    return {
        "flash_attention": flash_attention,
        "paged_attention": paged_attention_partial,
        "paged_attention_q8": _paged_attention_partial_q8,
        "paged_attention_multiquery": paged_attention_multiquery_partial,
    }


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def chat_prompts() -> list[str]:
    long = ("You are a helpful assistant. Summarize the following support "
            "ticket and propose next steps. ") * 6  # > 512 byte tokens
    return [
        long,
        long,  # the same prompt twice must give the same tokens
        "What is the capital of France?",
        "Write a haiku about GPUs.",
        "Explain paged attention in two sentences.",
        "List three prime numbers.",
        "Translate 'good morning' into Spanish.",
        "How many legs does a spider have?",
    ]


async def serve(engine, prompts, max_tokens):
    t0 = time.monotonic()
    results = await asyncio.gather(*(
        engine.generate(p, {"max-tokens": max_tokens, "temperature": 0})
        for p in prompts
    ))
    wall = time.monotonic() - t0
    stats = engine.stats()
    return results, wall, stats


def device_breakdown(torch, prof, wall_s: float) -> str:
    """Kernel time by group from a torch.profiler capture: the device's busy
    and idle share of the captured window, and the top kernels."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return "profile: no device events captured"
    by_name: dict[str, float] = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy = sum(by_name.values())
    span = max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)
    # flash_fwd_wgmma_kernel (bf16) and flash_fwd_kernel (f32); the decode
    # read's paged_decode_split_kernel (bf16/f32 pools) or
    # paged_decode_split_q8_kernel (int8 pools) + paged_decode_combine_kernel;
    # the multi-query read's paged_mq_wgmma_kernel + paged_mq_combine_kernel
    # (bf16) or paged_mq_kernel (f32)
    groups = {"flash prefill (flash_fwd_*)": 0.0, "paged read (paged_decode_*)": 0.0,
              "multi-query read (paged_mq_*)": 0.0, "gemm": 0.0,
              "memcpy/memset": 0.0, "other (elementwise, reductions)": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        if "flash_fwd_" in name:
            groups["flash prefill (flash_fwd_*)"] += us
        elif "paged_decode_" in name:
            groups["paged read (paged_decode_*)"] += us
        elif "paged_mq_" in name:
            groups["multi-query read (paged_mq_*)"] += us
        elif any(k in low for k in ("gemm", "cutlass", "xmma", "cublas", "gemv", "nvjet")):
            groups["gemm"] += us
        elif "memcpy" in low or "memset" in low:
            groups["memcpy/memset"] += us
        else:
            groups["other (elementwise, reductions)"] += us
    lines = [f"profile: wall_s={wall_s:.3f} device_span_ms={span / 1e3:.1f} "
             f"device_busy_ms={busy / 1e3:.1f} busy_share_of_span={busy / span:.3f} "
             f"kernels={len(kern)}"]
    for g, us in groups.items():
        lines.append(f"profile group {g}: {us / 1e3:.1f} ms ({us / busy:.3f} of busy)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        lines.append(f"profile top {us / 1e3:9.2f} ms  {name[:110]}")
    return "\n".join(lines)


def phase_main_path(torch, label, cfg: dict, params=None, profile=False):
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    t0 = time.monotonic()
    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cuda", params=params)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = chat_prompts()
    if len(engine.tokenizer.encode(prompts[0])) < 512:
        fail("the long prompt must be at least 512 tokens")

    async def run():
        try:
            measured = await serve(engine, prompts, 64)
            counts = read_counts()
            report = None
            if profile:  # a second, identical wave under the profiler
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as torch_profile

                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA],
                                   acc_events=True) as prof:
                    _, wall, _ = await serve(engine, prompts, 64)
                report = device_breakdown(torch, prof, wall)
            return measured, counts, report
        finally:
            await engine.close()

    reset_counts()
    (results, wall, stats), counts, report = asyncio.run(run())
    for i, r in enumerate(results):
        if not r["tokens"] or len(r["tokens"]) > 64:
            fail(f"{label}: request {i} returned {len(r['tokens'])} tokens")
        if not all(math.isfinite(x) for x in r["logprobs"]):
            fail(f"{label}: request {i} has non-finite logprobs")
    if results[0]["tokens"] != results[1]["tokens"]:
        fail(f"{label}: the same prompt gave different greedy tokens")
    dc = stats["decode-chunks"]
    if dc["host_fetches_per_chunk"] != 1.0:
        fail(f"{label}: host_fetches_per_chunk {dc['host_fetches_per_chunk']} != 1.0")
    ttft = sorted(r["ttft"] for r in results)
    n_tokens = sum(len(r["tokens"]) for r in results)
    step_ms = dc["seconds"] / dc["steps"] * 1e3 if dc["steps"] else float("nan")
    decode_tok_s = (n_tokens - len(results)) / dc["seconds"] if dc["seconds"] else 0.0
    print(f"main path [{label}]: init_s={init_s:.2f} requests={len(results)} "
          f"tokens={n_tokens} wall_s={wall:.3f} ttft_s min={ttft[0]:.3f} "
          f"max={ttft[-1]:.3f} tok_s_wall={n_tokens / wall:.1f} "
          f"decode_tok_s={decode_tok_s:.1f} decode_steps={dc['steps']} "
          f"ms_per_step={step_ms:.2f} chunks={dc['dispatched']} "
          f"prefill_calls={stats['prefill-calls']} launches={counts} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f}", flush=True)
    if report:
        print(report, flush=True)
    return engine.params, counts


def preamble_prompts() -> tuple[list[str], list[str], list[str]]:
    """Main path C's three waves: six questions on a shared preamble of
    about 1,100 byte tokens plus two short distinct prompts; six new
    questions on the same preamble; one prompt of the first wave again."""
    preamble = ("You are the support assistant of a cloud storage service. "
                "Answer from the policy below and cite the section. Policy: "
                "accounts keep deleted files for thirty days; shared links "
                "expire after seven days unless renewed; uploads above five "
                "gigabytes resume in parts; two-factor sign-in is required for "
                "administrators; quotas are counted per organisation, not per "
                "user. ") * 3
    first = [preamble + f"Question {i}: {q}" for i, q in enumerate((
        "How long are deleted files kept?", "Can a shared link last a month?",
        "Do large uploads restart from zero?", "Who must use two-factor sign-in?",
        "Is the quota per user?", "What happens after thirty days?"))]
    second = [preamble + f"Question {i + 6}: {q}" for i, q in enumerate((
        "How do I renew a shared link?", "Are quotas shared by a team?",
        "Can a viewer restore a deleted file?", "What is the upload part size?",
        "Do guests need two-factor sign-in?", "Which section covers links?"))]
    short = ["What is the capital of France?", "List three prime numbers."]
    return first + short, second, [first[2]]


def phase_prefix_path(torch, label, cfg: dict, params):
    """Main path C: three waves in turn through the prefix cache and the
    chunked prefill; checks the cache hits and that the repeated prompt
    gives its wave-1 greedy tokens (first 8)."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    t0 = time.monotonic()
    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cuda", params=params)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    waves = preamble_prompts()
    n_pre = len(engine.tokenizer.encode(waves[1][0]))
    if not 1024 + 64 <= n_pre <= 1300:
        fail(f"{label}: the preamble prompts must be about 1,100 tokens, got {n_pre}")

    async def run():
        try:
            out = []
            for wave in waves:
                out.append(await serve(engine, wave, 64))
            return out
        finally:
            await engine.close()

    # which (batch, T) each continuation pass gives the multi-query read:
    # a recorder around the model's call (the wrapper still counts launches)
    from langstream_tpu_torch.models import llama_paged

    real_mq, mq_calls = llama_paged.paged_attention_multiquery_partial, []

    def recording_mq(q, *args, **kw):
        mq_calls.append((q.shape[0], q.shape[1], kw["num_read_blocks"]))
        return real_mq(q, *args, **kw)

    llama_paged.paged_attention_multiquery_partial = recording_mq
    reset_counts()
    t0 = time.monotonic()
    try:
        served = asyncio.run(run())
    finally:
        llama_paged.paged_attention_multiquery_partial = real_mq
    wall = time.monotonic() - t0
    counts = read_counts()
    layers = engine.model_config.layers
    print(f"main path [{label}]: multi-query calls per continuation pass "
          f"(B, T, num_read_blocks): {mq_calls[::layers]}", flush=True)
    stats = served[-1][2]
    for w, (results, _, _) in enumerate(served):
        for i, r in enumerate(results):
            if not r["tokens"] or len(r["tokens"]) > 64:
                fail(f"{label}: wave {w + 1} request {i} returned {len(r['tokens'])} tokens")
            if not all(math.isfinite(x) for x in r["logprobs"]):
                fail(f"{label}: wave {w + 1} request {i} has non-finite logprobs")
    before, again = served[0][0][2]["tokens"], served[2][0][0]["tokens"]
    common = next((i for i, (a, b) in enumerate(zip(before, again)) if a != b),
                  min(len(before), len(again)))
    ttft = [sorted(r["ttft"] for r in results) for results, _, _ in served]
    dc = stats["decode-chunks"]
    pre = stats["prefix"]
    print(f"main path [{label}]: init_s={init_s:.2f} wall_s={wall:.3f} "
          f"prompt_tokens={n_pre} "
          + " ".join(f"wave{w + 1}_ttft_s min={t[0]:.3f} max={t[-1]:.3f}"
                     for w, t in enumerate(ttft))
          + f" prefix_hits={pre['hits']} prefix_tokens={pre['tokens_reused']} "
          f"cached_prefix_blocks={stats['kv']['cached_prefix_blocks']} "
          f"host_fetches_per_chunk={dc['host_fetches_per_chunk']} "
          f"prefill_calls={stats['prefill-calls']} "
          f"continue_calls={stats['prefill-continue-calls']} "
          f"repeat_common_prefix={common}/{len(before)} launches={counts} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f}", flush=True)
    if min(counts["paged_attention_multiquery"], counts["flash_attention"],
           counts["paged_attention"]) == 0:
        fail(f"{label}: the multi-query, flash and paged kernels must all launch: {counts}")
    if pre["hits"] < 6:
        fail(f"{label}: prefix_hits {pre['hits']} < 6")
    if dc["host_fetches_per_chunk"] != 1.0:
        fail(f"{label}: host_fetches_per_chunk {dc['host_fetches_per_chunk']} != 1.0")
    if common < 8:
        fail(f"{label}: the repeated prompt's first 8 greedy tokens differ from "
             f"wave 1 ({before[:8]} vs {again[:8]})")
    return counts


def spec_prompts() -> tuple[list[str], list[dict]]:
    """Main path D's wave: six greedy prompts that repeat a phrase (what
    prompt lookup drafts from) and two sampled ones (temperature 0.8,
    top-k 20)."""
    phrases = ("the quick brown fox jumps over the lazy dog. ",
               "def add(a, b):\n    return a + b\n",
               "Error: disk quota exceeded on volume /data. ",
               "SELECT name, email FROM users WHERE active = 1; ",
               "Section 4.2: shared links expire after seven days. ",
               "red, green, blue, red, green, blue, ")
    greedy = [f"Repeat the text below exactly.\n{p * 6}\n{p * 2}" for p in phrases]
    sampled = ["Write a short story about a lighthouse keeper.",
               "Continue the list: apples, pears, plums, "]
    opts = ([{"max-tokens": 64, "temperature": 0}] * len(greedy)
            + [{"max-tokens": 64, "temperature": 0.8, "top-k": 20}] * len(sampled))
    return greedy + sampled, opts


def phase_spec_path(torch, label, cfg: dict, params):
    """Main path D: one wave of 8 concurrent requests through the
    speculative burst (prompt lookup, verify through the multi-query read
    at T = drafts + 1), with the host-clock time of each verify step and
    each plain chunk (both end in their one fetch, so the device is done);
    then the greedy prompts with speculation off and the share of their
    tokens that match (printed, not required: bf16 near-ties may flip
    between the verify and decode shapes); then the wave again under the
    profiler with speculation held on (no calibration chunks)."""
    from langstream_tpu_torch.models import llama_paged
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    prompts, opts = spec_prompts()
    n_greedy = sum(1 for o in opts if o["temperature"] == 0)

    def serve_wave(engine, prompts, opts):
        async def run():
            try:
                t0 = time.monotonic()
                results = await asyncio.gather(*(
                    engine.generate(p, o) for p, o in zip(prompts, opts)))
                return results, time.monotonic() - t0, engine.stats()
            finally:
                await engine.close()

        return asyncio.run(run())

    def timed(engine, name, log):
        """Record the host-clock seconds of each call of an engine method."""
        real = getattr(engine, name)

        def call(*args):
            t0 = time.monotonic()
            out = real(*args)
            log.append((args[5] if name == "_run_decode" else 0, time.monotonic() - t0))
            return out

        setattr(engine, name, call)

    t0 = time.monotonic()
    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cuda", params=params)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    spec_log, plain_log = [], []
    timed(engine, "_run_spec_step", spec_log)
    timed(engine, "_run_decode", plain_log)
    real_mq, mq_calls = llama_paged.paged_attention_multiquery_partial, []

    def recording_mq(q, *args, **kw):
        mq_calls.append((q.shape[0], q.shape[1]))
        return real_mq(q, *args, **kw)

    llama_paged.paged_attention_multiquery_partial = recording_mq
    reset_counts()
    try:
        results, wall, stats = serve_wave(engine, prompts, opts)
    finally:
        llama_paged.paged_attention_multiquery_partial = real_mq
    counts = read_counts()
    for i, r in enumerate(results):
        if not r["tokens"] or len(r["tokens"]) > 64:
            fail(f"{label}: request {i} returned {len(r['tokens'])} tokens")
        if not all(math.isfinite(x) for x in r["logprobs"]):
            fail(f"{label}: request {i} has non-finite logprobs")
    sp, dc = stats["speculative"], stats["decode-chunks"]
    layers = engine.model_config.layers
    shapes = sorted({bt: mq_calls.count(bt) // layers for bt in set(mq_calls)}.items())
    ttft = sorted(r["ttft"] for r in results)
    n_tokens = sum(len(r["tokens"]) for r in results)
    drafted = sp["drafts_accepted"] + sp["rejected"]
    steps = sp["steps"] + dc["steps"]

    def ms(samples):
        xs = sorted(t for t in samples)
        return (f"n={len(xs)} median={xs[len(xs) // 2] * 1e3:.2f} min={xs[0] * 1e3:.2f} "
                f"max={xs[-1] * 1e3:.2f}" if xs else "n=0")

    print(f"main path [{label}]: init_s={init_s:.2f} requests={len(results)} "
          f"tokens={n_tokens} wall_s={wall:.3f} ttft_s min={ttft[0]:.3f} "
          f"max={ttft[-1]:.3f} speculative={sp} "
          f"accept_ratio={sp['drafts_accepted'] / drafted if drafted else 0.0:.4f} "
          f"decode_steps={dc['steps']} decode_chunks={dc['dispatched']} "
          f"tokens_per_step={(n_tokens - len(results)) / steps if steps else 0.0:.3f} "
          f"(batch tokens after the first over verify steps + plain decode steps) "
          f"multiquery_calls_per_step (B, T): count={shapes} launches={counts} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f}", flush=True)
    print(f"main path [{label}]: host-clock ms per verify step "
          f"{ms(t for _, t in spec_log)}; per K=1 plain chunk "
          f"{ms(t for k, t in plain_log if k == 1)}; per step of K>1 plain chunks "
          f"{ms(t / k for k, t in plain_log if k > 1)}", flush=True)
    if sp["steps"] == 0:
        fail(f"{label}: no speculative step ran: {sp}")
    if not sp["dispatches"] == sp["fetches"] == sp["steps"]:
        fail(f"{label}: dispatches/fetches/steps differ: {sp}")
    if not any(t == cfg["speculative-drafts"] + 1 for _, t in mq_calls):
        fail(f"{label}: the multi-query kernel never ran at T=drafts+1: {shapes}")
    if counts["paged_attention_multiquery"] == 0:
        fail(f"{label}: the multi-query kernel did not launch: {counts}")

    # the greedy prompts again with speculation off: how far the streams
    # match, and at each first divergence the two streams' logprobs of
    # their own token (close for a near-tie of the top two)
    plain_engine = TorchServingEngine(
        ServingConfig.from_dict({**cfg, "speculative-drafts": 0}), device="cuda",
        params=params)
    plain, _, _ = serve_wave(plain_engine, prompts[:n_greedy], opts[:n_greedy])
    same = total = 0
    forks = []
    for a, b in zip(results[:n_greedy], plain):
        n = min(len(a["tokens"]), len(b["tokens"]))
        common = next((i for i in range(n) if a["tokens"][i] != b["tokens"][i]), n)
        same += common
        total += max(len(a["tokens"]), len(b["tokens"]))
        if common < n:
            forks.append((common, round(a["logprobs"][common], 4),
                          round(b["logprobs"][common], 4)))
    print(f"main path [{label}]: greedy streams against speculation off: "
          f"common prefix {same}/{total} tokens ({same / total:.3f}); first "
          f"divergences (position, logprob speculative, logprob plain): {forks}",
          flush=True)

    # the wave again under the profiler, speculation held on
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    os.environ["LS_TPU_SPEC_CALIBRATE_EVERY"] = str(10**9)
    try:
        prof_engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cuda",
                                         params=params)
    finally:
        os.environ.pop("LS_TPU_SPEC_CALIBRATE_EVERY")
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        _, wall, pstats = serve_wave(prof_engine, prompts, opts)
    print(f"main path [{label}]: profiled wave, speculation held on: "
          f"speculative={pstats['speculative']} "
          f"decode_steps={pstats['decode-chunks']['steps']}", flush=True)
    print(device_breakdown(torch, prof, wall), flush=True)
    return counts


def ascii_head(engine) -> None:
    """Zero the LM head's columns outside the byte tokenizer's printable
    ASCII ids (32-126): a random head over Llama-3's 128,256 ids almost
    never picks an id the byte tokenizer prints, and path E's stream and
    stop checks need text. The 95 kept columns are random, so one of them
    has a positive logit (the zeroed ones' 0) at every step but with
    probability 2**-95."""
    import torch

    head = engine.params["lm_head"]
    vocab = (head.q if hasattr(head, "q") else head).shape[-1]
    keep = torch.zeros(vocab, dtype=torch.bool, device=engine.device)
    keep[32:127] = True
    if hasattr(head, "s"):  # int8: (1, vocab) scales
        head.s[..., ~keep] = 0
    else:
        head[:, ~keep] = 0


async def stream_chat(service, messages, options):
    """One streamed chat completion: (result, the Chunks it streamed)."""
    chunks = []
    result = await service.chat_completions(messages, options, chunks.append)
    return result, chunks


def check_stream(label, result, chunks) -> None:
    text = "".join(c.text for c in chunks)
    if text != result.text:
        fail(f"{label}: streamed text {text!r} != final text {result.text!r}")
    if [c.index for c in chunks] != list(range(len(chunks))):
        fail(f"{label}: chunk indices {[c.index for c in chunks]} are not 0, 1, 2, ...")
    if not chunks or not chunks[-1].last or any(c.last for c in chunks[:-1]):
        fail(f"{label}: exactly the last chunk must be marked last")


def phase_provider_path(torch, resource: dict, device="cuda", max_tokens=32) -> dict:
    """Main path E: the chat example's resource through the port's provider
    (``TorchServiceProvider.get_completions_service``), as the
    ``ai-chat-completions`` agent reaches it: (a) one chat request, which
    runs the warmup first; (b) a wave of 8 streamed chats (light regime:
    8 <= slots // 8); (c) a wave of 24 (heavy regime), steps per decode
    dispatch of each wave from the ``decode-chunks`` deltas; (d) one chat
    with a stop string its greedy text contains; (e) an ``adapter`` and an
    expired ``deadline``, both refused before they touch a slot. Then the
    embeddings service (minilm-l6, weights from a CPU generator seeded 0)
    on ``device`` against the CPU. Returns the launch counts of (a)-(e)."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.serving.deadline import DeadlineExceeded
    from langstream_tpu_torch.serving.embeddings import EmbeddingEngine
    from langstream_tpu_torch.serving.engine import TorchServingEngine

    label = "E: chat example resource through the provider"
    # the mapping the platform hands a provider: type and name beside the
    # resource's configuration keys
    cfg = {"type": resource["type"], "name": resource["name"], **resource["configuration"]}
    held_gb = torch.cuda.memory_allocated() / 1e9 if device == "cuda" else 0.0
    t0 = time.monotonic()
    provider = TorchServiceProvider(cfg, device=device)
    service = provider.get_completions_service({})
    engine = service.engine
    init_s = time.monotonic() - t0
    if engine.stats()["warmup"]["state"] != "pending":
        fail(f"{label}: warmup-on-start must leave the warmup pending until a request")
    ascii_head(engine)
    light_threshold = engine._light_threshold()
    questions = [p for p in chat_prompts() for _ in range(4)]  # 32 messages
    chats = [[{"role": "user", "content": q}] for q in questions]
    opts = {"max-tokens": max_tokens, "temperature": 0}

    def dc_delta(before, after):
        a, b = before["decode-chunks"], after["decode-chunks"]
        return (b["steps"] - a["steps"], b["dispatched"] - a["dispatched"],
                b["seconds"] - a["seconds"])

    async def run():
        out = {}
        try:
            # (a) the first request runs the warmup, then itself
            t = time.monotonic()
            out["a"] = await stream_chat(service, chats[0], opts)
            out["a_wall"] = time.monotonic() - t
            out["warmup"] = engine.stats()["warmup"]
            # (b) light and (c) heavy waves, every request streamed; the
            # counts once the loop has applied the heavy wave's over-run chunk
            for name, n in (("b", 8), ("c", 24)):
                before = engine.stats()
                t = time.monotonic()
                out[name] = await asyncio.gather(*(
                    stream_chat(service, chats[1 + i], opts) for i in range(n)))
                out[name + "_wall"] = time.monotonic() - t
                await engine.settled()
                out[name + "_dc"] = dc_delta(before, engine.stats())
            # (d) a stop string the request's greedy text contains
            plain = out["a"][0].text
            cands = {plain[i:i + 2] for i in range(len(plain) - 1)
                     if "�" not in plain[i:i + 2]}
            if not cands:
                fail(f"{label}: the greedy text {plain!r} has no stop candidate")
            stop = max(sorted(cands), key=plain.find)  # the latest first match
            out["d"] = await stream_chat(service, chats[0], {**opts, "stop": stop})
            out["d_stop"], out["d_plain"] = stop, plain
            # (e) refused before the request queues
            before = engine.stats()
            try:
                await service.chat_completions(chats[0], {**opts, "adapter": "tenant-ft"})
                fail(f"{label}: a request naming an adapter was served")
            except ValueError as e:
                out["e_adapter"] = str(e)
            try:
                await service.chat_completions(chats[0], {**opts, "deadline": time.time() - 1})
                fail(f"{label}: a request with a spent deadline was served")
            except DeadlineExceeded as e:
                out["e_deadline"] = str(e)
            after = engine.stats()
            keys = ("active", "queued", "completed", "prefill-calls", "total-generated")
            if any(before[k] != after[k] for k in keys) or after["active"]:
                fail(f"{label}: a refused request touched the engine: "
                     f"{[(k, before[k], after[k]) for k in keys]}")
            out["stats"] = after
            return out
        finally:
            TorchServingEngine.reset_instances()
            await engine.close()

    reset_counts()
    out = asyncio.run(run())
    counts = read_counts()
    warm = out["warmup"]
    if warm["state"] != "done":
        fail(f"{label}: warmup did not complete: {warm}")
    results = [out["a"]] + out["b"] + out["c"] + [out["d"]]
    for i, (r, chunks) in enumerate(results):
        check_stream(f"{label}: request {i}", r, chunks)
        if not 0 < r.num_completion_tokens <= max_tokens:
            fail(f"{label}: request {i} returned {r.num_completion_tokens} tokens")
    d, stop = out["d"][0], out["d_stop"]
    if d.finish_reason != "stop" or stop in d.text:
        fail(f"{label}: stop {stop!r}: finish_reason {d.finish_reason}, text {d.text!r}")
    per_dispatch = {}
    for name in ("b", "c"):
        steps, dispatched, _ = out[name + "_dc"]
        per_dispatch[name] = steps / dispatched if dispatched else float("nan")
    if not per_dispatch["b"] <= 8 < per_dispatch["c"]:
        fail(f"{label}: steps per decode dispatch light {per_dispatch['b']} must be "
             f"<= 8 and heavy {per_dispatch['c']} > 8")
    if device == "cuda" and min(counts["flash_attention"], counts["paged_attention"]) == 0:
        # (CPU tensors take the plain versions, which count nothing)
        fail(f"{label}: flash and the bf16 paged read must launch: {counts}")
    waves = out["b"] + out["c"]
    ttft = sorted(r.ttft_s for r, _ in waves)
    steps = out["b_dc"][0] + out["c_dc"][0]
    secs = out["b_dc"][2] + out["c_dc"][2]
    n_decode = sum(r.num_completion_tokens - 1 for r, _ in waves)
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else 0.0
    print(f"main path [{label}]: init_s={init_s:.2f} light_threshold={light_threshold} "
          f"warmup_s={warm['seconds']:.3f} (probe {warm['probe_tokens']} tokens, wave "
          f"{warm['wave']}) first_request wall_s={out['a_wall']:.3f} "
          f"ttft_s={out['a'][0].ttft_s:.3f}", flush=True)
    print(f"main path [{label}]: light wave (8) wall_s={out['b_wall']:.3f} "
          f"steps_per_dispatch={per_dispatch['b']:.2f} ({out['b_dc'][0]}/{out['b_dc'][1]}); "
          f"heavy wave (24) wall_s={out['c_wall']:.3f} "
          f"steps_per_dispatch={per_dispatch['c']:.2f} ({out['c_dc'][0]}/{out['c_dc'][1]}); "
          f"ttft_s min={ttft[0]:.3f} max={ttft[-1]:.3f} "
          f"decode_tok_s={n_decode / secs if secs else 0.0:.1f} "
          f"ms_per_step={secs / steps * 1e3 if steps else float('nan'):.2f} "
          f"chunks_streamed={sum(len(c) for _, c in results)} launches={counts} "
          f"peak_mem_gb={peak:.1f} (held before the engine: {held_gb:.1f})", flush=True)
    print(f"main path [{label}]: stop {stop!r} -> text {d.text!r} (greedy "
          f"{out['d_plain']!r}; equal to its cut: "
          f"{d.text == out['d_plain'][:out['d_plain'].find(stop)]}); refused: "
          f"{out['e_adapter']!r}, {out['e_deadline']!r}; "
          f"deadline_sheds={out['stats']['deadline-sheds']}", flush=True)

    # embeddings: the same weights on the device and on the CPU
    texts = [("embed this sentence. " * (1 + 3 * i))[: 16 + 37 * i] for i in range(16)]

    def embed_on(dev):
        svc = TorchServiceProvider(cfg, device=dev).get_embeddings_service({})
        t = time.monotonic()
        vectors = asyncio.run(svc.compute_embeddings(texts))
        return vectors, time.monotonic() - t, svc.engine

    vec_dev, s_dev, emb = embed_on(device)
    vec_dev2, s_dev2, _ = embed_on(device)  # the second call: warm
    vec_cpu, s_cpu, _ = embed_on("cpu")
    import numpy as np

    a, b = np.asarray(vec_dev2), np.asarray(vec_cpu)
    err = float(np.abs(a - b).max())
    if a.shape != (16, emb.config.hidden) or not np.isfinite(a).all():
        fail(f"embeddings: shape {a.shape} or non-finite values")
    if not err <= TOL_EMBED or vec_dev != vec_dev2:
        fail(f"embeddings: {device} vs CPU max abs error {err} > {TOL_EMBED}, or two "
             f"calls differ")
    print(f"embeddings [minilm-l6, {len(texts)} texts of {len(texts[0])}-"
          f"{len(texts[-1])} chars]: max_abs_err vs CPU={err:.3e} (tolerance {TOL_EMBED}) "
          f"wall_s first={s_dev:.3f} warm={s_dev2:.3f} cpu={s_cpu:.3f}", flush=True)
    for engine_ in list(EmbeddingEngine._instances.values()):
        engine_.close()
    EmbeddingEngine.reset_instances()
    return counts


F_BUDGETS = (48, 96, 128, 160)


def saturated_requests(n: int = 96) -> list[tuple[str, int]]:
    """Path F's load: ``n`` greedy requests of 30-600 byte tokens, their
    max-tokens cycling through ``F_BUDGETS``, so slots finish mid-burst and
    the 32 requests queued behind 64 slots are admitted under a pending
    chunk."""
    text = ("Customer wrote: my order arrived late and the box was damaged; "
            "please advise on a refund or a replacement and the steps to "
            "return the item. ") * 8
    out = []
    for i in range(n):
        length = 30 + (i * 577) % 571  # 30..600
        prompt = (f"#{i} " + text)[:length]
        out.append((prompt, F_BUDGETS[i % len(F_BUDGETS)]))
    return out


def _decode_k(program: str | None) -> int | None:
    """K of a decode program id (``decode:w<rows>:k<K>:<sampler>``)."""
    if not program or not program.startswith("decode:"):
        return None
    return int(program.split(":")[2][1:])


def phase_saturated_path(torch, label, cfg: dict, params=None, device="cuda"):
    """One run of main path F: the saturated load through one engine. Returns
    (results, launch counts, the engine's params)."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    requests = saturated_requests()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)

    async def run():
        t0 = time.monotonic()

        async def one(prompt, max_tokens):  # its result and completion time
            r = await engine.generate(prompt, {"max-tokens": max_tokens, "temperature": 0})
            return r, time.monotonic() - t0

        try:
            done = await asyncio.gather(*(one(p, m) for p, m in requests))
            return done, time.monotonic() - t0
        finally:
            await engine.close()

    reset_counts()
    done, wall = asyncio.run(run())
    results = [r for r, _ in done]
    latency = sorted(t for _, t in done)
    counts = read_counts()
    stats = engine.stats()  # after close: the loop has applied every chunk
    dc = stats["decode-chunks"]
    for i, ((_, budget), r) in enumerate(zip(requests, results)):
        if not 0 < len(r["tokens"]) <= budget or r["finish_reason"] not in ("stop", "length"):
            fail(f"{label}: request {i} returned {len(r['tokens'])} tokens of {budget}, "
                 f"finish_reason {r['finish_reason']!r}")
        if not all(math.isfinite(x) for x in r["logprobs"]):
            fail(f"{label}: request {i} has non-finite logprobs")
    if dc["host_fetches_per_chunk"] != 1.0:
        fail(f"{label}: host_fetches_per_chunk {dc['host_fetches_per_chunk']} != 1.0")
    if stats["completed"] != len(requests) or stats["active"] or stats["queued"]:
        fail(f"{label}: {stats['completed']} of {len(requests)} completed, "
             f"{stats['active']} active, {stats['queued']} queued")
    if "kv" in stats:
        kv = stats["kv"]
        if kv["reserved_blocks"] or kv["live_blocks"] or engine._deferred_releases:
            fail(f"{label}: the block manager is not idle after the load: {kv}, "
                 f"deferred {engine._deferred_releases}")
    flight = engine.flight
    summary = flight.summary()
    totals = summary["totals"]
    if flight.dropped:
        fail(f"{label}: the flight ring dropped {flight.dropped} samples")
    decode_tokens = stats["total-generated"] - len(requests)  # less the prefills' tokens
    att = stats["attribution"]
    programs = [
        f"{p['program']} x{p['dispatches']}: expected {p['expected']['expected_ms']:.2f} "
        f"ms ({p['expected']['expected_ms'] / _decode_k(p['program']):.3f}/step) "
        f"achieved p50 {p['measured_ms_p50']:.2f} ms "
        f"({p['measured_ms_p50'] / _decode_k(p['program']):.2f}/step) "
        f"achieved_vs_expected {p['achieved_vs_expected']}"
        for p in att["programs"] if p["kind"] == "decode" and p["measured_ms_p50"]
    ]
    wall_ms = totals["wall_ms"]
    report = {
        "wall_s": round(wall, 3),
        # seconds from the wave's submission to each request's result
        "latency_s_p50_p95": (round(latency[len(latency) // 2], 3),
                              round(latency[int(0.95 * len(latency))], 3)),
        "ttft_s_p50": round(sorted(r["ttft"] for r in results)[len(results) // 2], 3),
        "decode_tok_s": round(decode_tokens / dc["seconds"], 1) if dc["seconds"] else 0.0,
        "ms_per_step": round(dc["seconds"] / dc["steps"] * 1e3, 2) if dc["steps"] else None,
        "steps_per_dispatch": round(dc["steps"] / dc["dispatched"], 2),
        "chunks_light_heavy": (dc["light"], dc["heavy"]),
        "launch_s": round(dc["launch_seconds"], 3),
        "flight_s": {k: round(totals[k] / 1e3, 3)
                     for k in ("wall_ms", "device_ms", "host_ms", "stall_ms")},
        "host_overlapped_ms": totals["host_overlapped_ms"],
        "overlap_ratio": summary["window"]["overlap_ratio"],
        "idle_share": round((totals["host_ms"] + totals["stall_ms"]) / wall_ms, 4)
        if wall_ms else None,
    }
    print(f"main path [{label}]: requests={len(requests)} tokens={stats['total-generated']} "
          f"host_fetches_per_chunk={dc['host_fetches_per_chunk']} "
          f"pipeline={stats['pipeline']} {json.dumps(report)} "
          f"device_cache={json.dumps(stats['device-cache'])} launches={counts} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0:.1f}",
          flush=True)
    print(f"main path [{label}]: attribution at {att['hbm_gbps_assumed']} GB/s "
          f"(generation {att['generation']}, memory limit "
          f"{att['memory']['limit_bytes']} from {att['memory']['limit_source']}): "
          + "; ".join(programs), flush=True)
    return results, counts, engine.params


def profiled_saturated_wave(torch, label, cfg: dict, params) -> None:
    """All slots busy under the profiler (device activity only): one greedy
    request of 97 tokens per slot, three K=32 chunks each, so the pipelined
    loop keeps a chunk in flight; prints the device's busy share of the
    profiled span (its idle share is the rest)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cuda", params=params)
    prompts = [p for p, _ in saturated_requests(cfg["slots"])]

    async def run():
        try:
            return await asyncio.gather(*(
                engine.generate(p, {"max-tokens": 97, "temperature": 0}) for p in prompts))
        finally:
            await engine.close()

    with torch_profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.monotonic()
        results = asyncio.run(run())
        wall = time.monotonic() - t0
    dc = engine.stats()["decode-chunks"]
    print(f"main path [{label}, profiled wave of {len(prompts)} x 97 tokens]: "
          f"tokens={sum(len(r['tokens']) for r in results)} "
          f"chunks={dc['dispatched']} steps={dc['steps']}", flush=True)
    print(device_breakdown(torch, prof, wall), flush=True)


def phase_saturated(torch, base: dict, device="cuda") -> dict:
    """Main path F: the saturated load (96 greedy requests on 64 slots) four
    times: F1 the chat example's resource (dense bf16 KV) pipelined, F2 the
    same sequential, F3 paged int8 KV pipelined, F4 the same sequential.
    Compares F1's greedy streams with F2's (recorded, not required: bf16
    near-ties may flip). Returns the launch counts summed over the runs."""
    dense = {**base, "decode-chunk-light": 8}
    paged = {**dense, "kv-layout": "paged", "kv-quantize": "int8", "prefix-cache": False}
    runs = [("F1: dense bf16 KV, pipeline", {**dense, "pipeline": True}),
            ("F2: dense bf16 KV, sequential", {**dense, "pipeline": False}),
            ("F3: paged int8 KV, pipeline", {**paged, "pipeline": True}),
            ("F4: paged int8 KV, sequential", {**paged, "pipeline": False})]
    total: dict[str, int] = {}
    params, out = None, {}
    for label, cfg in runs:
        results, counts, params = phase_saturated_path(torch, label, cfg, params, device)
        if device == "cuda" and label[:2] in ("F1", "F2"):
            profiled_saturated_wave(torch, label, cfg, params)
        out[label[:2]] = results
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    same = n_all = 0
    forks = []
    for a, b in zip(out["F1"], out["F2"]):
        n = min(len(a["tokens"]), len(b["tokens"]))
        common = next((i for i in range(n) if a["tokens"][i] != b["tokens"][i]), n)
        same += common
        n_all += max(len(a["tokens"]), len(b["tokens"]))
        if common < n:
            forks.append((common, round(a["logprobs"][common], 4),
                          round(b["logprobs"][common], 4)))
    print(f"main path [F1 vs F2]: greedy common prefix {same}/{n_all} tokens "
          f"({same / n_all:.3f}); {len(forks)} streams diverge; first divergences "
          f"(position, logprob pipelined, logprob sequential): {forks[:12]}", flush=True)
    del params
    return total


# examples/applications/moe-mixtral-ep/configuration.yaml's resource
# without its mesh (ep: 4, tp: 2): the port serves the model on one card
# (expert parallelism is ROADMAP.md Queue 1 item 13). Written out, as
# CHAT_EXAMPLE_RESOURCE; a CPU test holds the two equal.
MOE_EXAMPLE_RESOURCE = {
    "model": "moe-8x7b",
    "slots": 32,
    "max-seq-len": 4096,
    "quantize": "int8",
}
G_MAX_TOKENS = 32
# path G's depth: 16 of Mixtral-8x7B's 32 layers at the published widths,
# cut when path H joined the smoke (a Mixtral step is device-bound, so its
# time and the profiled wave's kernel count follow the depth)
G_LAYERS = 16


def moe_prompts() -> tuple[list[str], list[str], list[str]]:
    """Path G's waves: 8 prompts, the first ~3,000 byte tokens (a prefill
    at the 4,096 bucket); 32 of 40-700 tokens; and for the profiled wave
    the same 32 cut to 129-200 tokens (one bucket: four prefills of 8)."""
    log = ("2026-03-02 11:04:17 storage-node-7 WARN write latency p99 above "
           "40 ms on volume vol-3181; replication lag 2.4 s; compaction "
           "running on 3 of 12 shards. ")
    long = ("Summarize the incident log below in three bullet points and name "
            "the most likely root cause.\n" + log * 40)[:3000]
    topics = ("paged attention", "expert routing", "a write-ahead log",
              "consistent hashing", "a bloom filter", "speculative decoding",
              "token bucket rate limiting", "a B-tree split")
    shorts = []
    for i in range(32):
        body = (f"Request {i}: explain {topics[i % len(topics)]} to a new "
                f"engineer, with one example from production. ")
        shorts.append((body * (1 + (i * 7) % 16))[: 40 + (i * 97) % 661])
    uniform = [(s * 4)[: 129 + (i * 13) % 72] for i, s in enumerate(shorts)]
    return [long] + shorts[:7], shorts, uniform


class _Ranges:
    """While active, the dequant (``as_weight`` in the model modules) and
    the routed FFN (``moe_ffn``) run inside ``record_function`` ranges, so
    a profiler running on the dispatch thread attributes their kernels."""

    def __init__(self, torch):
        from langstream_tpu_torch.models import llama, llama_paged, moe

        self.torch = torch
        self.sites = [(llama, "_w", "dequant"), (llama_paged, "_w", "dequant"),
                      (moe, "as_weight", "dequant"), (moe, "moe_ffn", "expert ffn")]
        self.saved = [getattr(mod, name) for mod, name, _ in self.sites]

    def __enter__(self):
        record = self.torch.profiler.record_function
        for (mod, name, label), real in zip(self.sites, self.saved):
            def ranged(*args, _real=real, _label=label, **kw):
                with record(f"moe:{_label}"):
                    return _real(*args, **kw)
            setattr(mod, name, ranged)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), real in zip(self.sites, self.saved):
            setattr(mod, name, real)


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in name:
        return "flash"
    if "paged_decode_" in name or "paged_mq_" in name:
        return "paged read"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "cublas", "gemv", "nvjet")):
        return "gemm"
    return "other"


def moe_breakdown(torch, prof, wall_s: float) -> str:
    """Device busy time of a profiled path-G wave by group: GEMMs, flash,
    the paged read and the rest by kernel name; of the rest, the dequant's
    kernels and the routed FFN's non-GEMM kernels (routing, dispatch, the
    experts' SiLU and product, combine) from the ranges that launched
    them. The ranges' own device spans (user annotations) are not
    kernels and are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    t0 = time.monotonic()
    events = prof.events()
    kern = [e for e in events if e.device_type == cuda and not e.name.startswith("moe:")]
    if not kern:
        return "profile: no device events captured"
    busy = sum(e.time_range.end - e.time_range.start for e in kern)
    span = max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)
    groups = {"gemm": 0.0, "flash": 0.0, "paged read": 0.0, "other": 0.0}
    for e in kern:
        groups[_kernel_group(e.name)] += e.time_range.end - e.time_range.start

    def subtree_kernels(e):
        yield from e.kernels
        for ch in e.cpu_children:
            yield from subtree_kernels(ch)

    ranged = {"moe:dequant": 0.0, "moe:expert ffn": 0.0}
    for e in events:
        if e.device_type != cuda and e.name in ranged:
            ranged[e.name] += sum(k.duration for k in subtree_kernels(e)
                                  if _kernel_group(k.name) == "other")
    groups["dequant"] = ranged["moe:dequant"]
    groups["expert ffn non-gemm"] = ranged["moe:expert ffn"]
    groups["other"] -= groups["dequant"] + groups["expert ffn non-gemm"]
    lines = [f"profile: wall_s={wall_s:.3f} device_span_ms={span / 1e3:.1f} "
             f"device_busy_ms={busy / 1e3:.1f} busy_share_of_span={busy / span:.3f} "
             f"kernels={len(kern)} analysis_s={time.monotonic() - t0:.1f}"]
    for g in ("dequant", "gemm", "expert ffn non-gemm", "flash", "paged read",
              "other"):
        lines.append(f"profile group {g}: {groups[g] / 1e3:.1f} ms "
                     f"({groups[g] / busy:.3f} of busy)")
    by_name: dict[str, float] = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        lines.append(f"profile top {us / 1e3:9.2f} ms  {name[:110]}")
    return "\n".join(lines)


def _peak_gb(torch, device) -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else 0.0


def _wave_line(label, before, after, results, wall, peak_gb) -> str:
    """One run's numbers: ms per step, decode tok/s, TTFT, chunks by
    regime, the launches, peak memory."""
    dc0, dc1 = before["decode-chunks"], after["decode-chunks"]
    steps = dc1["steps"] - dc0["steps"]
    secs = dc1["seconds"] - dc0["seconds"]
    tokens = sum(len(r["tokens"]) for r in results)
    ttft = sorted(r["ttft"] for r in results)
    report = {
        "requests": len(results), "tokens": tokens, "wall_s": round(wall, 3),
        "ttft_s_min_p50_max": (round(ttft[0], 3), round(ttft[len(ttft) // 2], 3),
                               round(ttft[-1], 3)),
        "decode_tok_s": round((tokens - len(results)) / secs, 1) if secs else None,
        "ms_per_step": round(secs / steps * 1e3, 2) if steps else None,
        "chunks_light_heavy": (dc1["light"] - dc0["light"], dc1["heavy"] - dc0["heavy"]),
        "prefill_calls": after["prefill-calls"] - before["prefill-calls"],
    }
    return f"main path [{label}]: {json.dumps(report)} peak_mem_gb={peak_gb:.1f}"


def _attribution_lines(label, stats) -> str:
    att = stats["attribution"]
    programs = [
        f"{p['program']} x{p['dispatches']}: expected {p['expected']['expected_ms']:.2f} ms "
        f"achieved p50 {p['measured_ms_p50']:.2f} ms "
        f"achieved_vs_expected {p['achieved_vs_expected']}"
        for p in att["programs"] if p["measured_ms_p50"]
        and (p["kind"] == "decode" or p["program"].startswith("prefill:p4096"))
    ]
    return (f"main path [{label}]: attribution at {att['hbm_gbps_assumed']} GB/s "
            f"(decode programs, the 4,096-bucket prefill): "
            + "; ".join(programs))


def phase_moe_path(torch, resource: dict = MOE_EXAMPLE_RESOURCE,
                   device="cuda") -> tuple[dict, dict]:
    """Main path G: Mixtral-8x7B (``moe-8x7b``) at full width and
    ``G_LAYERS`` of its 32 layers, random int8 weights from seed 0, at the
    ``moe-mixtral-ep`` resource without its mesh. G1 (the example's dense bf16 KV): a wave of
    8 (one ~3,000-token prompt: flash at the 4,096 bucket), a wave of 32
    (heavy, pipelined), then 32 prompts of one bucket, 17 tokens each (one
    K=16 chunk and the over-run), under the profiler (run on the dispatch
    thread, with the dequant and the routed FFN in ranges). G2
    (paged int8 KV, the params shared): one wave of 32. Returns the launch
    counts of G1 and G2. ``device="cpu"`` with a tiny resource rehearses
    the path on the CPU (no profiled wave there)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from langstream_tpu_torch.serving import engine as engine_module
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg = {**resource, "seed": 0}

    def make_engine(cfg, params=None):
        """The engine at ``G_LAYERS``: it takes the model's shape from its
        name, so the cut depth goes in through that table, for this
        construction only."""
        full = engine_module._MOE_MODELS[cfg["model"]]
        engine_module._MOE_MODELS[cfg["model"]] = lambda **kw: dataclasses.replace(
            full(**kw), layers=min(full(**kw).layers, G_LAYERS))
        try:
            return TorchServingEngine(ServingConfig.from_dict(cfg), device=device,
                                      params=params)
        finally:
            engine_module._MOE_MODELS[cfg["model"]] = full

    t0 = time.monotonic()
    engine = make_engine(cfg)
    if cuda:
        torch.cuda.synchronize()
    print(f"main path [G: {cfg['model']} {cfg.get('quantize')}]: "
          f"init_s={time.monotonic() - t0:.2f} "
          f"layers={engine.model_config.layers} hidden={engine.model_config.hidden} "
          f"experts={engine.model_config.experts} weight_bytes={engine._weights_bytes} "
          f"peak_mem_gb={_peak_gb(torch, device):.1f}", flush=True)
    light, heavy, uniform = moe_prompts()
    n_long = len(engine.tokenizer.encode(light[0]))
    if not 2048 < n_long <= 4096 - G_MAX_TOKENS:
        fail(f"path G: the long prompt must take the 4,096 bucket, got {n_long} tokens")
    opts = {"max-tokens": G_MAX_TOKENS, "temperature": 0}

    async def wave(label, prompts, max_tokens=G_MAX_TOKENS):
        before = engine.stats()
        t = time.monotonic()
        results = await asyncio.gather(*(
            engine.generate(p, {**opts, "max-tokens": max_tokens}) for p in prompts))
        wall = time.monotonic() - t
        await engine.settled()
        for i, r in enumerate(results):
            if not 0 < len(r["tokens"]) <= max_tokens:
                fail(f"{label}: request {i} returned {len(r['tokens'])} tokens")
            if not all(math.isfinite(x) for x in r["logprobs"]):
                fail(f"{label}: request {i} has non-finite logprobs")
        print(_wave_line(label, before, engine.stats(), results, wall,
                         _peak_gb(torch, device)), flush=True)
        return results, wall

    async def run_g1():
        loop = asyncio.get_running_loop()
        try:
            first, _ = await wave("G1: dense bf16 KV, wave of 8", light)
            await wave("G1: dense bf16 KV, wave of 32", heavy)
            if not cuda:
                return first, None, 0.0
            # the profiler on the dispatch thread, where the model's ops run
            holder = {}

            def start():
                holder["prof"] = torch_profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                holder["prof"].__enter__()

            def stop():
                torch.cuda.synchronize()
                holder["prof"].__exit__(None, None, None)

            with _Ranges(torch):
                await loop.run_in_executor(engine._executor, start)
                # one decode chunk (K=16) and the pipelined loop's over-run
                _, wall = await wave("G1: dense bf16 KV, profiled wave of 32 x 17 tokens",
                                     uniform, max_tokens=17)
                t = time.monotonic()
                await loop.run_in_executor(engine._executor, stop)
                print(f"profile: stop_s={time.monotonic() - t:.1f}", flush=True)
            return first, holder["prof"], wall
        finally:
            await engine.close()

    reset_counts()
    first, prof, prof_wall = asyncio.run(run_g1())
    g1 = read_counts()
    stats = engine.stats()
    print(_attribution_lines("G1", stats), flush=True)
    if prof is not None:
        print(moe_breakdown(torch, prof, prof_wall), flush=True)
    print(f"main path [G1]: launches={g1} host_fetches_per_chunk="
          f"{stats['decode-chunks']['host_fetches_per_chunk']}", flush=True)
    if cuda and (g1["flash_attention"] == 0 or g1["paged_attention"] == 0):
        fail(f"G1 did not launch flash and the bf16 paged read: {g1}")
    if stats["decode-chunks"]["host_fetches_per_chunk"] != 1.0:
        fail(f"G1: host_fetches_per_chunk {stats['decode-chunks']['host_fetches_per_chunk']}")
    params = engine.params
    del engine, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    g2_cfg = {**cfg, "kv-layout": "paged", "kv-quantize": "int8", "prefix-cache": False}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    engine = make_engine(g2_cfg, params)

    async def run_g2():
        try:
            return await wave("G2: paged int8 KV, wave of 32", light[:1] + heavy[1:])
        finally:
            await engine.close()

    reset_counts()
    asyncio.run(run_g2())
    g2 = read_counts()
    stats = engine.stats()
    print(_attribution_lines("G2", stats), flush=True)
    print(f"main path [G2]: launches={g2} host_fetches_per_chunk="
          f"{stats['decode-chunks']['host_fetches_per_chunk']} "
          f"peak_mem_gb={_peak_gb(torch, device):.1f}", flush=True)
    if cuda and (g2["flash_attention"] == 0 or g2["paged_attention_q8"] == 0):
        fail(f"G2 did not launch flash and the int8 paged read: {g2}")
    if stats["kv"]["reserved_blocks"] or stats["kv"]["live_blocks"]:
        fail(f"G2: the block manager is not idle after the wave: {stats['kv']}")
    del engine, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return g1, g2


# ---------------------------------------------------------------------------
# path H: the admission and delivery planes under a multi-tenant load
# ---------------------------------------------------------------------------

H_BATCH, H_INTER, H_EXTRA, H_CANCEL = 48, 16, 16, 4
H_BATCH_TOKENS, H_INTER_TOKENS, H_EXTRA_TOKENS = 256, 64, 32
# the three default classes (the interactive one with a TBT target), and a
# bulk tenant whose request bucket holds the batch wave and refills at one
# request per 1,000 s, so the later bulk submissions are throttled
H_QOS = {
    # K=32 chunks at 62-88 ms per step (PERF.md section 5) deliver every
    # 2.0-2.8 s on the card; the target leaves room for a resume's prefill
    "classes": {"interactive": {"tbt-p99-s": 8.0}, "default": {}, "batch": {}},
    "tenants": {"bulk": {"requests-per-s": 0.001, "request-burst": H_BATCH}},
}
H_SLO = {"objectives": {"ttft": {"target": 0.9, "threshold-ms": 10000},
                        "queue-wait": {"target": 0.9, "threshold-ms": 5000},
                        "shed-rate": {"target": 0.99}}}


def qos_prompts() -> tuple[list[str], list[str], list[str]]:
    """Path H's prompts: 48 batch prompts of 300-600 byte tokens sharing a
    support-ticket preamble (their later prefills hit its cached blocks),
    16 interactive questions of 30-120 tokens, and 16 further bulk
    prompts. Each ends in its index, so no two are equal."""
    ticket = ("Support ticket: the customer reports that the nightly export "
              "job fails after the upgrade, attaches logs, and asks for a "
              "root cause, a workaround and a timeline for the fix. ") * 6
    question = "Quick question from the chat window: what does this error mean? " * 2
    batch = [ticket[: 299 + (i * 97) % 301 - 6] + f" #{i:04d}" for i in range(H_BATCH)]
    inter = [question[: 29 + (i * 37) % 91 - 6] + f" #{i:04d}" for i in range(H_INTER)]
    extra = [ticket[: 199 - 6] + f" #{i:04d}" for i in range(H_EXTRA)]
    return batch, inter, extra


def qos_pool_blocks(batch, inter, block_size: int) -> tuple[int, float]:
    """kv-pool-blocks for path H: the batch wave's worst-case reservations
    (prompt + max-tokens + 1, the byte tokenizer's BOS included) take 94%
    of the usable pool (block 0 is scratch), at least the 90% path H asks
    for and under the 95% the KV-saturation predicate flags, so the
    interactive wave cannot all find blocks; returns (blocks, the batch
    share)."""
    need = [-(-(len(p.encode()) + 1 + H_BATCH_TOKENS + 1) // block_size) for p in batch]
    usable = math.ceil(sum(need) / 0.94)
    inter_need = sum(-(-(len(p.encode()) + 1 + H_INTER_TOKENS + 1) // block_size)
                     for p in inter)
    if inter_need <= usable - sum(need):
        fail(f"H: the interactive wave ({inter_need} blocks) fits the pool's free "
             f"{usable - sum(need)} blocks: nothing would be preempted")
    return usable + 1, sum(need) / usable


def phase_qos_run(torch, label: str, cfg: dict, device: str):
    """One run of path H through one engine (made by the port's provider, as
    the chat agent reaches it): the batch wave, then the interactive wave
    through the provider's streaming branch with stream keys, four of them
    cancelled through the stream registry after their second chunk, then
    the further bulk submissions. Every request streams. Returns (report,
    launch counts, batch results by prompt index, preempted indices); both
    runs make the same random weights from the resource's seed."""
    import threading

    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.serving.engine import TorchServingEngine
    from langstream_tpu_torch.serving.qos import RateLimited
    from langstream_tpu_torch.serving.streaming import STREAMS

    batch, inter, extra = qos_prompts()
    qos_on = "qos" in cfg
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    service = TorchServiceProvider(cfg, device=device).get_completions_service({})
    engine = service.engine
    ascii_head(engine)
    preempted: list[str] = []
    real_preempt = engine._preempt_slot

    def note_preempt(slot_id, *args, **kwargs):  # which stream was the victim
        preempted.append(engine.slots[slot_id].request.stream_key)
        real_preempt(slot_id, *args, **kwargs)

    engine._preempt_slot = note_preempt
    chunks = {}

    def collector(key):
        chunks[key] = []
        return lambda ids, delta, final: chunks[key].append((list(ids), delta, final))

    async def run():
        out = {}
        try:
            await engine.warmup()  # the resource's warmup-on-start, before the clock
            before = engine.stats()
            t0 = time.monotonic()
            batch_tasks = [asyncio.ensure_future(engine.generate(
                p, {"max-tokens": H_BATCH_TOKENS, "temperature": 0, "priority": "batch",
                    "qos-tenant": "bulk", "stream-key": f"bulk-{i}"},
                on_chunk=collector(f"bulk-{i}"))) for i, p in enumerate(batch)]
            while any(not chunks.get(f"bulk-{i}") for i in range(H_BATCH)):
                await asyncio.sleep(0.005)  # every batch request is decoding
            out["batch_started_s"] = time.monotonic() - t0
            cancelled = set(range(0, H_INTER, H_INTER // H_CANCEL))

            def consumer(i):
                key = f"chat-{i}"
                chunks[key] = []

                def on_chunk(chunk):
                    chunks[key].append(chunk)
                    if i in cancelled and len(chunks[key]) == 2:
                        # the gateway's disconnect, from its own thread
                        threading.Thread(target=STREAMS.cancel, args=(key,)).start()
                return on_chunk

            t_inter = time.monotonic()
            inter_tasks = [asyncio.ensure_future(service.text_completions(
                p, {"max-tokens": H_INTER_TOKENS, "temperature": 0,
                    "priority": "interactive", "stream-key": f"chat-{i}"}, consumer(i)))
                for i, p in enumerate(inter)]
            await asyncio.sleep(0)
            extra_tasks = [asyncio.ensure_future(engine.generate(
                p, {"max-tokens": H_EXTRA_TOKENS, "temperature": 0, "priority": "batch",
                    "qos-tenant": "bulk"}, on_chunk=collector(f"extra-{i}")))
                for i, p in enumerate(extra)]
            out["inter"] = await asyncio.gather(*inter_tasks, return_exceptions=True)
            out["inter_wall"] = time.monotonic() - t_inter
            out["extra"] = await asyncio.gather(*extra_tasks, return_exceptions=True)
            out["batch"] = await asyncio.gather(*batch_tasks, return_exceptions=True)
            out["wall"] = time.monotonic() - t0
            await engine.settled()
            out["health"] = engine.health()
            out["slo"] = engine.slo_status()
            out["before"] = before
            out["cancelled_keys"] = [f"chat-{i}" for i in sorted(cancelled)]
            return out
        finally:
            TorchServingEngine.reset_instances()
            await engine.close()

    reset_counts()
    out = asyncio.run(run())
    counts = read_counts()
    stats = engine.stats()  # after close: every chunk applied
    for key in out["cancelled_keys"]:
        STREAMS.consume_cancelled(key)
    # -- hard checks ------------------------------------------------------
    errors = [r for r in out["batch"] if isinstance(r, BaseException)]
    if errors:
        fail(f"{label}: batch requests failed: {errors[:3]}")
    for i, r in enumerate(out["batch"]):
        ids = [t for c in chunks[f"bulk-{i}"] for t in c[0]]
        text = "".join(c[1] for c in chunks[f"bulk-{i}"])
        if (len(r["tokens"]) != H_BATCH_TOKENS or ids != r["tokens"] or text != r["text"]
                or not chunks[f"bulk-{i}"][-1][2]):
            fail(f"{label}: batch stream {i} ({len(r['tokens'])} tokens, preempted "
                 f"{preempted.count(f'bulk-{i}')}x) does not tile its result")
    inter_cancelled = [i for i, r in enumerate(out["inter"])
                       if isinstance(r, asyncio.CancelledError)]
    if inter_cancelled != [int(k.split("-")[1]) for k in out["cancelled_keys"]]:
        fail(f"{label}: cancelled interactive requests {inter_cancelled}, expected "
             f"{out['cancelled_keys']}: {out['inter']}")
    for i, r in enumerate(out["inter"]):
        if i in inter_cancelled:
            continue
        if isinstance(r, BaseException) or r.num_completion_tokens != H_INTER_TOKENS:
            fail(f"{label}: interactive request {i} did not complete: {r!r}")
        check_stream(f"{label}: interactive request {i}", r, chunks[f"chat-{i}"])
    shed = [r for r in out["extra"] if isinstance(r, RateLimited)]
    if qos_on and (len(shed) != H_EXTRA or any(e.reason != "throttled" for e in shed)):
        fail(f"{label}: the further bulk submissions must all be throttled: {out['extra']}")
    if not qos_on and any(isinstance(r, BaseException) for r in out["extra"]):
        fail(f"{label}: FIFO refused further bulk submissions: {out['extra']}")
    sched, streaming = stats["scheduler"], stats["streaming"]
    events = engine.flight.recent_events(0)
    # (the event ring is bounded: counts from the counters, waits from the ring)
    n_preempt = sched.get("preempted", len(preempted))
    n_resume = engine.flight.events_by_type.get("resume", 0)
    resumes = [e for e in events if e["kind"] == "resume"]
    if qos_on and not (n_preempt == len(preempted) == n_resume
                       == sched["resumed"] >= 1):
        fail(f"{label}: preemptions {n_preempt} ({len(preempted)} victims) and resumes "
             f"{n_resume} ({sched['resumed']}) must be equal and at least 1")
    if not qos_on and (preempted or n_resume):
        fail(f"{label}: FIFO preempted {preempted}")
    if not streaming["cancelled"] == streaming["reclaimed"] == H_CANCEL:
        fail(f"{label}: cancelled {streaming['cancelled']} reclaimed "
             f"{streaming['reclaimed']}, expected {H_CANCEL} each")
    kv = stats["kv"]
    if kv["reserved_blocks"] or kv["live_blocks"] or engine._deferred_releases:
        fail(f"{label}: the block manager is not idle: {kv}")
    dc = stats["decode-chunks"]
    if dc["host_fetches_per_chunk"] != 1.0:
        fail(f"{label}: host_fetches_per_chunk {dc['host_fetches_per_chunk']} != 1.0")
    health = out["health"]
    # with QoS the run must end healthy; FIFO admits the bulk work QoS
    # throttles and holds the pool saturated, so its verdict is recorded
    # (it must not be wedged)
    if (health["state"] != "ok" if qos_on else health["state"] == "wedged"):
        fail(f"{label}: health() ends {health['state']}: {health['reasons']}")
    # -- report ------------------------------------------------------------
    def pct(values, q):
        values = sorted(values)
        return round(values[min(len(values) - 1, int(q * len(values)))], 3) if values else None

    ttft = {"batch": [r["ttft"] for r in out["batch"]],
            "interactive": [r.ttft_s for r in out["inter"] if not isinstance(r, BaseException)]}
    if not qos_on:
        ttft["batch (further bulk)"] = [r["ttft"] for r in out["extra"]]
    before = out["before"]["decode-chunks"]
    steps, secs = dc["steps"] - before["steps"], dc["seconds"] - before["seconds"]
    gen = stats["total-generated"] - out["before"]["total-generated"]
    waited = [e["waited_ms"] / 1e3 for e in resumes]
    # what the health predicates read: the decode samples' overlapped share
    # of host time and their mean occupancy (the overlap-collapse inputs)
    decode = [x for x in engine.flight.recent(240) if x["phase"] == "decode"]
    host = sum(x["host_ms"] + x["host_overlapped_ms"] for x in decode)
    sheds: dict[str, int] = {}
    for e in events:
        if e["kind"] == "shed":
            sheds[e["reason"]] = sheds.get(e["reason"], 0) + 1
    report = {
        "wall_s": round(out["wall"], 3), "batch_started_s": round(out["batch_started_s"], 3),
        "interactive_wall_s": round(out["inter_wall"], 3),
        "ttft_s_p50_p99_max": {c: (pct(v, 0.5), pct(v, 0.99), pct(v, 1.0))
                               for c, v in ttft.items()},
        "tbt_s_p50_p99": {c: (d["p50"], d["p99"]) for c, d in streaming["tbt"].items()},
        "stalls": streaming["stalls"], "emits": streaming["emits"],
        "preemptions": n_preempt, "resumes": n_resume,
        "resume_wait_s_p50_max": (pct(waited, 0.5), pct(waited, 1.0)),
        "sheds": sheds, "deadline_sheds": stats["deadline-sheds"],
        "cancelled": streaming["cancelled"], "reclaimed": streaming["reclaimed"],
        "decode_tok_s": round(gen / secs, 1) if secs else None,
        "ms_per_step": round(secs / steps * 1e3, 2) if steps else None,
        "host_fetches_per_chunk": dc["host_fetches_per_chunk"],
        "kv_pool_blocks": kv["num_blocks"], "prefix_hits": stats["prefix"]["hits"],
        "decode_samples": len(decode),
        "decode_overlapped_share": round(sum(x["host_overlapped_ms"] for x in decode)
                                         / host, 4) if host else None,
        "decode_occupancy_mean": round(sum(x["occupancy"] for x in decode)
                                       / len(decode), 2) if decode else None,
    }
    slo = out["slo"]
    slo_line = {name: (o["burn_rate_fast"], o["total_good"], o["total_bad"])
                for name, o in slo["objectives"].items()} if slo else None
    print(f"main path [{label}]: {json.dumps(report)} launches={counts} "
          f"peak_mem_gb={_peak_gb(torch, device):.1f}", flush=True)
    print(f"main path [{label}]: health={health['state']} reasons={health['reasons']} "
          f"ready={health['ready']} tbt_burn={health.get('tbt_burn')}; slo (burn fast, "
          f"good, bad)={slo_line} alerting={slo['alerting'] if slo else None}; "
          f"scheduler={json.dumps({k: v for k, v in sched.items() if k != 'classes'})}",
          flush=True)
    results = {i: r for i, r in enumerate(out["batch"])}
    victims = sorted({int(k.split("-")[1]) for k in preempted})
    return report, counts, results, victims


def phase_qos_path(torch, resource: dict = CHAT_EXAMPLE_RESOURCE, device="cuda",
                   block_size: int = 64) -> dict:
    """Main path H: the chat example's resource with paged int8 KV
    (``kv-block-size`` 64, the default, and the prefix cache on, the
    default), ``streaming: true``, a ``qos`` section (the three classes, the
    interactive one with ``tbt-p99-s``; a ``bulk`` tenant with a request
    bucket) and an ``slo`` section (TTFT, queue wait, shed rate), the pool
    sized so that the batch wave reserves 94% of it. H1 with QoS, H2 the
    same traffic with ``qos`` absent (FIFO: nothing is preempted or
    throttled; the further bulk submissions are served). H1 must end with
    ``health()`` ok; H2's verdict is printed (not wedged). Then the batch
    streams H1 preempted against the same prompts in H2 (not preempted):
    common prefix and the logprob gap at the first divergence (printed,
    not required). Returns the launch counts summed over H1 and H2."""
    batch, inter, _ = qos_prompts()
    blocks, share = qos_pool_blocks(batch, inter, block_size)
    base = {"type": resource["type"], "name": resource["name"],
            **resource["configuration"], "kv-layout": "paged", "kv-quantize": "int8",
            "kv-block-size": block_size, "kv-pool-blocks": blocks, "streaming": True,
            "slo": H_SLO}
    print(f"main path [H]: kv-pool-blocks={blocks} of {block_size} tokens; the batch "
          f"wave's reservations take {share:.4f} of the usable pool", flush=True)
    r1, c1, res1, victims = phase_qos_run(
        torch, "H1: QoS, paged int8 KV", {**base, "qos": H_QOS}, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    r2, c2, res2, _ = phase_qos_run(torch, "H2: FIFO, paged int8 KV", base, device)
    forks = []
    for i in victims:
        a, b = res1[i], res2[i]
        n = min(len(a["tokens"]), len(b["tokens"]))
        common = next((j for j in range(n) if a["tokens"][j] != b["tokens"][j]), n)
        gap = (round(abs(a["logprobs"][common] - b["logprobs"][common]), 4)
               if common < n else None)
        forks.append((i, common, gap))
    print(f"main path [H1 vs H2]: preempted batch streams against the same prompts "
          f"unpreempted (index, common prefix of {H_BATCH_TOKENS}, logprob gap at the "
          f"first divergence): {forks}", flush=True)
    print(f"main path [H1 vs H2]: interactive TTFT p50 "
          f"{r1['ttft_s_p50_p99_max']['interactive'][0]} s with QoS, "
          f"{r2['ttft_s_p50_p99_max']['interactive'][0]} s FIFO", flush=True)
    return {k: c1[k] + c2[k] for k in c1}


def phase_card_vs_cpu(torch, devices=("cuda", "cpu")):
    from langstream_tpu_torch.models.llama import LlamaConfig, init_llama_params
    from langstream_tpu_torch.models.moe import MoEConfig, init_moe_params
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    preamble = "A shared preamble of more than three blocks of sixteen tokens. "
    prompts = ["paged cache equivalence", "second prompt!", "a",
               preamble + "and a longer fourth prompt here", preamble + "fifth"]
    repetitive = "the cat sat on the mat. " * 6  # prompt lookup drafts land here
    c = dataclasses.replace(LlamaConfig.tiny(max_seq_len=256), dtype=torch.float32)
    mc = dataclasses.replace(MoEConfig.tiny(max_seq_len=256), dtype=torch.float32)
    params = {  # by model
        "tiny": init_llama_params(c, torch.Generator().manual_seed(3), device="cpu"),
        "moe-tiny": init_moe_params(mc, torch.Generator().manual_seed(3), device="cpu"),
    }
    golden_dir = REPO / "tests" / "fixtures" / "llama_tiny_golden"
    import numpy as np

    golden = np.load(golden_dir / "golden.npz")
    golden_prompts = [golden[f"prompt_{p}"].tolist() for p in (0, 1)]

    def run_layout(layout, device, prompts, budgets=None):
        """Two waves of ``prompts`` (12 tokens each, or ``budgets``)."""
        cfg = {"model": "tiny", "model-dtype": "float32", "slots": 3,
               "max-seq-len": 256, "decode-chunk": 4, **layout}
        # no uplift calibration here: its verdict is a wall-clock ratio and
        # would switch the card and the CPU to plain decode at other steps
        os.environ["LS_TPU_SPEC_CALIBRATE_EVERY"] = str(10**9)
        try:
            engine = TorchServingEngine(
                ServingConfig.from_dict(cfg), device=device,
                params=None if "checkpoint" in layout else params[cfg["model"]])
        finally:
            os.environ.pop("LS_TPU_SPEC_CALIBRATE_EVERY")

        async def wave():
            if budgets is None:
                return (await serve(engine, prompts, 12))[0]
            return await asyncio.gather(*(
                engine.generate(p, {"max-tokens": m, "temperature": 0})
                for p, m in zip(prompts, budgets)))

        async def run():
            try:  # two waves in turn: with the prefix cache the second hits
                first = await wave()
                second = await wave()
                stats = engine.stats()
                if "checkpoint" in layout:  # HF's greedy continuations
                    golden_out = await asyncio.gather(*(
                        engine.generate(p, {"max-tokens": len(golden[f"greedy_{i}"]),
                                            "temperature": 0})
                        for i, p in enumerate(golden_prompts)))
                    stats["golden"] = [r["tokens"] for r in golden_out]
                return first + second, stats
            finally:
                await engine.close()

        results, stats = asyncio.run(run())
        if budgets is not None and stats["decode-chunks"]["heavy"] == 0:
            fail(f"card vs CPU {layout}: the mixed load ran no heavy (pipelined) chunk")
        return [r["tokens"] for r in results], stats

    checkpoint = {"checkpoint": str(golden_dir)}
    for layout in ({**checkpoint, "kv-layout": "dense"},
                   {**checkpoint, "kv-layout": "paged", "prefix-cache": False,
                    "kv-block-size": 16, "kv-quantize": "int8"},
                   {"kv-layout": "dense"},
                   {"kv-layout": "paged", "prefix-cache": False, "kv-block-size": 16},
                   {"kv-layout": "paged", "prefix-cache": False, "kv-block-size": 16,
                    "kv-quantize": "int8"},
                   {"kv-layout": "paged", "prefix-cache": True, "kv-block-size": 16},
                   {"kv-layout": "paged", "prefix-cache": True, "kv-block-size": 16,
                    "prefill-chunk": 32},
                   {"kv-layout": "paged", "prefix-cache": True, "kv-block-size": 16,
                    "kv-quantize": "int8"},
                   {"kv-layout": "paged", "speculative-drafts": 4},
                   {"kv-layout": "paged", "speculative-drafts": 4, "kv-quantize": "int8"},
                   # moe-tiny (path G's family): capacity drops at 3 slots
                   {"model": "moe-tiny", "kv-layout": "dense"},
                   {"model": "moe-tiny", "kv-layout": "paged", "prefix-cache": False,
                    "kv-block-size": 16, "kv-quantize": "int8"},
                   {"model": "moe-tiny", "kv-layout": "paged", "prefix-cache": True,
                    "kv-block-size": 16, "prefill-chunk": 32},
                   {"model": "moe-tiny", "kv-layout": "paged", "speculative-drafts": 4}):
        spec = layout.get("speculative-drafts", 0) > 0
        wave = prompts + [repetitive] if spec else prompts
        out, stats = {}, {}
        for name, device in zip(("cuda", "cpu"), devices):
            tokens, stats[name] = run_layout(layout, device, wave)
            out[name] = (tokens, stats[name]["prefix"]["hits"])
        if out["cuda"] != out["cpu"]:
            fail(f"card vs CPU {layout}: greedy tokens or prefix hits differ:\n{out}")
        extra = ""
        if "checkpoint" in layout:
            if stats["cuda"]["golden"] != stats["cpu"]["golden"]:
                fail(f"card vs CPU {layout}: the golden prompts' greedy tokens differ")
            if layout["kv-layout"] == "dense":
                want = [golden[f"greedy_{p}"].tolist() for p in (0, 1)]
                if stats["cuda"]["golden"] != want:
                    fail(f"card {layout}: greedy tokens {stats['cuda']['golden']} != "
                         f"the fixture's HF greedy {want}")
                extra = " golden greedy_0/greedy_1 equal"
        if layout.get("prefix-cache") and out["cuda"][1] < 2:
            fail(f"card vs CPU {layout}: the second wave made no prefix hits")
        if spec:
            sp, sp_cpu = (stats[d]["speculative"] for d in ("cuda", "cpu"))
            keys = ("steps", "drafts_accepted", "rejected")
            if sp["drafts_accepted"] == 0 or any(sp[k] != sp_cpu[k] for k in keys):
                fail(f"card vs CPU {layout}: no draft accepted, or the speculative "
                     f"counts differ: {sp} vs {sp_cpu}")
            extra = f" speculative={sp}"
            # int8: commit boundaries differ; MoE: the verify's batch shape
            # sets other capacities than a decode step's
            if "kv-quantize" not in layout and "model" not in layout:
                plain, _ = run_layout({**layout, "speculative-drafts": 0}, devices[0], wave)
                if plain != out["cuda"][0]:
                    fail(f"card {layout}: speculative greedy streams differ from "
                         f"speculation off:\n{out['cuda'][0]}\n{plain}")
                extra += " equal to speculation off"
        shown = {k: ("fixture" if k == "checkpoint" else v) for k, v in layout.items()}
        print(f"card vs CPU [{shown}]: {2 * len(wave)} greedy streams identical, "
              f"prefix_hits={out['cuda'][1]}{extra}", flush=True)

    # the pipelined loop under a mixed-length load with more requests than
    # slots: slots finish mid-burst and freeze, queued requests are admitted
    # under a pending chunk
    mixed = prompts + ["judge my vow", "abcdefgh, ijklmnop", "the quick brown fox"]
    budgets = [5, 12, 9, 16, 7, 21, 11, 14]
    for layout in ({"kv-layout": "dense", "pipeline": True, "decode-chunk-light": 0},
                   {"kv-layout": "paged", "prefix-cache": False, "kv-block-size": 16,
                    "kv-quantize": "int8", "pipeline": True},
                   {"model": "moe-tiny", "kv-layout": "dense", "pipeline": True,
                    "decode-chunk-light": 0}):
        out = {name: run_layout(layout, device, mixed, budgets)[0]
               for name, device in zip(("cuda", "cpu"), devices)}
        if out["cuda"] != out["cpu"]:
            fail(f"card vs CPU {layout}: pipelined greedy tokens differ:\n{out}")
        print(f"card vs CPU [{layout}]: {2 * len(mixed)} greedy streams of a mixed-length "
              f"load ({len(mixed)} requests on 3 slots) identical", flush=True)

    # QoS: tests/test_qos.py's preemption shape (8 blocks of 16, 2 slots)
    qos_cfg = {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 256,
               "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16,
               "kv-pool-blocks": 8, "prefix-cache": False, "qos": {}}
    out = {name: qos_preemption_round_trip(torch, qos_cfg, device, params["tiny"])
           for name, device in zip(("cuda", "cpu"), devices)}
    alone, resumed, interactive, counts = out["cuda"]
    if out["cuda"] != out["cpu"] or resumed != alone or counts != (1, 1):
        fail(f"card vs CPU [QoS preemption]: the card {out['cuda']} against the CPU "
             f"{out['cpu']}: tokens must be identical, the resumed stream equal to the "
             f"unpreempted one, one preemption and one resume")
    print(f"card vs CPU [QoS preemption, 8 blocks of 16, 2 slots]: the preempted batch "
          f"request's {len(resumed)} greedy tokens equal its unpreempted run and the "
          f"CPU's; the interactive request's {len(interactive)} identical; "
          f"preempted/resumed={counts}", flush=True)


def qos_preemption_round_trip(torch, cfg: dict, device: str, params):
    """A batch request alone, then again with an interactive request
    arriving at its third token (submitted and queued inside that token's
    delivery, so every device sees it at the same chunk boundary): the
    pool cannot hold both, so the batch request is preempted and resumes.
    Returns (tokens alone, tokens resumed, interactive tokens, (preempted,
    resumed))."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)
    batch_prompt, inter_prompt = "quarterly report: revenue", "what should i check now?"

    async def run():
        try:
            alone = await engine.generate(batch_prompt, {"max-tokens": 40})
            seen, inter = 0, []

            async def on_token(token, logprob, last):
                nonlocal seen
                seen += 1
                if seen == 3:
                    inter.append(asyncio.ensure_future(engine.generate(
                        inter_prompt, {"max-tokens": 8, "priority": "interactive"})))
                    for _ in range(3):
                        await asyncio.sleep(0)

            resumed = await engine.generate(
                batch_prompt, {"max-tokens": 40, "priority": "batch"}, on_token=on_token)
            interactive = await inter[0]
            sched = engine.stats()["scheduler"]
            return (alone["tokens"], resumed["tokens"], interactive["tokens"],
                    (sched["preempted"], sched["resumed"]))
        finally:
            await engine.close()

    return asyncio.run(run())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from langstream_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable next to this script: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: set-up --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.monotonic()
    built = _build.build_all()
    print(f"built {sorted(built)} in {time.monotonic() - t0:.1f} s into "
          f"{_build.build_dir()}", flush=True)
    for line in ptxas_report(built):
        print(line)

    # -- phase 2: kernels against plain ------------------------------------
    t0 = time.monotonic()
    rows = phase_kernels(torch)
    rows.update(phase_mq_kernel(torch))
    print(f"phase kernels: {time.monotonic() - t0:.1f} s", flush=True)

    # -- phases 3 and 4: the main path --------------------------------------
    base = {"model": "llama3-8b", "quantize": "int8", "slots": 64,
            "max-seq-len": 2048, "decode-chunk": 32, "seed": 0}
    t0 = time.monotonic()
    params, dense_counts = phase_main_path(torch, "dense bf16 KV", base, profile=True)
    if dense_counts["flash_attention"] == 0 or dense_counts["paged_attention"] == 0:
        fail(f"dense main path did not launch flash and paged kernels: {dense_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    q8_counts = phase_main_path(
        torch, "paged int8 KV",
        {**base, "kv-layout": "paged", "kv-quantize": "int8", "prefix-cache": False},
        params=params, profile=True,
    )[1]  # (its params are path A's: bound to no name, freed with them below)
    if q8_counts["paged_attention_q8"] == 0 or q8_counts["flash_attention"] == 0:
        fail(f"int8-KV main path did not launch flash and q8 kernels: {q8_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    c_counts = phase_prefix_path(
        torch, "paged bf16 KV, prefix cache, prefill-chunk 512",
        {**base, "kv-layout": "paged", "prefix-cache": True, "prefill-chunk": 512},
        params=params,
    )
    gc.collect()
    torch.cuda.empty_cache()
    d_counts = phase_spec_path(
        torch, "paged bf16 KV, speculative-drafts 4",
        {**base, "kv-layout": "paged", "prefix-cache": False, "speculative-drafts": 4},
        params=params,
    )
    del params  # path E makes its own weights: two 8B sets never share the card
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    e_counts = phase_provider_path(torch, CHAT_EXAMPLE_RESOURCE)
    gc.collect()
    torch.cuda.empty_cache()
    t_f = time.monotonic()
    f_counts = phase_saturated(torch, base)
    gc.collect()
    torch.cuda.empty_cache()
    t_g = time.monotonic()
    g1_counts, g2_counts = phase_moe_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t_h = time.monotonic()
    h_counts = phase_qos_path(torch)
    print(f"phase main path: {time.monotonic() - t0:.1f} s (path F "
          f"{t_g - t_f:.1f} s, path G {t_h - t_g:.1f} s, path H "
          f"{time.monotonic() - t_h:.1f} s)", flush=True)

    # -- phase 5: card against CPU -----------------------------------------
    t0 = time.monotonic()
    phase_card_vs_cpu(torch)
    print(f"phase card vs CPU: {time.monotonic() - t0:.1f} s", flush=True)

    # -- phase 6: kernels line, then the device line ------------------------
    g_counts = {k: g1_counts[k] + g2_counts[k] for k in g1_counts}
    paths = {"A": dense_counts, "B": q8_counts, "C": c_counts, "D": d_counts,
             "E": e_counts, "F": f_counts, "G": g_counts, "H": h_counts}
    meta = {  # launches: summed over the eight main paths
        "flash_attention": ("langstream_tpu_torch/ops/csrc/flash_attention.cu",
                            "langstream_tpu/ops/flash_attention.py:36"),
        "paged_attention": ("langstream_tpu_torch/ops/csrc/paged_attention.cu",
                            "langstream_tpu/ops/paged_attention.py:44"),
        "paged_attention_q8": ("langstream_tpu_torch/ops/csrc/paged_attention.cu",
                               "langstream_tpu/ops/paged_attention.py:126"),
        "paged_attention_multiquery": (
            "langstream_tpu_torch/ops/csrc/paged_attention_mq.cu",
            "langstream_tpu/ops/paged_attention.py:379"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        launches = sum(counts[name] for counts in paths.values())
        if launches == 0:
            fail(f"kernel {name} launched on no main path")
        # ms: a replayed CUDA graph of the calls (the card's time alone);
        # eager_ms: the same calls launched one by one (the wrapper's host
        # work included, which is what the main path pays)
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "launches_by_path": {p: c[name] for p, c in paths.items()},
                        "timing": "cuda_graph", **rows[name]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
