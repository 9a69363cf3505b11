#!/usr/bin/env python3
"""Design sweeps of the port's two decode-time reads on one GPU.

    python3 chip_sweep.py

Times the variants that were weighed against the shipped designs, at the
shapes of ``chip_smoke.py`` phase 2 (Llama-3-8B width: H=32, Kh=8, D=128),
each checked against its plain version before it is timed:

1. the int8 paged decode read (64 slots ragged to 2048, bs 64; bf16 and f32
   queries) and the bf16 read that shares its spans: ring depth, grid
   order, shared-memory carveout and span length. Each variant
   is a copy of ``langstream_tpu_torch/ops/csrc`` with one constant or line
   edited, built into ``build/sweep/`` (one ``nvcc`` per variant, all
   started together) and swapped in for the shipped library;
2. the multi-query history read's plan (B=8, T=16, 64 and 512, bf16):
   warpgroups per CTA (1, 2 or 3; 2 from an edited copy, the shipped source
   builds 1 and 3) and the number of history spans.

A time is the mean of 20 calls replayed in a CUDA graph, the least of 3
such means; every variant runs twice, in two rounds, so drift shows. Needs
the card (exits 2 without CUDA), like ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
H, KH, D = 32, 8, 128

# (variant, source file, [(text, replacement), ...]); the shipped source
# has Q8_TILE 64, Q8_STAGES 2, SPLIT_ROWS 256, KV heads fastest in the grid
Q8_VARIANTS = [
    ("shipped", "paged_attention", []),
    # ring depth; the tile height stays 64: the mma.sync route's warps take
    # 16 rows each, one m16 tile (a static_assert holds it)
    *[(f"stages{stages}", "paged_attention", [
        ("constexpr int Q8_STAGES = 2;", f"constexpr int Q8_STAGES = {stages};"),
    ]) for stages in (3, 4)],
    ("spans_fastest", "paged_attention", [
        ("const int kh = blockIdx.x;  // the KV heads of one span run side by side\n"
         "  const int split = blockIdx.y;",
         "const int split = blockIdx.x;\n  const int kh = blockIdx.y;"),
        ("dim3(Kh, n_split, B), NT, smem", "dim3(n_split, Kh, B), NT, smem"),
    ]),
    ("carveout100", "paged_attention", [
        ("              cudaStream_t stream) {\n  if (smem > 48 * 1024) {",
         "              cudaStream_t stream) {\n"
         "  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
         "  if (smem > 48 * 1024) {"),
        ("  auto kernel = paged_decode_split_kernel<T, D>;\n",
         "  auto kernel = paged_decode_split_kernel<T, D>;\n"
         "  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"),
    ]),
    *[(f"span{rows}", "paged_attention", [
        ("constexpr int SPLIT_ROWS = 256;", f"constexpr int SPLIT_ROWS = {rows};"),
    ]) for rows in (128, 512)],
]
MQ_VARIANT = ("mq_wg2", "paged_attention_mq", [
    ("    if (D == 128 && warpgroups == 3) LAUNCH(128, 3);\n",
     "    if (D == 128 && warpgroups == 3) LAUNCH(128, 3);\n"
     "    if (D == 128 && warpgroups == 2) LAUNCH(128, 2);\n"),
])


def build_variants(variants) -> dict[str, Path]:
    """One edited copy of csrc per variant, all compiled at once."""
    from langstream_tpu_torch.ops import _build

    root = _build.build_dir().parent / "sweep"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, source, edits in variants:
        csrc = root / name / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        f = csrc / f"{source}.cu"
        text = f.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"chip_sweep: variant {name}: {old[:60]!r} not in {f.name}")
            text = text.replace(old, new)
        f.write_text(text)
        out = root / name / f"{source}.so"
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"chip_sweep: nvcc failed for {name}:\n{log}")
    return {name: out for name, (out, _) in procs.items()}


def use_library(source: str, path: Path) -> None:
    from langstream_tpu_torch.ops import _build

    _build._libs[source] = ctypes.CDLL(str(path))


def best_ms(torch, chip_smoke, fn) -> float:
    return min(chip_smoke.cuda_ms(torch, fn, iters=20, graph=True) for _ in range(3))


def normalised_err(pa, got, want) -> float:
    return (pa.merge_partial_attention([got]) - pa.merge_partial_attention([want])
            ).abs().max().item()


def sweep_decode_reads(torch, chip_smoke, libs) -> None:
    from langstream_tpu_torch.ops import paged_attention as pa

    cases = {
        (label, int8): chip_smoke.paged_case(
            torch, B=64, H=H, Kh=KH, D=D, bs=64, max_len=2048, dtype=dtype,
            int8=int8, dense=False, seed=7)
        for label, dtype, int8 in (("int8 bf16-q", torch.bfloat16, True),
                                   ("int8 f32-q", torch.float32, True),
                                   ("bf16 pool", torch.bfloat16, False))
    }
    shipped_rows, shipped_splits = pa.SPLIT_ROWS, pa.paged_read_splits
    for rnd in range(2):
        for name, _, edits in Q8_VARIANTS:
            use_library("paged_attention", libs[name])
            rows = shipped_rows
            for old, new in edits:
                if old.startswith("constexpr int SPLIT_ROWS"):
                    rows = int(new.split("=")[1].strip(" ;"))
            # the wrapper reads both at call time: the span the variant was built with
            pa.SPLIT_ROWS = rows
            pa.paged_read_splits = (
                lambda nrb, bs, split_rows=rows: shipped_splits(nrb, bs, split_rows))
            out = []
            for (label, int8), (q, kp, vp, tables, lengths, nrb) in cases.items():
                fn = pa._paged_attention_partial_q8 if int8 else pa.paged_attention_partial
                kw = dict(num_read_blocks=nrb, kv_heads=KH, head_dim=D)
                err = normalised_err(pa, fn(q, kp, vp, tables, lengths, **kw),
                                     pa.paged_attention_reference(q, kp, vp, tables,
                                                                  lengths, **kw))
                tol = chip_smoke.TOL_F32 if q.dtype == torch.float32 else chip_smoke.TOL_BF16
                if not err <= tol:
                    raise SystemExit(f"chip_sweep: {name} {label}: error {err} > {tol}")
                ms = best_ms(torch, chip_smoke, lambda: fn(q, kp, vp, tables, lengths, **kw))
                out.append(f"{label} err={err:.1e} ms={ms:.4f}")
            print(f"decode read round {rnd} {name}: " + "; ".join(out), flush=True)
    pa.SPLIT_ROWS, pa.paged_read_splits = shipped_rows, shipped_splits


def forced_plan(wg: int, n: int):
    """A stand-in for the wrapper's _multiquery_plan: ``wg`` warpgroups, the
    window in ``n`` spans of whole 64-row tiles (fewer if they would be empty)."""
    def plan(batch, t, group, kv_heads, num_read_blocks, block_size):
        window = num_read_blocks * block_size
        tiles = max(1, -(-window // 64))
        span = -(-tiles // min(n, tiles)) * 64
        return wg, max(1, -(-window // span)), span
    return plan


def sweep_multiquery_plans(torch, chip_smoke, libs) -> None:
    from langstream_tpu_torch.ops import paged_attention as pa

    use_library("paged_attention_mq", libs["mq_wg2"])
    shipped_plan = pa._multiquery_plan
    B, bs, max_len = 8, 64, 2048
    g = torch.Generator().manual_seed(13)
    starts = torch.randint(1, 1537, (B,), generator=g)
    starts[:4] = torch.tensor([0, bs // 2 + 5, 2 * bs, 1536])
    nrb = -(-int(starts.max()) // bs)
    nb = int(sum(-(-int(n) // bs) for n in starts)) + 1
    perm = (torch.randperm(nb - 1, generator=g) + 1).tolist()
    tables = torch.zeros((B, max_len // bs), dtype=torch.int32)
    for b in range(B):
        for j in range(-(-int(starts[b]) // bs)):
            tables[b, j] = perm.pop()
    tables, starts = tables.cuda(), starts.to(torch.int32).cuda()
    kw = dict(num_read_blocks=nrb, kv_heads=KH, head_dim=D)
    for T in (16, 64, 512):
        q = torch.randn((B, T, H, D), generator=g).to(torch.bfloat16).cuda()
        kp, vp = (torch.randn((nb, bs, KH * D), generator=g).to(torch.bfloat16).cuda()
                  for _ in range(2))
        args = (q, kp, vp, tables, starts)
        want = pa.paged_attention_multiquery_reference(*args, **kw)
        kept = shipped_plan(B, T, H // KH, KH, nrb, bs)
        splits = (1,) if T == 512 else (1, 2, 3, 5, 8)
        for rnd in range(2):
            for wg in (1, 2, 3):
                for n in splits:
                    pa._multiquery_plan = forced_plan(wg, n)
                    try:
                        plan = pa._multiquery_plan(B, T, H // KH, KH, nrb, bs)
                        err = normalised_err(
                            pa, pa.paged_attention_multiquery_partial(*args, **kw), want)
                        if not err <= chip_smoke.TOL_BF16:
                            raise SystemExit(f"chip_sweep: mq T={T} plan {plan}: error {err}")
                        ms = best_ms(torch, chip_smoke,
                                     lambda: pa.paged_attention_multiquery_partial(*args, **kw))
                    finally:
                        pa._multiquery_plan = shipped_plan
                    mark = " (shipped plan)" if plan == kept else ""
                    print(f"multi-query round {rnd} T={T} warpgroups={wg} spans={plan[1]} "
                          f"span_rows={plan[2]}: err={err:.1e} ms={ms:.4f}{mark}", flush=True)
        del q, kp, vp, args, want
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_sweep: torch.cuda is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    libs = build_variants([*Q8_VARIANTS, MQ_VARIANT])
    print(f"built {len(libs)} variants", flush=True)
    sweep_decode_reads(torch, chip_smoke, libs)
    sweep_multiquery_plans(torch, chip_smoke, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
