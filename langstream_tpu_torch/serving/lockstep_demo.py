"""Multi-process lockstep serving of the port: the executable proof that a
mesh engine runs (the leader consumes and samples, the followers replay
the same model calls on their shards, the collectives cross processes).
Port of ``langstream_tpu/serving/lockstep_demo.py``.

Run one process per rank (the tests and ``chip_smoke.py`` spawn these):

    python -m langstream_tpu_torch.serving.lockstep_demo \\
        --index 0 --num-processes 2 --coordinator-port P --lockstep-port Q \\
        --device cpu --out leader.json
    python -m langstream_tpu_torch.serving.lockstep_demo \\
        --index 1 --num-processes 2 --coordinator-port P --lockstep-port Q \\
        --device cpu --out follower.json

Each process is one rank (``--device cuda``: card ``rank % cards``). The
workload is :func:`demo_config`'s (``tiny`` on a ``dp x tp`` mesh,
``LS_DEMO_KV=paged`` for the block pool, ``LS_DEMO_SPEC=N`` for
speculation) unless ``--config`` gives resource configurations (a JSON
object or a list of them, served one after the other in the same world).
``--prompts`` (a JSON list, or a list of lists served as waves in turn)
and ``--max-tokens`` set the requests, which run greedy. ``--layers N``
serves every model at N layers (full width), a cut of depth for time.

The leader writes, per configuration, its token streams, their logprobs,
the tokens each dispatch sampled and its engine's mesh section to
``--out``; a follower writes the tokens each replayed dispatch sampled, so
the caller can hold every rank's chunks against the leader's.
``--reference`` runs the same workload in one process without the mesh.

Fault injection (the tests' failure paths): ``LS_DEMO_FOLLOWER_DIE_AFTER=N``
kills a follower after N replayed descriptors, ``LS_DEMO_LEADER_ABRUPT_EXIT=1``
kills the leader after its requests without the ``stop`` frame.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import os
import sys
from pathlib import Path

PROMPTS = ["hello tpu world", "lockstep decode", "multi host serving"]


@contextlib.contextmanager
def cut_layers(layers: int | None):
    """Engines built inside the block serve every model of the engine's
    tables at ``layers`` layers (full width; None: as they are). Every
    entry is cut: a follower learns its model only from the handshake."""
    from langstream_tpu_torch.serving import engine as engine_module

    saved = [(table, dict(table)) for table in (engine_module._MODEL_CONFIGS,
                                                engine_module._MOE_MODELS)]
    if layers:
        for table, full in saved:
            for name, f in full.items():
                table[name] = (lambda f: lambda **kw: dataclasses.replace(
                    f(**kw), layers=min(f(**kw).layers, layers)))(f)
    try:
        yield
    finally:
        for table, full in saved:
            table.clear()
            table.update(full)


async def _drive(engine, prompts: list, max_tokens: int) -> dict:
    """Serve ``prompts`` greedy, all at once, or in waves (a list of lists,
    each awaited before the next, so a later wave can hit the prefix
    cache)."""
    waves = prompts if prompts and isinstance(prompts[0], list) else [prompts]
    results = []
    for wave in waves:
        results += await asyncio.gather(*(
            engine.generate(p, {"max-tokens": max_tokens, "temperature": 0.0})
            for p in wave))
    out = {
        "tokens": [list(r["tokens"]) for r in results],
        "logprobs": [[float(x) for x in r["logprobs"]] for r in results],
        "mesh": engine.mesh_section(),
        "kernels": engine.stats()["kernels"],
        "prefix": engine.stats()["prefix"],
        "speculative-steps": engine.spec_steps,
        "continue-calls": engine._continue_calls,
    }
    if os.environ.get("LS_DEMO_LEADER_ABRUPT_EXIT") == "1":
        # leader-death injection: skip close(), whose "stop" frame is what
        # a crashed leader never sends
        return out
    await engine.close()
    out["mesh"] = engine.mesh_section()  # with the chunk close() drained
    out["dispatches"] = {str(k): [op, v.tolist()]
                         for k, (op, v) in sorted(engine.lockstep_tokens.items())}
    return out


def run_process(index: int, num_processes: int, coordinator_port: int,
                lockstep_port: int, configs: list[dict], prompts: list[str],
                max_tokens: int, device: str = "cpu",
                out_path: str | None = None) -> None:
    from langstream_tpu_torch.parallel.mesh import init_distributed

    init_distributed(f"127.0.0.1:{coordinator_port}", num_processes, index, device)
    import torch.distributed as dist

    outputs = []
    if index == 0:
        from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
        from langstream_tpu_torch.serving.lockstep import LockstepBroken

        os.environ["LS_LOCKSTEP_PORT"] = str(lockstep_port)
        for cfg in configs:
            engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device)
            engine.lockstep_tokens = {}  # held against the followers' logs
            try:
                outputs.append(asyncio.run(_drive(engine, prompts, max_tokens)))
            except LockstepBroken as e:
                # the fail-loud contract: in-flight work already failed
                # with this error; exit non-zero so the slice restarts
                print(f"leader saw LockstepBroken: {e}; engine stopped serving: "
                      f"{engine._stop}", file=sys.stderr, flush=True)
                os._exit(5)
            if os.environ.get("LS_DEMO_LEADER_ABRUPT_EXIT") == "1":
                if out_path:
                    Path(out_path).write_text(json.dumps(outputs))
                print("fault injection: leader abrupt exit", file=sys.stderr, flush=True)
                os._exit(4)
    else:
        from langstream_tpu_torch.serving.lockstep import LockstepFollower

        die_after = int(os.environ.get("LS_DEMO_FOLLOWER_DIE_AFTER", "0"))
        for _ in configs:
            follower = LockstepFollower("127.0.0.1", lockstep_port, device=device,
                                        record_tokens=True)
            steps = follower.run(die_after_steps=die_after or None)
            outputs.append({
                "replayed": steps,
                "dispatches": [[op, v.tolist()] for op, v in follower.tokens_log],
                "mesh": follower.engine.mesh_section(),
                "kernels": follower.engine.stats()["kernels"],
            })
            print(f"follower replayed {steps} steps", file=sys.stderr)
    if out_path:
        Path(out_path).write_text(json.dumps(outputs))
    dist.destroy_process_group()


def demo_config(num_processes: int) -> dict:
    """The JAX demo's workload, one rank per process: ``tiny`` on a mesh of
    ``dp = n / 2`` by ``tp = 2`` (the tiny model's 2 KV heads cap tp at 2)."""
    kv_layout = os.environ.get("LS_DEMO_KV", "dense")
    spec = int(os.environ.get("LS_DEMO_SPEC", "0"))
    return {
        "model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 64,
        "decode-chunk": 4, "prefill-batch": 2, "seed": 0, "kv-layout": kv_layout,
        "kv-block-size": 16, "speculative-drafts": spec,
        "mesh": {"dp": max(num_processes // 2, 1), "tp": min(num_processes, 2)},
    }


def run_reference(configs: list[dict], prompts: list[str], max_tokens: int,
                  device: str = "cpu") -> list[dict]:
    """The same workload in one process, each configuration without its
    mesh: the streams the group must reproduce."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    outputs = []
    for cfg in configs:
        cfg = {k: v for k, v in cfg.items() if k != "mesh"}
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device)
        outputs.append(asyncio.run(_drive(engine, prompts, max_tokens)))
    return outputs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", action="store_true",
                    help="one process without the mesh instead of a group role")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator-port", type=int, default=0)
    ap.add_argument("--lockstep-port", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=None,
                    help="a resource configuration (JSON object) or a list of them")
    ap.add_argument("--prompts", default=None, help="a JSON list of prompts")
    ap.add_argument("--max-tokens", type=int,
                    default=int(os.environ.get("LS_DEMO_MAX_TOKENS", "6")))
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    with cut_layers(args.layers):
        _main(args)


def _main(args) -> None:
    configs = json.loads(args.config) if args.config else demo_config(args.num_processes)
    if isinstance(configs, dict):
        configs = [configs]
    prompts = json.loads(args.prompts) if args.prompts else PROMPTS
    if args.reference:
        out = run_reference(configs, prompts, args.max_tokens, args.device)
        if args.out:
            Path(args.out).write_text(json.dumps(out))
        return
    run_process(args.index, args.num_processes, args.coordinator_port,
                args.lockstep_port, configs, prompts, args.max_tokens,
                args.device, args.out)


if __name__ == "__main__":
    main()
