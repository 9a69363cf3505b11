"""Multi-process lockstep serving of the port: the executable proof that a
mesh engine runs (the leader consumes and samples, the followers replay
the same model calls on their shards, the collectives cross processes).
Port of ``langstream_tpu/serving/lockstep_demo.py``.

An engine whose mesh finds no world starts its own ranks
(:mod:`langstream_tpu_torch.parallel.launch`); this demo instead runs each
rank as a process of its own, started by hand (the tests and
``chip_smoke.py`` spawn these, to drive ranks one by one):

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

A configuration with ``embeddings-model`` (and ``tokenizer``,
``embeddings-checkpoint``, as the provider reads them) also serves the
embeddings engine under the same mesh: the leader embeds the prompts
through it (``vectors`` in its output), on the channel of the serving
engine when the configuration names a ``model`` too, on its own otherwise.

Every configuration is one world: each rank joins it, serves, and ends it
(:func:`~langstream_tpu_torch.parallel.mesh.shutdown`; the leader's
engines end it when the last one closes).

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


async def _embed(cfg: dict, prompts: list, device: str) -> dict:
    """The configuration's embeddings engine (under its mesh, if any) on
    the prompts; closed after."""
    from langstream_tpu_torch.serving.embeddings import EmbeddingEngine

    flat = [p for wave in prompts for p in wave] if prompts and isinstance(
        prompts[0], list) else list(prompts)
    engine = EmbeddingEngine(cfg["embeddings-model"], cfg.get("tokenizer"),
                             cfg.get("embeddings-checkpoint"), mesh=cfg.get("mesh"),
                             device=device)
    try:
        vectors = await engine.embed(flat)
        return {"vectors": vectors, "embed-mesh": engine.mesh_section()}
    finally:
        engine.close()


async def _drive(engine, prompts: list, max_tokens: int, embed_cfg: dict | None = None,
                 device: str = "cpu") -> dict:
    """Serve ``prompts`` greedy, all at once, or in waves (a list of lists,
    each awaited before the next, so a later wave can hit the prefix
    cache); with ``embed_cfg`` the embeddings engine embeds them too, on
    the serving engine's channel."""
    waves = prompts if prompts and isinstance(prompts[0], list) else [prompts]
    embedded = (asyncio.ensure_future(_embed(embed_cfg, prompts, device))
                if embed_cfg else None)
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
    if embedded is not None:
        out.update(await embedded)
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
    from langstream_tpu_torch.parallel.mesh import init_distributed, shutdown

    outputs = []
    for cfg in configs:
        # one world per configuration: the last engine's close() (the
        # leader) or the replay's end (a follower) ends it
        init_distributed(f"127.0.0.1:{coordinator_port}", num_processes, index, device)
        if index == 0:
            outputs.append(_lead(cfg, prompts, max_tokens, device, lockstep_port,
                                 outputs, out_path))
        else:
            outputs.append(_follow(lockstep_port, device))
        shutdown()  # nothing when the world already ended
    if out_path:
        Path(out_path).write_text(json.dumps(outputs))


def _lead(cfg: dict, prompts, max_tokens: int, device: str, lockstep_port: int,
          outputs: list, out_path: str | None) -> dict:
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
    from langstream_tpu_torch.serving.lockstep import LockstepBroken

    os.environ["LS_LOCKSTEP_PORT"] = str(lockstep_port)
    embed_cfg = cfg if "embeddings-model" in cfg else None
    if "model" not in cfg:  # an embeddings resource alone: no dispatch
        return {**asyncio.run(_embed(cfg, prompts, device)), "dispatches": {}}
    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device)
    engine.lockstep_tokens = {}  # held against the followers' logs
    try:
        out = asyncio.run(_drive(engine, prompts, max_tokens, embed_cfg, device))
    except LockstepBroken as e:
        # the fail-loud contract: in-flight work already failed with this
        # error; exit non-zero so the slice restarts
        print(f"leader saw LockstepBroken: {e}; engine stopped serving: "
              f"{engine._stop}", file=sys.stderr, flush=True)
        os._exit(5)
    if os.environ.get("LS_DEMO_LEADER_ABRUPT_EXIT") == "1":
        if out_path:
            Path(out_path).write_text(json.dumps(outputs + [out]))
        print("fault injection: leader abrupt exit", file=sys.stderr, flush=True)
        os._exit(4)
    return out


def _follow(lockstep_port: int, device: str) -> dict:
    from langstream_tpu_torch.serving.lockstep import LockstepFollower

    die_after = int(os.environ.get("LS_DEMO_FOLLOWER_DIE_AFTER", "0"))
    follower = LockstepFollower("127.0.0.1", lockstep_port, device=device,
                                record_tokens=True)
    steps = follower.run(die_after_steps=die_after or None)
    print(f"follower replayed {steps} steps", file=sys.stderr)
    engine = follower.engine
    return {
        "replayed": steps,
        "dispatches": [[op, v.tolist()] for op, v in follower.tokens_log],
        "mesh": engine.mesh_section() if engine is not None else None,
        "kernels": engine.stats()["kernels"] if engine is not None else None,
        "embed-mesh": [e.mesh_section() for e in follower.embedders.values()],
    }


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
        if "model" not in cfg:
            outputs.append(asyncio.run(_embed(cfg, prompts, device)))
            continue
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device)
        engine.lockstep_tokens = {}
        embed_cfg = cfg if "embeddings-model" in cfg else None
        outputs.append(asyncio.run(_drive(engine, prompts, max_tokens, embed_cfg, device)))
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
