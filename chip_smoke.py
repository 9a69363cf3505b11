#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``langstream_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (every one unguarded: any failure exits non-zero):

1. set-up: require CUDA, print the card's name and power limit, build the
   kernels from ``langstream_tpu_torch/ops/csrc`` (one ``nvcc`` per source,
   started together) and print the build time (a ``first build:`` line:
   the seconds, or null when the build directory was warm: what a pod's
   first start pays unless its image carries the libraries);
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
   FMA kernel); at one tp=2 rank's heads (H=16, Kh=4, path N1), flash at
   S=2048 and the bf16 and int8 decode reads; and at Mixtral-8x7B's
   context (path G), flash at S=4096,
   the bf16 and int8 decode reads over 4,096 history rows and the
   multi-query read over histories to 3,584 rows; at path Y1's lengths
   (``summarizer_8192`` in the kernels line), flash at B=1, S=8192, the
   bf16 decode read over 8 slots ragged to 8,192 rows and the verify's
   multi-query read (T=5) over 8 histories to 8,187 rows; every bf16 case
   is held both to 2e-2 absolute and to 2e-2 of its values' size
   (:func:`scaled_err`), and flash at 8,192 prints the rows past 4,096
   apart;
3. main path A: ``TorchServingEngine`` serving the chat example's resource
   (llama3-8b, int8 weights, 64 slots, 2048 context, decode-chunk 32, dense
   KV; every llama3-8b engine of the run at ``MAIN_LAYERS`` = 16 of its 32
   layers at most, A, B, C, M3, T and X-Z at it, the others cut further) answering concurrent greedy requests, launch counters set to 0 just
   before and read just after (as for every path);
4. main path B: the same with ``kv-layout: paged``, ``kv-quantize: int8``
   (a profiled second wave, as path A);
   main path C: paged bf16 KV with the prefix cache and ``prefill-chunk:
   512``, three waves in turn over a shared ~1,100-token preamble (chunked
   prefills, then prefix hits, then a repeated prompt), printing the
   (batch, T) of each multi-query call;
   main path D: paged bf16 KV with ``speculative-drafts: 4`` on the first
   8 of path A's layers (``D_LAYERS``), one wave of
   six greedy prompts that repeat a phrase and two sampled ones: the
   speculative stats, the (batch, T) of the verify's multi-query calls,
   TTFT and tokens per step; then the greedy prompts with speculation off
   and the share of tokens that match (printed, not required);
   main path E: the chat example's resource (``CHAT_EXAMPLE_RESOURCE``:
   dense bf16 KV, ``decode-chunk-light: 8``, ``warmup-on-start``) at 4 of
   its 32 layers (``E_LAYERS``; 16 before, path T serves the resource at
   ``MAIN_LAYERS`` through the whole application path) through
   the port's provider, as the ``ai-chat-completions`` agent reaches it:
   the first chat runs the warmup; a streamed wave of 8 (light regime, at
   most 8 steps per decode dispatch) and one of 24 (heavy, more than 8);
   a stop string; an ``adapter`` and a spent ``deadline`` refused before
   they queue; then the embeddings service (minilm-l6) on the card against
   the CPU within 1e-4;
   main path F: the saturated load at 4 of llama3-8b's 32 layers
   (``F_LAYERS``), 96 greedy requests (30-600 byte tokens,
   max-tokens cycling 48/96/128/160) on 64 slots, four times: F1 the chat
   example's resource (dense bf16 KV) with the pipelined loop, F2 the same
   with ``pipeline: false``, F3/F4 paged int8 KV pipelined/sequential; per
   run decode tok/s, ms per step, steps per dispatch,
   ``host_fetches_per_chunk`` (must be 1.0), the flight split (device,
   exposed host, stall, overlapped host) and idle share, the attribution's expected against achieved decode ms at
   the card's bandwidth, device-cache counts and peak memory; F1's greedy
   streams against F2's (recorded); the block manager idle after F3/F4;
   main path G: Mixtral-8x7B (``moe-8x7b``, 2 of its 32 layers, full width, random
   int8 weights) at the ``moe-mixtral-ep`` resource without its mesh (32
   slots, 4,096 context): G1 with the example's dense bf16 KV, a wave of 8
   (one ~3,000-token prompt: flash at the 4,096 bucket), a wave of 32
   (pipelined) and a profiled wave of 32 (prompts of one bucket, 17
   tokens each; device busy time by group: dequant, GEMMs, the expert
   FFN's routing/dispatch/activation/combine, flash, paged read); G2 paged int8 KV, a wave
   of 32; per run ms per step, decode tok/s, TTFT, the attribution's
   expected against achieved ms and peak memory;
   main path H: the admission and delivery planes at llama3-8b (4 of its
   32 layers, ``H_LAYERS``), the chat example's resource with paged int8
   KV, ``streaming: true``, a ``qos``
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
   main path I: KV off the card at llama3-8b int8 on the first 4 of path
   A's layers (``I_LAYERS``, a cut for the time limit; run
   between D and E, while those params are on the card). I1: the chat
   example's resource with paged int8 KV and a ``prefix-store`` (T0 budget
   the 24-block preamble P and two blocks, T1 three preambles' blocks, T2
   a local temporary directory), one request at a time: P's question 1
   cold, questions 1-7 as T0 hits, a wave on two other preambles that
   demotes P's blocks to T1, questions 1-7 again (T1 promotion); engine A's
   budgets then drop to 0 and 1 byte until every block is in T2, and a
   fresh engine B on the same weights and directory serves questions 1-7
   from T2 hydration. TTFT cold, T0 hit, T1 promote and T2 hydrate;
   demote, promote and hydrate bytes, ms and GB/s; ``stats()["prefixstore"]``
   of both engines. Fails unless the promoted and hydrated greedy tokens
   equal the T0 hits', both tier ledgers balance, one fetch per chunk and
   idle block managers. I2: the resource with paged bf16 KV as a combined
   engine, then as a ``pool-role: prefill`` engine whose 16 exports land in
   a ``pool-role: decode`` engine (bf16 rows through the wire as raw
   words); the decoded greedy tokens must equal the combined engine's;
   payload bytes and export/import ms;
   main path J: multi-LoRA at llama3-8b int8 on the first 4 of path A's
   layers (``J_LAYERS``, a cut for the time limit; run after I, while
   those params are on the card). J1: the chat example's resource
   with paged int8 KV (no warmup, the prefix cache off) and an
   ``adapter-store`` (rank 16, four T0 rows, T1 for four adapters' f32
   factors, T2 a local temporary directory); six adapters
   (``make_lora_arrays``, ``scale=0.5``), three installed and three
   published to T2 only. A load wave of 64 (48 over the six adapters, 16
   base) and the same prompts on a store-less engine: ms per step, decode
   tok/s, TTFT by kind (T0 hit, T1 -> T0 load, T2 hydrate, base), peak
   memory, row-load and hydration times; a profiled decode window at the
   engine's shapes with ``lora_delta`` in a ``record_function`` range
   (kernels per step with and without adapters, the deltas' share of busy
   time). One request at a time, exact greedy tokens: (a) base prompts on
   the adapter engine equal the store-less engine's, (b) a T2-hydrated
   adapter equals it installed locally on a fresh engine, (c) an adapter
   evicted and reloaded into another T0 row gives its tokens, (d) the
   adapter changes the tokens; an unknown adapter is refused; the adapter
   ledger balances, no pin is left, the block managers end idle. J2: paged
   bf16 KV with ``speculative-drafts: 4`` and two adapters over 8
   repetitive prompts: the verify's (B, T) multi-query calls with the
   adapter rows of the speculative dispatches, tokens per step, then the
   same with speculation off and the common prefix (printed);
   main path K: the device-survival plane and the drain at llama3-8b int8
   on the first 8 of path A's layers for K1, K2 and K4 (``K_LAYERS``, a
   cut for the time limit; run after J), the chat example's resource with
   paged int8 KV, the pipelined loop and ``shrink-recovery-s: 2``. K1: a
   64-request greedy wave (path F's lengths and budgets) unfaulted (inert
   plans count the seams' passes), then under two allocator failures at
   pool-grow (at half the unfaulted wave's passes) and one at the third
   prefill: every request completes within its budget, preemptions equal
   resumes, ``pool-shrink`` events name their site after their
   ``fault-injected`` events, the budget is restored to 0 within 10 s of
   the last shrink, the block manager ends idle, one fetch per chunk; ms
   per step, tok/s and the share of greedy tokens equal to the unfaulted
   wave (int8 KV: not required equal); a genuine out-of-memory error from
   the card is classified as an allocator failure. K2: a ``fetch`` hang of
   three wedge windows (6 s) in a wave of 16: ``health()`` wedged during
   it, ok after, every request complete; path I2's pair with a ``scatter``
   failure on the decode pool shrinks and serves every import. K3: a child
   process (``--k3-child``) builds llama3-8b at 8 of 32 layers from a seed
   with a journal, accepts 32 requests behind a hung prefill and is killed
   with SIGKILL; an engine here on the same seed and directory replays
   them: the same weight checksum, all served, each entry retired once,
   the journal empty, one ``journal-replay`` event. K4: a wave of 64
   drained (grace 120 s) after its first chunk: requeued equals the slots
   occupied at the preempt pass, 64 completed, nothing shed but a refused
   submission; a fresh wave drained with a 0.5 s grace: completed and shed
   cover it, no future pending; then the port's module-level
   ``drain_engines``, ``flight_report``, ``attribution_report`` and
   ``profile_engines`` over those engines;
   main path L: the request-evidence and cross-replica planes at llama3-8b
   int8 on path A's params (run after K; L1 at K's ``K_LAYERS``, L2 at
   I2's ``I_LAYERS``). L1: K1's unfaulted wave on K's
   configuration with an ``incident-dir`` and an ``slo`` section whose TTFT
   objective the wave breaches, each request under its own ambient trace:
   ms per step and tok/s beside K1's, the p50 and p99 of the journey
   segments, spans per request, bundles captured and suppressed; fails
   unless every journey ends in ``finish`` in ``LIFECYCLE_CHAIN`` order
   with no event dropped, every request has its ``engine.queue``,
   ``engine.prefill`` and ``engine.decode`` spans, an ``slo-fast-burn``
   bundle is on disk, re-indexed by a fresh recorder and listed by
   ``incident_report()``, one fetch per chunk and an idle block manager.
   L2: I2's pair (paged bf16 KV) behind a router of three dead replicas
   and one live decode replica (one port ``CircuitBreaker`` each), an
   ``http-export`` drop and ``http-import`` drops on two offers: 16 prompts
   chained by ``HandoffChainer``, then 4 with every replica dead, which
   fall back to local decode; fails unless the greedy tokens equal I2's
   combined engine's, the dead replicas' breakers open, a
   ``breaker-storm`` bundle is captured on the prefill engine, every
   journey runs export -> export-taken -> import-received -> import ->
   first-step -> finish (the fallbacks' import on the prefill engine) and
   ``survival_section()`` counts the retries and fallbacks; prints the
   retries, fallbacks, breaker opens and the transfer segment;
   main path M: the Prometheus plane, the checkpoint writers and dense int8
   KV. M3 (after L, on path A's params): the chat prompts of A and B
   greedy at A's 16 layers with ``kv-quantize: int8`` on the dense layout; ms
   per step beside A's and B's, the common prefix against B; fails unless
   the int8 read kernel launched and the bf16 one did not. M2: llama3-8b
   at full width and 2 layers (``M2_LAYERS``), random bf16 weights from
   seed 0, written by ``save_llama_checkpoint`` (~5.9 GB of f32) to a
   temporary directory and served through ``checkpoint:`` with
   ``quantize: int8``: 8 greedy streams equal those of an engine on the
   same params in memory; the write and load seconds and the bytes. M1
   (after H, so every plane's engines have served): the port's registry
   rendered and held to the OpenMetrics line grammar, every plane's
   families present (``M_FAMILIES``), L1's scrape deltas of tokens and
   requests equal to its ``stats()`` and a TTFT exemplar naming one of
   its journeys (checked in L1), one fetch per chunk on K1 and L1 with
   their ms per step beside the reference's, ``recompile`` events on A,
   ``warmup`` begin and end on E, ``spec-auto-disable`` on D exactly when
   D's speculation flipped off, and the host nanoseconds of a counter
   increment and of an exemplar observation over 10^5 calls;
   main path N (after M1): multi-GPU serving, two ranks of one mesh on
   this card: this process is rank 0 and spawns rank 1
   (``python -m langstream_tpu_torch.serving.lockstep_demo --index 1``),
   gloo between them (NCCL refuses two ranks on one device). N1:
   llama3-8b int8 at 4 layers (``N_LAYERS``; 8 until path R came), paged int8 KV, 16 slots,
   ``mesh: {tp: 2}``, 16 greedy requests of 64 tokens, against a tp=1
   engine on the same weights: first tokens equal wherever tp=1's top-2
   logprob gap exceeds 0.05, first logprobs within 0.05, the common
   prefixes printed, kernels #1 and #3 launched on both ranks, and each
   rank's device peak while placing its weights under the tp=1 tree's
   bytes (``N_LOAD_PEAK``: its shards and one whole leaf at a time, never
   the whole tree). N2:
   Mixtral-8x7B int8 at 2 layers, ``mesh: {ep: 2, tp: 1}``, 8 requests,
   the same rule against ep=1. N3: ``tiny`` f32 on the HF fixture,
   ``mesh: {tp: 2}``, paged with the prefix cache, chunked prefill and
   speculation, then the same without speculation, then dense KV at
   ``mesh: {dp: 2, tp: 1}`` (each replica runs its own slots' rows): every
   lockstep op runs and the greedy tokens equal a CPU one-rank run. Every
   rank's dispatches sampled the same tokens. One line per run: ms per
   step of both engines, both ranks' launches, the collectives by call
   site, the decode steps' logits gather's share of decode, and each
   rank's weight bytes and load peak; two ranks on one card measure the
   seam, not the speed of TP;
   main path O (after N): sequence parallelism and the embeddings mesh,
   two ranks on this card again. O1: long-context-summarizer's resource
   (llama3-8b int8, paged int8 KV, 8 slots, 8,192 context,
   ``speculative-drafts: 4``) at 2 layers (``O_LAYERS``), ``mesh: {sp: 2,
   tp: 1}`` (the example's ``{sp: 4, tp: 2}`` cut to two ranks), 8 greedy
   reports of 1,500-7,000 tokens, 64 tokens each, against sp=1 on the same
   weights: every request completes, the first-token rule, the longest
   prompt's prefilled cache rows equal sp=1's within 2e-2 of their max
   abs, kernel #3 launched on both ranks, the ring's collectives counted;
   ms per prefilled prompt at sp=2 and sp=1 and the ring's seconds and
   bytes printed. O2: ``llama_forward_sp`` with the ring and Ulysses on
   one 2,048-token sequence at 2 layers on two ranks (this process and
   ``chip_smoke.py --o2-rank``), each within 2e-2 of the one-rank forward
   with the plain attention of its arithmetic (Ulysses through the
   host-staged all-to-all). O3: minilm-l6 at ``mesh: {dp: 2}`` over 64
   texts, equal to the one-rank engine within 1e-4;
   main path P (after O): training through the mesh, two ranks on this
   card again (rank 1 is ``chip_smoke.py --p-rank``, one world per part),
   bf16 parameters from a seed, f32 logits and loss, one SGD step at lr
   1e-3. P1: Mixtral-8x7B widths at 2 layers, ``moe_forward_pp`` at
   ``{pp: 2}`` (one layer per stage), 4 sequences of 256 tokens in 2
   microbatches, NLL + 0.01 aux, against the same step at pp=1: the loss
   within 2e-2 relative, every gradient and updated leaf of both stages
   within 2e-2 of its max abs; ms per step at both, the bubble, the
   hand-off's bytes and seconds both ways, each rank's parameter,
   gradient and peak bytes. P2: Llama-3-8B widths at 2 layers, one
   2,048-token sequence, ``llama_forward_sp`` at ``{sp: 2, tp: 1}`` with
   the ring and then Ulysses, gradients summed by ``sync_grads``, each
   against one rank's ``llama_forward`` with dense attention within the
   same tolerances; ms per step, the ring's bytes both ways,
   ``sync_grads``' seconds and bytes. P3: the flash kernel and the decode
   read raise on CUDA inputs that require grad. No kernel launches on P;
   main path Q (after P): meshes from the normal entry points, every rank
   but the caller's started by the port's launcher (``parallel/launch.py``;
   this script starts no rank). Q1: path B's resource (llama3-8b int8,
   paged int8 KV, 64 slots) at ``Q1_LAYERS`` = 4 layers (16, B's, until
   path Z came) at ``mesh: {tp: 2}`` through ``TorchServiceProvider``
   under ``LOCAL_WORLD_SIZE=2`` (two ranks share the card over gloo): B's
   8 prompts, 64 greedy tokens, N1's first-token rule against the streams
   of the same resource without its mesh at the same depth (a reference
   engine of its own), kernels #1 and #3 launched on both ranks; the
   seconds until the engine is ready and ms per step beside the
   reference's. Q2: a slice of 2 pods x 2 local ranks on the card (two ``--q2-pod``
   processes, ``LS_SLICE_HOSTS=2``, ``LS_POD_NAME`` q-0 and q-1, through the
   port's ``maybe_join_slice`` and ``run_slice_follower``), tiny f32 on the
   HF fixture at ``{dp: 2, tp: 2}``: the tokens equal a one-process CPU
   run. Q3: minilm-l6 at ``{dp: 2}`` through the provider's embeddings
   service, within ``TOL_EMBED`` of one rank; then a serving engine that
   joins its world with a ``checkpoint`` that exists on no rank is refused
   by its constructor (``FileNotFoundError``), every rank stays alive and
   the vectors asked for again are equal. Every started rank exits 0
   and no process of it is left;
   main path R (after Q): the tiered stores and the pool roles under a
   mesh, llama3-8b int8 at 1 layer (``R_LAYERS``) at ``{tp: 2}`` through
   ``TorchServiceProvider`` with two local ranks on the card started by the
   launcher (a ``sitecustomize`` on their ``PYTHONPATH`` cuts their depth
   as this process's), each tp=2 run against a tp=1 engine on the same
   weights. R1: paged bf16 KV, the prefix cache and a prefix store (T0 two
   blocks, T1 twelve, a local T2): path I's eight questions on its
   1,536-token preamble at once, 32 greedy tokens; the tiers drain (22
   blocks to T1, the oldest on to T2); the wave again hydrates the chain's
   T2 blocks and promotes its T1 blocks; every rank's promoted rows equal
   its demoted rows byte for byte (``LS_TORCH_TIER_DIGESTS``), kernel #4
   launches on both ranks, the warm streams hold N1's first-token rule
   against the cold ones; the demotion's and promotion's GB/s. R2: paged
   int8 KV, an adapter store of rank 16 with two T0 rows for three
   adapters; 24 requests mixed across base and the adapters, against the
   same wave at tp=1 under the first-token rule (the gaps under each
   request's adapter); an adapter stream differs from its base stream;
   both ranks loaded the same rows; each rank's ``lora_delta`` calls. R3:
   paged int8 KV, a ``pool-role: prefill`` engine at tp=2 exports 8
   requests and closes, a ``pool-role: decode`` engine at tp=1 decodes
   them against a combined tp=2 run (R2's engine, which serves the same
   prompts on the base model in its wave; the first-token rule); the payloads'
   fingerprints equal a tp=1 prefill engine's and their dequantized rows
   are within ``R3_TOL`` of its max abs. Kernels #1-#4 each launch on both
   ranks over R; every started rank exits 0;
   main path S (after R): the port in the cluster, from the manifests of
   the port's k8s factory (``langstream_tpu_torch/k8s/resources.py``). S1:
   at the ``LS_ACCELERATOR`` of the committed install (the operator
   manifest in ``deploy/torch/k8s/`` and the chart's ``values.yaml``, which
   must agree), the StatefulSet of an agent whose device mesh has the card
   count asks for that many ``nvidia.com/gpu``, and that entry's card is
   the one ``torch.cuda.get_device_name(0)`` reports. S2: the
   StatefulSet of the ``h100-2g`` entry (hosts of 2 cards) for a device
   mesh of 4 cards: 2 pods, ``LOCAL_WORLD_SIZE=2``; a manifest whose ranks
   disagree with the resource's mesh is refused in the launcher's words;
   its two pods run as ``--q2-pod`` processes whose env is the runtime
   container's, resolved as a kubelet would (``LS_POD_NAME`` from the
   ``fieldRef``, the coordinator's service name as 127.0.0.1), each
   starting its second rank: llama3-8b int8 weights and int8 paged KV at
   full width and ``S_LAYERS`` layers, ``{dp: 2, tp: 2}``, 8 prompts, 32
   greedy tokens, held to a one-rank engine of the same seed by the
   first-token rule; kernels #1 and #3 on every rank; every rank exits 0.
   S3: S2's slice with the prefix cache and a prefix store (T0 two
   blocks, T1 twelve, a local T2): path I1's eight questions on its
   1,536-token preamble cold, the tiers drained (demotion to T1, a spill
   to T2), the questions again warm (T1 promotion, T2 hydration); on all
   four ranks every promoted block's rows equal a demoted one's byte for
   byte and the tier moves are the leader's; the cold streams held to one
   rank and the warm ones to the cold ones by the first-token rule; the
   demotion's and promotion's GB/s, each rank's launches;
   main path T (after S): the application path without JAX, through the
   port's own ``run``, runner and gateway (``langstream_tpu_torch.cli``,
   ``runtime``, ``gateway``), llama3-8b at ``MAIN_LAYERS``. T1: the
   chat-completions example as it is (its resource: int8 weights, 64
   slots, 2,048 context, ``decode-chunk-light: 8``, ``warmup-on-start``,
   which must have warmed the engine inside the start), the LM head cut to
   printable ASCII as path E's; a wave of ``T_WAVE`` = 8 sessions, each a
   produce socket on ``user-input`` and a consume socket on
   ``bot-output``: every streamed answer equals its answers-topic value
   and the greedy text the port's provider gives directly on the agent's
   engine for the same messages; no ``jax``, ``langstream_tpu``, ``yaml``,
   ``aiohttp`` or ``click`` in ``sys.modules``; the gateway TTFT (produce
   frame to first chunk) beside the engine's TTFT, chunks per answer,
   records per topic. T1b: the ``chatbot-gateway`` example over its
   ``/v1/chat`` route, 4 sessions, chunks joined to each answer. T2:
   ``python -m langstream_tpu_torch.cli run`` as its own process on the
   card with the example at the tiny model (the HF fixture): one question,
   then SIGINT, exit 0. Kernels #1 and #2 launch on T1 and T1b;
   main path U (after T): the control-plane path without JAX, through the
   port's REST control plane, admin client, authenticated gateway and CLI
   (``langstream_tpu_torch.controlplane``, ``admin``, ``auth``, ``cli``),
   llama3-8b at ``MAIN_LAYERS``. U1: the JAX ``run``'s layout in this
   process (``ControlPlaneServer``, ``GatewayServer``, one
   ``LocalComputeRuntime`` over a ``GatewayRegistry``); through
   ``AdminClient`` a tenant, then ``chatbot-gateway`` as it is POSTed as a
   multipart zip with the repository's instance and secrets; ``U_SESSIONS``
   = 4 sessions over ``authenticated-chat``, each with its own HS256 token
   (``sub`` ``u-0``..``u-3``, signed with the secret the deployed app
   resolves), every record carrying its token's ``sub``; no, badly signed
   and expired credentials refused 401 with the topics' counts unmoved;
   ``/flight``, ``/health``, ``/qos``, ``/slo`` and ``/attribution`` carry
   the app's llama3-8b engine, ``/journey`` of one session stitches the
   engine's events, ``/logs`` holds the deploy line; the gateway TTFT
   beside T1b's (their difference: authentication's cost). U2: a PATCH
   with an invalid ``qos:`` refused 400 while the app answers a session; a
   PATCH to ``kv-layout: paged``, ``kv-quantize: int8``, then 4 sessions:
   kernel #3 launches, #2 does not; the card's allocated bytes before U1,
   after the redeploy and after U3 (a report). U3: DELETE, then GET 404 and
   ``/flight`` ``[]``. U4: ``python -m langstream_tpu_torch.cli run
   --api-port P --gateway-port G`` on the card at T2's tiny resource, then
   ``apps list``, ``apps get`` and ``gateway chat ... --credentials`` as
   processes, in the JAX CLI's format and with no ``torch`` loaded; SIGINT
   to ``run``, exit 0. Kernels #1, #2 and #3 launch on U;
   main path V (after U): the cluster path without JAX. ``python -m
   langstream_tpu_torch.cli mini up --device cuda`` as a process (the kube
   API server, the control plane in k8s mode, the operator, the process
   kubelet whose pods run ``python -m serve_torch --device cuda pod``, the
   tpustream broker built from the port's source, the standalone gateway),
   every process of it with an import system that refuses JAX, the JAX
   package, PyYAML, aiohttp, click and cryptography (a ``sitecustomize`` on
   the ``PYTHONPATH`` mini hands its pods, which also cuts llama3-8b to
   ``V_LAYERS`` and the LM head to printable ASCII, as T1 does in this
   process). mini-chat with T1's resource, its chat agent on one card
   (``device-mesh: {tp: 1}``). V1: ``V_WAVE`` = 8 sessions at once over
   ``user-input`` / ``bot-output``, every record crossing the broker twice
   between the pods; the gateway TTFT beside T1's, chunks per answer, each
   streamed answer equal to its answers-topic record. V2: the control
   plane reports the app and both agents DEPLOYED and reads the pods'
   health; the chat pod's ``/healthz`` and ``/ready`` 200, its
   ``/metrics`` carries ``langstream_serving_*``; a profiled wave of 2
   sessions through the pod's ``/profile/start`` and ``/stop`` counts its
   kernels in the trace (#1 and #2 must launch, a multiple of
   ``V_LAYERS`` times). V3: DELETE through the REST API: the StatefulSets
   and Agent CRs go, both pod processes are reaped, the card's free memory
   comes back; SIGINT to mini, exit 0, no process left. The deploy's split
   (setup and deployer Jobs, the Agent CRs DEPLOYED, the chat pod ready)
   and the delete's seconds are printed;
   main path W (after V): the chat app served over Kafka without JAX. The
   port's fake broker (``tests/torch_fake_kafka.py``, loaded by path: no
   Kafka broker runs on the machine) in a thread of this process, SASL
   SCRAM-SHA-256 required; an instance file copying
   ``examples/instances/kafka.yaml`` with the broker's address, the SASL
   properties and ``client: wire``; mini-chat with T1's resource (at
   ``W_LAYERS`` = ``MAIN_LAYERS``, the LM head to printable ASCII) served by
   ``cli.main.LocalRun`` on the card. W1: ``W_WAVE`` = 8 sessions through
   the port's gateway over WebSocket, the gateway TTFT beside T1's, chunks
   per answer, every streamed chunk equal to its stream-topic record and
   the joined chunks to the answers-topic record, both read back from the
   broker's own log, printable ASCII. W2: from the broker's state: every
   declared topic with its partitions, each agent group's committed offset
   at its input topic's end, no dead-letter record, SaslHandshake and
   SaslAuthenticate first on every connection and no failed
   authentication, every (API, version) the broker saw one that the client
   declares. W3: the run stopped and a second ``LocalRun`` started over
   the same broker and instance (its start timed); 2 more questions each
   answered once, no W1 question consumed again. Kernels #1 and #2 must
   launch;
   main path X (after W): the retrieval path without JAX, at ``X_LAYERS``
   = ``MAIN_LAYERS``, the LM heads to printable ASCII, each app on a memory
   broker cluster of its own. X1: an ingestion app (``text-splitter`` →
   ``document-to-json`` → ``compute-ai-embeddings`` (minilm-l6) →
   ``vector-db-sink``) run by ``cli.main.LocalRun`` takes ``X_DOCS`` = 512
   seeded documents of about 2,000 characters into the ``vector-db``
   in-memory store (seconds and chunks per second printed); then a copy of
   ``examples/applications/rag-pipeline`` unchanged, with chat-completions'
   gateways, answers ``X_WAVE`` = 8 questions through the port's gateway:
   the gateway TTFT beside T1's, the engine's TTFT, chunks per answer;
   each answer's ``related`` ids equal a plain numpy top-20 over the
   store's own rows (ties within 1e-6), its ``context`` is 5 of them, its
   joined stream chunks equal its answers-topic record; the multi-query
   kernel must launch if speculation ran verify steps. X2: a copy of
   ``chatbot-rag-memory`` with its SQLite file in a temporary directory,
   whose ``history`` table the ``jdbc-table`` asset creates, over its
   ``/v1/chat`` gateway: ``X_SESSIONS`` = 4 sessions of two turns, each
   second turn's history holding its first, the table's 8 rows equal to
   the streamed answers, the app's own engine completing exactly those 8
   turns. Kernels #1 and #2 must launch;
   main path Y (after X): the document and HTTP agents without JAX, each
   app on a memory broker cluster of its own. Y1: a copy of
   ``long-context-summarizer`` without its ``mesh`` (8 slots, 8,192
   context, paged bf16 KV, ``speculative-drafts: 4``, ``max-tokens: 256``)
   at ``Y_LAYERS`` = ``MAIN_LAYERS``, the LM head to printable ASCII, run
   by ``cli.main.LocalRun``: 8 documents from seed 0, written here with no
   library (two PDFs, one stream compressed; two docx; two HTML; two plain
   texts; 1,000 to 7,500 characters), produced as bytes to
   ``documents-in``; each summary on ``summaries-out`` is the engine's own
   greedy output for the rendered prompt or first differs at a top-2 gap
   under 0.05, the prompt holds ``pdftext``'s or the HTML parser's text of
   the bytes on the CPU, and it is 256 tokens or ends at EOS; per
   document the prompt's tokens, TTFT and seconds, speculation's stats.
   Kernels #1 and #2 must launch, #4 too if verify steps ran. Y2: a copy
   of ``webcrawler-to-vector`` over a site of 16 seeded pages on a stdlib
   ``http.server`` at 127.0.0.1 (``robots.txt`` disallowing a subtree and
   naming a sitemap), the default 500 ms between requests: the pages
   fetched equal a plain breadth-first walk under ``max-depth`` and the
   robots rules, the store holds one row per chunk that extract and split
   give on the CPU, each vector within 1e-4 of the CPU encoder's; pages
   and chunks per second;
   main path Z (after Y): the gRPC sidecar lane without JAX, grpcio or
   protobuf, each app on a memory broker cluster of its own. Z1 (no
   model): the ``grpc-sidecar-agent`` example unchanged through
   ``cli.main.LocalRun``, ``Z_RECORDS`` = 64 records through its sidecar
   interpreter, equal to the in-process ``python-processor`` lane's on the
   same records and class; a ``grpc-agent`` step whose ``endpoint`` is a
   port ``AgentServer`` started here, equal too; a ``grpc-python-source``
   into a ``grpc-python-sink``, every record read written by the sink and
   committed by the source. Z2: a copy of ``chat-completions`` with a
   ``grpc-python-processor`` step first (it trims the question and writes
   one record to a side topic; ``errors: retries``) at ``Z_LAYERS`` =
   ``MAIN_LAYERS``, the LM head to printable ASCII: ``Z_WAVE`` = 8
   sessions at once, each answer the provider's greedy text for the
   trimmed question, 8 side records, the gateway TTFT beside T1's (the
   difference is the sidecar hop's share); kernels #1 and #2 must launch.
   Z3: a second wave, the sidecar killed with SIGKILL after its first
   answer: one restart, every session answered, the seconds from the kill
   to the next record through the sidecar. Z4: an app whose
   ``python/requirements.txt`` names a wheel written here by hand into
   ``python/wheels/``: ``python install-requirements`` provisions its venv
   (its seconds), the sidecar runs on the venv's interpreter and imports
   the wheel's module, which this interpreter cannot, a second call leaves
   the venv as it was; ``apps ui --once --no-open`` serves the port's
   ``app_ui.html`` byte for byte;
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
   interactive one and resumes to its unpreempted tokens; the prefix store
   on paged f32 and int8 KV, where the cold, T1-promoted and T2-hydrated
   streams are one stream on both devices; handoffs whose export is made
   on the card and import on the CPU, and the reverse, equal to CPU->CPU;
   paged f32 and int8 KV under one adapter, equal on both devices and to
   a store-less engine whose weights carry the adapter merged offline;
   the survival plane on paged f32 and int8 KV with the pipelined loop
   under the mixed load: unfaulted, under K1's chaos plan and drained
   mid-wave, one stream on both devices, and a journal written on the card
   replays on the CPU to it; a mixed wave and a chained handoff's local
   fallback, whose greedy tokens and journey kinds per request are the
   same on both devices; dense int8 KV; one wave's scrape, whose series
   change the same on both devices);
6. one ``{"kernels": [...]}`` JSON line (launches summed over paths A-Z,
   rank 0's on N, O, Q, R and S, V's the chat pod's in its profiled window; each row carries a ``tp2_rank`` entry, phase 2's case
   at one tp=2 rank's heads),
   then the last line
   ``{"ok": true, "device": {...}}``.

Weights are random, made from a seed (path E's LM head keeps only the
printable ASCII columns, so its greedy text is not empty), apart from the
tiny HF fixture in the repository; nothing is downloaded.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
TOL_BF16 = 2e-2
#: a bf16 case's error also held against the values' size (:func:`scaled_err`),
#: the plain version run in f32 on the same inputs (its bf16 run rounds the
#: scores and the sums to bf16 and parts from an exact read by up to 2% of a
#: value at ragged lengths: 1.84e-2 and 2.03e-2 at 2,048 rows on an H100
#: 80GB HBM3 at 700 W)
TOL_BF16_SCALED = 2e-2
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


#: depth of the paths at llama3-8b (of its 32 layers, full width), cut for
#: the time limit: with path J the whole smoke took 1,141 s of its 1,200 on
#: a slow host at full depth; F at 8 since path P came (1,085 s); with path
#: R it took 1,181-1,226 s on slow hosts (an H100 80GB HBM3 at 700 W), so
#: every path came down (a path's numbers compare only at one depth).
#: ``MAIN_LAYERS`` holds every llama3-8b engine of the run (A, B, C, M3, T
#: and U-Z at it; the others at their own cut below it). With path T the
#: smoke took 986.9 s, so E came down to 4 (T serves its resource at 16);
#: with path Z, Q1 came down to ``Q1_LAYERS``
MAIN_LAYERS = 16
D_LAYERS = 8
E_LAYERS = 4
F_LAYERS = 4
H_LAYERS = 4
I_LAYERS = 4   # paths I and L2 (L2 serves I2's tokens)
J_LAYERS = 4
K_LAYERS = 8   # K1, K2, K4 and L1 (L1 compares with K1, and at 4 layers its
               # wave no longer breaches L_SLO's 250 ms TTFT; K3's child runs at 8)


@contextlib.contextmanager
def cut_depth(model: str, layers: int):
    """Engines made inside the block serve ``model`` at ``layers`` layers
    (full width): the engine takes the model's shape from its name, so the
    cut goes in through that table while the block runs."""
    from langstream_tpu_torch.serving import engine as engine_module

    full = engine_module._MODEL_CONFIGS[model]
    engine_module._MODEL_CONFIGS[model] = lambda **kw: dataclasses.replace(
        full(**kw), layers=min(full(**kw).layers, layers))
    try:
        yield
    finally:
        engine_module._MODEL_CONFIGS[model] = full


def at_depth(params: dict, layers: int) -> dict:
    """A parameter tree's first ``layers`` layers (views of the stacked
    per-layer weights, int8 ones included); the rest shared."""
    return {**params, "layers": {name: w[:layers] for name, w in params["layers"].items()}}


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


def scaled_err(got, want) -> float:
    """The largest ``|got - want| / (|want| + rms)``, ``rms`` the root mean
    square of ``want``'s row (its last axis): the error held against the
    values' own size. Long causal rows average many values to small
    outputs (about ``sqrt(e / rows)`` at unit scores), which an absolute
    bound of 2e-2 would not see. ``want`` is the plain version in f32."""
    got, want = got.float(), want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    return ((got - want).abs() / (want.abs() + rms).clamp_min(1e-30)).max().item()


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


def _f32(x):
    """A bf16 query or pool as f32 (an int8 pool's ``{"q", "s"}`` as it is)."""
    return x if isinstance(x, dict) else x.float()


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
    out, ref = merge_partial_attention([got]), merge_partial_attention([want])
    err = (out - ref).abs().max().item()
    if not err <= tol:
        fail(f"{name}: normalised max abs error {err} > {tol}")
    rel = None
    if tol == TOL_BF16:
        exact = merge_partial_attention([plain(*map(_f32, (q, kp, vp)), tables, lengths, **kw)])
        rel = scaled_err(out, exact)
        if not rel <= TOL_BF16_SCALED:
            fail(f"{name}: scaled error {rel} > {TOL_BF16_SCALED}")
    return err, rel


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
    rows, at_4096, at_8192 = {}, {}, {}

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
        # long-context-summarizer's pool (path Y1): 8 slots of 64-row blocks
        # ragged to 8,192 rows
        ("paged_attention", "bs64 bf16 8192", paged_attention_partial,
         dict(bs=64, dtype=torch.bfloat16, int8=False, dense=False, max_len=8192, B=8),
         TOL_BF16),
        # one rank's shapes at tp=2 on Llama-3-8B (path N1): H=16, Kh=4
        ("paged_attention", "tp2 bs64 bf16", paged_attention_partial,
         dict(bs=64, dtype=torch.bfloat16, int8=False, dense=False, H=H // 2,
              Kh=Kh // 2), TOL_BF16),
        ("paged_attention_q8", "tp2 bs64 int8", _paged_attention_partial_q8,
         dict(bs=64, dtype=torch.bfloat16, int8=True, dense=False, H=H // 2,
              Kh=Kh // 2), TOL_BF16),
    ]
    per_rank = {}
    for name, label, fn, spec, tol in cases:
        spec = {"max_len": 2048, **spec}
        h, kh, b = spec.pop("H", H), spec.pop("Kh", Kh), spec.pop("B", B)
        case = paged_case(torch, B=b, H=h, Kh=kh, D=D, seed=7, **spec)
        err, rel = check_paged(torch, f"{name} {label}", fn, paged_attention_reference,
                               case, kv_heads=kh, head_dim=D, tol=tol)
        q, kp, vp, tables, lengths, nrb = case
        kw = dict(num_read_blocks=nrb, kv_heads=kh, head_dim=D)
        ms = cuda_ms(torch, lambda: fn(q, kp, vp, tables, lengths, **kw), graph=True)
        eager_ms = cuda_ms(torch, lambda: fn(q, kp, vp, tables, lengths, **kw))
        plain_ms = cuda_ms(torch, lambda: paged_attention_reference(
            q, kp, vp, tables, lengths, **kw), iters=3, warmup=1)
        n_rows = int(lengths.clamp(max=nrb * spec["bs"]).sum())
        elem = 1 if spec["int8"] else (2 if spec["dtype"] == torch.bfloat16 else 4)
        nbytes = (
            2 * n_rows * kh * D * elem + (2 * n_rows * kh * 4 if spec["int8"] else 0)
            + q.numel() * q.element_size() + b * h * (D + 2) * 4
            + tables.numel() * 4 + b * 4
        )
        flops = 4.0 * h * D * n_rows
        peak = BF16_FLOPS_PER_S if spec["dtype"] == torch.bfloat16 else F32_FLOPS_PER_S
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        spans = f"spans={paged_read_splits(nrb, spec['bs'])}"
        if spec["int8"]:  # the int8 read's products: mma.sync for bf16 q, FMAs for f32
            spans += f" kernel={'mma' if spec['dtype'] == torch.bfloat16 else 'fma'}"
        print(f"kernel {name} [{label}] B={b} H={h} Kh={kh} D={D} rows={n_rows} {spans}: "
              f"max_abs_err={err:.3e} scaled_err={rel if rel is None else f'{rel:.3e}'} "
              f"ms={ms:.4f} eager_ms={eager_ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"achieved={nbytes / ms / 1e6:.1f} GB/s by_kernel="
              f"{device_ms_by_kernel(torch, lambda: fn(q, kp, vp, tables, lengths, **kw))}",
              flush=True)
        timing = dict(max_abs_err=err, scaled_err=rel, ms=ms, eager_ms=eager_ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if label in ("bs64 bf16", "bs64 int8"):
            rows[name] = timing
        elif label.endswith("8192"):
            at_8192[name] = {"case": f"{label} B={b} rows={n_rows}", **timing}
        elif label.endswith("4096"):
            at_4096[name] = {"case": label, **timing}
        elif label.startswith("tp2"):
            per_rank[name] = {"case": f"{label} H={h} Kh={kh}", **timing}

    # -- kernel 1: flash prefill ---------------------------------------------
    g = torch.Generator().manual_seed(11)
    full_heads = (H, Kh)
    for S, dtype, tol, label in (
        (512, torch.bfloat16, TOL_BF16, "bf16"),
        (2048, torch.bfloat16, TOL_BF16, "bf16"),
        (4096, torch.bfloat16, TOL_BF16, "bf16"),  # path G's longest bucket
        (8192, torch.bfloat16, TOL_BF16, "bf16"),  # path Y1's longest context
        (512, torch.float32, TOL_F32, "f32"),
        (2048, torch.bfloat16, TOL_BF16, "tp2 bf16"),  # one rank at tp=2 (path N1)
    ):
        H, Kh = (full_heads[0] // 2, full_heads[1] // 2) if label.startswith("tp2") \
            else full_heads
        # the plain version holds B*H*S*S f32 scores (8.6 GB at S=8,192, B=1)
        Bf = {4096: 2, 8192: 1}.get(S, 4)
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
        rel, tail = None, None
        if dtype == torch.bfloat16:
            exact = flash_attention_reference(q.float(), k.float(), v.float(), causal=True)
            rel = scaled_err(got, exact)
            if not rel <= TOL_BF16_SCALED:
                fail(f"flash_attention S={S} {label}: scaled error {rel} > {TOL_BF16_SCALED}")
            if S == 8192:  # the rows past 4,096 alone, against their values' RMS
                d, w = (got.float() - exact)[:, 4096:], exact[:, 4096:]
                tail = dict(max_abs_err=d.abs().max().item(),
                            rms=w.square().mean().sqrt().item(),
                            scaled_err=scaled_err(got[:, 4096:], w))
                del d, w
            del exact
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
              f"max_abs_err={err:.3e} scaled_err={rel if rel is None else f'{rel:.3e}'} "
              f"{f'rows_past_4096={json.dumps(tail)} ' if tail else ''}"
              f"ms={ms:.4f} eager_ms={eager_ms:.4f} "
              f"plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (library err {lib_err:.2e}) "
              f"bound_ms={b_ms:.4f} ({b_by}) "
              f"achieved={flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        timing = dict(max_abs_err=err, scaled_err=rel, ms=ms, eager_ms=eager_ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
        if label.startswith("tp2"):
            per_rank["flash_attention"] = {"case": f"B={Bf} S={S} {label} H={H} Kh={Kh}",
                                           **timing}
        elif S == 2048:
            rows["flash_attention"] = timing
        elif S == 4096:
            at_4096["flash_attention"] = {"case": f"B={Bf} S=4096 bf16", **timing}
        elif S == 8192:
            at_8192["flash_attention"] = {
                "case": f"B={Bf} S=8192 bf16 H={H} Kh={Kh} D={D} causal",
                "rows_past_4096": tail, **timing}
        del q, k, v, got, want, qt, kt, vt, lib_out
        torch.cuda.empty_cache()
    for name, timing in at_4096.items():  # beside each row of the kernels line
        rows[name]["mixtral_4096"] = timing
    for name, timing in per_rank.items():
        rows[name]["tp2_rank"] = timing
    for name, timing in at_8192.items():
        rows[name]["summarizer_8192"] = timing
    return rows


def mq_case(torch, B: int, seed: int, max_len: int = 2048, top: int | None = None):
    """Ragged history over shuffled tables for the multi-query read: B
    slots, starts 0, a sub-block, block-exact and ``top`` (default
    ``max_len - 512``, room for a chunk of 512) among them."""
    bs = 64
    top = max_len - 512 if top is None else top
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
    # long-context-summarizer's verify (path Y1): histories to 8,192 - T rows
    cases["8 at 8192"] = mq_case(torch, 8, 23, max_len=8192, top=8192 - 5)
    row, verify = None, {}
    for B, T, dtype, tol, label in ((8, 16, torch.bfloat16, TOL_BF16, "bf16"),
                                    ("8 at 4096", 64, torch.bfloat16, TOL_BF16, "bf16"),
                                    ("8 at 8192", 5, torch.bfloat16, TOL_BF16, "bf16"),
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
        out, ref = merge_partial_attention([got]), merge_partial_attention([want])
        err = (out - ref).abs().max().item()
        if not err <= tol:
            fail(f"{tag}: normalised max abs error {err} > {tol}")
        rel = None
        if dtype == torch.bfloat16:
            exact = merge_partial_attention([paged_attention_multiquery_reference(
                q.float(), kp.float(), vp.float(), tables, starts_d, **kw)])
            rel = scaled_err(out, exact)
            if not rel <= TOL_BF16_SCALED:
                fail(f"{tag}: scaled error {rel} > {TOL_BF16_SCALED}")
            del exact
        del out, ref
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
              f"max_abs_err={err:.3e} scaled_err={rel if rel is None else f'{rel:.3e}'} "
              f"ms={ms:.4f} eager_ms={eager_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) achieved={flops / ms / 1e9:.1f} TFLOP/s "
              f"by_kernel={device_ms_by_kernel(torch, call)} "
              f"library_ms=none (no PyTorch call returns these partials from a "
              f"block table)", flush=True)
        timing = dict(max_abs_err=err, scaled_err=rel, ms=ms, eager_ms=eager_ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if history == "8 at 8192":
            at_8192 = {"case": f"B=8 T={T} history to {int(starts.max())} bf16", **timing}
        elif history == "8 at 4096":
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
                                           "mixtral_4096": at_4096,
                                           "summarizer_8192": at_8192}}


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
    and idle share of the captured window, and the top kernels. The
    captures record device activity only: host events would double the
    events to parse and the breakdown reads none of them."""
    t_analysis = time.monotonic()
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
             f"kernels={len(kern)} analysis_s={time.monotonic() - t_analysis:.1f}"]
    for g, us in groups.items():
        lines.append(f"profile group {g}: {us / 1e3:.1f} ms ({us / busy:.3f} of busy)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        lines.append(f"profile top {us / 1e3:9.2f} ms  {name[:110]}")
    return "\n".join(lines)


def phase_main_path(torch, label, cfg: dict, params=None, profile=False, note=None):
    """Serve the chat prompts greedy once (and once more under the profiler
    with ``profile``); with ``note``, leave the tokens, ms per step, the
    flight events by kind, the configuration and the results in
    ``NOTES[note]`` (Q1 serves B's configuration from it)."""
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

                with torch_profile(activities=[ProfilerActivity.CUDA],
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
    if note is not None:
        NOTES[note] = {"tokens": [r["tokens"] for r in results], "ms_per_step": step_ms,
                       "events": dict(engine.flight.events_by_type), "config": cfg,
                       "results": results}
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
    NOTES["D"] = {"events": dict(engine.flight.events_by_type), "flips": sp["flips"],
                  "uplift": sp["uplift"]}
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
    with torch_profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
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
    from langstream_tpu_torch.serving.handoff import DeadlineExceeded
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
            NOTES["E"] = {"events": dict(engine.flight.events_by_type)}
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
# path G's depth: 2 of Mixtral-8x7B's 32 layers at the published widths
# (16 when path H joined the smoke, 8 since path I did; a Mixtral step is
# device-bound, so its time and the profiled wave's kernel count follow the
# depth; 2 since path R did)
G_LAYERS = 2


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
        from langstream_tpu_torch.models import llama, moe

        self.torch = torch
        self.sites = [(llama, "_w", "dequant"), (moe, "as_weight", "dequant"),
                      (moe, "moe_ffn", "expert ffn")]
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


# -- path I: KV off the card --------------------------------------------------

I_BLOCKS = 24      # the shared preamble's blocks (of 64 rows) in path I1
I_MAX_TOKENS = 16
I2_MAX_TOKENS = 32


def _preamble(topic: str, n_tokens: int) -> str:
    """An ASCII preamble of exactly ``n_tokens`` byte tokens with the BOS."""
    sentence = (f"You are the {topic} assistant. Answer from the handbook "
                f"below and cite its section. Handbook on {topic}: the team "
                f"keeps records for thirty days, renews access every seven "
                f"days, and escalates outages within one hour. ")
    return (sentence * (n_tokens // len(sentence) + 1))[: n_tokens - 1]


def tier_prompts(block_size: int = 64) -> tuple[list[str], list[str]]:
    """Path I1: eight questions on preamble P (``I_BLOCKS`` full blocks,
    every question shorter than a block, so a prompt's cached chain is the
    preamble), and four questions each on two other preambles Q and R."""
    questions = ("How long are records kept?", "When is access renewed?",
                 "How fast are outages escalated?", "Which section covers access?",
                 "Who approves a renewal?", "Is the handbook binding?",
                 "What counts as an outage?", "Where are records stored?")
    n = I_BLOCKS * block_size
    p = _preamble("storage", n)
    first = [p + f" Question {i}: {q}" for i, q in enumerate(questions)]
    second = [_preamble(topic, n) + f" Question {i}: {q}"
              for topic in ("billing", "networking") for i, q in enumerate(questions[:4])]
    return first, second


def _events_since(engine, seq: int, *kinds) -> list[dict]:
    return [e for e in engine.flight.recent_events(0)
            if e["seq"] > seq and (not kinds or e["kind"] in kinds)]


async def _tiers_settled(engine, timeout_s: float = 120.0) -> bool:
    """Wait until no demotion is pending and the hydrator has nothing in
    flight."""
    for _ in range(int(timeout_s / 0.05)):
        st = engine.stats()["prefixstore"]
        if (not engine._prefix_demote_pending() and not st["t2"]["pending_jobs"]
                and not st["t2"]["in_transit_bytes"]):
            return True
        await asyncio.sleep(0.05)
    return False


def phase_tier_path(torch, params, resource: dict = CHAT_EXAMPLE_RESOURCE,
                    device="cuda") -> dict:
    """Path I1: the chat example's resource with paged int8 KV and a prefix
    store (T0 budget: the preamble and two blocks; T1: three preambles'
    blocks; T2: a local directory). Wave 1: P's question 1 alone (cold),
    then questions 1-7 one at a time (T0 hits). Wave 2: Q's and R's
    questions at once (their chains push P's out of T0, leaf first, into
    T1). Wave 3: P's questions 1-7 again one at a time (the first promotes
    P's blocks from T1). Then engine A's budgets drop to 0 (t0) and 1 byte
    (t1), as for a retiring replica, and every block cascades to T2; a fresh
    engine B on the same weights and directory serves wave 3 from T2
    hydration. T1 holds all of wave 2's demotions, so each tier's TTFT is
    its own: were P split between T1 and T2, hydration's pinned entries
    would push P's unpinned T1 entries to T2, and the promotion stops at
    that gap in the chain (the JAX package's rule). One request at a time,
    so the T0 hits and the promoted and hydrated runs prefill the same
    shapes. Fails unless waves 3 on A and B give the T0 hits' greedy tokens,
    the tier ledgers balance, one fetch per chunk and idle block managers."""
    import tempfile

    from langstream_tpu_torch.serving.engine import (
        _MODEL_CONFIGS,
        ServingConfig,
        TorchServingEngine,
    )

    base = dict(resource["configuration"])
    base.update({"kv-layout": "paged", "kv-quantize": "int8", "prefix-cache": True})
    bs = int(base.get("kv-block-size", 64))
    first, second = tier_prompts(bs)
    t2_dir = tempfile.mkdtemp(prefix="ls-prefix-t2-")
    # one block of the int8 pool: K and V, every layer, int8 rows and f32
    # scales per KV head
    mc = _MODEL_CONFIGS[base["model"]](max_seq_len=int(base["max-seq-len"]))
    block_bytes = 2 * mc.layers * bs * (mc.kv_heads * mc.head_dim + 4 * mc.kv_heads)
    store = {"t0-bytes": (I_BLOCKS + 2) * block_bytes, "t1-bytes": 3 * I_BLOCKS * block_bytes,
             "t2": {"type": "local", "path": t2_dir}, "t2-rescan-s": 0.2,
             "hydrate-timeout-s": 60.0}
    cfg = {**base, "prefix-store": store}
    opts = {"max-tokens": I_MAX_TOKENS, "temperature": 0}
    label = "I1 tiers"

    async def one(engine, prompt):
        r = await engine.generate(prompt, dict(opts))
        if not r["tokens"] or not all(math.isfinite(x) for x in r["logprobs"]):
            fail(f"{label}: empty or non-finite result")
        return r

    def tier_counts(engine):
        st = engine.stats()["prefixstore"]
        return {k: st[k] for k in ("promotions", "hydrations", "demotions_t0_t1",
                                   "demotions_t1_t2")} | {"t1_hits": st["t1"]["hits"]}

    engine_a = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)
    if engine_a._kv_block_bytes != block_bytes:
        fail(f"{label}: block bytes {engine_a._kv_block_bytes} != {block_bytes}")
    out: dict = {}

    async def run_a():
        try:
            cold = await one(engine_a, first[1])
            hits = [await one(engine_a, p) for p in first[1:]]
            if engine_a.prefix_hits < len(hits):
                fail(f"{label}: wave 1's repeats made {engine_a.prefix_hits} T0 hits")
            seq = engine_a.flight.recent_events(1)[-1]["seq"]
            t_w2 = time.monotonic()
            await asyncio.gather(*(one(engine_a, p) for p in second))
            if not await _tiers_settled(engine_a):
                fail(f"{label}: the demotion after wave 2 did not settle")
            w2_s = time.monotonic() - t_w2
            st = engine_a.stats()["prefixstore"]
            demoted = _events_since(engine_a, seq, "prefix-demote")
            p_chain = engine_a.block_mgr.chain_digests(engine_a.tokenizer.encode(first[1]))
            p_in_t0 = sum(engine_a.block_mgr.prefix_has(d) for d in p_chain)
            out["after_wave2"] = {
                "p_blocks_in_t0": p_in_t0, "p_blocks": len(p_chain),
                "p_blocks_in_t1": sum(engine_a.prefix_store.t1_has(d.hex()) for d in p_chain),
                "p_blocks_in_t2": sum(engine_a.prefix_store.t2_has(d.hex()) for d in p_chain),
                "demote_events": len(demoted), "wave2_s": round(w2_s, 3),
                "demote_fetches": st["t0"]["demote_fetches"],
                "demote_seconds": st["t0"]["demote_seconds"],
                "demoted_bytes": st["demotions_t0_t1"] * block_bytes,
            }
            if p_in_t0 == len(p_chain):
                fail(f"{label}: wave 2 demoted none of P's blocks: {out['after_wave2']}")
            seq = engine_a.flight.recent_events(1)[-1]["seq"]
            before = tier_counts(engine_a)
            warm = [await one(engine_a, p) for p in first[1:]]
            after = tier_counts(engine_a)
            promoted = _events_since(engine_a, seq, "prefix-promote")
            hydrated = _events_since(engine_a, seq, "prefix-hydrate")
            if after["promotions"] == before["promotions"] or hydrated:
                fail(f"{label}: wave 3 must promote from T1 alone ({before} -> {after}, "
                     f"hydration events {hydrated})")
            # the retiring replica: every prefix block down to T2
            engine_a.prefix_store.spec = dataclasses.replace(
                engine_a.prefix_store.spec, t0_bytes=0, t1_bytes=1)
            engine_a._wake.set()
            for _ in range(2400):
                st = engine_a.stats()["prefixstore"]
                if (st["t0"]["blocks"] == 0 and st["t1"]["entries"] == 0
                        and not st["t2"]["pending_jobs"] and not st["t2"]["in_transit_bytes"]):
                    break
                await asyncio.sleep(0.05)
            else:
                fail(f"{label}: engine A did not drain to T2: {st}")
            out.update(cold=cold, hits=hits, warm=warm, promoted=promoted,
                       hydrated=hydrated, tiers_wave3=(before, after),
                       stats_a=engine_a.stats())
        finally:
            await engine_a.close()

    reset_counts()
    t0 = time.monotonic()
    asyncio.run(run_a())
    stats_a = out["stats_a"]
    if stats_a["kv"]["reserved_blocks"] or engine_a.block_mgr.stats()["live_blocks"]:
        fail(f"{label}: engine A's block manager is not idle: {engine_a.block_mgr.stats()}")
    del engine_a
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    engine_b = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)

    async def run_b():
        try:
            if not engine_b.prefix_store.flush(60):
                fail(f"{label}: engine B's first T2 scan did not finish")
            engine_b.prefix_store.apply_results()
            out["t2_known"] = engine_b.stats()["prefixstore"]["t2"]["entries"]
            out["hydrate"] = [await one(engine_b, p) for p in first[1:]]
            out["stats_b"] = engine_b.stats()
            out["hydrate_events"] = _events_since(engine_b, 0, "prefix-hydrate")
        finally:
            await engine_b.close()

    asyncio.run(run_b())
    wall = time.monotonic() - t0
    counts = read_counts()
    if engine_b.block_mgr.stats()["reserved_blocks"] or engine_b.block_mgr.stats()["live_blocks"]:
        fail(f"{label}: engine B's block manager is not idle: {engine_b.block_mgr.stats()}")
    stats_b = out["stats_b"]
    del engine_b
    gc.collect()

    # the T0 hits (P's questions 1-7) are the reference
    ref = [r["tokens"] for r in out["hits"]]
    warm_tokens = [r["tokens"] for r in out["warm"]]
    hyd_tokens = [r["tokens"] for r in out["hydrate"]]
    if warm_tokens != ref:
        fail(f"{label}: T1-promoted greedy tokens differ from the T0 hits:\n{warm_tokens}\n{ref}")
    if hyd_tokens != ref:
        fail(f"{label}: T2-hydrated greedy tokens differ from the T0 hits:\n{hyd_tokens}\n{ref}")
    cold_t, hit_t = out["cold"]["tokens"], out["hits"][0]["tokens"]
    common = next((i for i, (a, b) in enumerate(zip(cold_t, hit_t)) if a != b),
                  min(len(cold_t), len(hit_t)))
    for name, st in (("A", stats_a), ("B", stats_b)):
        ps = st["prefixstore"]
        ledger = ps["ledger"]
        resident = ledger["t1_bytes"] + ledger["in_transit_bytes"] + ledger["t2_bytes"]
        flows = (ledger["inserted_bytes"] + ledger["discovered_bytes"]
                 - ledger["taken_bytes"] - ledger["evicted_bytes"])
        if resident != flows:
            fail(f"{label}: engine {name}'s tier ledger does not balance: {ledger}")
        if st["decode-chunks"]["host_fetches_per_chunk"] != 1.0:
            fail(f"{label}: engine {name} host_fetches_per_chunk "
                 f"{st['decode-chunks']['host_fetches_per_chunk']} != 1.0")
    ps_b = stats_b["prefixstore"]
    if ps_b["hydrations"] == 0 or ps_b["fingerprint_refusals"]:
        fail(f"{label}: engine B hydrated nothing from T2: {ps_b}")
    if device == "cuda" and (counts["flash_attention"] == 0
                             or counts["paged_attention_q8"] == 0):
        fail(f"{label}: flash and the int8 read must launch: {counts}")

    def ms(x):
        return round(x * 1e3, 3)

    aw2 = out["after_wave2"]
    demote_gbps = (aw2["demoted_bytes"] / aw2["demote_seconds"] / 1e9
                   if aw2["demote_seconds"] else float("nan"))
    prom_bytes = sum(e["bytes"] for e in out["promoted"])
    prom_ms = sum(e["device_ms"] for e in out["promoted"])
    fetched = [e for e in out["hydrate_events"] if e.get("stage") == "fetched"]
    begin = [e for e in out["hydrate_events"] if e.get("stage") == "begin"]
    done = [e for e in out["hydrate_events"] if e.get("stage") in ("done", "timeout")]
    hyd_bytes = sum(e["bytes"] for e in fetched)
    hyd_wait = (done[0]["m_s"] - begin[0]["m_s"]) if begin and done else float("nan")
    hit_ttft = sorted(r["ttft"] for r in out["hits"])
    print(f"path [{label}]: wall_s={wall:.3f} block_bytes={block_bytes} "
          f"preamble_blocks={I_BLOCKS} ttft_s cold={out['cold']['ttft']:.4f} "
          f"t0_hit median={hit_ttft[len(hit_ttft) // 2]:.4f} "
          f"t1_promote={out['warm'][0]['ttft']:.4f} "
          f"t2_hydrate={out['hydrate'][0]['ttft']:.4f} "
          f"cold_vs_t0_common_prefix={common}/{len(cold_t)}", flush=True)
    print(f"path [{label}]: after wave 2 {aw2}; demote {aw2['demoted_bytes']} bytes in "
          f"{aw2['demote_fetches']} fetches, {ms(aw2['demote_seconds'])} ms waited, "
          f"{demote_gbps:.3f} GB/s device->host", flush=True)
    print(f"path [{label}]: wave 3 tiers {out['tiers_wave3']}; promote "
          f"{prom_bytes} bytes in {len(out['promoted'])} scatters, {prom_ms:.3f} ms on the "
          f"card, {prom_bytes / prom_ms / 1e6 if prom_ms else float('nan'):.3f} GB/s "
          f"host->device; wave 3 hydration events "
          f"{[e.get('stage') for e in out['hydrated']]}", flush=True)
    print(f"path [{label}]: engine B: {out['t2_known']} T2 blobs known; hydrate {hyd_bytes} "
          f"bytes in {len(fetched)} blobs, stash {ms(hyd_wait) if begin else 'n/a'} ms; "
          f"then promote {ps_b['promotions']} run(s); greedy tokens of T1 promotion and T2 "
          f"hydration equal the T0 hits ({len(ref)} requests x {I_MAX_TOKENS} tokens); "
          f"launches={counts}", flush=True)
    print(f"path [{label}]: stats()['prefixstore'] engine A "
          f"{json.dumps(stats_a['prefixstore'], sort_keys=True)}", flush=True)
    print(f"path [{label}]: stats()['prefixstore'] engine B "
          f"{json.dumps(ps_b, sort_keys=True)}", flush=True)
    return counts


def i2_prompts() -> list[str]:
    return chat_prompts() + [
        "Name a planet with rings.", "What does HBM stand for?",
        "Give an antonym of 'early'.", "Count from one to five.",
        "Describe a paged KV cache briefly.", "Which ocean is the largest?",
        "Spell 'kernel' backwards.", "What is two plus two?",
    ]


def phase_handoff_path(torch, params, resource: dict = CHAT_EXAMPLE_RESOURCE,
                       device="cuda", dec_faults=None) -> tuple:
    """Path I2: the chat example's resource with paged bf16 KV as a
    ``combined`` engine, then as a ``pool-role: prefill`` engine whose 16
    exports (``take_export``) land in a ``pool-role: decode`` engine
    (``import_handoff``), all three on the same weights: bf16 rows through
    the wire as raw 2-byte words. The 16 arrive together at every engine, so
    the prefill batches and the decode chunks are the same; the decoded
    greedy tokens must equal the combined engine's. With ``dec_faults``
    (path K2) the decode engine is armed with them and must also shrink its
    budget at an injected ``scatter`` failure and serve every import. Returns
    the launch counts and the combined engine's greedy tokens (path L2
    holds its chained handoffs to them)."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    base = {k: v for k, v in resource["configuration"].items() if k != "warmup-on-start"}
    base.update({"kv-layout": "paged", "prefix-cache": False})
    prompts = i2_prompts()
    opts = {"max-tokens": I2_MAX_TOKENS, "temperature": 0}
    label = "K2 scatter fault on the decode pool" if dec_faults else "I2 pool roles"

    def make(role):
        extra = {"faults": dec_faults} if dec_faults and role == "decode" else {}
        return TorchServingEngine(ServingConfig.from_dict({**base, "pool-role": role, **extra}),
                                  device=device, params=params)

    reset_counts()
    t0 = time.monotonic()
    combined = make("combined")

    async def run_combined():
        try:
            return await asyncio.gather(*(combined.generate(p, dict(opts)) for p in prompts))
        finally:
            await combined.close()

    want = asyncio.run(run_combined())
    del combined
    gc.collect()
    pre, dec = make("prefill"), make("decode")

    async def run_pair():
        try:
            tickets = await asyncio.gather(*(pre.generate(p, dict(opts)) for p in prompts))
            payloads = [pre.take_export(t["handoff"]) for t in tickets]
            t_imp = time.monotonic()
            got = await asyncio.gather(*(dec.import_handoff(p) for p in payloads))
            return (tickets, payloads, got, time.monotonic() - t_imp,
                    _events_since(pre, 0, "kv-export"), _events_since(dec, 0, "kv-import"),
                    pre.stats(), dec.stats(), dec.flight.recent_events(0))
        finally:
            await pre.close()
            await dec.close()

    (tickets, payloads, got, import_wall, exports, imports, st_pre, st_dec,
     dec_events) = asyncio.run(run_pair())
    wall = time.monotonic() - t0
    counts = read_counts()
    for name, engine in (("prefill", pre), ("decode", dec)):
        bm = engine.block_mgr.stats()
        if bm["reserved_blocks"] or bm["live_blocks"]:
            fail(f"{label}: the {name} engine's block manager is not idle: {bm}")
    fp = pre.kv_fingerprint()
    del pre, dec
    gc.collect()
    if fp["dtype"] != "bfloat16":
        fail(f"{label}: the pools must hold bf16 rows, fingerprint {fp}")
    if any(t["finish_reason"] != "handoff" for t in tickets):
        fail(f"{label}: the prefill engine must answer with handoff tickets")
    got_t, want_t = [r["tokens"] for r in got], [r["tokens"] for r in want]
    if got_t != want_t:
        diffs = [i for i, (a, b) in enumerate(zip(got_t, want_t)) if a != b]
        fail(f"{label}: decoded greedy tokens differ from the combined engine's at "
             f"requests {diffs}")
    if st_dec["kvtransfer"]["imports"] != len(prompts) or (
            device == "cuda" and counts["paged_attention"] == 0):
        fail(f"{label}: {st_dec['kvtransfer']} imports, launches {counts}")
    if st_dec["decode-chunks"]["host_fetches_per_chunk"] != 1.0:
        fail(f"{label}: host_fetches_per_chunk != 1.0")
    if dec_faults:
        survival = st_dec["survival"]
        shrinks = [e for e in dec_events if e["kind"] == "pool-shrink"]
        if (survival["shrinks"] < 1 or [e["site"] for e in shrinks][:1] != ["scatter"]
                or any(f["fired"] != f["count"] for f in survival["faults"])):
            fail(f"{label}: the scatter failure must shrink the budget: {survival}, {shrinks}")
        print(f"path K [{label}]: shrinks={survival['shrinks']} at "
              f"{[e['site'] for e in shrinks]}, every import served", flush=True)
    sizes = sorted(len(p) for p in payloads)
    exp_ms = sorted(e["ms"] for e in exports)
    exp_dev = sorted(e["device_ms"] for e in exports)
    imp_ms = sorted(e["ms"] for e in imports)
    imp_dev = sorted(e["device_ms"] for e in imports)
    total = sum(sizes)
    print(f"path [{label}]: wall_s={wall:.3f} requests={len(prompts)} dtype={fp['dtype']} "
          f"payload_bytes min={sizes[0]} max={sizes[-1]} total={total} "
          f"export_ms min={exp_ms[0]:.3f} max={exp_ms[-1]:.3f} (fetch {exp_dev[0]:.3f}-"
          f"{exp_dev[-1]:.3f}, {total / sum(exp_dev) / 1e6:.3f} GB/s device->host) "
          f"import_ms min={imp_ms[0]:.3f} max={imp_ms[-1]:.3f} (scatter {imp_dev[0]:.3f}-"
          f"{imp_dev[-1]:.3f}, {total / sum(imp_dev) / 1e6:.3f} GB/s host->device) "
          f"import_wall_s={import_wall:.3f}; greedy tokens equal the combined engine's "
          f"({len(prompts)} x <= {I2_MAX_TOKENS}); launches={counts}", flush=True)
    return counts, want_t


# ---------------------------------------------------------------------------
# path J: multi-LoRA serving
# ---------------------------------------------------------------------------

J_RANK = 16
J_T0_ENTRIES = 4
J_NAMES = tuple(f"tenant-j{m}" for m in range(1, 7))  # j1-j3 installed, j4-j6 in T2 only
J_MAX_TOKENS = 64        # the load waves
J_CHECK_TOKENS = 12      # the one-at-a-time checks
J2_MAX_TOKENS = 48


def j_arrays(mc, name: str) -> dict:
    """Adapter ``tenant-jm``'s factors: ``make_lora_arrays(..., seed=100 +
    m, scale=0.5)`` at the model's widths (f32 on the host)."""
    from langstream_tpu_torch.serving.adapters import make_lora_arrays

    return make_lora_arrays(layers=mc.layers, hidden=mc.hidden, heads=mc.heads,
                            kv_heads=mc.kv_heads, head_dim=mc.head_dim, rank=J_RANK,
                            seed=100 + int(name[len("tenant-j"):]), scale=0.5)


def j_prompts() -> list[str]:
    """64 distinct prompts of 200-600 byte tokens."""
    filler = ("Customer ticket: the upload of a large archive stalls at ninety "
              "percent and the client retries forever; logs show timeouts. ") * 8
    return [f"Request {i:02d}. " + filler[: 200 + (i * 53) % 401] for i in range(64)]


def j_mix(n: int = 64) -> list[str]:
    """The load wave's adapters: every fourth request base, the other 48
    cycling over the six adapters (8 each)."""
    out, k = [], 0
    for i in range(n):
        if i % 4 == 3:
            out.append("")
        else:
            out.append(J_NAMES[k % len(J_NAMES)])
            k += 1
    return out


class _LoraRanges:
    """While active, ``lora_delta`` runs inside a ``record_function`` range
    (``lora:delta``), so a profiler attributes its kernels."""

    def __init__(self, torch):
        from langstream_tpu_torch.models import llama

        self.torch, self.llama, self.real = torch, llama, llama.lora_delta

    def __enter__(self):
        record, real = self.torch.profiler.record_function, self.real

        def ranged(*args):
            with record("lora:delta"):
                return real(*args)

        self.llama.lora_delta = ranged
        return self

    def __exit__(self, *exc):
        self.llama.lora_delta = self.real


def lora_decode_profile(torch, engine, ids, steps: int = 2) -> str:
    """A profiled window of the engine's decode program at its shapes (all
    slots active at 400 history rows, read through scratch tables, the
    commit to the scratch block): ``steps`` fused steps with the engine's
    adapters at ``ids``, then the same without adapters. Prints the
    kernels per step of each, the ``lora_delta`` kernels and their device
    time, and the deltas' share of the adapter step's busy time."""
    import numpy as np
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from langstream_tpu_torch.models.llama_paged import llama_decode_chunk_paged

    B, dev = engine.config.slots, engine.device
    mc = engine.model_config
    tokens0 = torch.full((B,), 65, dtype=torch.int64, device=dev)
    lengths = torch.full((B,), 400, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    tables = torch.zeros((B, engine.paged_layout.max_blocks_per_slot), dtype=torch.int32,
                         device=dev)
    nrb = engine._read_blocks_for(400 + steps)
    sample_fn = engine._sample_fn(torch.zeros(B, device=dev), torch.zeros(B, dtype=torch.int32,
                                  device=dev), torch.ones(B, device=dev), (False, False, True))
    adapters = engine._adapters_device(np.asarray(ids, dtype=np.int32))
    record = torch.profiler.record_function
    cuda_dev = dev.type == "cuda"  # the CPU rehearsal has no kernels to count
    sync = torch.cuda.synchronize if cuda_dev else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda_dev else [])

    def chunk(ad):
        return llama_decode_chunk_paged(mc, engine.params, tokens0, lengths, active,
                                        engine.cache_k, engine.cache_v, tables, sample_fn,
                                        steps, num_read_blocks=nrb, return_packed=True,
                                        adapters=ad)

    with torch.no_grad():
        chunk(adapters), chunk(None)  # settle the allocator
        sync()
        with _LoraRanges(torch), torch_profile(activities=activities) as prof:
            for name, ad in (("lora:with", adapters), ("lora:without", None)):
                with record(name):
                    chunk(ad)
                sync()
    t0 = time.monotonic()
    cuda = torch.autograd.DeviceType.CUDA

    def subtree_kernels(e):
        yield from e.kernels
        for ch in e.cpu_children:
            yield from subtree_kernels(ch)

    def collect(name):
        ks = [k for e in prof.events() if e.device_type != cuda and e.name == name
              for k in subtree_kernels(e)]
        return len(ks), sum(k.duration for k in ks)

    with_n, with_us = collect("lora:with")
    without_n, without_us = collect("lora:without")
    lora_n, lora_us = collect("lora:delta")
    return (f"lora decode profile (B={B}, {steps} steps, 400 rows, adapter rows "
            f"{sorted(set(int(i) for i in ids))}): kernels per step with adapters "
            f"{with_n / steps:.0f} (busy {with_us / steps / 1e3:.3f} ms), without "
            f"{without_n / steps:.0f} (busy {without_us / steps / 1e3:.3f} ms); lora_delta "
            f"{lora_n / steps:.0f} kernels per step, {lora_us / steps / 1e3:.3f} ms busy, "
            f"{lora_us / with_us if with_us else float('nan'):.4f} of the adapter step's busy "
            f"time; per K=32 chunk {32 * with_n / steps:.0f} launches with adapters, "
            f"{32 * without_n / steps:.0f} without; analysis_s={time.monotonic() - t0:.1f}")


def phase_lora_path(torch, params, resource: dict = CHAT_EXAMPLE_RESOURCE,
                    device="cuda") -> dict:
    """Path J1: mixed-adapter traffic and the adapter tiers at Llama-3-8B
    int8 on path A's params. The chat example's resource with paged int8 KV
    (the prefix cache off, so every comparison below runs one path) and an
    ``adapter-store`` of rank 16, four T0 rows, T1 for four adapters' f32
    factors and a local T2 directory; six adapters, three installed locally
    and three published to T2 alone (as another replica would).

    A load wave of 64 (200-600 tokens, 64 generated, greedy): 48 requests
    over the six adapters, 16 base; then the same 64 prompts on a
    store-less engine. Per wave ms per step, decode tok/s, TTFT by kind
    (the adapter's tier when the request first resolved: T0 hit, T1 -> T0
    load, T2 hydrate; base), peak memory; row loads and hydrations from the
    flight events; a profiled decode window with ``lora_delta`` in a
    range. Soft: printed only.

    Hard, one request at a time (so batches are equal between the runs
    compared): (a) 8 base prompts on the adapter engine equal the
    store-less engine's tokens; (b) 4 prompts under a T2-hydrated adapter
    equal the same adapter installed locally on a fresh engine; (c) an
    adapter evicted and reloaded into another T0 row gives its earlier
    tokens; (d) the adapter changes the tokens of at least one of the 8
    prompts. An unknown adapter is refused with ``AdapterUnavailable``; the
    adapter ledger balances, no pin is left, the block managers end idle."""
    import tempfile

    from langstream_tpu_torch.serving.adapters import AdapterUnavailable, publish_adapter
    from langstream_tpu_torch.serving.engine import (
        _MODEL_CONFIGS,
        ServingConfig,
        TorchServingEngine,
    )

    label = "J1 adapters"
    # no warmup (as path I2): paths A-I ran the kernels and grew the
    # allocator already, and every engine here serves the same shapes
    base = {k: v for k, v in resource["configuration"].items() if k != "warmup-on-start"}
    base.update({"kv-layout": "paged", "kv-quantize": "int8", "prefix-cache": False})
    t2 = {"type": "local", "path": tempfile.mkdtemp(prefix="ls-adapter-t2-")}
    prompts = j_prompts()
    checks = prompts[:8]
    opts = {"max-tokens": J_MAX_TOKENS, "temperature": 0}
    copts = {"max-tokens": J_CHECK_TOKENS, "temperature": 0}

    def make(store: bool):
        cfg = dict(base)
        if store:
            cfg["adapter-store"] = store_cfg
        return TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)

    store_cfg = {"rank": J_RANK, "t0-entries": J_T0_ENTRIES, "t2": t2, "t2-rescan-s": 0.2,
                 "hydrate-timeout-s": 60.0}
    reset_counts()
    t_start = time.monotonic()
    mc = _MODEL_CONFIGS[base["model"]](max_seq_len=int(base["max-seq-len"]))
    arrays = {n: j_arrays(mc, n) for n in J_NAMES}
    per_f32 = int(sum(a.nbytes for a in arrays[J_NAMES[0]].values()))
    store_cfg["t1-bytes"] = 4 * per_f32
    eng = make(True)
    st0 = eng.adapter_store
    # one T0 row holds the factors in the model dtype (bf16: half the f32 bytes)
    width = torch.empty((), dtype=eng.model_config.dtype).element_size()
    if st0.entry_bytes != per_f32 // 4 * width or st0.entry_bytes * (J_T0_ENTRIES + 1) != sum(
            t.numel() * t.element_size() for t in eng._ad_layers.values()):
        fail(f"{label}: entry bytes {st0.entry_bytes} against f32 {per_f32}")
    for n in J_NAMES[:3]:
        eng.install_adapter(n, arrays[n])
    for n in J_NAMES[3:]:
        publish_adapter(t2, n, arrays[n], eng.adapter_fingerprint())
    kinds: dict = {}
    real_resolve = eng._resolve_adapter

    async def resolve(loop, request):
        store = eng.adapter_store
        key = tuple(request.prompt_tokens[:12])
        if key not in kinds:
            kinds[key] = ("t0-hit" if request.adapter in store.t0_resident() else
                          "t1-load" if store.t1_has(request.adapter) else "t2-hydrate")
        return await real_resolve(loop, request)

    eng._resolve_adapter = resolve
    out: dict = {}

    async def one(engine, prompt, adapter=""):
        r = await engine.generate(prompt, {**copts, **({"adapter": adapter} if adapter else {})})
        if not r["tokens"] or not all(math.isfinite(x) for x in r["logprobs"]):
            fail(f"{label}: empty or non-finite result")
        return r["tokens"]

    async def wave(engine, name, adapters):
        torch.cuda.reset_peak_memory_stats() if device == "cuda" else None
        before = engine.stats()
        t = time.monotonic()
        results = await asyncio.gather(*(
            engine.generate(p, {**opts, **({"adapter": a} if a else {})})
            for p, a in zip(prompts, adapters)))
        wall = time.monotonic() - t
        await engine.settled()
        for i, r in enumerate(results):
            if not 0 < len(r["tokens"]) <= J_MAX_TOKENS or not all(
                    math.isfinite(x) for x in r["logprobs"]):
                fail(f"{label}: {name} request {i} returned {len(r['tokens'])} tokens")
        print(_wave_line(f"J1 {name}", before, engine.stats(), results, wall,
                         _peak_gb(torch, device)), flush=True)
        return results

    async def run_adapter_engine():
        try:
            ads = eng.adapter_store
            for _ in range(600):  # the hydrator's rescan finds the published blobs
                ads.apply_results()
                if all(ads.known(n) for n in J_NAMES):
                    break
                await asyncio.sleep(0.05)
            if not all(ads.known(n) for n in J_NAMES):
                fail(f"{label}: adapters unknown to the store: {ads.stats()}")
            mix = j_mix(len(prompts))
            results = await wave(eng, "load wave, 48 adapter + 16 base requests", mix)
            by_kind: dict = {}
            for p, a, r in zip(prompts, mix, results):
                key = tuple(eng.tokenizer.encode(p)[:12])
                by_kind.setdefault(kinds.get(key, "base") if a else "base", []).append(r["ttft"])
            out["ttft_by_kind"] = {k: (len(v), round(sorted(v)[len(v) // 2], 4),
                                       round(max(v), 4)) for k, v in sorted(by_kind.items())}
            out["wave_events"] = _events_since(eng, 0, "adapter-load", "adapter-hydrate",
                                               "adapter-evict", "adapter-demote")
            store = eng.adapter_store
            rows = [store.t0_resident()[n] for n in sorted(store.t0_resident())]
            ids = [0 if i % 4 == 3 else rows[i % len(rows)] for i in range(eng.config.slots)]
            out["profile"] = lora_decode_profile(torch, eng, ids)
            # (a) and (d): 8 prompts base, then under tenant-j1
            out["a_adapter_engine"] = [await one(eng, p) for p in checks]
            out["d_adapter"] = [await one(eng, p, J_NAMES[0]) for p in checks]
            # (c): evict j1, then reload it into another row
            store = eng.adapter_store
            row_before = store.t0_resident()[J_NAMES[0]]
            others = [n for n in J_NAMES if n != J_NAMES[0]]
            for step in range(24):
                resident = store.t0_resident()
                nxt = (store._rows_free[-1] if store._rows_free
                       else next(iter(store._t0.values())))
                if J_NAMES[0] not in resident and nxt != row_before:
                    break
                await eng.generate(checks[0], {"max-tokens": 1, "adapter": others[step % 5]})
            else:
                fail(f"{label}: could not evict {J_NAMES[0]} to another row")
            out["c_reload"] = [await one(eng, p, J_NAMES[0]) for p in checks[:2]]
            out["c_rows"] = (row_before, store.t0_resident()[J_NAMES[0]])
            # (b): a T2-hydrated adapter (j4, hydrated in the load wave)
            out["b_hydrated"] = [await one(eng, p, J_NAMES[3]) for p in checks[:4]]
            try:
                await eng.generate(checks[0], {**copts, "adapter": "tenant-unknown"})
                fail(f"{label}: an unknown adapter was served")
            except AdapterUnavailable as e:
                out["unknown"] = str(e)
            out["stats_ad"] = eng.stats()
            out["load_events"] = _events_since(eng, 0, "adapter-load")
            out["hydrate_events"] = _events_since(eng, 0, "adapter-hydrate")
        finally:
            await eng.close()

    asyncio.run(run_adapter_engine())
    st_ad = out["stats_ad"]
    bm = eng.block_mgr.stats()
    if bm["reserved_blocks"] or bm["live_blocks"]:
        fail(f"{label}: the adapter engine's block manager is not idle: {bm}")
    del eng
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    plain = make(False)

    async def run_plain():
        try:
            await wave(plain, "the same 64 prompts on a store-less engine", [""] * len(prompts))
            out["a_plain"] = [await one(plain, p) for p in checks]
            out["stats_plain"] = plain.stats()
        finally:
            await plain.close()

    asyncio.run(run_plain())
    del plain
    gc.collect()
    local = make(True)  # fresh, same T2 directory: j4 installed locally

    async def run_local():
        try:
            local.install_adapter(J_NAMES[3], arrays[J_NAMES[3]])
            out["b_local"] = [await one(local, p, J_NAMES[3]) for p in checks[:4]]
            out["stats_local"] = local.stats()
        finally:
            await local.close()

    asyncio.run(run_local())
    wall = time.monotonic() - t_start
    counts = read_counts()
    del local
    gc.collect()

    if out["a_adapter_engine"] != out["a_plain"]:
        fail(f"{label} (a): base prompts on the adapter engine differ from the store-less "
             f"engine:\n{out['a_adapter_engine']}\n{out['a_plain']}")
    if out["b_hydrated"] != out["b_local"]:
        fail(f"{label} (b): T2-hydrated tokens differ from the locally installed "
             f"adapter's:\n{out['b_hydrated']}\n{out['b_local']}")
    if out["c_rows"][0] == out["c_rows"][1] or out["c_reload"] != out["d_adapter"][:2]:
        fail(f"{label} (c): reload into row {out['c_rows']} gave {out['c_reload']} against "
             f"{out['d_adapter'][:2]}")
    differ = sum(a != b for a, b in zip(out["d_adapter"], out["a_adapter_engine"]))
    if differ == 0:
        fail(f"{label} (d): the adapter changed none of the 8 prompts' tokens")
    ads = st_ad["adapters"]
    ledger = ads["ledger"]
    if (ledger["t1_bytes"] + ledger["in_transit_bytes"] + ledger["t2_bytes"]
            != ledger["inserted_bytes"] + ledger["discovered_bytes"] - ledger["evicted_bytes"]):
        fail(f"{label}: the adapter ledger does not balance: {ledger}")
    if ads["t0"]["pinned"] or out["stats_local"]["adapters"]["t0"]["pinned"]:
        fail(f"{label}: pins left at the end: {ads['t0']['pinned']}")
    if ads["refusals"] != 1 or ads["hydrations"] == 0 or ads["t0"]["evictions"] == 0:
        fail(f"{label}: refusals {ads['refusals']}, hydrations {ads['hydrations']}, "
             f"T0 evictions {ads['t0']['evictions']}")
    for name in ("stats_ad", "stats_plain", "stats_local"):
        if out[name]["decode-chunks"]["host_fetches_per_chunk"] != 1.0:
            fail(f"{label}: {name} host_fetches_per_chunk "
                 f"{out[name]['decode-chunks']['host_fetches_per_chunk']}")
    if device == "cuda" and (counts["flash_attention"] == 0 or counts["paged_attention_q8"] == 0):
        fail(f"{label}: flash and the int8 read must launch: {counts}")
    loads = [e for e in out["load_events"]]
    load_ms = sorted(e["device_ms"] for e in loads)
    fetched = [e for e in out["hydrate_events"] if e.get("stage") == "fetched"]
    opened, waits = {}, []  # each fetch against the first stash that asked for it
    for e in out["hydrate_events"]:
        if e.get("stage") == "begin":
            opened.setdefault(e["adapter"], e["m_s"])
        elif e.get("stage") == "fetched" and e["adapter"] in opened:
            waits.append(round((e["m_s"] - opened.pop(e["adapter"])) * 1e3, 3))
    entry = ads["entry_bytes"]
    print(f"path [{label}]: wall_s={wall:.3f} entry_bytes={entry} (bf16 rows) "
          f"f32_bytes_per_adapter={per_f32} t0_rows={J_T0_ENTRIES}+1 "
          f"ttft_s by kind (n, p50, max): {out['ttft_by_kind']}", flush=True)
    print(f"path [{label}]: row loads n={len(loads)} device_ms min={load_ms[0] if load_ms else 0} "
          f"median={load_ms[len(load_ms) // 2] if load_ms else 0} max={load_ms[-1] if load_ms else 0} "
          f"({entry / (load_ms[len(load_ms) // 2] / 1e3) / 1e9 if load_ms else 0:.3f} GB/s of "
          f"bf16 rows at the median, from f32 host factors); T2 fetches {len(fetched)} x "
          f"{fetched[0]['bytes'] if fetched else 0} bytes, ms from the first stash to the "
          f"fetch {sorted(waits)}", flush=True)
    if out.get("profile"):
        print(f"path [{label}]: {out['profile']}", flush=True)
    print(f"path [{label}]: checks (a) 8 base prompts equal the store-less engine's; (b) "
          f"{J_NAMES[3]} hydrated from T2 equals it installed locally (4 prompts); (c) "
          f"{J_NAMES[0]} reloaded from row {out['c_rows'][0]} into row {out['c_rows'][1]} "
          f"gives its tokens; (d) the adapter changed {differ}/8 prompts' tokens; unknown "
          f"adapter refused ({out['unknown']!r}); launches={counts}", flush=True)
    print(f"path [{label}]: stats()['adapters'] {json.dumps(ads, sort_keys=True)}", flush=True)
    return counts


def phase_lora_spec_path(torch, params, resource: dict = CHAT_EXAMPLE_RESOURCE,
                         device="cuda") -> dict:
    """Path J2: adapters through speculation. Paged bf16 KV with
    ``speculative-drafts: 4`` (held on: no calibration chunk), the prefix
    cache off, two locally installed adapters over 8 repetitive greedy
    prompts: the verify's (B, T) multi-query calls, the adapter rows of the
    speculative dispatches and tokens per step; then the same requests
    with speculation off and the common prefix of their tokens (bf16
    near-ties may flip between the verify and decode shapes: printed, not
    required)."""
    from langstream_tpu_torch.models import llama_paged
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    label = "J2 adapters x speculation"
    base = {k: v for k, v in resource["configuration"].items() if k != "warmup-on-start"}
    base.update({"kv-layout": "paged", "prefix-cache": False, "speculative-drafts": 4,
                 "adapter-store": {"rank": J_RANK, "t0-entries": J_T0_ENTRIES}})
    greedy = [p for p, o in zip(*spec_prompts()) if o["temperature"] == 0]
    prompts = greedy + ["Repeat exactly: " + "alpha beta gamma delta. " * 12,
                        "Repeat exactly: " + "0, 1, 1, 2, 3, 5, 8, 13, " * 10]
    adapters = [J_NAMES[i % 2] for i in range(len(prompts))]
    opts = {"max-tokens": J2_MAX_TOKENS, "temperature": 0}

    def run(spec: bool):
        cfg = {**base, "speculative-drafts": 4 if spec else 0}
        os.environ["LS_TPU_SPEC_CALIBRATE_EVERY"] = str(10**9)
        try:
            engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device,
                                        params=params)
        finally:
            os.environ.pop("LS_TPU_SPEC_CALIBRATE_EVERY")
        mc = engine.model_config
        for n in J_NAMES[:2]:
            engine.install_adapter(n, j_arrays(mc, n))
        rows_seen = []
        real_step = engine._run_spec_step

        def spec_step(*args):
            rows_seen.append(args[-1])
            return real_step(*args)

        engine._run_spec_step = spec_step

        async def main():
            try:
                t = time.monotonic()
                results = await asyncio.gather(*(
                    engine.generate(p, {**opts, "adapter": a}) for p, a in zip(prompts, adapters)))
                return results, time.monotonic() - t, engine.stats()
            finally:
                await engine.close()

        results, wall, stats = asyncio.run(main())
        bm = engine.block_mgr.stats()
        if bm["reserved_blocks"] or bm["live_blocks"] or stats["adapters"]["t0"]["pinned"]:
            fail(f"{label}: engine not idle after the wave: {bm} {stats['adapters']['t0']}")
        for i, r in enumerate(results):
            if not r["tokens"] or not all(math.isfinite(x) for x in r["logprobs"]):
                fail(f"{label}: request {i} returned no finite tokens")
        return results, wall, stats, rows_seen, mc.layers

    real_mq, mq_calls = llama_paged.paged_attention_multiquery_partial, []

    def recording_mq(q, *args, **kw):
        mq_calls.append((q.shape[0], q.shape[1]))
        return real_mq(q, *args, **kw)

    reset_counts()
    t0 = time.monotonic()
    llama_paged.paged_attention_multiquery_partial = recording_mq
    try:
        spec, wall, stats, rows_seen, layers = run(True)
    finally:
        llama_paged.paged_attention_multiquery_partial = real_mq
    plain, plain_wall, plain_stats, _, _ = run(False)
    counts = read_counts()
    sp, dc = stats["speculative"], stats["decode-chunks"]
    shapes = sorted({bt: mq_calls.count(bt) // layers for bt in set(mq_calls)}.items())
    row_ids = sorted({int(r) for rows in rows_seen if rows is not None for r in rows if r})
    n_tokens = sum(len(r["tokens"]) for r in spec)
    steps = sp["steps"] + dc["steps"]
    same = total = 0
    for a, b in zip(spec, plain):
        n = min(len(a["tokens"]), len(b["tokens"]))
        same += next((i for i in range(n) if a["tokens"][i] != b["tokens"][i]), n)
        total += max(len(a["tokens"]), len(b["tokens"]))
    print(f"path [{label}]: wall_s={time.monotonic() - t0:.3f} wave_s={wall:.3f} "
          f"requests={len(prompts)} tokens={n_tokens} speculative={sp} "
          f"tokens_per_step={(n_tokens - len(prompts)) / steps if steps else 0.0:.3f} "
          f"multiquery_calls_per_step (B, T): count={shapes} adapter rows in the "
          f"speculative dispatches {row_ids}; speculation off: wave_s={plain_wall:.3f} "
          f"decode_steps={plain_stats['decode-chunks']['steps']}; common prefix "
          f"{same}/{total} tokens ({same / total:.3f}); launches={counts}", flush=True)
    if sp["steps"] == 0 or not any(t == 5 for _, t in mq_calls):
        fail(f"{label}: no verify at T=5 ran: {sp} {shapes}")
    if len(row_ids) < 2:
        fail(f"{label}: the speculative dispatches carried adapter rows {row_ids}")
    if device == "cuda" and (counts["paged_attention_multiquery"] == 0
                             or counts["paged_attention"] == 0
                             or counts["flash_attention"] == 0):
        fail(f"{label}: the multi-query read, the bf16 read and flash must launch: {counts}")
    return counts


# ---------------------------------------------------------------------------
# path K: the device-survival plane and the drain
# ---------------------------------------------------------------------------

def k1_plan(grow_passes: int) -> list:
    """K1's chaos plan: two allocator failures in a row at a pool-grow pass
    (a decode or admission block growth) half way through ``grow_passes``,
    the unfaulted wave's pool-grow passes (64 requests make about 18), so
    they land mid-wave whatever the burst structure; one at the third
    prefill."""
    return [{"site": "pool-grow", "after": grow_passes // 2, "count": 2, "shape": "oom"},
            {"site": "prefill", "after": 2, "count": 1, "shape": "oom"}]
K_REQUESTS = 64
#: K2's wedge-window-s: above the longest gap between two recorded
#: dispatches at llama3-8b on the card (~5 s: a pipelined burst records its
#: first chunk after the second chunk's launches, ~2.4 s each; a 2 s window
#: read every chunk, a 4 s one the burst's start, as a wedge); the fetch
#: hangs for three windows
K2_WEDGE_S = 6.0
K2_REQUESTS = 16
K3_LAYERS = 8         # K3's crashed child and its replaying successor
K3_REQUESTS = 32
K3_SEED = 7


def k_resource(resource: dict = CHAT_EXAMPLE_RESOURCE) -> dict:
    """Path K's serving configuration: the chat example's resource with
    paged int8 KV, the pipelined loop (the default) and a 2 s recovery
    window; no warmup, so the fault plans count the wave's passes only."""
    base = {k: v for k, v in resource["configuration"].items() if k != "warmup-on-start"}
    return {**base, "kv-layout": "paged", "kv-quantize": "int8", "pipeline": True,
            "shrink-recovery-s": 2.0}


def _k_wave_line(label, stats, before, wall, path="K") -> dict:
    dc, dc0 = stats["decode-chunks"], before["decode-chunks"]
    steps, secs = dc["steps"] - dc0["steps"], dc["seconds"] - dc0["seconds"]
    gen = stats["total-generated"] - before["total-generated"]
    line = {"wall_s": round(wall, 3),
            "ms_per_step": round(secs / steps * 1e3, 2) if steps else None,
            "decode_tok_s": round(gen / secs, 1) if secs else None,
            "host_fetches_per_chunk": dc["host_fetches_per_chunk"]}
    print(f"path {path} [{label}]: {json.dumps(line)}", flush=True)
    return line


def _k_check_idle(label, engine) -> None:
    kv = engine.stats()["kv"]
    if kv["reserved_blocks"] or kv["live_blocks"] or engine._deferred_releases:
        fail(f"{label}: the block manager is not idle: {kv}")


def phase_chaos_path(torch, params, resource: dict = CHAT_EXAMPLE_RESOURCE,
                     device="cuda") -> tuple:
    """K1: a greedy wave of ``K_REQUESTS`` (path F's lengths and budgets)
    without faults, then the same wave under :func:`k1_plan`'s faults, on the same
    weights. Hard checks: every request completes within its budget,
    preemptions equal resumes, a ``pool-shrink`` event naming its site
    after its ``fault-injected`` event, a ``pool-restore`` that brings the
    withheld blocks back to 0 within 10 s of the last shrink, an idle block
    manager and one fetch per chunk. Recorded: ms per step and decode tok/s
    of both waves, the share of greedy tokens equal to the unfaulted wave's
    (int8 KV: not required equal). Then a genuine out-of-memory error from
    the card must be classified as an allocator failure."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    requests = saturated_requests(K_REQUESTS)
    cfg = k_resource(resource)

    def wave(faults):
        engine = TorchServingEngine(ServingConfig.from_dict(
            {**cfg, **({"faults": faults} if faults else {})}), device=device, params=params)
        preempted = []
        real_preempt = engine._preempt_slot

        def note_preempt(slot_id, *args, **kwargs):
            preempted.append(kwargs.get("reason", args[0] if args else None))
            real_preempt(slot_id, *args, **kwargs)

        engine._preempt_slot = note_preempt

        async def run():
            try:
                before = engine.stats()
                t0 = time.monotonic()
                results = await asyncio.gather(*(
                    engine.generate(p, {"max-tokens": m, "temperature": 0})
                    for p, m in requests))
                wall = time.monotonic() - t0
                # the recovery probe restores one quantum per quiet window
                t_wait = time.monotonic()
                while engine.block_mgr.budget_reduction and time.monotonic() - t_wait < 30:
                    await asyncio.sleep(0.05)
                await engine.settled()
                return results, wall, before
            finally:
                await engine.close()

        results, wall, before = asyncio.run(run())
        return engine, results, wall, before, preempted

    reset_counts()
    # the unfaulted wave carries inert plans: they fire never and count the
    # seams' passes (an armed plan that never fires changes no token)
    clean, want, wall0, before0, _ = wave([{"site": "pool-grow", "after": 10 ** 9},
                                           {"site": "prefill", "after": 10 ** 9}])
    line0 = _k_wave_line("K1 unfaulted", clean.stats(), before0, wall0)
    _k_check_idle("K1 unfaulted", clean)
    passes = {f["site"]: f["seen"] for f in clean.stats()["survival"]["faults"]}
    plan = k1_plan(passes["pool-grow"])
    print(f"path K [K1]: the unfaulted wave passed the seams {passes}; chaos plan {plan}",
          flush=True)
    del clean
    gc.collect()
    engine, got, wall1, before1, preempted = wave(plan)
    counts = read_counts()
    stats = engine.stats()
    line1 = _k_wave_line("K1 chaos", stats, before1, wall1)
    label = "K1 chaos"
    for i, ((_, budget), r) in enumerate(zip(requests, got)):
        if not 0 < len(r["tokens"]) <= budget or r["finish_reason"] not in ("stop", "length"):
            fail(f"{label}: request {i} returned {len(r['tokens'])} tokens of {budget}, "
                 f"finish_reason {r['finish_reason']!r}")
    events = engine.flight.recent_events(0)
    kinds = [e["kind"] for e in events]
    resumes = engine.flight.events_by_type.get("resume", 0)
    if len(preempted) != resumes:
        fail(f"{label}: {len(preempted)} preemptions ({preempted}) against {resumes} resumes")
    shrinks = [e for e in events if e["kind"] == "pool-shrink"]
    if not shrinks or any(not e.get("site") for e in shrinks):
        fail(f"{label}: no pool-shrink event naming its site: {shrinks}")
    if "fault-injected" not in kinds or kinds.index("fault-injected") > kinds.index(
            "pool-shrink"):
        fail(f"{label}: no fault-injected event before the first pool-shrink: {kinds[:40]}")
    fired = stats["survival"]["faults"]
    if any(f["fired"] != f["count"] for f in fired):
        fail(f"{label}: a fault plan did not fire in full (the chaos did not arm): {fired}")
    restores = [e for e in events if e["kind"] == "pool-restore"]
    last_shrink, last_restore = shrinks[-1]["m_s"], (restores[-1]["m_s"] if restores else None)
    if (stats["survival"]["withheld_blocks"] or last_restore is None
            or last_restore - last_shrink > 10.0):
        fail(f"{label}: the budget was not restored to 0 within 10 s of the last shrink: "
             f"{stats['survival']}, restores {restores}")
    _k_check_idle(label, engine)
    if stats["decode-chunks"]["host_fetches_per_chunk"] != 1.0:
        fail(f"{label}: host_fetches_per_chunk {stats['decode-chunks']['host_fetches_per_chunk']}")
    same = sum(1 for a, b in zip(want, got) for x, y in zip(a["tokens"], b["tokens"]) if x == y)
    total = sum(len(a["tokens"]) for a in want)
    print(f"path K [{label}]: shrinks={stats['survival']['shrinks']} "
          f"restores={stats['survival']['restores']} preempted={len(preempted)} "
          f"(by reason {dict((r, preempted.count(r)) for r in set(preempted))}) "
          f"resumes={resumes} restore_s_after_last_shrink="
          f"{round(last_restore - last_shrink, 3)} shrink_sites="
          f"{[e['site'] for e in shrinks]} faults={fired}; greedy tokens equal to the "
          f"unfaulted wave: {same}/{total} ({same / total:.4f}); launches={counts}", flush=True)
    del engine
    gc.collect()
    if device != "cuda":
        return counts, line0, line1
    # a genuine allocator refusal on the card: more bytes than it holds
    try:
        torch.empty(torch.cuda.get_device_properties(0).total_memory * 2,
                    dtype=torch.uint8, device=device)
        fail("K1: an allocation of twice the card's memory succeeded")
    except RuntimeError as e:  # torch.OutOfMemoryError is a RuntimeError
        if not TorchServingEngine._resource_exhausted(e):
            fail(f"K1: the classifier missed a genuine {type(e).__name__}: {e}")
        print(f"path K [K1]: a genuine {type(e).__module__}.{type(e).__name__} "
              f"({str(e).splitlines()[0][:90]}...) is classified resource-exhausted",
              flush=True)
    torch.cuda.empty_cache()
    return counts, line0, line1


def phase_wedge_path(torch, params, resource: dict = CHAT_EXAMPLE_RESOURCE,
                     device="cuda") -> dict:
    """K2: a ``fetch`` hang of three wedge windows during a wave of
    ``K2_REQUESTS``: ``health()`` reads WEDGED while it lasts and ok after,
    every request completes. Then path I2's pair (bf16 KV) with a ``scatter``
    allocator failure on the decode pool: it shrinks and serves every
    import (I2's checks hold: the combined engine's tokens)."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    cfg = {**k_resource(resource), "wedge-window-s": K2_WEDGE_S,
           "faults": [{"site": "fetch", "shape": "hang", "after": 3,
                       "hang-ms": 3 * K2_WEDGE_S * 1000.0}]}
    requests = saturated_requests(K2_REQUESTS)
    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)

    async def run():
        try:
            tasks = [asyncio.ensure_future(engine.generate(
                p, {"max-tokens": m, "temperature": 0})) for p, m in requests]
            states, t0 = [], time.monotonic()
            while not all(t.done() for t in tasks):
                states.append((round(time.monotonic() - t0, 2), engine.health()["state"]))
                await asyncio.sleep(0.1)
            results = await asyncio.gather(*tasks)
            for _ in range(100):
                if engine.health()["state"] == "ok":
                    break
                await asyncio.sleep(0.1)
            return states, results, engine.health()
        finally:
            await engine.close()

    reset_counts()
    states, results, health = asyncio.run(run())
    counts = read_counts()
    label = "K2 wedge"
    for i, ((_, budget), r) in enumerate(zip(requests, results)):
        if not 0 < len(r["tokens"]) <= budget:
            fail(f"{label}: request {i} returned {len(r['tokens'])} tokens of {budget}")
    wedged = [i for i, (_, s) in enumerate(states) if s == "wedged"]
    # wedged only while the hang lasts: one unbroken run of wedged readings,
    # shorter than the hang (the heartbeat's age crosses the window inside it)
    if (not wedged or wedged[-1] - wedged[0] + 1 != len(wedged)
            or states[wedged[-1]][0] - states[wedged[0]][0] > 3 * K2_WEDGE_S
            or health["state"] != "ok"):
        fail(f"{label}: health must read wedged during the hang and ok after: "
             f"{states}, final {health}")
    wedged = [states[i][0] for i in wedged]
    fired = engine.stats()["survival"]["faults"]
    if fired[0]["fired"] != 1:
        fail(f"{label}: the hang did not fire: {fired}")
    print(f"path K [{label}]: wedged from {wedged[0]} s to {wedged[-1]} s of the wave "
          f"(hang {3 * K2_WEDGE_S:.1f} s, window {K2_WEDGE_S:.1f} s), health after "
          f"{health['state']}; {len(results)} requests complete; launches={counts}",
          flush=True)
    del engine
    gc.collect()
    i2_counts = phase_handoff_path(torch, params, resource, device,
                                   dec_faults=[{"site": "scatter", "count": 1}])[0]
    return {k: counts[k] + i2_counts[k] for k in counts}


def weights_checksum(params) -> str:
    """A digest of every weight tensor, sampled every 997th element (both
    sides of K3 make their weights from one seed)."""
    import hashlib

    import torch

    digest = hashlib.sha256()

    def walk(tree):
        if isinstance(tree, dict):
            for key in sorted(tree):
                walk(tree[key])
        elif hasattr(tree, "q"):
            walk(tree.q)
            walk(tree.s)
        else:
            sample = tree.reshape(-1)[::997].to("cpu")
            if sample.dtype == torch.bfloat16:
                sample = sample.float()  # exact; numpy has no bf16
            digest.update(sample.numpy().tobytes())

    walk(params)
    return digest.hexdigest()[:16]


def k3_config(journal_dir: str, resource: dict) -> dict:
    return {**k_resource(resource), "seed": K3_SEED, "journal-dir": journal_dir}


def k3_child(journal_dir: str, device: str = "cuda",
             resource: dict = CHAT_EXAMPLE_RESOURCE) -> int:
    """K3's crashing process: llama3-8b at ``K3_LAYERS`` layers from the
    seed, a journal in ``journal_dir``, a prefill that hangs for ten minutes
    so nothing it accepts is answered; it accepts ``K3_REQUESTS``, flushes
    the journal, prints its weight checksum and waits for its SIGKILL."""
    import torch

    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    if device == "cuda" and not torch.cuda.is_available():
        return 2
    with cut_depth(resource["configuration"]["model"], K3_LAYERS):
        engine = TorchServingEngine(ServingConfig.from_dict({
            **k3_config(journal_dir, resource),
            "faults": [{"site": "prefill", "shape": "hang", "hang-ms": 600000.0}]}),
            device=device)
    print(f"K3 child checksum {weights_checksum(engine.params)}", flush=True)

    async def accept():
        tasks = [asyncio.ensure_future(engine.generate(p, {"max-tokens": m, "temperature": 0}))
                 for p, m in saturated_requests(K3_REQUESTS)]
        await asyncio.sleep(0)
        if not engine.journal.flush(30.0) or engine.journal.stats()["live"] != K3_REQUESTS:
            print(f"K3 child journal {engine.journal.stats()}", flush=True)
            return
        print(f"K3 child journaled {engine.journal.stats()['live']}", flush=True)
        await asyncio.sleep(3600)  # the parent kills this process
        del tasks

    asyncio.run(accept())
    return 1


def phase_crash_requeue_path(torch, resource: dict = CHAT_EXAMPLE_RESOURCE,
                             device="cuda") -> dict:
    """K3: a child process accepts ``K3_REQUESTS`` into its journal and is
    killed with SIGKILL; an engine here, on the same seed and directory,
    replays them. Hard checks: the same weight checksum, every request
    served, each entry retired once, the journal's depth 0, a
    ``journal-replay`` event with the count. Recorded: the seconds from the
    engine's construction to the last replayed completion."""
    import shutil
    import signal
    import tempfile

    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    label = "K3 crash-requeue"
    journal_dir = tempfile.mkdtemp(prefix="ls-journal-")
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--k3-child",
                              journal_dir, device, json.dumps(resource)],
                             stdout=subprocess.PIPE, text=True)
    lines = []
    try:
        t_child = time.monotonic()
        for line in child.stdout:
            lines.append(line.strip())
            if line.startswith("K3 child journal"):
                break
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        child.stdout.close()
    print(f"path K [{label}]: child {lines} killed with SIGKILL after "
          f"{time.monotonic() - t_child:.1f} s, exit {child.returncode}", flush=True)
    if not any(line == f"K3 child journaled {K3_REQUESTS}" for line in lines):
        fail(f"{label}: the child did not journal {K3_REQUESTS} requests: {lines}")
    child_sum = next(line.split()[-1] for line in lines if line.startswith("K3 child checksum"))
    reset_counts()
    t0 = time.monotonic()
    with cut_depth(resource["configuration"]["model"], K3_LAYERS):
        engine = TorchServingEngine(ServingConfig.from_dict(k3_config(journal_dir, resource)),
                                    device=device)
    ours = weights_checksum(engine.params)
    replayed = []
    requeue = engine.scheduler.requeue_front

    def capture(request):
        if request.journey_id and request.preemptions == 0:
            replayed.append(request)
        requeue(request)

    engine.scheduler.requeue_front = capture

    async def run():
        try:
            fresh = await engine.generate("a fresh request after the restart",
                                          {"max-tokens": 8, "temperature": 0})
            results = await asyncio.wait_for(
                asyncio.gather(*(r.future for r in replayed)), 600)
            done_s = time.monotonic() - t0
            for _ in range(200):
                if engine.journal.depth() == 0:
                    break
                await asyncio.sleep(0.05)
            return fresh, results, done_s, engine.journal.stats(), engine.journal.depth()
        finally:
            await engine.close()

    fresh, results, done_s, jstats, depth = asyncio.run(run())
    shutil.rmtree(journal_dir, ignore_errors=True)
    counts = read_counts()
    events = [e for e in engine.flight.recent_events(0) if e["kind"] == "journal-replay"]
    if ours != child_sum:
        fail(f"{label}: weight checksums differ: child {child_sum}, here {ours}")
    if len(results) != K3_REQUESTS or any(not r["tokens"] for r in results) or not fresh["tokens"]:
        fail(f"{label}: {len(results)} of {K3_REQUESTS} replayed requests served")
    if (jstats["replayed"] != K3_REQUESTS or jstats["retired"] != K3_REQUESTS + 1
            or jstats["live"] or depth):
        fail(f"{label}: each entry must retire once and the depth end 0: {jstats}, "
             f"depth {depth}")
    if [e["requests"] for e in events] != [K3_REQUESTS]:
        fail(f"{label}: journal-replay events {events}")
    print(f"path K [{label}]: checksum {ours} on both sides; {len(results)} replayed "
          f"requests served, the last {done_s:.3f} s after the engine's construction; "
          f"journal {jstats}; launches={counts}", flush=True)
    del engine
    gc.collect()
    return counts


def phase_drain_path(torch, params, resource: dict = CHAT_EXAMPLE_RESOURCE,
                     device="cuda") -> dict:
    """K4: a wave of ``K_REQUESTS`` drained (grace 120 s) after its first
    chunk: the requeued count equals the slots occupied at the preempt
    pass, every request completes, none is shed, a submission during the
    drain is refused with ``RateLimited``. Then a fresh wave drained with a
    0.5 s grace: completed and shed add up to the wave and no future is
    left pending. Then the port's module-level ``drain_engines``,
    ``flight_report``, ``attribution_report`` and ``profile_engines`` over
    the two engines."""
    import tempfile

    from langstream_tpu_torch.serving import engine as engine_module
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
    from langstream_tpu_torch.serving.qos import RateLimited

    requests = saturated_requests(K_REQUESTS)
    cfg = ServingConfig.from_dict(k_resource(resource))
    engines = []

    def drained_wave(grace_s):
        engine = TorchServingEngine(cfg, device=device, params=params)
        engines.append(engine)
        occupied = []
        real_pass = engine._drain_preempt_pass

        def note_pass():
            occupied.append(sum(1 for s in engine.slots
                                if s.request is not None and not s.request.future.done()))
            return real_pass()

        engine._drain_preempt_pass = note_pass

        async def run():
            tasks = [asyncio.ensure_future(engine.generate(
                p, {"max-tokens": m, "temperature": 0})) for p, m in requests]
            while engine._decode_fetches < 1:  # the wave's first chunk landed
                await asyncio.sleep(0.005)
            t0 = time.monotonic()
            drain = asyncio.ensure_future(engine.drain(grace_s=grace_s))
            await asyncio.sleep(0)
            try:
                await engine.generate("a submission during the drain", {"max-tokens": 4})
                refused = None
            except RateLimited as e:
                refused = e.reason
            report = await drain
            wall = time.monotonic() - t0
            done = await asyncio.gather(*tasks, return_exceptions=True)
            return report, wall, refused, done, [t.done() for t in tasks]

        return (*asyncio.run(run()), occupied, engine)

    reset_counts()
    report, wall, refused, done, finished, occupied, engine = drained_wave(120.0)
    label = "K4 drain"
    errors = [r for r in done if isinstance(r, BaseException)]
    if (report["requeued"] != (occupied[0] if occupied else -1) or report["completed"]
            != K_REQUESTS or report["shed"] != 1 or errors or refused != "draining"):
        fail(f"{label}: report {report} with {occupied} occupied at the pass, "
             f"refusal {refused!r}, errors {errors[:3]}")
    _k_check_idle(label, engine)
    print(f"path K [{label}, grace 120 s]: {json.dumps(report)} (the one shed is the "
          f"refused submission); {occupied[0]} slots occupied at the pass; drained in "
          f"{wall:.3f} s", flush=True)
    report2, wall2, _, done2, finished2, occupied2, engine2 = drained_wave(0.5)
    shed = [r for r in done2 if isinstance(r, RateLimited) and r.reason == "draining"]
    served = [r for r in done2 if isinstance(r, dict)]
    if (not all(finished2) or len(shed) + len(served) != K_REQUESTS
            or report2["completed"] + report2["shed"] - 1 != K_REQUESTS):
        fail(f"{label}, grace 0.5 s: report {report2}, {len(served)} served, {len(shed)} "
             f"shed, pending {finished2.count(False)}")
    _k_check_idle(f"{label}, grace 0.5 s", engine2)
    print(f"path K [{label}, grace 0.5 s]: {json.dumps(report2)}; {len(served)} served, "
          f"{len(shed)} shed explicitly, none pending", flush=True)
    # the module-level pod seam over the live engines (the engines join the
    # shared instance map as get_or_create would have put them there)
    for i, e in enumerate(engines):
        TorchServingEngine._instances[(f"k4-{i}", str(e.device))] = e
    trace_dir = tempfile.mkdtemp(prefix="ls-profile-")
    try:
        reports = asyncio.run(engine_module.drain_engines(grace_s=5.0))
        summary = engine_module.flight_report(summary_only=True)
        attribution = engine_module.attribution_report()
        started = engine_module.profile_engines("start", trace_dir)
        stopped = engine_module.profile_engines("stop")
    finally:
        TorchServingEngine.reset_instances()
        for e in engines:  # joins a dispatch the shed wave left running
            asyncio.run(e.close())
    counts = read_counts()
    if (len(summary) != 2 or len(attribution) != 2 or not all(started.values())
            or not all(stopped.values()) or any("survival" not in s for s in summary)):
        fail(f"{label}: the pod seam over the live engines: {reports}, {len(summary)} "
             f"flight entries, {len(attribution)} attribution entries, {started}, {stopped}")
    print(f"path K [{label}]: drain_engines {reports}; flight_report(summary_only) "
          f"{len(summary)} entries with {sorted(summary[0])}; attribution_report "
          f"{len(attribution)}; profile_engines start {started} stop {stopped}", flush=True)
    del engine, engine2, engines
    gc.collect()
    return counts


# ---------------------------------------------------------------------------
# path L: the request-evidence and cross-replica planes
# ---------------------------------------------------------------------------

#: L1's slo section: a TTFT objective the 64-request wave breaches (its
#: queued requests wait whole prefill batches), so the fast burn pages
L_SLO = {"objectives": {"ttft": {"target": 0.99, "threshold-ms": 250}}}
#: the journey segments path L reports (the TTFT decomposition and decode)
L_SEGMENTS = ("queue", "prefill", "transfer", "decode-admission", "first-step", "decode")
L2_DEAD = ("dead-0", "dead-1", "dead-2")
L2_FALLBACKS = 4


def _quantile(values: list, q: float):
    if not values:
        return None
    ordered = sorted(values)
    return round(ordered[min(len(ordered) - 1, int(q * len(ordered)))], 3)


def journey_segments(journeys: list[list[dict]]) -> dict:
    """Per segment of :data:`L_SEGMENTS`: the journeys that have it, and the
    p50 and p99 of each journey's total ms in it."""
    from langstream_tpu_torch.serving.journey import segments

    per: dict = {name: [] for name in L_SEGMENTS}
    for events in journeys:
        totals: dict = {}
        for seg in segments(events):
            totals[seg["segment"]] = totals.get(seg["segment"], 0.0) + seg["ms"]
        for name in L_SEGMENTS:
            if name in totals:
                per[name].append(totals[name])
    return {name: {"n": len(v), "p50_ms": _quantile(v, 0.5), "p99_ms": _quantile(v, 0.99)}
            for name, v in per.items()}


def _chain_order(label: str, kinds: list, chain) -> None:
    """Fail unless the first occurrences of ``chain``'s kinds are all in
    ``kinds`` and in that order."""
    first = {}
    for i, kind in enumerate(kinds):
        first.setdefault(kind, i)
    if any(k not in first for k in chain) or [first[k] for k in chain] != sorted(
            first[k] for k in chain):
        fail(f"{label}: journey {kinds} does not run {list(chain)} in order")


def phase_evidence_path(torch, params, k1_line: dict, resource: dict = CHAT_EXAMPLE_RESOURCE,
                        device="cuda") -> tuple:
    """L1: K1's unfaulted wave (``K_REQUESTS`` greedy requests, path F's
    lengths and budgets) on K's configuration with an ``incident-dir`` and
    :data:`L_SLO`, each request under its own ambient trace. Prints ms per
    step and tok/s beside K1's, the journey segments, spans per request and
    the bundles captured and suppressed. Fails unless every journey ends in
    ``finish`` with its first occurrences in ``LIFECYCLE_CHAIN`` order and
    no event dropped, every request has its ``engine.queue``,
    ``engine.prefill`` and ``engine.decode`` spans under its trace, an
    ``slo-fast-burn`` bundle is on disk, re-indexed by a fresh recorder and
    listed by ``incident_report()``, one fetch per chunk holds and the block
    manager ends idle."""
    import tempfile

    from langstream_tpu_torch.core import metrics, tracing
    from langstream_tpu_torch.serving import engine as engine_module
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
    from langstream_tpu_torch.serving.incident import IncidentRecorder
    from langstream_tpu_torch.serving.journey import JOURNEYS, LIFECYCLE_CHAIN

    label = "L1 journeys, spans and incidents"
    requests = saturated_requests(K_REQUESTS)
    incident_dir = tempfile.mkdtemp(prefix="ls-l1-incidents-")
    engine = TorchServingEngine(ServingConfig.from_dict(
        {**k_resource(resource), "incident-dir": incident_dir, "slo": L_SLO}),
        device=device, params=params)
    key = ("chip-smoke", "L1")
    TorchServingEngine._instances[key] = engine  # incident_report walks the instance map
    traces = [tracing.TraceContext.new() for _ in requests]
    dropped0 = JOURNEYS.dropped_events

    async def traced(ctx, prompt, budget):
        token = tracing.set_current(ctx)
        try:
            return await engine.generate(prompt, {"max-tokens": budget, "temperature": 0})
        finally:
            tracing.reset_current(token)

    async def run():
        try:
            before = engine.stats()
            snap0 = metrics.snapshot()  # path M1: the wave's scrape deltas
            t0 = time.monotonic()
            results = await asyncio.gather(*(traced(ctx, p, m)
                                             for ctx, (p, m) in zip(traces, requests)))
            wall = time.monotonic() - t0
            await engine.settled()
            snap1 = metrics.snapshot()
            engine.health()
            if not engine.incidents.flush(30.0):
                fail(f"{label}: the incident writer did not drain")
            return (results, wall, before, engine.stats(), engine_module.incident_report(),
                    (snap0, snap1))
        finally:
            await engine.close()
            TorchServingEngine._instances.pop(key, None)

    reset_counts()
    results, wall, before, stats, report, snaps = asyncio.run(run())
    counts = read_counts()
    line = _k_wave_line(label, stats, before, wall, path="L")
    # path M1: the scrape's deltas over the wave equal what the engine
    # reports, and a TTFT exemplar names one of the wave's journeys
    deltas = scrape_changes(*snaps, engine.config.model)
    want = {"langstream_serving_tokens_generated_total":
            stats["total-generated"] - before["total-generated"],
            "langstream_serving_requests_completed_total":
            stats["completed"] - before["completed"]}
    if any(deltas.get(k) != v for k, v in want.items()):
        fail(f"{label}: scrape deltas {[(k, deltas.get(k)) for k in want]} against stats {want}")
    ids = {ctx.trace_id for ctx in traces}
    named = [t for n, t in scrape_grammar(metrics.render_metrics().decode())
             if n == "langstream_serving_ttft_seconds_bucket" and t in ids]
    if not named or not JOURNEYS.events(named[0]):
        fail(f"{label}: no TTFT exemplar names a journey of the wave: {named}")
    NOTES["L1"] = {**line, "tokens_delta": deltas["langstream_serving_tokens_generated_total"],
                   "requests_delta": deltas["langstream_serving_requests_completed_total"],
                   "exemplar": named[0], "exemplar_events": len(JOURNEYS.events(named[0]))}
    print(f"path L [L1 against K1 unfaulted, both at {K_LAYERS} layers]: ms_per_step "
          f"{line['ms_per_step']} against "
          f"{k1_line['ms_per_step']}, decode_tok_s {line['decode_tok_s']} against "
          f"{k1_line['decode_tok_s']}, wall_s {line['wall_s']} against {k1_line['wall_s']} "
          f"(recorded, not claimed)", flush=True)
    journeys, spans = [], 0
    for i, (ctx, (_, budget), r) in enumerate(zip(traces, requests, results)):
        if not 0 < len(r["tokens"]) <= budget:
            fail(f"{label}: request {i} returned {len(r['tokens'])} tokens of {budget}")
        events = JOURNEYS.events(ctx.trace_id)
        kinds = [e["kind"] for e in events]
        if not kinds or kinds[-1] != "finish":
            fail(f"{label}: request {i}'s journey does not end in finish: {kinds}")
        _chain_order(f"{label} request {i}", kinds, [k for k in LIFECYCLE_CHAIN if k in kinds])
        journeys.append(events)
        mine = [s for s in tracing.SPANS.spans(ctx.trace_id) if s["parent_id"] == ctx.span_id]
        names = {s["name"] for s in mine}
        if not {"engine.queue", "engine.prefill", "engine.decode"} <= names:
            fail(f"{label}: request {i}'s spans under its trace are {sorted(names)}")
        spans += len(mine)
    if JOURNEYS.dropped_events != dropped0:
        fail(f"{label}: {JOURNEYS.dropped_events - dropped0} journey events dropped")
    if stats["decode-chunks"]["host_fetches_per_chunk"] != 1.0:
        fail(f"{label}: host_fetches_per_chunk {stats['decode-chunks']['host_fetches_per_chunk']}")
    _k_check_idle(label, engine)
    on_disk = sorted(p.name[:-len(".json")] for p in Path(incident_dir).glob(
        "incident-*-slo-fast-burn.json"))
    if not on_disk:
        fail(f"{label}: no slo-fast-burn bundle on disk: {stats.get('incidents')}")
    fresh = IncidentRecorder(incident_dir)
    try:
        reindexed = [b["id"] for b in fresh.list()]
    finally:
        fresh.close()
    listed = [b["id"] for entry in report for b in entry.get("incidents", [])]
    if not set(on_disk) <= set(reindexed) or not set(on_disk) <= set(listed):
        fail(f"{label}: bundles on disk {on_disk}, re-indexed {reindexed}, listed {listed}")
    inc = stats["incidents"]
    segs = journey_segments(journeys)
    print(f"path L [{label}]: journeys={len(journeys)} segments={json.dumps(segs)} "
          f"spans_per_request={spans / len(results):.2f} bundles captured={inc['captured']} "
          f"written={inc['written']} suppressed={inc['suppressed']} on_disk={on_disk}; "
          f"every journey ends in finish in chain order, 0 events dropped; "
          f"launches={counts}", flush=True)
    del engine
    gc.collect()
    return counts, segs


class L2Router:
    """The part of the platform's router the chainer uses (``pick``,
    ``report_failure``, ``report_success``, ``hold``, ``on_breaker_event``),
    holding one port :class:`CircuitBreaker` per replica. Picks in its
    replica order, the dead replicas first (they look least loaded), past
    the excluded one and the breakers that refuse; OPEN and CLOSED edges go
    to ``on_breaker_event`` as the platform router's do."""

    def __init__(self, replicas, spec):
        from langstream_tpu_torch.serving.handoff import CircuitBreaker

        self.order = list(replicas)
        self.breakers = {r: CircuitBreaker(spec) for r in replicas}
        self.on_breaker_event = None

    def _emit(self, kind: str, replica: str, **detail) -> None:
        detail["open_replicas"] = sum(1 for b in self.breakers.values() if b.state == "open")
        if self.on_breaker_event is not None:
            self.on_breaker_event(kind, replica, detail)

    def pick(self, phase=None, exclude=None):
        for replica in self.order:
            breaker = self.breakers[replica]
            if replica not in (exclude or ()) and breaker.can_serve():
                breaker.note_probe()
                return replica
        return None

    def report_failure(self, replica: str, kind: str = "error") -> None:
        breaker = self.breakers[replica]
        before = breaker.state
        if breaker.record_failure(kind) == "open" and before != "open":
            self._emit("breaker-open", replica, failures=breaker.stats()["window_failures"],
                       last_kind=kind)

    def report_success(self, replica: str) -> None:
        breaker = self.breakers[replica]
        before = breaker.state
        if breaker.record_success() != before:
            self._emit("breaker-close", replica)

    def hold(self, replica: str, retry_after_s: float) -> None:
        pass  # no replica here sheds with a hint


def phase_chainer_path(torch, params, combined_tokens: list,
                       resource: dict = CHAT_EXAMPLE_RESOURCE, device="cuda") -> tuple:
    """L2: I2's pair (paged bf16 KV; the prefill engine with an
    ``incident-dir``, an ``http-export`` drop and ``http-import`` drops on
    two offers) behind :class:`L2Router`: three dead replicas whose
    transport raises ``ConnectionError`` and one live decode replica, whose
    in-process transport lands the 16 offers in the decode engine's
    ``import_handoff`` together (in prompt order, as I2 lands them). 16
    prompts chained by :class:`HandoffChainer`, then 4 with the live replica
    dead too, which fall back to local decode. Fails unless every greedy
    token equals I2's combined engine, the dead replicas' breakers open and
    a ``breaker-storm`` bundle is captured on the prefill engine, every
    journey runs export -> export-taken -> import-received -> import ->
    first-step -> finish (the fallbacks' import on the prefill engine), and
    ``survival_section()`` counts the retries and fallbacks."""
    import tempfile

    from langstream_tpu_torch.core import tracing
    from langstream_tpu_torch.serving import kvtransfer
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
    from langstream_tpu_torch.serving.handoff import (
        BreakerSpec, HandoffChainer, HandoffLost, RetryPolicy,
    )
    from langstream_tpu_torch.serving.journey import JOURNEYS, stitch

    label = "L2 chainer across replicas"
    base = {k: v for k, v in resource["configuration"].items() if k != "warmup-on-start"}
    base.update({"kv-layout": "paged", "prefix-cache": False})
    incident_dir = tempfile.mkdtemp(prefix="ls-l2-incidents-")
    pre = TorchServingEngine(ServingConfig.from_dict({
        **base, "pool-role": "prefill", "incident-dir": incident_dir,
        "faults": [{"site": "http-export", "shape": "drop", "count": 1},
                   {"site": "http-import", "shape": "drop", "after": 3, "count": 2}]}),
        device=device, params=params)
    dec = TorchServingEngine(ServingConfig.from_dict({**base, "pool-role": "decode"}),
                             device=device, params=params)
    prompts = i2_prompts()
    extra = [f"Fallback question {i}: name a colour." for i in range(L2_FALLBACKS)]
    opts = {"max-tokens": I2_MAX_TOKENS, "temperature": 0}
    router = L2Router(L2_DEAD + ("live-0",), BreakerSpec(failures=3, window_s=30.0,
                                                          open_s=30.0))
    chainer = HandoffChainer(pre, router=router, policy=RetryPolicy(
        attempts=8, backoff_s=0.01, backoff_cap_s=0.05))
    live = {"up": True, "order": {}, "waiting": []}

    async def transport(replica, payload, headers, timeout_s):
        if replica != "live-0" or not live["up"]:
            raise ConnectionError(f"{replica} refused the connection")
        waiter = asyncio.get_running_loop().create_future()
        live["waiting"].append((payload, waiter))
        if len(live["waiting"]) == len(prompts):
            # every offer is here: land them together, in prompt order
            batch = sorted(live["waiting"], key=lambda pw: live["order"][
                kvtransfer.peek_header(pw[0])["request"]])
            outs = await asyncio.gather(*(dec.import_handoff(p) for p, _ in batch))
            for (_, w), out in zip(batch, outs):
                w.set_result(out)
        return 200, await waiter, {}

    chainer.transport = transport

    async def chain(ticket):
        try:
            return await chainer.chain(ticket)
        except HandoffLost:
            # the http-export drop: the pickup never arrived and the payload
            # stayed put; the retried pickup lands
            return await chainer.chain(ticket)

    async def traced_tickets(texts):
        traces = [tracing.TraceContext.new() for _ in texts]

        async def one(ctx, text):
            token = tracing.set_current(ctx)
            try:
                return await pre.generate(text, dict(opts))
            finally:
                tracing.reset_current(token)

        return traces, await asyncio.gather(*(one(c, t) for c, t in zip(traces, texts)))

    async def run():
        try:
            traces, tickets = await traced_tickets(prompts)
            live["order"] = {t["handoff"]: i for i, t in enumerate(tickets)}
            t0 = time.monotonic()
            got = await asyncio.gather(*(chain(t) for t in tickets))
            chain_wall = time.monotonic() - t0
            pre.health()  # the breaker-storm predicate reads the ring here
            live["up"] = False
            f_traces, f_tickets = await traced_tickets(extra)
            fallen = await asyncio.gather(*(chain(t) for t in f_tickets))
            await pre.settled()
            await dec.settled()
            if not pre.incidents.flush(30.0):
                fail(f"{label}: the incident writer did not drain")
            return (traces, got, f_traces, fallen, chain_wall, pre.stats(), dec.stats(),
                    pre.incidents.list())
        finally:
            await pre.close()
            await dec.close()

    reset_counts()
    traces, got, f_traces, fallen, chain_wall, st_pre, st_dec, bundles = asyncio.run(run())
    counts = read_counts()
    got_t = [r["tokens"] for r in got]
    if got_t != combined_tokens:
        diffs = [i for i, (a, b) in enumerate(zip(got_t, combined_tokens)) if a != b]
        fail(f"{label}: chained greedy tokens differ from I2's combined engine at {diffs}")
    opened = {r: b.opens for r, b in router.breakers.items()}
    if any(opened[r] < 1 for r in L2_DEAD):
        fail(f"{label}: the dead replicas' breakers did not all open: {opened}")
    kinds_by_bundle = [b["kind"] for b in bundles]
    if "breaker-storm" not in kinds_by_bundle:
        fail(f"{label}: no breaker-storm bundle on the prefill engine: {kinds_by_bundle}")
    chain_kinds = ["export", "export-taken", "import-received", "import", "first-step",
                   "finish"]
    stitched = []
    for i, ctx in enumerate(traces + f_traces):
        events = JOURNEYS.events(ctx.trace_id)
        kinds = [e["kind"] for e in events]
        _chain_order(f"{label} request {i}", kinds, chain_kinds)
        merged = stitch(ctx.trace_id, [events])
        if not merged["complete"] or merged["anomalies"] or kinds[-1] != "finish":
            fail(f"{label}: request {i}'s stitched journey {kinds}: {merged['anomalies']}")
        role = [e.get("role") for e in events if e["kind"] == "import"][-1]
        if role != ("decode" if i < len(traces) else "prefill"):
            fail(f"{label}: request {i} imported on the {role} engine")
        stitched.append(events)
    survival = st_pre["survival"]
    cstats = chainer.stats()
    if (survival["handoff_retries"] != cstats["retries"] or cstats["retries"] < len(L2_DEAD)
            or survival["handoff_fallbacks"] != cstats["fallbacks"] != L2_FALLBACKS):
        fail(f"{label}: survival {survival} against the chainer's {cstats}")
    for name, st in (("prefill", st_pre), ("decode", st_dec)):
        if st["decode-chunks"]["dispatched"] and st["decode-chunks"][
                "host_fetches_per_chunk"] != 1.0:
            fail(f"{label}: the {name} engine's host_fetches_per_chunk != 1.0")
        if st["kv"]["reserved_blocks"] or st["kv"]["live_blocks"]:
            fail(f"{label}: the {name} engine's block manager is not idle: {st['kv']}")
    if any(not r["tokens"] for r in fallen):
        fail(f"{label}: a local fallback returned no tokens")
    segs = journey_segments(stitched[:len(traces)])
    print(f"path L [{label}]: {len(got)} chained in {chain_wall:.3f} s, greedy tokens equal "
          f"I2's combined engine; retries={cstats['retries']} fallbacks={cstats['fallbacks']} "
          f"breaker_opens={opened} bundles={kinds_by_bundle} transfer_ms p50="
          f"{segs['transfer']['p50_ms']} p99={segs['transfer']['p99_ms']} "
          f"segments={json.dumps(segs)} survival={{'handoff_retries': "
          f"{survival['handoff_retries']}, 'handoff_fallbacks': "
          f"{survival['handoff_fallbacks']}}}; launches={counts}", flush=True)
    return counts, segs


# ---------------------------------------------------------------------------
# path M: the Prometheus plane's scrape, the checkpoint writers, dense int8 KV
# ---------------------------------------------------------------------------

#: what the earlier paths leave for path M's checks, by path
NOTES: dict = {}
M2_LAYERS = 2      # the written checkpoint's depth (full width)
M_REQUESTS = 8
#: series a scrape compares by presence only: times (and ratios of times)
#: and the memory ledger's device bytes
M_TIMED = re.compile(r"_seconds(_total)?$|_uplift$|hbm_bytes_")

# the OpenMetrics line grammar of tests/test_incident.py
_M_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_M_VALUE = r"(?:[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)|NaN|[-+]?Inf)"
_M_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
_M_LABELS = rf"\{{(?:{_M_LABEL}(?:,{_M_LABEL})*)?,?\}}"
_M_HELP = re.compile(rf"^# HELP {_M_NAME} .*$")
_M_TYPE = re.compile(rf"^# TYPE {_M_NAME} (counter|gauge|histogram|summary|untyped)$")
_M_SAMPLE = re.compile(
    rf"^(?P<name>{_M_NAME})(?:{_M_LABELS})? {_M_VALUE}(?: {_M_VALUE})?"
    rf'(?P<exemplar> # \{{trace_id="(?P<trace>[^"]+)"\}} {_M_VALUE} {_M_VALUE})?$')

#: each plane's families, and the path whose engines register them
M_FAMILIES = {
    "always (A)": ("tokens_generated_total", "requests_completed_total", "ttft_seconds",
                   "queue_wait_seconds", "decode_step_seconds", "kv_pool_used_ratio",
                   "recompiles_total", "hbm_bytes_weights"),
    "QoS (H)": ("qos_queue_depth_interactive", "qos_shed_total", "qos_preempted_total",
                "qos_resume_seconds"),
    "streaming TBT (H)": ("langstream_stream_tbt_seconds",),
    "prefix tiers (I1)": ("prefix_tier_t0_bytes", "prefix_t1_promotions_total",
                          "prefix_t2_hydrations_total", "prefix_demotions_total"),
    "handoff and KV transfer (I2, L2)": ("handoff_retries_total", "handoff_fallbacks_total",
                                         "kv_export_seconds", "kv_import_bytes_total",
                                         "breaker_open_replicas"),
    "adapters (J)": ("adapter_tier_t0_bytes", "adapter_loads_total",
                     "adapter_hydrations_total"),
    "survival (K)": ("pool_shrinks_total", "pool_restores_total", "kv_budget_blocks",
                     "journal_depth"),
    "SLO (L1)": ("slo_burn_rate_ttft", "slo_budget_remaining_ttft"),
    "embeddings and deadlines (E)": ("embeddings_total", "deadline_shed_total"),
}


def scrape_grammar(body: str) -> list[tuple[str, str]]:
    """Fail unless every line of ``body`` is a HELP/TYPE comment or a
    well-formed sample with exemplars on ``_bucket`` lines only; returns
    the exemplars as (bucket line's name, trace id)."""
    exemplars = []
    for line in body.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            if not (_M_HELP.match(line) or _M_TYPE.match(line)):
                fail(f"M1: malformed comment line {line!r}")
            continue
        m = _M_SAMPLE.match(line)
        if m is None:
            fail(f"M1: malformed sample line {line!r}")
        if m.group("exemplar"):
            if not m.group("name").endswith("_bucket"):
                fail(f"M1: an exemplar off a bucket line: {line!r}")
            exemplars.append((m.group("name"), m.group("trace")))
    return exemplars


def scrape_changes(before: dict, after: dict, agent: str) -> dict:
    """One agent's series between two ``metrics.snapshot()``s: counters and
    histogram counts by their change, gauges by their value; times by
    presence only (None)."""
    out = {}
    for (name, label), (kind, value) in after.items():
        if label != agent:
            continue
        if M_TIMED.search(name):
            out[name] = None
        elif kind == "gauge":
            out[name] = value
        else:
            out[name] = value - before.get((name, label), (kind, 0.0))[1]
    return out


def phase_metrics_path(torch) -> None:
    """M1, after paths A-L: the port's registry rendered and held to the
    OpenMetrics line grammar; every plane's families present; L1's scrape
    deltas and TTFT exemplar (checked in :func:`phase_evidence_path`); K1's
    and L1's one fetch per chunk and ms per step (the same depth); the new
    flight events where the smoke exercises them; and the host cost of a
    counter increment and of an exemplar observation over 10^5 calls."""
    from langstream_tpu_torch.core import metrics

    label = "M1 the Prometheus scrape"
    body = metrics.render_metrics().decode()
    exemplars = scrape_grammar(body)
    families = {line.split(" ")[2] for line in body.splitlines()
                if line.startswith("# TYPE ")}
    missing = {}
    for plane, names in M_FAMILIES.items():
        gone = [n for n in names if not any(f.endswith(n) for f in families)]
        if gone:
            missing[plane] = gone
    if missing:
        fail(f"{label}: families missing by plane: {missing}")
    for path in ("K1", "L1"):
        line = NOTES[path]
        if line["host_fetches_per_chunk"] != 1.0:
            fail(f"{label}: {path} host_fetches_per_chunk {line['host_fetches_per_chunk']}")
    events = {"A recompile": NOTES["A"]["events"].get("recompile", 0),
              "E warmup": NOTES["E"]["events"].get("warmup", 0),
              "D spec-auto-disable": NOTES["D"]["events"].get("spec-auto-disable", 0)}
    if events["A recompile"] < 2 or events["E warmup"] != 2:
        fail(f"{label}: recompile on A and warmup begin/end on E expected: {events}")
    if bool(events["D spec-auto-disable"]) != bool(NOTES["D"]["flips"]):
        fail(f"{label}: D's auto-disable events {events} against its flips "
             f"{NOTES['D']['flips']} (uplift {NOTES['D']['uplift']})")
    rep = metrics.PrometheusMetricsReporter(prefix="langstream_smoke", agent_id="m1")
    inc = rep.counter("cost_total", "the host cost probe")
    observe = rep.exemplar_histogram("cost_seconds", "the host cost probe")
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        inc(1)
    inc_ns = (time.perf_counter() - t0) / n * 1e9
    t0 = time.perf_counter()
    for _ in range(n):
        observe(0.004, "0af7651916cd43dd8448eb211c80319c")
    obs_ns = (time.perf_counter() - t0) / n * 1e9
    l1 = NOTES["L1"]
    print(f"path M [{label}]: {len(body.splitlines())} lines, {len(families)} families, "
          f"{len(exemplars)} exemplars, grammar ok; every plane present "
          f"({', '.join(M_FAMILIES)}); L1 deltas tokens={l1['tokens_delta']} "
          f"requests={l1['requests_delta']} equal its stats, its TTFT exemplar "
          f"{l1['exemplar']} names a journey of {l1['exemplar_events']} events; "
          f"host_fetches_per_chunk K1={NOTES['K1']['host_fetches_per_chunk']} "
          f"L1={l1['host_fetches_per_chunk']}; ms_per_step K1={NOTES['K1']['ms_per_step']} "
          f"L1={l1['ms_per_step']} (both at {K_LAYERS} layers); "
          f"events {events} (D uplift {NOTES['D']['uplift']}); "
          f"host ns per counter increment {inc_ns:.1f}, per exemplar observation "
          f"{obs_ns:.1f} (over {n} calls)", flush=True)


def phase_writer_path(torch, model: str = "llama3-8b", device="cuda") -> dict:
    """M2: ``model`` (llama3-8b) at full width and ``M2_LAYERS`` layers, random
    weights from seed 0, written by ``save_llama_checkpoint`` (f32, ~5.9 GB)
    to a temporary directory, then served by an engine whose resource names
    it under ``checkpoint:`` with ``quantize: int8``; fails unless its
    greedy tokens for ``M_REQUESTS`` prompts equal those of an engine built
    from the same params in memory. Prints the write and load seconds and
    the bytes written; the directory is deleted after."""
    import shutil
    import tempfile

    from langstream_tpu_torch.models.checkpoints import save_llama_checkpoint
    from langstream_tpu_torch.models.llama import init_llama_params
    from langstream_tpu_torch.serving import engine as engine_module
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    label = "M2 checkpoint writer"
    cfg = {"model": model, "quantize": "int8", "slots": M_REQUESTS,
           "max-seq-len": 2048, "decode-chunk": 32, "seed": 0}
    prompts = chat_prompts()[:M_REQUESTS]
    tmp = tempfile.mkdtemp(prefix="ls-m2-checkpoint-")
    reset_counts()
    try:
        with cut_depth(model, M2_LAYERS):
            mc = engine_module._MODEL_CONFIGS[model](max_seq_len=2048)
            params = init_llama_params(mc, torch.Generator(device=device).manual_seed(0),
                                       device=device)
            t0 = time.monotonic()
            save_llama_checkpoint(params, mc, tmp)
            write_s = time.monotonic() - t0
            nbytes = sum(p.stat().st_size for p in Path(tmp).iterdir())
            t0 = time.monotonic()
            loaded = TorchServingEngine(ServingConfig.from_dict({**cfg, "checkpoint": tmp}),
                                        device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            in_memory = TorchServingEngine(ServingConfig.from_dict(cfg), device=device,
                                           params=params)

            async def run():
                try:
                    return ((await serve(loaded, prompts, 32))[0],
                            (await serve(in_memory, prompts, 32))[0])
                finally:
                    await loaded.close()
                    await in_memory.close()

            got, want = asyncio.run(run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = read_counts()
    if any(not r["tokens"] for r in got):
        fail(f"{label}: a request returned no tokens")
    if [r["tokens"] for r in got] != [r["tokens"] for r in want]:
        fail(f"{label}: greedy tokens through checkpoint: differ from the in-memory "
             f"engine's")
    print(f"path M [{label}]: {model} full width at {M2_LAYERS} layers, "
          f"{nbytes} bytes written in {write_s:.2f} s, loaded and quantized in "
          f"{load_s:.2f} s; {M_REQUESTS} greedy streams "
          f"({sum(len(r['tokens']) for r in got)} tokens) equal the in-memory engine's; "
          f"launches={counts}", flush=True)
    del params, loaded, in_memory
    gc.collect()
    return counts


def phase_dense_int8_path(torch, params, base: dict) -> dict:
    """M3: dense int8 KV (``kv-quantize: int8`` on the dense layout) at
    path B's depth on its int8 weights, the chat prompts of
    paths A and B greedy; ms per step beside A's (dense bf16) and B's
    (paged int8) of this run and the greedy common prefix against B. Fails
    unless the int8 read kernel launched and the bf16 one did not."""
    label = "M3 dense int8 KV"
    counts = phase_main_path(torch, label, {**base, "kv-quantize": "int8"}, params=params,
                             note="M3")[1]
    if counts["paged_attention_q8"] == 0 or counts["paged_attention"] != 0:
        fail(f"{label}: expected the int8 read kernel only: {counts}")
    m3, a, b = (NOTES[k] for k in ("M3", "A", "B"))
    same = total = 0
    for x, y in zip(m3["tokens"], b["tokens"]):
        n = min(len(x), len(y))
        same += next((i for i in range(n) if x[i] != y[i]), n)
        total += max(len(x), len(y))
    print(f"path M [{label}]: ms_per_step {m3['ms_per_step']:.2f} against A (dense bf16) "
          f"{a['ms_per_step']:.2f} and B (paged int8) {b['ms_per_step']:.2f}; greedy "
          f"common prefix against B {same}/{total} ({same / total:.3f}); "
          f"launches={counts}", flush=True)
    return counts


def scrape_round_trip(torch, cfg: dict, device: str, params) -> tuple:
    """Phase 5: one wave on a tiny engine, its tokens and its agent's scrape
    changes (:func:`scrape_changes` between two registry snapshots)."""
    from langstream_tpu_torch.core import metrics
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)

    async def run():
        try:
            before = metrics.snapshot()
            outs = await asyncio.gather(*(engine.generate(p, {"max-tokens": 9})
                                          for p in ("scrape", "the same", "wave", "twice")))
            for _ in range(500):  # the loop's last pass sets the slot gauges
                if all(s.free for s in engine.slots) and not engine._wake.is_set():
                    break
                await asyncio.sleep(0.01)
            engine.stats()  # the section gauges
            return [o["tokens"] for o in outs], scrape_changes(
                before, metrics.snapshot(), cfg["model"])
        finally:
            await engine.close()

    return asyncio.run(run())


def survival_round_trip(torch, cfg: dict, device: str, params) -> dict:
    """Phase 5's survival layouts on one device, under the mixed-length load
    on 3 slots: the greedy streams unfaulted, under K1's chaos plan (its
    pool-grow ``after`` scaled to this load), and drained mid-wave."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    prompts, budgets = survival_load()
    plan = k1_plan(12)  # this load passes pool-grow about 14 times

    async def wave(engine, on_token=None):
        return await asyncio.gather(*(
            engine.generate(p, {"max-tokens": m, "temperature": 0}, on_token=on_token)
            for p, m in zip(prompts, budgets)))

    def run(extra, scenario):
        engine = TorchServingEngine(ServingConfig.from_dict({**cfg, **extra}), device=device,
                                    params=params)

        async def main():
            try:
                return await scenario(engine)
            finally:
                await engine.close()

        return asyncio.run(main()), engine

    async def drained(engine):
        gate, held, seen = asyncio.Event(), asyncio.Event(), [0]

        async def on_token(token, logprob, last):
            seen[0] += 1
            if seen[0] == len(prompts) + 2:
                held.set()
                await gate.wait()

        task = asyncio.ensure_future(wave(engine, on_token))
        await held.wait()
        drain = asyncio.ensure_future(engine.drain(grace_s=120.0))
        await asyncio.sleep(0)
        gate.set()
        report = await drain
        if report["requeued"] < 1 or report["shed"]:
            fail(f"card vs CPU survival {cfg} on {device}: drain report {report}")
        return await task

    clean, _ = run({}, wave)
    chaos, engine = run({"faults": plan}, wave)
    survival = engine.stats()["survival"]
    if survival["shrinks"] < 1 or any(f["fired"] != f["count"] for f in survival["faults"]):
        fail(f"card vs CPU survival {cfg} on {device}: the chaos plan did not fire: {survival}")
    drain, _ = run({}, drained)
    return {name: [r["tokens"] for r in results]
            for name, results in (("clean", clean), ("chaos", chaos), ("drain", drain))}


def survival_load() -> tuple[list, list]:
    prompts = ["paged cache equivalence", "second prompt!", "a", "judge my vow",
               "abcdefgh, ijklmnop", "the quick brown fox", "survival plane", "drain me"]
    return prompts, [5, 12, 9, 16, 7, 21, 11, 14]


def journal_across(torch, cfg: dict, src: str, dst: str, params) -> list:
    """A journal written on ``src`` (its prefill hangs, so nothing it
    accepts is answered before its loop is abandoned) and replayed on
    ``dst``; the replayed requests' greedy streams in the order accepted."""
    import tempfile

    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    prompts, budgets = survival_load()
    journal = {"journal-dir": tempfile.mkdtemp(prefix="ls-journal-")}

    async def crash():
        engine = TorchServingEngine(ServingConfig.from_dict(
            {**cfg, **journal, "faults": [{"site": "prefill", "shape": "hang",
                                           "hang-ms": 2000.0}]}), device=src, params=params)
        tasks = [asyncio.ensure_future(engine.generate(p, {"max-tokens": m, "temperature": 0}))
                 for p, m in zip(prompts, budgets)]
        await asyncio.sleep(0)
        if not engine.journal.flush(10.0) or engine.journal.stats()["live"] != len(prompts):
            fail(f"card vs CPU journal {cfg}: {engine.journal.stats()}")
        engine._loop_task.cancel()
        for t in tasks:
            t.cancel()

    asyncio.run(crash())
    engine = TorchServingEngine(ServingConfig.from_dict({**cfg, **journal}), device=dst,
                                params=params)
    replayed = []
    requeue = engine.scheduler.requeue_front
    engine.scheduler.requeue_front = lambda r: (replayed.append(r) if r.preemptions == 0
                                                else None, requeue(r))

    async def replay():
        try:
            await engine.generate("fresh", {"max-tokens": 2, "temperature": 0})
            results = await asyncio.wait_for(asyncio.gather(*(r.future for r in replayed)), 120)
            engine.journal.flush(10.0)
            return [r["tokens"] for r in reversed(results)], engine.journal.stats()
        finally:
            await engine.close()

    tokens, stats = asyncio.run(replay())
    if stats["replayed"] != len(prompts) or stats["live"]:
        fail(f"card vs CPU journal {cfg} {src}->{dst}: {stats}")
    return tokens


def adapter_round_trip(torch, cfg: dict, device: str, params) -> tuple:
    """Phase 5's adapter case on one device: greedy tokens of two prompts
    under one adapter (rank 4, ``scale=0.5``), and of a store-less engine
    whose weights carry the adapter merged offline."""
    from langstream_tpu_torch.serving.adapters import make_lora_arrays, merge_adapter_into_params
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    arrays = make_lora_arrays(layers=2, hidden=64, heads=4, kv_heads=2, head_dim=16, rank=4,
                              seed=41, scale=0.5)
    prompts = [list(range(1, 80)), "paged cache equivalence under an adapter"]
    opts = {"max-tokens": 12, "temperature": 0}

    async def serve(engine, adapter):
        try:
            out = []
            for p in prompts:
                out.append((await engine.generate(
                    p, {**opts, **({"adapter": adapter} if adapter else {})}))["tokens"])
            return out
        finally:
            await engine.close()

    eng = TorchServingEngine(ServingConfig.from_dict(
        {**cfg, "adapter-store": {"rank": 4, "t0-entries": 2}}), device=device, params=params)
    eng.install_adapter("tenant-a", arrays)
    adapted = asyncio.run(serve(eng, "tenant-a"))
    merged = TorchServingEngine(ServingConfig.from_dict(cfg), device=device,
                                params=merge_adapter_into_params(params, arrays))
    base = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)
    return adapted, asyncio.run(serve(merged, "")), asyncio.run(serve(base, ""))


def tier_round_trip(torch, cfg: dict, device: str, params) -> list:
    """Phase 5's tier layout on one device: a request cold, the same again
    after its blocks demoted to T2 (promotion), and on a fresh engine over
    the same T2 directory (hydration). Returns the three greedy streams."""
    import tempfile

    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    store = {"t0-bytes": 0, "t1-bytes": 1, "t2-rescan-s": 0.1,
             "t2": {"type": "local", "path": tempfile.mkdtemp(prefix="ls-prefix-t2-")}}
    cfg = {**cfg, "prefix-store": store}
    prompt = list(range(1, 100))
    opts = {"max-tokens": 12, "temperature": 0}

    async def writer():
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)
        try:
            cold = await engine.generate(prompt, dict(opts))
            for _ in range(600):
                st = engine.stats()["prefixstore"]
                if (st["t0"]["blocks"] == 0 and st["t1"]["entries"] == 0
                        and not st["t2"]["pending_jobs"] and not st["t2"]["in_transit_bytes"]):
                    break
                await asyncio.sleep(0.02)
            warm = await engine.generate(prompt, dict(opts))
            if engine.stats()["prefixstore"]["promotions"] == 0:
                fail(f"card vs CPU tiers {cfg}: no promotion on {device}")
            return cold["tokens"], warm["tokens"]
        finally:
            await engine.close()

    async def reader():
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)
        try:
            engine.prefix_store.flush(10)
            out = await engine.generate(prompt, dict(opts))
            if engine.stats()["prefixstore"]["hydrations"] == 0:
                fail(f"card vs CPU tiers {cfg}: no hydration on {device}")
            return out["tokens"]
        finally:
            await engine.close()

    cold, warm = asyncio.run(writer())
    return [cold, warm, asyncio.run(reader())]


def handoff_across(torch, cfg: dict, src: str, dst: str, params) -> list:
    """An export made on ``src`` imported on ``dst``; the decoded streams."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    prompts = ["disaggregated serving byte identity prompt", "second prompt!"]

    async def run():
        pre = TorchServingEngine(ServingConfig.from_dict({**cfg, "pool-role": "prefill"}),
                                 device=src, params=params)
        dec = TorchServingEngine(ServingConfig.from_dict({**cfg, "pool-role": "decode"}),
                                 device=dst, params=params)
        try:
            out = []
            for p in prompts:
                ticket = await pre.generate(p, {"max-tokens": 12, "temperature": 0})
                out.append((await dec.import_handoff(pre.take_export(ticket["handoff"])))["tokens"])
            return out
        finally:
            await pre.close()
            await dec.close()

    return asyncio.run(run())


def evidence_round_trip(torch, cfg: dict, device: str, params) -> tuple:
    """Phase 5's request-evidence check: a mixed wave on a combined engine,
    then one chained handoff whose only decode replica is dead (the local
    fallback on the prefill engine). Returns the greedy tokens and each
    request's journey kinds."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
    from langstream_tpu_torch.serving.handoff import BreakerSpec, HandoffChainer, RetryPolicy
    from langstream_tpu_torch.serving.journey import JOURNEYS

    async def dead(replica, payload, headers, timeout_s):
        raise ConnectionError(f"{replica} refused the connection")

    async def run():
        wave = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)
        pre = TorchServingEngine(ServingConfig.from_dict({**cfg, "pool-role": "prefill"}),
                                 device=device, params=params)
        before = set(JOURNEYS.ids())
        try:
            outs = await asyncio.gather(*(wave.generate(p, {"max-tokens": m, "temperature": 0})
                                          for p, m in zip(*survival_load())))
            chainer = HandoffChainer(pre, router=L2Router(("dead-0",), BreakerSpec(failures=1)),
                                     transport=dead,
                                     policy=RetryPolicy(attempts=2, backoff_s=0.001))
            ticket = await pre.generate("a chained handoff falls back", {"max-tokens": 10,
                                                                          "temperature": 0})
            fallback = await chainer.chain(ticket)
        finally:
            await wave.close()
            await pre.close()
        kinds = [[e["kind"] for e in JOURNEYS.events(j)] for j in JOURNEYS.ids()
                 if j not in before]
        return [o["tokens"] for o in outs] + [fallback["tokens"]], kinds

    return asyncio.run(run())


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
                   {"kv-layout": "dense", "kv-quantize": "int8"},
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

    # KV off the card: T1 promotion and T2 hydration (cold = promoted =
    # hydrated on each device, card = CPU), and handoffs across devices
    tiny = {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 256,
            "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16}
    for layout in ({}, {"kv-quantize": "int8"}):
        cfg = {**tiny, **layout}
        out = {name: tier_round_trip(torch, cfg, device, params["tiny"])
               for name, device in zip(("cuda", "cpu"), devices)}
        if out["cuda"] != out["cpu"] or any(t != out["cuda"][0] for t in out["cuda"]):
            fail(f"card vs CPU tiers {layout}: cold, T1-promoted and T2-hydrated greedy "
                 f"tokens must be one stream on both devices:\n{out}")
        print(f"card vs CPU [tiers, paged {layout.get('kv-quantize') or 'f32'} KV]: cold, "
              f"T1-promoted and T2-hydrated greedy streams identical on the card and the "
              f"CPU", flush=True)
    for layout in ({}, {"kv-quantize": "int8"}):
        cfg = {**tiny, **layout, "prefix-cache": False}
        out = {name: adapter_round_trip(torch, cfg, device, params["tiny"])
               for name, device in zip(("cuda", "cpu"), devices)}
        adapted, merged, base = out["cuda"]
        if out["cuda"][:2] != out["cpu"][:2] or adapted != merged or adapted == base:
            fail(f"card vs CPU adapter {layout}: adapted, offline-merged and base streams "
                 f"(card, cpu):\n{out}")
        print(f"card vs CPU [adapter, paged {layout.get('kv-quantize') or 'f32'} KV]: greedy "
              f"streams under one adapter identical on the card and the CPU and equal to "
              f"the offline-merged weights'; base differs", flush=True)
    for layout in ({}, {"kv-quantize": "int8"}):
        cfg = {**tiny, **layout, "prefix-cache": False}
        ref = handoff_across(torch, cfg, devices[1], devices[1], params["tiny"])
        out = {f"{a}->{b}": handoff_across(torch, cfg, da, db, params["tiny"])
               for (a, da), (b, db) in ((("card", devices[0]), ("cpu", devices[1])),
                                        (("cpu", devices[1]), ("card", devices[0])))}
        if any(v != ref for v in out.values()):
            fail(f"card vs CPU handoff {layout}: {out} against CPU->CPU {ref}")
        print(f"card vs CPU [handoff, paged {layout.get('kv-quantize') or 'f32'} KV]: "
              f"exports made on the card decode on the CPU and the reverse with the "
              f"CPU->CPU greedy tokens", flush=True)

    # the survival plane (path K's shapes, tiny): chaos, a drain mid-wave, a
    # journal written on the card and replayed on the CPU, under the mixed
    # load with the pipelined loop
    for layout in ({}, {"kv-quantize": "int8"}):
        cfg = {**tiny, **layout, "pipeline": True, "shrink-recovery-s": 0.3}
        out = {name: survival_round_trip(torch, cfg, device, params["tiny"])
               for name, device in zip(("cuda", "cpu"), devices)}
        streams = [out[d][k] for d in out for k in ("clean", "chaos", "drain")]
        replayed = journal_across(torch, cfg, devices[0], devices[1], params["tiny"])
        if any(t != streams[0] for t in streams + [replayed]):
            fail(f"card vs CPU survival {layout}: clean, chaos, drained and replayed greedy "
                 f"streams must be one on both devices:\n{out}\nreplayed {replayed}")
        print(f"card vs CPU [survival, paged {layout.get('kv-quantize') or 'f32'} KV, "
              f"pipelined]: unfaulted, K1-chaos and drained greedy streams identical on "
              f"the card and the CPU; a journal written on the card replays on the CPU to "
              f"them", flush=True)

    # the request-evidence and cross-replica planes (path L's shapes, tiny)
    cfg = {**tiny, "prefix-cache": False}
    out = {name: evidence_round_trip(torch, cfg, device, params["tiny"])
           for name, device in zip(("cuda", "cpu"), devices)}
    tokens, kinds = out["cuda"]
    if out["cuda"] != out["cpu"] or kinds[-1] != [
            "submit", "admit", "first-token", "export", "export-taken", "import-received",
            "import", "first-step", "finish"] or any(k[-1] != "finish" for k in kinds):
        fail(f"card vs CPU [journeys]: the card {out['cuda']} against the CPU {out['cpu']}")
    print(f"card vs CPU [journeys, paged f32 KV]: a mixed wave of {len(tokens) - 1} and a "
          f"chained handoff's local fallback: greedy tokens and the journey kinds of every "
          f"request identical on the card and the CPU", flush=True)

    # the Prometheus plane (path M1's series, tiny): one wave's scrape
    cfg = {**tiny, "kv-quantize": "int8", "prefix-cache": False}
    out = {name: scrape_round_trip(torch, cfg, device, params["tiny"])
           for name, device in zip(("cuda", "cpu"), devices)}
    tokens, changes = out["cuda"]
    if out["cuda"] != out["cpu"] or not changes.get(
            "langstream_serving_tokens_generated_total"):
        fail(f"card vs CPU [scrape]: the card {out['cuda']} against the CPU {out['cpu']}")
    print(f"card vs CPU [scrape, paged int8 KV]: a wave of {len(tokens)}: greedy tokens and "
          f"the change of all {len(changes)} series (counters, gauges, histogram counts; "
          f"times by presence) identical on the card and the CPU", flush=True)


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


# ---------------------------------------------------------------------------
# path N: multi-GPU serving, two ranks of one mesh on this card
# ---------------------------------------------------------------------------

N_LAYERS = 4          # N1 (Llama-3-8B) depth, of 32 (8 until path R came)
N2_LAYERS = 2         # N2 (Mixtral-8x7B) depth, of 32
N1_MAX_TOKENS = 64
N_GAP = 0.05          # the first token must match where tp=1's top-2 gap exceeds it
N_LOAD_PEAK = 1.0     # a tp=2 rank's load peak must stay under the tp=1 tree's bytes
N_RESOURCE = {"model": "llama3-8b", "quantize": "int8", "kv-layout": "paged",
              "kv-quantize": "int8", "prefix-cache": False, "slots": 16,
              "max-seq-len": 2048, "decode-chunk": 32, "seed": 0}
N2_RESOURCE = {"model": "moe-8x7b", "quantize": "int8", "slots": 8,
               "max-seq-len": 1024, "decode-chunk": 8, "seed": 0}
N3_RESOURCE = {"model": "tiny", "model-dtype": "float32", "kv-layout": "paged",
               "kv-block-size": 16, "prefix-cache": True, "prefill-chunk": 16,
               "speculative-drafts": 4, "slots": 4, "max-seq-len": 256,
               "decode-chunk": 4, "seed": 0,
               "checkpoint": str(REPO / "tests" / "fixtures" / "llama_tiny_golden")}


def n_prompts(n: int = 16) -> list[str]:
    topics = ["GPUs", "rivers", "databases", "chess", "tea", "orbits", "bridges", "bees"]
    return [f"Request {i}: write a short paragraph about {topics[i % len(topics)]}"
            + " and why it matters" * (i % 4) for i in range(n)]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_run(torch, label: str, configs: list[dict], waves: list[list[str]],
             max_tokens: int, layers: int | None = None, device="cuda",
             before=None, after=None) -> list[dict]:
    """Serve ``configs`` in turn on a two-rank mesh: this process is rank 0
    (the leader), one spawned ``lockstep_demo --index 1`` process is rank 1,
    both on this card over gloo. Per configuration: the results, stats and
    mesh section, rank 0's launches (counts set to 0 just before the run),
    rank 1's launches and the dispatches both ranks sampled, checked equal.
    ``before(engine)`` runs on rank 0's engine before the waves,
    ``after(engine)`` after them and before ``close()`` (its value in the
    run's ``after``). Each configuration is one world, ended by the
    engine's ``close()``. Fails on a follower that does not start or exits
    non-zero, a collective timeout or a lockstep failure."""
    from langstream_tpu_torch.parallel.mesh import init_distributed, shutdown
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
    from langstream_tpu_torch.serving.lockstep_demo import cut_layers

    coordinator, lockstep = _free_port(), _free_port()
    out = Path(os.environ.get("TMPDIR", "/tmp")) / f"chip_smoke_rank1_{os.getpid()}.json"
    flat = [p for wave in waves for p in wave]
    cmd = [sys.executable, "-m", "langstream_tpu_torch.serving.lockstep_demo",
           "--index", "1", "--num-processes", "2", "--coordinator-port", str(coordinator),
           "--lockstep-port", str(lockstep), "--device", device,
           "--config", json.dumps(configs), "--prompts", json.dumps(flat),
           "--max-tokens", str(max_tokens), "--out", str(out)]
    if layers:
        cmd += ["--layers", str(layers)]
    env = {**os.environ, "PYTHONPATH": str(REPO), "LS_TORCH_COLLECTIVE_TIMEOUT_S": "120"}
    log_path = out.with_suffix(".log")
    with open(log_path, "wb") as log_file:  # a file: a full pipe would stall rank 1
        follower = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                                    stderr=log_file)

    def rank1_log() -> str:
        text = log_path.read_text(errors="replace")[-3000:]
        log_path.unlink(missing_ok=True)
        return text

    os.environ["LS_LOCKSTEP_PORT"] = str(lockstep)
    runs = []
    try:
        for cfg in configs:
            # one world per configuration: the engine's close() ends it
            init_distributed(f"127.0.0.1:{coordinator}", 2, 0, device, timeout_s=120)
            t0 = time.monotonic()
            with cut_layers(layers):
                engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device)
            engine.lockstep_tokens = {}  # held against rank 1's
            init_s = time.monotonic() - t0
            if before is not None:
                before(engine)
            reset_counts()
            t0 = time.monotonic()
            results, inspected = [], []

            async def drive():
                try:
                    for wave in waves:
                        results.extend(await asyncio.gather(*(
                            engine.generate(p, {"max-tokens": max_tokens, "temperature": 0})
                            for p in wave)))
                    if after is not None:
                        inspected.append(after(engine))
                    return engine.stats()
                finally:
                    await engine.close()

            stats = asyncio.run(drive())
            if device == "cuda":
                torch.cuda.synchronize()
            runs.append({"results": results, "stats": stats, "wall_s": time.monotonic() - t0,
                         "init_s": init_s, "counts": read_counts(),
                         "mesh": engine.mesh_section(),
                         "after": inspected[0] if inspected else None,
                         "dispatches": [[op, v.tolist()] for _, (op, v) in
                                        sorted(engine.lockstep_tokens.items())]})
            del engine
            gc.collect()
    except BaseException:
        follower.kill()
        follower.wait()
        print(f"path N [{label}]: rank 1's stderr tail:\n{rank1_log()}", flush=True)
        raise
    finally:
        shutdown(barrier=False)  # a failed run's world; nothing after close()
        os.environ.pop("LS_LOCKSTEP_PORT", None)
    try:
        follower.wait(timeout=120)
    except subprocess.TimeoutExpired:
        follower.kill()
        follower.wait()
        fail(f"path N [{label}]: rank 1 did not exit after the leader's stop: {rank1_log()}")
    err = rank1_log()
    if follower.returncode != 0:
        fail(f"path N [{label}]: rank 1 exited {follower.returncode}: {err}")
    rank1 = json.loads(out.read_text())
    out.unlink()
    for run, other in zip(runs, rank1):
        if other["dispatches"] != run["dispatches"]:
            fail(f"path N [{label}]: rank 1 sampled other tokens than rank 0")
        run["rank1"] = other
    return runs


def top2_gaps(torch, engine, prompts: list[str], adapters=None) -> list[float]:
    """The tp=1 reference's first-token top-2 logprob gap per prompt, from
    one prefill forward of each prompt on the engine's own params;
    ``adapters[i]`` (factors by name, or None) is prompt i's LoRA adapter,
    applied as a one-row ``adapters`` argument."""
    from langstream_tpu_torch.models.llama import prefill_forward

    gaps = []
    for i, p in enumerate(prompts):
        ids = engine.tokenizer.encode(p)
        tokens = torch.tensor([ids], device=engine.device)
        lengths = torch.tensor([len(ids)], device=engine.device)
        lora = None
        if adapters is not None and adapters[i] is not None:
            dtype = engine.model_config.dtype
            factors = {k: torch.as_tensor(v).to(engine.device, dtype)
                       for k, v in adapters[i].items()}
            lora = {"ids": torch.ones(1, dtype=torch.long, device=engine.device),
                    "layers": {k: torch.stack([torch.zeros_like(t), t], dim=1)
                               for k, t in factors.items()}}
        with torch.no_grad():
            logits = prefill_forward(engine.model_config, engine.params, tokens, lengths,
                                     ffn=engine._ffn, adapters=lora)[0]
        top = torch.log_softmax(logits[0].float(), dim=-1).topk(2).values
        gaps.append(float(top[0] - top[1]))
    return gaps


def reference_run(torch, cfg: dict, waves, max_tokens: int, layers: int | None,
                  device="cuda", before=None, after=None) -> tuple[dict, list[float]]:
    """The same configuration without its mesh, on ``device``: results,
    stats and the first tokens' top-2 gaps (``before``/``after`` as in
    :func:`mesh_run`)."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
    from langstream_tpu_torch.serving.lockstep_demo import cut_layers

    cfg = {k: v for k, v in cfg.items() if k != "mesh"}
    with cut_layers(layers):
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device)
    flat = [p for wave in waves for p in wave]
    gaps = top2_gaps(torch, engine, flat)
    if before is not None:
        before(engine)
    results, inspected = [], []

    async def drive():
        try:
            for wave in waves:
                results.extend(await asyncio.gather(*(
                    engine.generate(p, {"max-tokens": max_tokens, "temperature": 0})
                    for p in wave)))
            if after is not None:
                inspected.append(after(engine))
            return engine.stats()
        finally:
            await engine.close()

    t0 = time.monotonic()
    stats = asyncio.run(drive())
    out = {"results": results, "stats": stats, "wall_s": time.monotonic() - t0,
           "weights_bytes": engine._weights_bytes,
           "after": inspected[0] if inspected else None}
    del engine
    gc.collect()
    return out, gaps


def _step_ms(stats: dict) -> float | None:
    dc = stats["decode-chunks"]
    return round(dc["seconds"] / dc["steps"] * 1e3, 3) if dc["steps"] else None


def check_first_tokens(label: str, mesh_results, ref_results, gaps,
                       path: str = "N") -> dict:
    """The first-token rule: equal wherever the reference's top-2 gap
    exceeds ``N_GAP``, the first logprob within ``N_GAP``; every stream's
    common prefix with the reference."""
    prefixes, checked = [], 0
    for i, (m, r, gap) in enumerate(zip(mesh_results, ref_results, gaps)):
        if not m["tokens"] or not r["tokens"]:
            fail(f"path {path} [{label}]: request {i} generated nothing")
        if gap > N_GAP:
            checked += 1
            if m["tokens"][0] != r["tokens"][0]:
                fail(f"path {path} [{label}]: request {i}'s first token {m['tokens'][0]} != "
                     f"{r['tokens'][0]} at a top-2 gap of {gap:.4f}")
        if abs(m["logprobs"][0] - r["logprobs"][0]) > N_GAP:
            fail(f"path {path} [{label}]: request {i}'s first logprob {m['logprobs'][0]:.4f} "
                 f"vs {r['logprobs'][0]:.4f}")
        common = 0
        for a, b in zip(m["tokens"], r["tokens"]):
            if a != b:
                break
            common += 1
        prefixes.append(f"{common}/{len(r['tokens'])}")
    print(f"path {path} [{label}]: first tokens equal at {checked} of {len(gaps)} requests "
          f"with a top-2 gap > {N_GAP}; common prefixes {prefixes}", flush=True)
    return {"checked": checked, "prefixes": prefixes}


def _mesh_line(label: str, run: dict, ref: dict | None = None, path: str = "N",
               extra: dict | None = None) -> None:
    mesh = run["mesh"]
    coll = mesh["collectives"]
    step = _step_ms(run["stats"])
    decode_s = run["stats"]["decode-chunks"]["seconds"]
    # the decode steps' vocab gathers only (prefill and verify gathers are
    # tagged "logits"); over gloo on the card a collective's seconds are its
    # own (the stream is synchronized before its timer starts)
    gather = coll.get("logits-decode", {"seconds": 0.0, "calls": 0, "bytes": 0})
    report = {
        "ms_per_step_mesh": step,
        "ms_per_step_reference": _step_ms(ref["stats"]) if ref else None,
        "wall_s": round(run["wall_s"], 3), "init_s": round(run["init_s"], 3),
        "backend": mesh["backend"], "backend_reason": mesh["backend-reason"],
        "rank0_launches": {k: v for k, v in run["counts"].items() if v},
        "rank1_launches": {k: v for k, v in run["rank1"]["kernels"].items() if v},
        "collectives": coll,
        "decode_logits_gather_share_of_decode": (round(gather["seconds"] / decode_s, 4)
                                                 if decode_s else None),
        "weights_bytes": [mesh["weights-bytes"], run["rank1"]["mesh"]["weights-bytes"]],
        "load_peak_bytes": [mesh["load-peak-bytes"],
                            run["rank1"]["mesh"]["load-peak-bytes"]],
        "reference_weights_bytes": ref["weights_bytes"] if ref else None,
    }
    report.update(extra or {})
    print(f"path {path} [{label}]: {json.dumps(report)}", flush=True)


def phase_mesh_path(torch, device="cuda") -> dict:
    """Path N: multi-GPU serving through the port's lockstep mesh, two
    ranks sharing this card over gloo (NCCL refuses two ranks on one device;
    one card per rank is not exercised on a one-card machine). Two ranks on
    one card measure the seam, not the speed of TP: no speed is claimed.

    - N1: Llama-3-8B int8 at full width and ``N_LAYERS`` layers, paged int8
      KV, ``mesh: {tp: 2}``, 16 slots, 16 greedy requests of
      ``N1_MAX_TOKENS`` tokens, against a tp=1 engine on the same weights
      (the same seed): the first-token rule; kernels #1 and #3 launch on both
      ranks.
    - N2: Mixtral-8x7B int8 at full width and ``N2_LAYERS`` layers,
      ``mesh: {ep: 2, tp: 1}`` (the MoE specs name tp, so the ep-only mesh
      carries tp of 1), 8 requests of 32 tokens, the same rule against ep=1.
    - N3: ``tiny`` f32 on the HF fixture, ``mesh: {tp: 2}``, paged with the
      prefix cache, chunked prefill and speculation, then the same without
      speculation (the pipelined burst's chained chunks), then dense KV at
      ``mesh: {dp: 2, tp: 1}``: every lockstep op runs and the leader's
      greedy tokens equal a CPU one-rank run.

    Returns rank 0's launches summed over N1-N3."""
    totals = {name: 0 for name in _wrappers()}
    t0 = time.monotonic()
    # -- N1 -----------------------------------------------------------------
    waves = [n_prompts(16)]
    n1 = mesh_run(torch, "N1", [{**N_RESOURCE, "mesh": {"tp": 2}}], waves,
                  N1_MAX_TOKENS, layers=N_LAYERS, device=device)[0]
    ref, gaps = reference_run(torch, N_RESOURCE, waves, N1_MAX_TOKENS, N_LAYERS, device)
    _mesh_line("N1 llama3-8b int8 tp=2", n1, ref)
    check_first_tokens("N1", n1["results"], ref["results"], gaps)
    # each rank places its shards and never the whole tree: its peak while
    # loading is its half plus one whole leaf and a chunk's transient
    for rank, mesh in (("0", n1["mesh"]), ("1", n1["rank1"]["mesh"])):
        if device == "cuda" and mesh["load-peak-bytes"] > N_LOAD_PEAK * ref["weights_bytes"]:
            fail(f"path N1: rank {rank} peaked at {mesh['load-peak-bytes']} bytes while "
                 f"loading, over {N_LOAD_PEAK} of the tp=1 tree's {ref['weights_bytes']}")
    for rank, counts in (("0", n1["counts"]), ("1", n1["rank1"]["kernels"])):
        if device == "cuda" and (counts["flash_attention"] == 0
                                 or counts["paged_attention_q8"] == 0):
            fail(f"path N1: rank {rank} did not launch kernels #1 and #3: {counts}")
    print("path N1: two ranks share one card here; the ms per step measure the "
          "lockstep seam and gloo collectives through the host, not the speed of "
          "tensor parallelism", flush=True)
    totals = {k: totals[k] + n1["counts"][k] for k in totals}
    del ref
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = time.monotonic()
    # -- N2 -----------------------------------------------------------------
    waves = [n_prompts(8)]
    n2 = mesh_run(torch, "N2", [{**N2_RESOURCE, "mesh": {"ep": 2, "tp": 1}}], waves, 32,
                  layers=N2_LAYERS, device=device)[0]
    ref, gaps = reference_run(torch, N2_RESOURCE, waves, 32, N2_LAYERS, device)
    _mesh_line("N2 moe-8x7b int8 ep=2", n2, ref)
    check_first_tokens("N2", n2["results"], ref["results"], gaps)
    totals = {k: totals[k] + n2["counts"][k] for k in totals}
    del ref
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t2 = time.monotonic()
    # -- N3 -----------------------------------------------------------------
    preamble = "System: answer briefly and well, with care. "
    waves = [["hello gpu world", preamble + "the quick brown fox", "abcdefgh, ijklmnop",
              preamble * 3 + "a long prompt in chunks"],
             [preamble + "judge my vow", "a", preamble * 3 + "and again"]]
    plain = {**N3_RESOURCE, "speculative-drafts": 0, "decode-chunk-light": 0}
    dense = {**plain, "kv-layout": "dense", "prefix-cache": False, "prefill-chunk": 0}
    n3 = mesh_run(torch, "N3", [{**N3_RESOURCE, "mesh": {"tp": 2}},
                                {**plain, "mesh": {"tp": 2}},
                                {**dense, "mesh": {"dp": 2, "tp": 1}}], waves, 24,
                  device=device)
    ops = {op for run in n3 for op, _ in run["dispatches"]}
    want_ops = {"prefill", "prefill_continue", "spec_step", "decode", "decode_cont"}
    if not want_ops <= ops:
        fail(f"path N3: lockstep ops {sorted(ops)} miss {sorted(want_ops - ops)}")
    for run, cfg in zip(n3, (N3_RESOURCE, plain, dense)):
        cpu, _ = reference_run(torch, cfg, waves, 24, None, "cpu")
        got = [r["tokens"] for r in run["results"]]
        want = [r["tokens"] for r in cpu["results"]]
        if got != want:
            fail(f"path N3: {run['mesh']['axes']} tokens on the card {got} != the CPU "
                 f"one-rank run {want}")
        totals = {k: totals[k] + run["counts"][k] for k in totals}
    dp = n3[2]["mesh"]
    if dp["dp-slots"] != [0, 2] or "dp-rows" not in dp["collectives"]:
        fail(f"path N3: the dp=2 engine did not split its slots' rows: {dp}")
    print(f"path N3: tiny f32 tp=2, ops {sorted(ops)}, tokens equal the CPU one-rank "
          f"run (speculative, plain, and dense at dp=2 with rank 0 on slots "
          f"{dp['dp-slots']} and {dp['collectives']['dp-rows']['calls']} row sums over "
          f"dp); prefix hits {n3[0]['stats']['prefix']['hits']}, verify steps "
          f"{n3[0]['stats']['speculative']['steps']}", flush=True)
    print(f"path N: {time.monotonic() - t0:.1f} s (N1 {t1 - t0:.1f} s, N2 {t2 - t1:.1f} s, "
          f"N3 {time.monotonic() - t2:.1f} s)", flush=True)
    return totals


# ---------------------------------------------------------------------------
# path O: sequence parallelism and the embeddings mesh, two ranks on this card
# ---------------------------------------------------------------------------

O_LAYERS = 2           # O1 and O2 (Llama-3-8B) depth, of 32 (8 until path R came)
O_MAX_TOKENS = 64
# long-context-summarizer's resource (examples/applications/
# long-context-summarizer/configuration.yaml) with paged int8 KV; its mesh
# {sp: 4, tp: 2} is {sp: 2, tp: 1} here (eight ranks on one card do not fit
# the smoke's time; the Llama specs name tp, so the sp-only mesh carries tp: 1)
O_RESOURCE = {"model": "llama3-8b", "quantize": "int8", "kv-layout": "paged",
              "kv-quantize": "int8", "slots": 8, "max-seq-len": 8192,
              "speculative-drafts": 4, "seed": 0}
O_MESH = {"sp": 2, "tp": 1}
O_PROMPT_TOKENS = (1500, 7000)
# a plain K=1 decode chunk calibrates speculation every this many steps
# (the engine's default is 32): the decode read (kernel #3) then runs on
# both ranks within 64 tokens
O_CALIBRATE_EVERY = "8"
O2_TOKENS = 2048
O3_TEXTS = 64
O3_RESOURCE = {"embeddings-model": "minilm-l6", "mesh": {"dp": 2}}


def o_prompts(n: int = 8) -> list[str]:
    """``n`` reports of ``O_PROMPT_TOKENS`` byte tokens (evenly spread),
    each ending in a request to summarize it."""
    topics = ["river deltas", "GPU kernels", "tea markets", "bridge loads", "orbits",
              "bee colonies", "chess openings", "grid storage"]
    lo, hi = O_PROMPT_TOKENS
    out = []
    for i in range(n):
        target = lo + (hi - lo) * i // max(n - 1, 1)
        body, k = [], 0
        while sum(len(x) for x in body) < target:
            body.append(f"Section {k} of report {i} on {topics[i % len(topics)]}: the "
                        f"measurements repeat, the numbers hold at {k * 7 % 97}, and the "
                        f"summary follows the data. ")
            k += 1
        tail = "\nSummarize the report above:"
        out.append("".join(body)[:target - len(tail)] + tail)
    return out


def _dequant(torch, rows):
    """A paged gather's rows as f32: int8 ``{"q", "s"}`` dequantized."""
    if isinstance(rows, dict):
        q, sc = rows["q"], rows["s"]
        return (q.unflatten(-1, (sc.shape[-1], -1)).float() * sc.float()[..., None]).flatten(-2)
    return rows.float()


def o_cache_rows(torch, prompt: str):
    """An ``after`` hook: the cache rows of ``prompt``'s full blocks, found
    through the prefix cache after the wave, as f32 on the card."""
    from langstream_tpu_torch.models.paged import gather_kv

    def after(engine):
        blocks, n = engine.block_mgr.match_prefix(engine.tokenizer.encode(prompt))
        if not blocks:
            fail("path O1: the long prompt's blocks are not in the prefix cache")
        tables = torch.tensor([blocks], dtype=torch.int32, device=engine.device)
        return {"tokens": n,
                "k": _dequant(torch, gather_kv(engine.cache_k, tables, len(blocks))),
                "v": _dequant(torch, gather_kv(engine.cache_v, tables, len(blocks)))}

    return after


def o_prefill_timer(torch):
    """A ``before`` hook wrapping the engine's prefill dispatch (the first
    prompts' prefills: continuations are not counted): the seconds, the
    calls and the prompts, on the dispatch thread, whose numpy result
    waits for the card."""
    spent = {"s": 0.0, "calls": 0, "prompts": 0, "shapes": []}

    def before(engine):
        run = engine._run_prefill

        def timed(padded, lengths, slot_ids, *args, **kw):
            t0 = time.monotonic()
            out = run(padded, lengths, slot_ids, *args, **kw)
            if kw.get("cont") is None:
                spent["s"] += time.monotonic() - t0
                spent["calls"] += 1
                spent["prompts"] += len(slot_ids)
                spent["shapes"].append(list(padded.shape))
            return out

        engine._run_prefill = timed

    return spent, before


def _spawn_rank1(cmd: list[str], tag: str):
    """Start rank 1 (``cmd``), its stderr to a file; returns the process and
    a function that reads (and removes) the file's tail."""
    log_path = Path(os.environ.get("TMPDIR", "/tmp")) / f"chip_smoke_{tag}_{os.getpid()}.log"
    env = {**os.environ, "PYTHONPATH": str(REPO), "LS_TORCH_COLLECTIVE_TIMEOUT_S": "120"}
    with open(log_path, "wb") as log_file:  # a file: a full pipe would stall rank 1
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                                stderr=log_file)

    def tail() -> str:
        text = log_path.read_text(errors="replace")[-3000:] if log_path.exists() else ""
        log_path.unlink(missing_ok=True)
        return text

    return proc, tail


def _join_rank1(proc, tail, label: str) -> None:
    try:
        proc.wait(timeout=180)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"path O [{label}]: rank 1 did not exit: {tail()}")
    err = tail()
    if proc.returncode != 0:
        fail(f"path O [{label}]: rank 1 exited {proc.returncode}: {err}")


def o2_forward(torch, rank: int, coordinator: str, device="cuda",
               model: str | None = None, n_tokens: int | None = None) -> dict:
    """O2 on one rank (this process is rank 0, ``--o2-rank`` rank 1): the
    resource's model at full width and ``O_LAYERS`` layers on one
    ``O2_TOKENS``-token sequence, ``llama_forward_sp`` with the ring and
    with Ulysses at ``{sp: 2}`` against the one-rank ``llama_forward`` with
    dense attention (the JAX library's default) on this rank's positions;
    the normalised max abs error (by the reference's max abs) and ms of
    each. The weights are made from seed 0 on both ranks; ``model`` and
    ``n_tokens`` default to ``O_RESOURCE``'s model and ``O2_TOKENS`` (rank
    0 passes its own to rank 1)."""
    from functools import partial

    from langstream_tpu_torch.models.llama import (
        llama_forward,
        llama_forward_sp,
        local_config,
    )
    from langstream_tpu_torch.models.quant import init_llama_params_q8
    from langstream_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown
    from langstream_tpu_torch.parallel.ring import dense_attention
    from langstream_tpu_torch.serving.engine import _MODEL_CONFIGS

    init_distributed(coordinator, 2, rank, device, timeout_s=120)
    ok = False
    try:
        n_tokens = n_tokens or O2_TOKENS
        config = dataclasses.replace(
            _MODEL_CONFIGS[model or O_RESOURCE["model"]](max_seq_len=n_tokens),
            layers=O_LAYERS)
        params = init_llama_params_q8(
            config, torch.Generator(device=device).manual_seed(0), device=device)
        tokens = torch.randint(0, config.vocab_size, (1, n_tokens),
                               generator=torch.Generator().manual_seed(1)).to(device)
        mesh = make_mesh(O_MESH)
        rows = n_tokens // mesh.size("sp")
        lo = mesh.index("sp") * rows
        dense = partial(dense_attention, causal=True, scale=1.0 / math.sqrt(config.head_dim))

        def dense_f32(q, k, v):
            return dense(q.float(), k.float(), v.float()).to(q.dtype)

        out = {}
        with torch.no_grad():
            # each path against the one-rank forward of its own arithmetic:
            # the ring's f32 softmax and products, Ulysses' dense attention
            # in the input dtype with f32 accumulation
            for attn, plain in (("ring", dense_f32), ("ulysses", dense)):
                # causal: this rank's positions need the tokens up to its last
                ref = llama_forward(config, params, tokens[:, :lo + rows],
                                    attention=plain)[:, lo:]
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.monotonic()
                got = llama_forward_sp(local_config(config, mesh), params, tokens, mesh,
                                       attn=attn)
                if device == "cuda":
                    torch.cuda.synchronize()
                out[attn] = {"ms": round((time.monotonic() - t0) * 1e3, 3),
                             "err": float((got - ref).abs().max()) / float(ref.abs().max())}
                del got, ref
        out["collectives"] = mesh.describe()["collectives"]
        ok = True
        return out
    finally:
        shutdown(barrier=ok)


def o2_rank(coordinator: str, device: str, out_path: str, model: str,
            n_tokens: str) -> int:
    """``chip_smoke.py --o2-rank``: rank 1 of O2."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = o2_forward(torch, 1, coordinator, device, model, int(n_tokens))
    Path(out_path).write_text(json.dumps(out))
    return 0


def o3_embeddings(torch, texts: list[str], device="cuda") -> dict:
    """O3: the embeddings engine (``O3_RESOURCE``: minilm-l6 at its full
    width, ``mesh: {dp: 2}``) on two ranks, this process the leader and a
    ``lockstep_demo`` follower replaying its ``embed`` frames, against the
    one-rank engine on the same texts."""
    from langstream_tpu_torch.parallel.mesh import init_distributed, shutdown
    from langstream_tpu_torch.serving.embeddings import EmbeddingEngine

    coordinator, lockstep = _free_port(), _free_port()
    proc, tail = _spawn_rank1(
        [sys.executable, "-m", "langstream_tpu_torch.serving.lockstep_demo", "--index",
         "1", "--num-processes", "2", "--coordinator-port", str(coordinator),
         "--lockstep-port", str(lockstep), "--device", device,
         "--config", json.dumps([O3_RESOURCE])], "o3")
    os.environ["LS_LOCKSTEP_PORT"] = str(lockstep)
    try:
        init_distributed(f"127.0.0.1:{coordinator}", 2, 0, device, timeout_s=120)
        engine = EmbeddingEngine(O3_RESOURCE["embeddings-model"], mesh=O3_RESOURCE["mesh"],
                                 device=device)
        t0 = time.monotonic()
        try:
            vectors = asyncio.run(engine.embed(texts))
            mesh_ms = (time.monotonic() - t0) * 1e3
            section = engine.mesh_section()
        finally:
            engine.close()  # the last user of the channel: "stop", then the world ends
    except BaseException:
        proc.kill()
        print(f"path O [O3]: rank 1's stderr tail:\n{tail()}", flush=True)
        raise
    finally:
        shutdown(barrier=False)  # a failed run's world; nothing after close()
        os.environ.pop("LS_LOCKSTEP_PORT", None)
    _join_rank1(proc, tail, "O3")
    one = EmbeddingEngine(O3_RESOURCE["embeddings-model"], device=device)
    try:
        t0 = time.monotonic()
        want = asyncio.run(one.embed(texts))
        one_ms = (time.monotonic() - t0) * 1e3
    finally:
        one.close()
    err = max(abs(a - b) for va, vb in zip(vectors, want) for a, b in zip(va, vb))
    if not err <= TOL_EMBED:
        fail(f"path O3: dp=2 vectors differ from the one-rank engine's by {err} > {TOL_EMBED}")
    if section["collectives"].get("enc-dp", {}).get("calls") != 1:
        fail(f"path O3: the dp replicas did not sum their rows once: {section}")
    return {"max_abs_err": err, "ms_dp2": round(mesh_ms, 3), "ms_one_rank": round(one_ms, 3),
            "collectives": section["collectives"]}


def phase_sp_path(torch, device="cuda") -> dict:
    """Path O: sequence parallelism and the embeddings mesh, two ranks
    sharing this card over gloo (as path N). Two ranks on one card measure
    the seam, not the speed of sequence parallelism: no speed is claimed.

    - O1: ``O_RESOURCE`` (long-context-summarizer's) at full width and
      ``O_LAYERS`` layers, ``mesh: O_MESH``, 8 greedy requests of
      1,500-7,000-token reports, ``O_MAX_TOKENS`` tokens each, against the
      sp=1 engine on the same weights: every request completes; the first
      token equals sp=1's wherever its top-2 gap exceeds ``N_GAP``; the
      longest prompt's cache rows (its full blocks, found through the
      prefix cache) equal sp=1's within ``TOL_BF16`` of their max abs;
      kernel #3 launches on both ranks; the ``sp-ring`` and ``sp-kv``
      collectives are counted. Printed: ms per prefilled prompt at sp=2
      and sp=1, the ring's seconds and bytes.
    - O2: :func:`o2_forward` on two ranks (this one and ``--o2-rank``),
      ring and Ulysses within ``TOL_BF16``.
    - O3: :func:`o3_embeddings`.

    Returns rank 0's O1 launches."""
    t0 = time.monotonic()
    # -- O1 -----------------------------------------------------------------
    prompts = o_prompts(8)
    longest = max(prompts, key=len)
    waves = [prompts]
    os.environ["LS_TPU_SPEC_CALIBRATE_EVERY"] = O_CALIBRATE_EVERY
    try:
        sp_spent, sp_before = o_prefill_timer(torch)
        o1 = mesh_run(torch, "O1", [{**O_RESOURCE, "mesh": O_MESH}], waves, O_MAX_TOKENS,
                      layers=O_LAYERS, device=device, before=sp_before,
                      after=o_cache_rows(torch, longest))[0]
        one_spent, one_before = o_prefill_timer(torch)
        ref, gaps = reference_run(torch, O_RESOURCE, waves, O_MAX_TOKENS, O_LAYERS, device,
                                  before=one_before, after=o_cache_rows(torch, longest))
    finally:
        os.environ.pop("LS_TPU_SPEC_CALIBRATE_EVERY", None)
    for i, r in enumerate(o1["results"]):
        if r.get("finish_reason") not in ("length", "stop"):
            fail(f"path O1: request {i} did not complete: {r.get('finish_reason')}")
    check_first_tokens("O1", o1["results"], ref["results"], gaps, path="O")
    got, want = o1["after"], ref["after"]
    if got["tokens"] != want["tokens"]:
        fail(f"path O1: {got['tokens']} cached prompt rows at sp=2, {want['tokens']} at sp=1")
    cache_err = max(float((got[x] - want[x]).abs().max()) / float(want[x].abs().max())
                    for x in ("k", "v"))
    print(f"path O1: the longest prompt's {got['tokens']} prefilled cache rows (8 layers, "
          f"K and V, int8 dequantized) at sp=2 vs sp=1: normalised max abs difference "
          f"{cache_err:.6f} (limit {TOL_BF16})", flush=True)
    if not cache_err <= TOL_BF16:
        fail(f"path O1: the prefilled cache rows differ from sp=1's by {cache_err}")
    del got, want
    for rank, counts in (("0", o1["counts"]), ("1", o1["rank1"]["kernels"])):
        if device == "cuda" and counts["paged_attention_q8"] == 0:
            fail(f"path O1: rank {rank} did not launch kernel #3: {counts}")
    coll = o1["mesh"]["collectives"]
    if not {"sp-ring", "sp-kv", "sp-last"} <= set(coll):
        fail(f"path O1: the sp prefill's collectives were not counted: {sorted(coll)}")

    def per_prompt(spent):
        return round(spent["s"] / spent["prompts"] * 1e3, 3) if spent["prompts"] else None

    ring = coll["sp-ring"]
    _mesh_line("O1 llama3-8b int8 sp=2", o1, ref, path="O", extra={
        "prefill_ms_per_prompt_sp2": per_prompt(sp_spent),
        "prefill_ms_per_prompt_sp1": per_prompt(one_spent),
        "prefill_calls_sp2": sp_spent["calls"], "prefill_shapes": sp_spent["shapes"],
        "ring_seconds": ring["seconds"], "ring_bytes": ring["bytes"],
        "ring_calls": ring["calls"], "kv_gather_bytes": coll["sp-kv"]["bytes"],
        "speculative_steps": o1["stats"]["speculative"]["steps"]})
    print("path O1: two ranks share one card here; the prefill ms measure the ring "
          "through gloo and the host, not the speed of sequence parallelism", flush=True)
    counts = dict(o1["counts"])
    del ref
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = time.monotonic()
    # -- O2 -----------------------------------------------------------------
    coordinator = f"127.0.0.1:{_free_port()}"
    out = Path(os.environ.get("TMPDIR", "/tmp")) / f"chip_smoke_o2_{os.getpid()}.json"
    proc, tail = _spawn_rank1([sys.executable, str(REPO / "chip_smoke.py"), "--o2-rank",
                               coordinator, device, str(out), O_RESOURCE["model"],
                               str(O2_TOKENS)], "o2")
    try:
        mine = o2_forward(torch, 0, coordinator, device)
    except BaseException:
        proc.kill()
        print(f"path O [O2]: rank 1's stderr tail:\n{tail()}", flush=True)
        raise
    _join_rank1(proc, tail, "O2")
    theirs = json.loads(out.read_text())
    out.unlink()
    for attn in ("ring", "ulysses"):
        for rank, res in (("0", mine), ("1", theirs)):
            if not res[attn]["err"] <= TOL_BF16:
                fail(f"path O2: {attn} on rank {rank}: normalised max abs error "
                     f"{res[attn]['err']} > {TOL_BF16} against the one-rank forward")
    print(f"path O [O2 llama_forward_sp, {O2_TOKENS} tokens, {O_LAYERS} layers]: "
          f"{json.dumps({'rank0': mine, 'rank1': theirs})}", flush=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t2 = time.monotonic()
    # -- O3 -----------------------------------------------------------------
    texts = [f"text {i}: " + "embeddings under a data-parallel mesh " * (1 + i % 7)
             for i in range(O3_TEXTS)]
    o3 = o3_embeddings(torch, texts, device)
    print(f"path O [O3 minilm-l6 dp=2, {O3_TEXTS} texts]: {json.dumps(o3)}", flush=True)
    print(f"path O: {time.monotonic() - t0:.1f} s (O1 {t1 - t0:.1f} s, O2 {t2 - t1:.1f} s, "
          f"O3 {time.monotonic() - t2:.1f} s)", flush=True)
    return counts


# ---------------------------------------------------------------------------
# path P: training through the mesh
# ---------------------------------------------------------------------------

P_LR = 1e-3
#: P1: the MoE pipeline step (Mixtral-8x7B widths, one layer per stage)
P1 = {"model": "mixtral-8x7b", "layers": 2, "batch": 4, "tokens": 256, "micro": 2,
      "dtype": "bfloat16"}
#: P2: the dense sequence-parallel step (Llama-3-8B widths, one sequence)
P2 = {"model": "llama3-8b", "layers": 2, "tokens": 2048, "dtype": "bfloat16"}


def _p_config(spec: dict):
    """The model config of a path P part at its depth and dtype."""
    from langstream_tpu_torch.serving.engine import _DTYPES, _MODEL_CONFIGS, _MOE_MODELS

    make = {**_MODEL_CONFIGS, **_MOE_MODELS}[spec["model"]]
    return dataclasses.replace(make(max_seq_len=spec["tokens"]), layers=spec["layers"],
                               dtype=_DTYPES[spec["dtype"]])


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _sgd_step(torch, loss_fn, params: dict, device, sync=None) -> dict:
    """One training step on ``params`` (leaves that require grad): the loss,
    its backward, ``sync()`` (the gradients' sum over dp/sp) and the SGD
    update at ``P_LR``, timed to a synchronised end. Returns the loss, each
    leaf's gradient and updated value by path, and the ms."""
    for _, p in _leaves(params):
        p.grad = None
    _sync(torch, device)
    t0 = time.monotonic()
    loss = loss_fn()
    loss.backward()
    if sync is not None:
        sync()
    with torch.no_grad():
        new = {path: p - P_LR * p.grad for path, p in _leaves(params)}
    _sync(torch, device)
    ms = (time.monotonic() - t0) * 1e3
    return {"loss": float(loss.detach()),
            "grads": {path: p.grad for path, p in _leaves(params)},
            "new": new, "ms": ms}


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 for an all-zero ``want`` equal
    to ``got``)."""
    scale = float(want.float().abs().max())
    diff = float((got.float() - want.float()).abs().max())
    return diff / scale if scale else diff


def _hold(label: str, got: dict, want: dict, leaf_map=None) -> dict:
    """Hold a step's loss, gradients and updated leaves against the
    reference's within ``TOL_BF16`` (the loss relative, a leaf of its max
    abs); ``leaf_map(path, ref)`` picks the reference's slice of a leaf.
    Returns the worst errors."""
    pick = leaf_map or (lambda path, t: t)
    loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    if not loss_err <= TOL_BF16:
        fail(f"path {label}: loss {got['loss']} against {want['loss']} "
             f"(relative {loss_err} > {TOL_BF16})")
    worst = {}
    for kind in ("grads", "new"):
        errs = {path: _rel_err(t, pick(path, want[kind][path]))
                for path, t in got[kind].items()}
        path = max(errs, key=errs.get)
        if not errs[path] <= TOL_BF16:
            fail(f"path {label}: {kind} of {path} differ by {errs[path]} of their "
                 f"max abs (> {TOL_BF16})")
        worst[kind] = [path, round(errs[path], 6)]
    return {"loss_err": loss_err, "worst_grad": worst["grads"], "worst_new": worst["new"]}


def _tree_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def p1_moe_step(torch, rank: int, coordinator: str, device="cuda", spec=None) -> dict:
    """P1 on one rank of ``{pp: 2}`` (this process is rank 0, ``--p-rank``
    rank 1): the spec's MoE model, each rank its one stage's layers (its
    ``shard_pp_params`` shard, drawn from seed 0 leaf by leaf) plus the
    embed and head, one training step of the JAX package's loss (NLL +
    0.01 aux) through ``moe_forward_pp``; rank 1's layer gradients and
    updated leaves then cross to rank 0, which runs the same step at pp=1
    (one rank, the same microbatches) and holds both stages to it."""
    from langstream_tpu_torch.models.llama import next_token_nll
    from langstream_tpu_torch.models.moe import init_moe_params
    from langstream_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh, shard_for_rank, shutdown)
    from langstream_tpu_torch.parallel.pipeline import moe_forward_pp, pp_param_specs

    spec = spec or P1
    init_distributed(coordinator, 2, rank, device, timeout_s=120)
    ok = False
    try:
        config = _p_config(spec)
        B, S, M = spec["batch"], spec["tokens"], spec["micro"]
        mesh = make_mesh({"pp": 2})
        specs = pp_param_specs(config, mesh)

        def place(path, leaf):
            node = specs
            for key in path.split("."):
                node = node[key]
            return shard_for_rank(leaf, node, mesh)

        params = init_moe_params(config, torch.Generator(device=device).manual_seed(0),
                                 device=device, place=place)
        for _, p in _leaves(params):
            p.requires_grad_(True)
        tokens = torch.randint(0, config.vocab_size, (B, S),
                               generator=torch.Generator().manual_seed(1)).to(device)

        def loss_fn(tree, m):
            logits, aux = moe_forward_pp(config, tree, tokens, m, num_microbatches=M)
            return next_token_nll(logits, tokens) + 0.01 * aux

        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        step = _sgd_step(torch, lambda: loss_fn(params, mesh), params, device)
        coll = mesh.describe()["collectives"]
        peak = (round(torch.cuda.max_memory_allocated() / 2**30, 3)
                if torch.device(device).type == "cuda" else None)
        # the same step again, warm (the first pays each process's first
        # launches); the update is out of place, so it sees the same params
        warm = _sgd_step(torch, lambda: loss_fn(params, mesh), params, device)["ms"]
        out = {"ms": round(step["ms"], 3), "warm_ms": round(warm, 3), "loss": step["loss"],
               "param_bytes": _tree_bytes(p for _, p in _leaves(params)),
               "grad_bytes": _tree_bytes(step["grads"].values()),
               "peak_gb": peak, "handoff": {k: coll[k] for k in ("pp-handoff", "pp-handoff-bwd")},
               "collectives": coll}
        # the stage's layer leaves cross to the other stage (a permute of
        # two: rank 0 receives rank 1's), outside the step's counts
        layer_paths = [p for p in step["grads"] if p.startswith("layers.")]
        with torch.no_grad():
            theirs = {(kind, p): mesh.permute(step[kind][p], "pp", 1, tag="p1-check")
                      for kind in ("grads", "new") for p in layer_paths}
        if rank == 0:
            ref_params = init_moe_params(config, torch.Generator(device=device).manual_seed(0),
                                         device=device)
            for _, p in _leaves(ref_params):
                p.requires_grad_(True)
            one = make_mesh({"pp": 1}, world_size=1, rank=0, groups=False)
            ref = _sgd_step(torch, lambda: loss_fn(ref_params, one), ref_params, device)
            out["pp1_ms"] = round(ref["ms"], 3)
            out["pp1_warm_ms"] = round(_sgd_step(
                torch, lambda: loss_fn(ref_params, one), ref_params, device)["ms"], 3)
            out["pp1_loss"] = ref["loss"]
            for stage, got in ((0, step), (1, {"loss": step["loss"],
                                               **{k: {p: theirs[(k, p)] for p in layer_paths}
                                                  for k in ("grads", "new")}})):
                out[f"stage{stage}"] = _hold(
                    f"P1 stage {stage}", got, ref,
                    lambda path, t, stage=stage: t[stage:stage + 1]
                    if path.startswith("layers.") else t)
        ok = True
        return out
    finally:
        shutdown(barrier=ok)


def p2_sp_step(torch, rank: int, coordinator: str, device="cuda", spec=None) -> dict:
    """P2 on one rank of ``{sp: 2, tp: 1}``: the spec's Llama model (every
    rank holds it whole, from seed 0), one sequence, one training step of
    the next-token NLL through ``llama_forward_sp`` with the ring and then
    Ulysses, the gradients summed over sp by ``sync_grads``; rank 0 holds
    each to one rank's ``llama_forward`` with the dense attention of its
    arithmetic (as O2 does: f32 for the ring, the input dtype with f32
    accumulation for Ulysses)."""
    from functools import partial

    from langstream_tpu_torch.models.llama import (
        init_llama_params, llama_forward, llama_forward_sp, llama_param_specs,
        local_config, next_token_nll, rank_specs)
    from langstream_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh, shutdown, sync_grads)
    from langstream_tpu_torch.parallel.ring import dense_attention

    spec = spec or P2
    init_distributed(coordinator, 2, rank, device, timeout_s=120)
    ok = False
    try:
        config = _p_config(spec)
        n = spec["tokens"]
        params = init_llama_params(config, torch.Generator(device=device).manual_seed(0),
                                   device=device)
        for _, p in _leaves(params):
            p.requires_grad_(True)
        tokens = torch.randint(0, config.vocab_size, (1, n),
                               generator=torch.Generator().manual_seed(1)).to(device)
        mesh = make_mesh({"sp": 2, "tp": 1})
        local = local_config(config, mesh)
        specs = rank_specs(llama_param_specs(config), config, mesh)
        out, steps = {}, {}
        for attn in ("ring", "ulysses"):
            before = {k: list(v) for k, v in mesh.collectives.items()}
            step = _sgd_step(
                torch, lambda: next_token_nll(
                    llama_forward_sp(local, params, tokens, mesh, attn=attn), tokens, mesh),
                params, device, sync=lambda: sync_grads(params, specs, mesh))
            coll = {k: [v[0] - before.get(k, [0, 0.0, 0])[0],
                        round(v[1] - before.get(k, [0, 0.0, 0])[1], 6),
                        v[2] - before.get(k, [0, 0.0, 0])[2]]
                    for k, v in mesh.collectives.items()}
            out[attn] = {"ms": round(step["ms"], 3), "loss": step["loss"],
                         "collectives": {k: {"calls": c, "seconds": s, "bytes": b}
                                         for k, (c, s, b) in coll.items() if c}}
            steps[attn] = step
        if rank == 0:
            dense = partial(dense_attention, causal=True,
                            scale=1.0 / math.sqrt(config.head_dim))

            def dense_f32(q, k, v):
                return dense(q.float(), k.float(), v.float()).to(q.dtype)

            for attn, plain in (("ring", dense_f32), ("ulysses", dense)):
                ref = _sgd_step(torch, lambda: next_token_nll(
                    llama_forward(config, params, tokens, attention=plain), tokens),
                    params, device)
                out[attn]["one_rank_ms"] = round(ref["ms"], 3)
                out[attn].update(_hold(f"P2 {attn}", steps.pop(attn), ref))
                del ref
        ok = True
        return out
    finally:
        shutdown(barrier=ok)


def p_rank(coordinator: str, device: str, out_path: str, part: str, spec: str) -> int:
    """``chip_smoke.py --p-rank``: rank 1 of P1 or P2."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    run = {"P1": p1_moe_step, "P2": p2_sp_step}[part]
    out = run(torch, 1, coordinator, device, json.loads(spec))
    Path(out_path).write_text(json.dumps(out))
    return 0


def _p_world(torch, part: str, spec: dict, device: str) -> tuple[dict, dict]:
    """One world of two ranks on this card: rank 1 spawned, this process
    rank 0; both ranks' results."""
    run = {"P1": p1_moe_step, "P2": p2_sp_step}[part]
    coordinator = f"127.0.0.1:{_free_port()}"
    out = Path(os.environ.get("TMPDIR", "/tmp")) / f"chip_smoke_{part}_{os.getpid()}.json"
    proc, tail = _spawn_rank1([sys.executable, str(REPO / "chip_smoke.py"), "--p-rank",
                               coordinator, device, str(out), part, json.dumps(spec)], part)
    try:
        mine = run(torch, 0, coordinator, device, spec)
    except BaseException:
        proc.kill()
        print(f"path P [{part}]: rank 1's stderr tail:\n{tail()}", flush=True)
        raise
    _join_rank1(proc, tail, part)
    theirs = json.loads(out.read_text())
    out.unlink()
    return mine, theirs


def phase_train_path(torch, device="cuda") -> dict:
    """Path P: training through the mesh, two ranks sharing this card over
    gloo (as paths N and O: they measure the seam, not the speed of
    pipelining or sequence parallelism). Both parts run bf16 parameters
    with f32 logits and loss, random weights from a seed, one SGD step at
    lr ``P_LR``.

    - P1: :func:`p1_moe_step`, ``P1`` (Mixtral-8x7B widths, 2 layers, one
      per stage, ``{pp: 2}``, 4 sequences of 256 tokens, 2 microbatches)
      against pp=1: the loss within ``TOL_BF16`` relative, each gradient
      and updated leaf of both stages within ``TOL_BF16`` of its max abs.
      Printed: ms per step at pp=2 and pp=1, the bubble, the hand-off's
      bytes and host seconds both ways, each rank's parameter, gradient
      and peak bytes.
    - P2: :func:`p2_sp_step`, ``P2`` (Llama-3-8B widths, 2 layers, one
      2,048-token sequence, ``{sp: 2, tp: 1}``), ring then Ulysses, each
      against one rank's forward within the same tolerances. Printed: ms
      per step, the ring's bytes both ways, ``sync_grads``' seconds and
      bytes.
    - P3: the flash kernel and the decode read refuse CUDA inputs that
      require grad (on the CPU they take their differentiable plain
      versions: nothing to check).

    Returns the kernels' launches on the path (none: training attends
    through the plain functions, as the JAX package's does)."""
    t0 = time.monotonic()
    reset_counts()
    # -- P1 -----------------------------------------------------------------
    p1 = _p_world(torch, "P1", P1, device)
    mine, theirs = p1
    bubble = (2 - 1) / (P1["micro"] + 2 - 1)
    print(f"path P [P1 moe_forward_pp {P1['model']} {P1['layers']} layers {P1['dtype']}, "
          f"pp=2, {P1['batch']}x{P1['tokens']} tokens, M={P1['micro']}]: " + json.dumps({
              "ms_per_step_pp2": mine["ms"], "ms_per_step_pp1": mine["pp1_ms"],
              "warm_ms_pp2": [mine["warm_ms"], theirs["warm_ms"]],
              "warm_ms_pp1": mine["pp1_warm_ms"],
              "bubble": round(bubble, 4), "loss_pp2": mine["loss"], "loss_pp1": mine["pp1_loss"],
              "stage0": mine["stage0"], "stage1": mine["stage1"],
              "handoff": {"rank0": mine["handoff"], "rank1": theirs["handoff"]},
              "param_bytes": [mine["param_bytes"], theirs["param_bytes"]],
              "grad_bytes": [mine["grad_bytes"], theirs["grad_bytes"]],
              "peak_gb": [mine["peak_gb"], theirs["peak_gb"]]}), flush=True)
    for rank, res in (("0", mine), ("1", theirs)):
        h = res["handoff"]
        if not h["pp-handoff"]["calls"] == h["pp-handoff-bwd"]["calls"] > 0:
            fail(f"path P1: rank {rank}'s hand-offs forward and back: {h}")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = time.monotonic()
    # -- P2 -----------------------------------------------------------------
    mine, theirs = _p_world(torch, "P2", P2, device)
    for attn in ("ring", "ulysses"):
        tag = "sp-ring" if attn == "ring" else "sp-a2a"
        for rank, res in (("0", mine), ("1", theirs)):
            coll = res[attn]["collectives"]
            if not {tag, f"{tag}-bwd", "grads"} <= set(coll):
                fail(f"path P2: rank {rank}'s {attn} step did not move its collectives "
                     f"both ways and sum its gradients: {sorted(coll)}")
        print(f"path P [P2 llama_forward_sp {attn} {P2['model']} {P2['layers']} layers "
              f"{P2['dtype']}, sp=2, {P2['tokens']} tokens]: " + json.dumps({
                  "ms_per_step": [mine[attn]["ms"], theirs[attn]["ms"]],
                  "one_rank_ms": mine[attn]["one_rank_ms"],
                  "loss": [mine[attn]["loss"], theirs[attn]["loss"]],
                  **{k: mine[attn][k] for k in ("loss_err", "worst_grad", "worst_new")},
                  "collectives": {"rank0": mine[attn]["collectives"],
                                  "rank1": theirs[attn]["collectives"]}}), flush=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t2 = time.monotonic()
    # -- P3 -----------------------------------------------------------------
    if device == "cuda":
        from langstream_tpu_torch.ops.flash_attention import flash_attention
        from langstream_tpu_torch.ops.paged_attention import paged_attention_partial

        q = torch.randn((1, 64, 8, 128), device=device, dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.randn((1, 64, 2, 128), device=device, dtype=torch.bfloat16)
        qd, kp, vp, tables, lengths, nrb = paged_case(
            torch, B=4, H=8, Kh=2, D=128, bs=16, max_len=64, dtype=torch.bfloat16,
            int8=False, dense=False, seed=5)
        calls = {
            "flash_attention": lambda: flash_attention(q, k, k, causal=True),
            "paged_attention": lambda: paged_attention_partial(
                qd.requires_grad_(True), kp, vp, tables, lengths, num_read_blocks=nrb,
                kv_heads=2, head_dim=128),
        }
        for name, call in calls.items():
            try:
                call()
            except RuntimeError as e:
                if "has no backward" not in str(e):
                    raise
                print(f"path P [P3]: {name} on inputs that require grad: {e}", flush=True)
            else:
                fail(f"path P3: {name} launched on inputs that require grad")
    counts = read_counts()
    if any(counts.values()):
        fail(f"path P: a kernel launched on the training path: {counts}")
    print(f"path P: {time.monotonic() - t0:.1f} s (P1 {t1 - t0:.1f} s, P2 {t2 - t1:.1f} s)",
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# path Q: a mesh from the normal entry points (the port starts its ranks)
# ---------------------------------------------------------------------------

#: Q1: path B's resource at tp=2 through the provider, at ``Q1_LAYERS`` of
#: llama3-8b's 32 (B's ``MAIN_LAYERS`` until path Z came), held to a tp=1
#: reference engine of its own at that depth
Q1_MESH = {"tp": 2}
Q1_LAYERS = 4
#: Q2: a slice of two pods of two local ranks each, on this card (the HF
#: fixture: a random init draws other numbers on the card than on the CPU)
Q2_RESOURCE = {"model": "tiny", "model-dtype": "float32", "kv-layout": "paged",
               "kv-block-size": 16, "slots": 4, "max-seq-len": 128, "decode-chunk": 4,
               "seed": 0, "mesh": {"dp": 2, "tp": 2},
               "checkpoint": str(REPO / "tests" / "fixtures" / "llama_tiny_golden")}
Q2_PROMPTS = ["hello gpu world", "a slice of two pods", "abcdefgh, ijklmnop", "q"]
Q2_MAX_TOKENS = 12
#: Q3: the embeddings service at dp=2 (path O3's resource and bound)
Q3_RESOURCE = {"embeddings-model": "minilm-l6", "mesh": {"dp": 2}}


@contextlib.contextmanager
def environment(**env: str):
    """``env`` set in this process's environment inside the block (the
    ranks started inside it inherit it; ``LOCAL_WORLD_SIZE`` is the ranks
    this host may run, here ranks that share the one card over gloo)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def children_ended(label: str, launched: dict, path: str = "Q") -> list:
    """Every rank the launcher started exited 0 and no process of it is
    left; their exit codes."""
    codes = []
    for child in launched["children"]:
        if child["exit-code"] != 0:
            fail(f"path {path} [{label}]: local rank {child['rank']} exited "
                 f"{child['exit-code']}")
        try:
            os.kill(child["pid"], 0)
        except ProcessLookupError:
            codes.append(child["exit-code"])
            continue
        fail(f"path {path} [{label}]: local rank {child['rank']} (pid {child['pid']}) "
             f"outlived its world")
    return codes


def q1_provider_mesh(torch, device="cuda") -> dict:
    """Q1: path B's resource at ``Q1_MESH`` through ``TorchServiceProvider``
    with two local ranks on this card, at ``Q1_LAYERS``; nothing here starts
    a rank. B's 8 prompts, 64 greedy tokens, held by the first-token rule to
    the streams of B's resource without its mesh at the same depth (a
    reference engine of its own, :func:`reference_run`); kernels #1 and #3
    on both ranks. Returns rank 0's launches."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.serving.engine import TorchServingEngine

    b = NOTES["B"]
    resource = {**b["config"], "mesh": Q1_MESH}
    ref, gaps = reference_run(torch, b["config"], [chat_prompts()], 64, Q1_LAYERS,
                              device=device)
    if device == "cuda":
        torch.cuda.empty_cache()
    with ranks_at_depth(Q1_LAYERS):  # its ranks at the reference's depth too
        t0 = time.monotonic()
        engine = TorchServiceProvider(resource, device=device).get_completions_service(
            {}).engine
        ready_s = time.monotonic() - t0
    TorchServingEngine.reset_instances()

    async def drive():
        try:
            return await serve(engine, chat_prompts(), 64)
        finally:
            await engine.close()  # "stop", the world ends, the ranks are reaped

    reset_counts()
    results, wall, stats = asyncio.run(drive())
    counts = read_counts()
    mesh = engine.mesh_section()
    del engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    rank1 = mesh["launched"]["children"][0]["kernels"]
    for rank, c in (("0", counts), ("1", rank1)):
        if device == "cuda" and (c["flash_attention"] == 0 or c["paged_attention_q8"] == 0):
            fail(f"path Q1: rank {rank} did not launch kernels #1 and #3: {c}")
    codes = children_ended("Q1", mesh["launched"])
    rule = check_first_tokens("Q1", results, ref["results"], gaps, path="Q")
    print(f"path Q [Q1 llama3-8b int8 tp=2, {Q1_LAYERS} layers, provider]: " + json.dumps({
        "ready_s": round(ready_s, 3), "wall_s": round(wall, 3),
        "ms_per_step_mesh": _step_ms(stats), "ms_per_step_tp1": _step_ms(ref["stats"]),
        "backend": mesh["backend"], "backend_reason": mesh["backend-reason"],
        "rank0_launches": {k: v for k, v in counts.items() if v},
        "rank1_launches": {k: v for k, v in rank1.items() if v},
        "first_tokens_checked": rule["checked"], "child_exit_codes": codes,
        "weights_bytes": [mesh["weights-bytes"],
                          mesh["launched"]["children"][0]["mesh"][0]["weights-bytes"]]}),
        flush=True)
    return counts


#: the scenarios a ``--q2-pod`` leader drives (the followers only replay)
POD_SCENARIOS = ("serve", "tiers", "prefill", "decode")


async def tiers_drained(engine, store: dict, timeout_s: float = 120.0) -> dict:
    """Wait until the demotions have brought T0 and T1 within ``store``'s
    budgets, spilled to T2, and no T2 write is in flight; the prefix
    store's stats then."""
    for _ in range(int(timeout_s / 0.05)):
        st = engine.stats()["prefixstore"]
        if (st["t0"]["bytes"] <= store["t0-bytes"] and st["t1"]["bytes"] <= store["t1-bytes"]
                and st["demotions_t1_t2"] and not st["t2"]["pending_jobs"]
                and not st["t2"]["in_transit_bytes"]):
            return st
        await asyncio.sleep(0.05)
    raise RuntimeError(f"the tiers did not drain within {timeout_s} s: {st}")


async def pod_scenario(engine, scenario: str, prompts: list, max_tokens: int,
                       payloads: list[bytes] | None = None) -> dict:
    """What a ``--q2-pod`` leader does with its engine: ``serve`` the
    prompts greedy at once; ``tiers``: the same wave cold, the prefix
    store drained to its budgets (demotion to T1, spill to T2), then the
    wave again (T1 promotion, T2 hydration); ``prefill``: the wave on a
    ``pool-role: prefill`` engine, each request's LSKV export taken;
    ``decode``: ``payloads`` imported and decoded."""
    opts = {"max-tokens": max_tokens, "temperature": 0}

    def streams(results):
        return {"tokens": [list(r["tokens"]) for r in results],
                "logprobs": [list(r["logprobs"]) for r in results]}

    async def wave():
        return await asyncio.gather(*(engine.generate(p, dict(opts)) for p in prompts))

    t0 = time.monotonic()
    if scenario == "decode":
        return {**streams(await asyncio.gather(*(engine.import_handoff(x) for x in payloads))),
                "serve_s": time.monotonic() - t0}
    results = await wave()
    out = {**streams(results), "serve_s": time.monotonic() - t0}
    if scenario == "prefill":
        out["payloads"] = [engine.take_export(r["handoff"]).hex() for r in results]
    elif scenario == "tiers":
        store = engine.config.to_dict()["prefix-store"]
        t1 = time.monotonic()
        drained = await tiers_drained(engine, store)
        seq = engine.flight.recent_events(1)[-1]["seq"]
        t2 = time.monotonic()
        warm = await wave()
        out.update(warm=streams(warm), drained=drained, stats=engine.stats()["prefixstore"],
                   block_bytes=engine._tier_block_bytes,
                   promoted=_events_since(engine, seq, "prefix-promote"),
                   seconds={"cold": round(t1 - t0, 3), "drain": round(t2 - t1, 3),
                            "warm": round(time.monotonic() - t2, 3)})
    return out


def q2_pod(resource: str, prompts: str, max_tokens: str, device: str, out_path: str,
           scenario: str = "serve", payloads_path: str | None = None) -> int:
    """``chip_smoke.py --q2-pod``: one pod of a slice, its place from
    ``LS_SLICE_HOSTS``, ``LS_POD_NAME``, ``LOCAL_WORLD_SIZE``,
    ``LS_COORDINATOR_ADDRESS``, ``LS_LOCKSTEP_PORT`` and
    ``LS_LOCKSTEP_TOKEN``, as the platform's pod runs it: the port's
    ``maybe_join_slice`` (the pod's local ranks started), then the ordinal-0
    pod drives ``scenario`` (:func:`pod_scenario`; ``decode`` imports the
    hex payloads of the JSON list at ``payloads_path``) through the
    provider and the others replay (``run_slice_follower``). Writes what
    the scenario returns, the mesh (a follower pod's from its info
    object), the launched ranks and this process's launches to
    ``out_path``."""
    import torch

    from langstream_tpu_torch.ops import launch_counts
    from langstream_tpu_torch.runtime import pod

    if scenario not in POD_SCENARIOS:
        raise SystemExit(f"--q2-pod: unknown scenario {scenario!r}, not one of {POD_SCENARIOS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    world = pod.maybe_join_slice(device)
    ordinal = pod.pod_ordinal(os.environ["LS_POD_NAME"])
    if ordinal:
        infos = []

        async def keep_info(info):  # what the pod's info server would serve
            infos.append(info)

        out = {"replayed": asyncio.run(pod.run_slice_follower(
            world.hosts, ordinal, serve_info=keep_info, device=device))}
        out["mesh"] = infos[0].info()["mesh"]
    else:
        from langstream_tpu_torch.agents.provider import TorchServiceProvider

        engine = TorchServiceProvider(json.loads(resource), device=device
                                      ).get_completions_service({}).engine
        payloads = ([bytes.fromhex(x) for x in json.loads(Path(payloads_path).read_text())]
                    if payloads_path else None)

        async def drive():
            try:
                return await pod_scenario(engine, scenario, json.loads(prompts),
                                          int(max_tokens), payloads)
            finally:
                await engine.close()

        out = asyncio.run(drive())
        out["mesh"] = engine.mesh_section()
        out["digests"] = engine.tier_digests
    out.update(launched=world.describe(), kernels=launch_counts())
    Path(out_path).write_text(json.dumps(out))
    return 0


def q2_slice(torch, device="cuda") -> dict:
    """Q2: a slice of 2 hosts x 2 local ranks on this card: two pod
    processes (``--q2-pod``, ``LS_POD_NAME`` q-0 and q-1), each starting
    its second rank itself; ``Q2_RESOURCE`` (tiny f32, ``{dp: 2, tp: 2}``)
    must give a one-process CPU run's tokens without the mesh."""
    coordinator, lockstep = f"127.0.0.1:{_free_port()}", _free_port()
    tmp = Path(os.environ.get("TMPDIR", "/tmp"))
    pods = []
    for name in ("q-0", "q-1"):
        out = tmp / f"chip_smoke_{name}_{os.getpid()}.json"
        env = {**os.environ, "PYTHONPATH": str(REPO), "LS_SLICE_HOSTS": "2",
               "LS_POD_NAME": name, "LOCAL_WORLD_SIZE": "2",
               "LS_COORDINATOR_ADDRESS": coordinator, "LS_LOCKSTEP_PORT": str(lockstep),
               "LS_LOCKSTEP_TOKEN": f"q2-{os.getpid()}"}
        with open(out.with_suffix(".log"), "wb") as log_file:  # a file, not a pipe
            proc = subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--q2-pod",
                 json.dumps(Q2_RESOURCE), json.dumps(Q2_PROMPTS), str(Q2_MAX_TOKENS),
                 device, str(out)], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                stderr=log_file)
        pods.append((name, proc, out))
    deadline = time.monotonic() + 240
    for name, proc, out in pods:
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for _, other, _ in pods:
                other.kill()
                other.wait()
        err = out.with_suffix(".log").read_text(errors="replace")[-3000:]
        out.with_suffix(".log").unlink()
        if proc.returncode != 0:
            fail(f"path Q2: pod {name} exited {proc.returncode}: {err}")
    reports = []
    for name, _, out in pods:
        reports.append(json.loads(out.read_text()))
        out.unlink()
        children_ended(f"Q2 {name}", reports[-1]["launched"])
    leader = reports[0]
    if leader["mesh"]["world-size"] != 4 or leader["mesh"]["dp-slots"] != [0, 2]:
        fail(f"path Q2: the leader's mesh is not the 2 x 2 slice's: {leader['mesh']}")
    cpu, _ = reference_run(torch, Q2_RESOURCE, [Q2_PROMPTS], Q2_MAX_TOKENS, None, "cpu")
    want = [list(r["tokens"]) for r in cpu["results"]]
    if leader["tokens"] != want:
        fail(f"path Q2: the slice's tokens {leader['tokens']} != the CPU one-process run "
             f"{want}")
    ranks = {c["rank"]: c["pid"] for r in reports for c in r["launched"]["children"]}
    return {"tokens_equal_cpu": True, "started_ranks": ranks,
            "replayed_by_pod_q1": reports[1]["replayed"],
            "launches_by_pod": [r["kernels"] for r in reports]}


#: Q3's refused serving engine: its mesh fits the embeddings engine's world,
#: its checkpoint directory exists on no rank
Q3_FAILING = {"model": "tiny", "slots": 4, "max-seq-len": 128, "mesh": {"tp": 2},
              "checkpoint": str(REPO / "no-such-checkpoint")}


def q3_failed_build(engine, texts: list[str], vectors, device="cuda") -> dict:
    """A serving engine that joins the world ``engine`` (embeddings) leads
    and fails to build on every rank is refused by its constructor; the
    world's started ranks are alive after it and the embeddings engine
    gives ``vectors`` again, exactly."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    t0 = time.monotonic()
    try:
        with environment(LOCAL_WORLD_SIZE="2"):
            TorchServingEngine(ServingConfig.from_dict(Q3_FAILING), device=device)
    except FileNotFoundError as e:
        refused = f"{type(e).__name__}: {e}"
    else:
        fail("path Q3: a serving engine with no checkpoint on any rank was built")
    refused_s = time.monotonic() - t0
    alive = [c.proc.poll() is None for c in engine._launched.children]
    if not all(alive):
        fail(f"path Q3: a rank of the embeddings world exited after the refused build: {alive}")
    again = asyncio.run(engine.embed(texts))
    if again != vectors:
        err = max(abs(a - b) for va, vb in zip(again, vectors) for a, b in zip(va, vb))
        fail(f"path Q3: the vectors after the refused build differ by {err}")
    return {"refused": refused, "refused_s": round(refused_s, 3), "ranks_alive": len(alive),
            "vectors_equal_after": True}


def q3_embeddings(torch, texts: list[str], device="cuda") -> dict:
    """Q3: ``Q3_RESOURCE`` through the provider's embeddings service with
    two local ranks on this card, against the one-rank engine within
    ``TOL_EMBED`` (path O3's bound); then :func:`q3_failed_build` before
    the world ends through ``close()``."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.serving.embeddings import EmbeddingEngine

    with environment(LOCAL_WORLD_SIZE="2"):
        service = TorchServiceProvider(Q3_RESOURCE, device=device).get_embeddings_service({})
    EmbeddingEngine.reset_instances()
    try:
        t0 = time.monotonic()
        vectors = asyncio.run(service.compute_embeddings(texts))
        mesh_ms = (time.monotonic() - t0) * 1e3
        failed_build = q3_failed_build(service.engine, texts, vectors, device)
    finally:
        service.engine.close()
    mesh = service.engine.mesh_section()
    codes = children_ended("Q3", mesh["launched"])
    one = EmbeddingEngine(Q3_RESOURCE["embeddings-model"], device=device)
    try:
        want = asyncio.run(one.embed(texts))
    finally:
        one.close()
    err = max(abs(a - b) for va, vb in zip(vectors, want) for a, b in zip(va, vb))
    if not err <= TOL_EMBED:
        fail(f"path Q3: dp=2 vectors differ from the one-rank engine's by {err} > {TOL_EMBED}")
    return {"max_abs_err": err, "ms_dp2": round(mesh_ms, 3), "child_exit_codes": codes,
            "failed_build": failed_build, "collectives": mesh["collectives"]}


def phase_launch_path(torch, device="cuda") -> dict:
    """Path Q: meshes from the normal entry points, every rank but the
    caller's started by the port's launcher (``parallel/launch.py``), two
    local ranks sharing this card over gloo: :func:`q1_provider_mesh`,
    :func:`q2_slice`, :func:`q3_embeddings`. Returns rank 0's Q1
    launches."""
    t0 = time.monotonic()
    counts = q1_provider_mesh(torch, device)
    t1 = time.monotonic()
    q2 = q2_slice(torch, device)
    print(f"path Q [Q2 tiny f32 2 hosts x 2 local ranks, dp=2 tp=2]: {json.dumps(q2)}",
          flush=True)
    t2 = time.monotonic()
    texts = [f"text {i}: " + "embeddings served by launched ranks " * (1 + i % 7)
             for i in range(O3_TEXTS)]
    q3 = q3_embeddings(torch, texts, device)
    print(f"path Q [Q3 minilm-l6 dp=2, {O3_TEXTS} texts]: {json.dumps(q3)}", flush=True)
    print(f"path Q: {time.monotonic() - t0:.1f} s (Q1 {t1 - t0:.1f} s, Q2 {t2 - t1:.1f} s, "
          f"Q3 {time.monotonic() - t2:.1f} s)", flush=True)
    return counts


# ---------------------------------------------------------------------------
# path R: the tiered stores and the pool roles under a mesh
# ---------------------------------------------------------------------------

#: llama3-8b at full width and ``R_LAYERS`` of its 32 layers, int8 weights
#: from seed 0: the tp=2 engines (two local ranks sharing the card, started
#: by the launcher) and the tp=1 references on the same weights
R_LAYERS = 1   # at 8 the smoke took 1,181 s of its 1,200 (H100 80GB HBM3, 700 W); 4 until
               # path V came (1,018.5 s with R and S at 4), 2 until path Y came
               # (1,052.3 s with R and S at 2 on a slow host)
R_MESH = {"tp": 2}
R_BASE = {"model": "llama3-8b", "quantize": "int8", "kv-layout": "paged", "slots": 16,
          "max-seq-len": 2048, "decode-chunk": 32, "seed": 0}
R1_MAX_TOKENS = 32
R2_RANK = 16
#: the adapters' B scale: a delta about a fifth of the weights' size, as a
#: trained adapter's (``sqrt(rank) x scale`` of them); at 0.5, twice the
#: weights, the adapter streams' first tokens had logprobs near -8 (a
#: near-uniform vocabulary) and bf16 tp=2 and tp=1 rounding parted them by
#: 0.16 on an H100 80GB HBM3 at 700 W
R2_SCALE = 0.05
R2_NAMES = ("tenant-r1", "tenant-r2", "tenant-r3")
R2_MAX_TOKENS = 32
R3_MAX_TOKENS = 32
R3_TOL = 2e-2   # an export's rows against a tp=1 export's, of its max abs

#: a ``sitecustomize`` put on the started ranks' ``PYTHONPATH`` by
#: :func:`ranks_at_depth`: once the engine module is imported, its model
#: tables serve every model at ``LS_SMOKE_LAYERS`` layers, as
#: ``lockstep_demo.cut_layers`` does in this process (a started rank learns
#: its model only from the leader's handshake)
_DEPTH_SITE = '''
import dataclasses, importlib.abc, importlib.util, os, sys


class _Depth(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name != "langstream_tpu_torch.serving.engine":
            return None
        sys.meta_path.remove(self)
        spec = importlib.util.find_spec(name)
        run = spec.loader.exec_module
        layers = int(os.environ["LS_SMOKE_LAYERS"])

        def cut(make):
            return lambda **kw: dataclasses.replace(
                make(**kw), layers=min(make(**kw).layers, layers))

        def exec_module(module):
            run(module)
            for table in (module._MODEL_CONFIGS, module._MOE_MODELS):
                for key, make in list(table.items()):
                    table[key] = cut(make)

        spec.loader.exec_module = exec_module
        return spec


if os.environ.get("LS_SMOKE_LAYERS"):
    sys.meta_path.insert(0, _Depth())
'''


@contextlib.contextmanager
def ranks_at_depth(layers: int | None):
    """Engines made inside the block, here and on the ranks the launcher
    starts, serve every model at ``layers`` layers (None: as they are);
    two local ranks share the card."""
    import shutil
    import tempfile

    from langstream_tpu_torch.serving.lockstep_demo import cut_layers

    site = tempfile.mkdtemp(prefix="chip-smoke-site-")
    Path(site, "sitecustomize.py").write_text(_DEPTH_SITE)
    env = {"PYTHONPATH": os.pathsep.join(p for p in (site, os.environ.get("PYTHONPATH"))
                                         if p), "LOCAL_WORLD_SIZE": "2"}
    if layers:
        env["LS_SMOKE_LAYERS"] = str(layers)
    try:
        with environment(**env), cut_layers(layers):
            yield
    finally:
        shutil.rmtree(site, ignore_errors=True)


def r_mesh(torch, label: str, cfg: dict, drive, device="cuda") -> dict:
    """``drive(engine)`` on ``cfg`` at ``R_MESH`` through
    ``TorchServiceProvider`` (inside :func:`ranks_at_depth`), the engine
    closed in its loop: the world ends, its rank is reaped and must have
    exited 0. Rank 0's launches (set to 0 just before the drive, read just
    after), the mesh section with the started rank's report, the seconds
    until the engine was ready and the drive's wall."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.models import llama
    from langstream_tpu_torch.serving.engine import TorchServingEngine

    t0 = time.monotonic()
    engine = TorchServiceProvider({**cfg, "mesh": R_MESH}, device=device
                                  ).get_completions_service({}).engine
    ready_s = time.monotonic() - t0
    TorchServingEngine.reset_instances()

    async def run():
        try:
            return await drive(engine)
        finally:
            await engine.close()

    reset_counts()
    lora0 = llama.LORA_DELTA_CALLS
    t0 = time.monotonic()
    out = asyncio.run(run())
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    run_out = {"out": out, "counts": read_counts(), "mesh": engine.mesh_section(),
               "lora_delta": llama.LORA_DELTA_CALLS - lora0, "ready_s": ready_s,
               "wall_s": wall, "digests": engine.tier_digests}
    children_ended(label, run_out["mesh"]["launched"], path="R")
    run_out["rank1"] = run_out["mesh"]["launched"]["children"][0]
    del engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return run_out


def r_reference(cfg: dict, params, drive, device="cuda"):
    """``drive(engine)`` on ``cfg`` without the mesh, one rank on the
    path's weights (``params``), closed in its loop."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)

    async def run():
        try:
            return await drive(engine)
        finally:
            await engine.close()

    out = asyncio.run(run())
    del engine
    gc.collect()
    return out


def _digest_check(label: str, digests, path: str = "R") -> dict:
    """A rank's tier digests: every promoted block's rows, read back from
    its pools after the scatter, equal a demoted block's at its gather."""
    demoted = {d for op, ds in digests if op == "kv_gather" for d in ds}
    promoted = [d for op, ds in digests if op == "kv_scatter" for d in ds]
    if not promoted or not set(promoted) <= demoted:
        fail(f"path {path} [{label}]: {len(promoted)} promoted blocks, "
             f"{len(set(promoted) - demoted)} of them not byte-equal to a demoted one")
    return {"demoted_blocks": len(demoted), "promoted_blocks": len(promoted)}


def r1_tiers(torch, params, ref, device="cuda") -> dict:
    """R1: paged bf16 KV with the prefix cache and a prefix store (T0 two
    blocks, T1 twelve, a local T2). Wave 1: path I's eight questions on
    its 1,536-token preamble at once, ``R1_MAX_TOKENS`` greedy tokens (the
    cold wave). Then the tiers drain (demotions to T1, twelve blocks on to
    T2) and the wave runs again: it hydrates the chain's T2 blocks and
    promotes its T1 blocks. Every rank's promoted rows equal its demoted
    ones byte for byte; kernel #4 launches on both ranks; the warm streams
    hold the first-token rule against the cold ones."""
    import tempfile

    from langstream_tpu_torch.serving.engine import _MODEL_CONFIGS

    label = "R1 prefix tiers"
    bs = int(R_BASE.get("kv-block-size", 64))
    prompts = tier_prompts(bs)[0]
    mc = _MODEL_CONFIGS[R_BASE["model"]](max_seq_len=int(R_BASE["max-seq-len"]))
    width = 4 if R_BASE.get("model-dtype") == "float32" else 2
    block_bytes = 2 * mc.layers * bs * mc.kv_heads * mc.head_dim * width
    store = {"t0-bytes": 2 * block_bytes, "t1-bytes": 12 * block_bytes,
             "t2": {"type": "local", "path": tempfile.mkdtemp(prefix="ls-r1-t2-")},
             "t2-rescan-s": 0.2, "hydrate-timeout-s": 60.0}
    cfg = {**R_BASE, "prefix-cache": True, "prefix-store": store}
    opts = {"max-tokens": R1_MAX_TOKENS, "temperature": 0}

    async def drive(engine):
        if engine._tier_block_bytes != block_bytes:
            fail(f"path R [{label}]: whole-head block bytes {engine._tier_block_bytes} "
                 f"!= {block_bytes}")
        t0 = time.monotonic()
        cold = await asyncio.gather(*(engine.generate(p, dict(opts)) for p in prompts))
        t1 = time.monotonic()
        for _ in range(2400):  # T0 down to its budget, every T2 write landed
            drained = engine.stats()["prefixstore"]
            if (drained["t0"]["bytes"] <= store["t0-bytes"] and drained["demotions_t1_t2"]
                    and not drained["t2"]["pending_jobs"]
                    and not drained["t2"]["in_transit_bytes"]):
                break
            await asyncio.sleep(0.05)
        else:
            fail(f"path R [{label}]: the tiers did not drain: {drained}")
        seq = engine.flight.recent_events(1)[-1]["seq"]
        t2 = time.monotonic()
        warm = await asyncio.gather(*(engine.generate(p, dict(opts)) for p in prompts))
        return {"cold": cold, "warm": warm, "drained": drained,
                "seconds": {"cold": round(t1 - t0, 3), "drain": round(t2 - t1, 3),
                            "warm": round(time.monotonic() - t2, 3)},
                "stats": engine.stats()["prefixstore"],
                "promoted": _events_since(engine, seq, "prefix-promote")}

    with environment(LS_TORCH_TIER_DIGESTS="1"):  # every rank keeps its moves' digests
        run = r_mesh(torch, label, cfg, drive, device)
    out, st, drained = run["out"], run["out"]["stats"], run["out"]["drained"]
    if not (drained["demotions_t0_t1"] and drained["demotions_t1_t2"]):
        fail(f"path R [{label}]: the drain must demote to T1 and spill to T2: {drained}")
    if not (st["promotions"] > drained["promotions"] and st["hydrations"]):
        fail(f"path R [{label}]: the second wave must promote from T1 and hydrate from T2: "
             f"{st}")
    ranks = {"0": _digest_check(f"{label} rank 0", run["digests"]),
             "1": _digest_check(f"{label} rank 1", run["rank1"]["mesh"][0]["tier-digests"])}
    for rank, c in (("0", run["counts"]), ("1", run["rank1"]["kernels"])):
        if device == "cuda" and c["paged_attention_multiquery"] == 0:
            fail(f"path R [{label}]: rank {rank} did not launch kernel #4: {c}")
    gaps = top2_gaps(torch, ref, prompts)
    rule = check_first_tokens(label, out["warm"], out["cold"], gaps, path="R")
    moved = run["mesh"]["collectives"].get("kv-tier", {"bytes": 0, "seconds": 0.0})
    demoted = drained["demotions_t0_t1"] * block_bytes
    prom_bytes = sum(e["bytes"] for e in out["promoted"])
    prom_ms = sum(e["device_ms"] for e in out["promoted"])
    print(f"path R [{label}]: " + json.dumps({
        "ready_s": round(run["ready_s"], 3), "wall_s": round(run["wall_s"], 3),
        "seconds": out["seconds"], "block_bytes": block_bytes, "tiers_drained": {k: drained[k] for k in (
            "demotions_t0_t1", "demotions_t1_t2")},
        "tiers_warm": {k: st[k] for k in ("promotions", "hydrations")},
        "demote_bytes": demoted, "demote_fetch_s": drained["t0"]["demote_seconds"],
        "demote_gbps": (round(demoted / drained["t0"]["demote_seconds"] / 1e9, 3)
                        if drained["t0"]["demote_seconds"] else None),
        "promote_bytes": prom_bytes, "promote_device_ms": round(prom_ms, 3),
        "promote_gbps": round(prom_bytes / prom_ms / 1e6, 3) if prom_ms else None,
        "tier_collectives": moved, "digests": ranks,
        "first_tokens_checked": rule["checked"],
        "rank0_launches": {k: v for k, v in run["counts"].items() if v},
        "rank1_launches": {k: v for k, v in run["rank1"]["kernels"].items() if v},
        "tier_moves": [run["mesh"]["tier-moves"], run["rank1"]["mesh"][0]["tier-moves"]]}),
        flush=True)
    return run


def r2_adapters(torch, params, ref, device="cuda") -> dict:
    """R2: paged int8 KV and an adapter store of rank ``R2_RANK`` with two
    T0 rows for three adapters, so rows are evicted and loaded again. 24
    requests at once: eight prompts on the base model, six each on two
    adapters, four on the third; with them R3's eight prompts on the base
    model (the combined tp=2 run R3 is held to: a base row's delta is an
    exact zero). Every stream holds the first-token rule (each request's
    gap under its adapter) against the same wave at tp=1; at least one
    adapter stream differs from its base stream; every rank loaded the
    rows the leader did."""
    from langstream_tpu_torch.serving.adapters import make_lora_arrays
    from langstream_tpu_torch.serving.engine import _MODEL_CONFIGS

    label = "R2 adapters"
    mc = _MODEL_CONFIGS[R_BASE["model"]](max_seq_len=int(R_BASE["max-seq-len"]))
    arrays = {name: make_lora_arrays(layers=mc.layers, hidden=mc.hidden, heads=mc.heads,
                                     kv_heads=mc.kv_heads, head_dim=mc.head_dim,
                                     rank=R2_RANK, seed=200 + i, scale=R2_SCALE)
              for i, name in enumerate(R2_NAMES)}
    per = int(sum(a.nbytes for a in arrays[R2_NAMES[0]].values()))
    cfg = {**R_BASE, "kv-quantize": "int8", "prefix-cache": False,
           "adapter-store": {"rank": R2_RANK, "t0-entries": 2, "t1-bytes": 4 * per,
                             "hydrate-timeout-s": 60.0}}
    prompts = j_prompts()[:8]
    wave = ([(p, None) for p in prompts] + [(p, R2_NAMES[0]) for p in prompts[:6]]
            + [(p, R2_NAMES[1]) for p in prompts[:6]] + [(p, R2_NAMES[2]) for p in prompts[:4]]
            + [(p, None) for p in r3_prompts()])

    async def drive(engine):
        for name, factors in arrays.items():
            engine.install_adapter(name, factors)
        results = await asyncio.gather(*(engine.generate(p, {
            "max-tokens": R2_MAX_TOKENS, "temperature": 0, **({"adapter": n} if n else {})})
            for p, n in wave))
        return {"results": results, "t0": engine.stats()["adapters"]["t0"],
                "stats": engine.stats()}

    run = r_mesh(torch, label, cfg, drive, device)
    want = r_reference(cfg, params, drive, device)
    got = run["out"]["results"]
    gaps = top2_gaps(torch, ref, [p for p, _ in wave], [arrays.get(n) for _, n in wave])
    rule = check_first_tokens(label, got, want["results"], gaps, path="R")
    base = {p: r["tokens"] for (p, n), r in zip(wave, got) if n is None}
    steered = sum(r["tokens"] != base[p] for (p, n), r in zip(wave, got) if n)
    if not steered:
        fail(f"path R [{label}]: no adapter stream differs from its base stream")
    t0, leader, rank1 = run["out"]["t0"], run["mesh"], run["rank1"]["mesh"][0]
    if not t0["evictions"] or leader["tier-moves"]["adapter_row"] < len(R2_NAMES):
        fail(f"path R [{label}]: the rows were not evicted and loaded again: {t0}")
    if (rank1["tier-moves"] != leader["tier-moves"]
            or rank1["adapter-rows"] != leader["adapter-rows"]):
        fail(f"path R [{label}]: rank 1 loaded other rows than the leader: "
             f"{rank1['tier-moves']} {rank1['adapter-rows']} against "
             f"{leader['tier-moves']} {leader['adapter-rows']}")
    print(f"path R [{label}]: " + json.dumps({
        "ready_s": round(run["ready_s"], 3), "wall_s": round(run["wall_s"], 3),
        "ms_per_step": [_step_ms(run["out"]["stats"]), _step_ms(want["stats"])],
        "first_tokens_checked": rule["checked"], "adapter_streams_steered": steered,
        "row_loads": leader["tier-moves"]["adapter_row"], "t0": t0,
        "lora_delta_calls": [run["lora_delta"], run["rank1"]["lora_delta"]],
        "adapter_collectives": leader["collectives"].get("adapter-rows"),
        "rank0_launches": {k: v for k, v in run["counts"].items() if v},
        "rank1_launches": {k: v for k, v in run["rank1"]["kernels"].items() if v}}),
        flush=True)
    return run


def r3_prompts() -> list[str]:
    return chat_prompts()[:8]


def r3_pool_roles(torch, params, ref, combined: list, device="cuda") -> dict:
    """R3: paged int8 KV, one engine at a time. A ``pool-role: prefill``
    engine at tp=2 exports eight requests and closes; a ``pool-role:
    decode`` engine at tp=1 imports and decodes them, held by the
    first-token rule to ``combined``, R2's combined tp=2 run of the same
    prompts (the same pool and weights). The payloads' fingerprints
    equal a tp=1 prefill engine's and their rows, dequantized, are within
    ``R3_TOL`` of that engine's max abs."""
    from langstream_tpu_torch.serving import kvtransfer

    label = "R3 pool roles"
    cfg = {**R_BASE, "kv-quantize": "int8", "prefix-cache": False}
    prompts = r3_prompts()
    opts = {"max-tokens": R3_MAX_TOKENS, "temperature": 0}

    async def prefill(engine):
        tickets = await asyncio.gather(*(engine.generate(p, dict(opts)) for p in prompts))
        return [engine.take_export(t["handoff"]) for t in tickets]

    async def decode(engine):
        return await asyncio.gather(*(engine.import_handoff(p) for p in payloads))

    exported = r_mesh(torch, f"{label}: prefill tp=2", {**cfg, "pool-role": "prefill"},
                      prefill, device)
    payloads = exported["out"]
    decoded = r_reference({**cfg, "pool-role": "decode"}, params, decode, device)
    local = r_reference({**cfg, "pool-role": "prefill"}, params, prefill, device)
    rule = check_first_tokens(label, decoded, combined, top2_gaps(torch, ref, prompts),
                              path="R")
    worst = 0.0
    for ours, theirs in zip(payloads, local, strict=True):
        (ha, aa), (hb, ab) = (kvtransfer.deserialize_handoff(x) for x in (ours, theirs))
        if ha["fingerprint"] != hb["fingerprint"] or ha["kv-rows"] != hb["kv-rows"]:
            fail(f"path R [{label}]: the tp=2 export's fingerprint {ha['fingerprint']} "
                 f"!= the tp=1 export's {hb['fingerprint']}")
        for cache in ("k", "v"):
            rows = []
            for arrays in (aa, ab):
                q, sc = arrays[f"{cache}.q"].float(), arrays[f"{cache}.s"].float()
                rows.append((q.reshape(*sc.shape, -1) * sc[..., None]).reshape(q.shape))
            err = float((rows[0] - rows[1]).abs().max() / rows[1].abs().max())
            worst = max(worst, err)
    if not worst <= R3_TOL:
        fail(f"path R [{label}]: the tp=2 export's rows differ from the tp=1 export's by "
             f"{worst} of their max abs > {R3_TOL}")
    gathers = [exported["mesh"]["tier-moves"]["kv_gather"],
               exported["rank1"]["mesh"][0]["tier-moves"]["kv_gather"]]
    if gathers != [len(prompts)] * 2:
        fail(f"path R [{label}]: export gathers by rank {gathers}, not {len(prompts)} each")
    print(f"path R [{label}]: " + json.dumps({
        "ready_s": round(exported["ready_s"], 3), "wall_s": round(exported["wall_s"], 3),
        "payload_bytes": sum(len(p) for p in payloads), "rows_err_of_max_abs": worst,
        "first_tokens_checked": rule["checked"], "export_gathers": gathers,
        "tier_collectives": exported["mesh"]["collectives"].get("kv-tier"),
        "rank0_launches": {k: v for k, v in exported["counts"].items() if v},
        "rank1_launches": {k: v for k, v in exported["rank1"]["kernels"].items() if v}}),
        flush=True)
    return exported


def phase_store_mesh_path(torch, device="cuda") -> dict:
    """Path R: the tiered stores and the pool roles under ``R_MESH``, two
    local ranks on this card started by the launcher (``ranks_at_depth``
    cuts them to ``R_LAYERS`` as it cuts this process): :func:`r1_tiers`,
    :func:`r2_adapters`, :func:`r3_pool_roles`, each against a tp=1
    reference on the same weights (a tp=1 engine's, from the same seed or
    checkpoint). Kernels #1-#4 must each launch on both ranks over R's
    tp=2 runs. Returns rank 0's launches summed over them."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    t0 = time.monotonic()
    with ranks_at_depth(R_LAYERS):
        ref = TorchServingEngine(ServingConfig.from_dict({**R_BASE, "prefix-cache": False}),
                                 device=device)
        params = ref.params
        r1 = r1_tiers(torch, params, ref, device)
        t1 = time.monotonic()
        r2 = r2_adapters(torch, params, ref, device)
        t2 = time.monotonic()
        r3 = r3_pool_roles(torch, params, ref, r2["out"]["results"][-len(r3_prompts()):],
                           device)
    runs = [r1, r2, r3]
    rank0 = {k: sum(r["counts"][k] for r in runs) for k in runs[0]["counts"]}
    rank1 = {k: sum(r["rank1"]["kernels"][k] for r in runs) for k in rank0}
    for rank, counts in (("0", rank0), ("1", rank1)):
        if device == "cuda" and not all(counts.values()):
            fail(f"path R: rank {rank} did not launch every kernel: {counts}")
    asyncio.run(ref.close())
    del ref, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"path R: {time.monotonic() - t0:.1f} s (R1 {t1 - t0:.1f} s, R2 {t2 - t1:.1f} s, "
          f"R3 {time.monotonic() - t2:.1f} s); launches rank 0 {rank0}, rank 1 {rank1}",
          flush=True)
    return rank0


# ---------------------------------------------------------------------------
# path S: the port in the cluster
# ---------------------------------------------------------------------------

#: S2's serving resource: llama3-8b at full width, int8 weights and int8
#: paged KV from seed 0, at ``S_LAYERS`` of its 32 layers, over the slice's
#: four ranks
S_LAYERS = 1   # 4 until path V came (the smoke 1,018.5 s with R and S at 4), 2
               # until path Y came (1,052.3 s with R and S at 2 on a slow host)
S_RESOURCE = {"model": "llama3-8b", "quantize": "int8", "kv-layout": "paged",
              "kv-quantize": "int8", "slots": 8, "max-seq-len": 2048, "decode-chunk": 32,
              "seed": 0, "mesh": {"dp": 2, "tp": 2}}
S_MAX_TOKENS = 32
S_ACCELERATOR = "h100-2g"  # hosts of 2 cards: a mesh of 4 is 2 pods of 2 ranks


def s_agent_cr(device_mesh: dict) -> dict:
    """An Agent CR, as the operator receives it, whose agent asks for
    ``device_mesh``."""
    return {"apiVersion": "langstream.tpu/v1alpha1", "kind": "Agent",
            "metadata": {"name": "smoke-chat", "namespace": "langstream-smoke"},
            "spec": {"tenant": "smoke", "applicationId": "smoke", "agentId": "chat",
                     "image": "langstream-tpu-torch/runtime:latest",
                     "agentConfigSecretRef": "smoke-chat-config",
                     "agentConfigSecretRefChecksum": "path-s",
                     "resources": {"parallelism": 1, "size": 1,
                                   "deviceMesh": device_mesh}}}


def pod_env(sts: dict, ordinal: int) -> dict:
    """The runtime container's env of pod ``ordinal`` of ``sts`` as a
    kubelet gives it: ``LS_POD_NAME`` from its ``fieldRef`` as
    ``<sts>-<ordinal>``, the coordinator's headless-service name resolved
    to 127.0.0.1 (where every pod of this host listens)."""
    env = {}
    for var in sts["spec"]["template"]["spec"]["containers"][0]["env"]:
        if "value" in var:
            env[var["name"]] = var["value"]
        elif var["valueFrom"]["fieldRef"]["fieldPath"] == "metadata.name":
            env[var["name"]] = f"{sts['metadata']['name']}-{ordinal}"
    env["LS_COORDINATOR_ADDRESS"] = "127.0.0.1:" + env["LS_COORDINATOR_ADDRESS"].rsplit(":", 1)[1]
    return env


def committed_accelerator() -> dict:
    """The ``LS_ACCELERATOR`` of the committed install: the operator
    manifest's (``deploy/torch/k8s/05-operator.yaml``) and the chart's
    default (``deploy/torch/helm/langstream-tpu-torch/values.yaml``), which
    must agree (read as text: the card's machine need not have PyYAML)."""
    manifest = (REPO / "deploy" / "torch" / "k8s" / "05-operator.yaml").read_text()
    values = (REPO / "deploy" / "torch" / "helm" / "langstream-tpu-torch" / "values.yaml"
              ).read_text()
    found = {"manifest": re.search(r"- name: LS_ACCELERATOR\n\s+value: (\S+)\n", manifest),
             "chart": re.search(r"^accelerator: (\S+)$", values, re.M)}
    found = {k: m.group(1) if m else None for k, m in found.items()}
    if found["manifest"] is None or found["manifest"] != found["chart"]:
        fail(f"path S1: the committed install names no one accelerator: {found}")
    return found


def s1_placement(torch, smi: str) -> dict:
    """S1: the port factory's StatefulSet, at the accelerator the committed
    install names (:func:`committed_accelerator`), for an agent whose
    device mesh has this machine's card count asks for that many cards, on
    a node pool whose entry names the card found."""
    from langstream_tpu_torch.k8s.resources import GPU_TOPOLOGIES, AgentResourcesFactory

    count = torch.cuda.device_count()
    accelerator = committed_accelerator()["manifest"]
    (sts,) = AgentResourcesFactory.generate_statefulsets(s_agent_cr({"tp": count}),
                                                         accelerator=accelerator)
    pod = sts["spec"]["template"]["spec"]
    resources = pod["containers"][0]["resources"]
    asked = (resources["limits"].get("nvidia.com/gpu"),
             resources["requests"].get("nvidia.com/gpu"))
    if asked != (str(count), str(count)):
        fail(f"path S1: the StatefulSet asks for {asked} cards, the machine has {count}")
    card = torch.cuda.get_device_name(0)
    entry = GPU_TOPOLOGIES[accelerator]
    if pod["nodeSelector"] != entry.node_selector or entry.card != card:
        fail(f"path S1: the committed install's {accelerator!r} ({entry}) does not place on "
             f"the card found, {card!r}: node selector {pod['nodeSelector']}")
    return {"cards": count, "committed_accelerator": accelerator,
            "node_selector": pod["nodeSelector"], "card": card, "nvidia_smi": smi}


def s2_refusals(device="cuda") -> list[str]:
    """A manifest whose ranks disagree with the resource's mesh is refused
    at the pod's start, in the launcher's words, before anything starts:
    one host of 2 ranks for a mesh of 4, and a slice of 4 hosts x 2 ranks
    for it."""
    from langstream_tpu_torch.k8s.resources import AgentResourcesFactory
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    said = []
    for accelerator, cards, words in (
            ("h100", 2, "needs 4 devices, have 2"),
            (S_ACCELERATOR, 8, "a slice of 4 hosts x 2 local ranks has 8")):
        (sts,) = AgentResourcesFactory.generate_statefulsets(
            s_agent_cr({"tp": cards}), accelerator=accelerator, device=device)
        with environment(**pod_env(sts, 0)):
            try:
                TorchServingEngine(ServingConfig.from_dict(S_RESOURCE), device=device)
            except ValueError as e:
                if words not in str(e):
                    fail(f"path S2: a {cards}-card manifest was refused otherwise: {e}")
                said.append(str(e))
                continue
        fail(f"path S2: a {cards}-card manifest served a mesh of 4")
    return said


def slice_pods(label: str, resource: dict, prompts: list, max_tokens: int, scenario: str,
               device="cuda", **env: str) -> tuple[list[dict], float]:
    """The 2-host slice from the ``S_ACCELERATOR`` manifest of ``resource``'s
    mesh, its pods as processes (``--q2-pod``, driving ``scenario``) with
    the runtime container's env (and ``env``), at ``S_LAYERS`` (a
    ``sitecustomize`` on their ``PYTHONPATH``, inherited by the ranks they
    start). Every pod and started rank must exit 0. The pods' reports and
    the seconds from their start to their exit."""
    import shutil
    import tempfile

    from langstream_tpu_torch.k8s.resources import AgentResourcesFactory

    (sts,) = AgentResourcesFactory.generate_statefulsets(
        s_agent_cr(resource["mesh"]), accelerator=S_ACCELERATOR, device=device)
    envs = [pod_env(sts, i) for i in range(sts["spec"]["replicas"])]
    if len(envs) != 2 or any(e["LOCAL_WORLD_SIZE"] != "2" or e["LS_SLICE_HOSTS"] != "2"
                             for e in envs):
        fail(f"path S [{label}]: the manifest is not 2 pods of 2 ranks: {envs}")
    site = tempfile.mkdtemp(prefix="chip-smoke-site-")
    Path(site, "sitecustomize.py").write_text(_DEPTH_SITE)
    tmp = Path(os.environ.get("TMPDIR", "/tmp"))
    pods = []
    t0 = time.monotonic()
    try:
        for pod in envs:
            out = tmp / f"chip_smoke_{pod['LS_POD_NAME']}_{os.getpid()}.json"
            with open(out.with_suffix(".log"), "wb") as log_file:  # a file, not a pipe
                proc = subprocess.Popen(
                    [sys.executable, str(REPO / "chip_smoke.py"), "--q2-pod",
                     json.dumps(resource), json.dumps(prompts), str(max_tokens), device,
                     str(out), scenario], cwd=REPO, stdout=subprocess.DEVNULL,
                    stderr=log_file,
                    env={**os.environ, **pod, **env, "LS_SMOKE_LAYERS": str(S_LAYERS),
                         "PYTHONPATH": os.pathsep.join((site, str(REPO)))})
            pods.append((pod["LS_POD_NAME"], proc, out))
        deadline = time.monotonic() + 300
        for name, proc, out in pods:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for _, other, _ in pods:
                    other.kill()
                    other.wait()
            err = out.with_suffix(".log").read_text(errors="replace")[-3000:]
            out.with_suffix(".log").unlink()
            if proc.returncode != 0:
                fail(f"path S [{label}]: pod {name} exited {proc.returncode}: {err}")
    finally:
        shutil.rmtree(site, ignore_errors=True)
    slice_s = time.monotonic() - t0
    reports = []
    for name, _, out in pods:
        reports.append(json.loads(out.read_text()))
        out.unlink()
        children_ended(f"{label} {name}", reports[-1]["launched"], path="S")
    mesh = reports[0]["mesh"]
    if (mesh["world-size"], mesh["rank"], mesh["axes"]) != (4, 0, resource["mesh"]):
        fail(f"path S [{label}]: the leader's mesh is not the slice's: {mesh}")
    return reports, slice_s


def slice_launches(label: str, reports: list[dict], device="cuda") -> dict:
    """Each of the slice's four ranks' kernel launches (the pods' own and
    their started ranks'); kernels #1 and #3 must have launched on each."""
    ranks = {0: reports[0]["kernels"], 2: reports[1]["kernels"]}
    for report in reports:
        ranks.update({c["rank"]: c["kernels"] for c in report["launched"]["children"]})
    for rank, counts in sorted(ranks.items()):
        if device == "cuda" and (counts["flash_attention"] == 0
                                 or counts["paged_attention_q8"] == 0):
            fail(f"path S [{label}]: rank {rank} did not launch kernels #1 and #3: {counts}")
    return dict(sorted(ranks.items()))


def _streams(out: dict) -> list[dict]:
    return [{"tokens": t, "logprobs": lp} for t, lp in zip(out["tokens"], out["logprobs"])]


def s2_slice(torch, device="cuda") -> dict:
    """S2: the 2-host slice from the ``S_ACCELERATOR`` manifest of a 4-card
    device mesh (:func:`slice_pods`), held to a one-rank engine of the same
    seed, and the manifests' refusals. Returns the leader rank's
    launches."""
    refusals = s2_refusals(device)
    prompts = chat_prompts()
    reports, slice_s = slice_pods("S2", S_RESOURCE, prompts, S_MAX_TOKENS, "serve", device)
    leader, mesh = reports[0], reports[0]["mesh"]
    ranks = slice_launches("S2", reports, device)
    ref, gaps = reference_run(torch, S_RESOURCE, [prompts], S_MAX_TOKENS, S_LAYERS, device)
    rule = check_first_tokens("S2", _streams(leader), ref["results"], gaps, path="S")
    return {"slice_s": round(slice_s, 3), "refusals": refusals,
            "first_tokens_checked": rule["checked"], "prefixes": rule["prefixes"],
            "wave_s": round(leader["serve_s"], 3), "wave_s_one_rank": round(ref["wall_s"], 3),
            "replayed_by_pod_1": reports[1]["replayed"],
            "lockstep_dispatches": mesh["lockstep-dispatches"],
            "collectives": mesh["collectives"],
            "launches_by_rank": {r: {k: v for k, v in c.items() if v} for r, c in ranks.items()},
            "counts": leader["kernels"]}


#: S3: S2's slice with the prefix cache and a prefix store (T0 two blocks,
#: T1 twelve, a local T2), path I1's eight questions on its 1,536-token
#: preamble, cold and then warm
S3_MAX_TOKENS = 32


def s3_tiers(torch, device="cuda") -> dict:
    """S3: a cold wave on the slice, the tiers drained (demotion to T1, a
    spill to T2), the wave again (T1 promotion, T2 hydration) landing on
    all four ranks: every rank's promoted rows byte-equal to demoted ones
    (``LS_TORCH_TIER_DIGESTS``), every rank's tier moves the leader's; the
    cold streams held to a one-rank engine by the first-token rule, the
    warm ones to the cold ones. Returns the leader rank's launches."""
    import shutil
    import tempfile

    from langstream_tpu_torch.serving.engine import _MODEL_CONFIGS

    label = "S3 prefix tiers"
    bs = int(S_RESOURCE.get("kv-block-size", 64))
    mc = _MODEL_CONFIGS[S_RESOURCE["model"]](max_seq_len=int(S_RESOURCE["max-seq-len"]))
    block_bytes = 2 * S_LAYERS * bs * mc.kv_heads * (mc.head_dim + 4)  # int8 rows, f32 scales
    t2 = tempfile.mkdtemp(prefix="ls-s3-t2-")
    store = {"t0-bytes": 2 * block_bytes, "t1-bytes": 12 * block_bytes,
             "t2": {"type": "local", "path": t2}, "t2-rescan-s": 0.2,
             "hydrate-timeout-s": 60.0}
    cfg = {**S_RESOURCE, "prefix-cache": True, "prefix-store": store}
    prompts = tier_prompts(bs)[0]
    try:
        reports, slice_s = slice_pods("S3", cfg, prompts, S3_MAX_TOKENS, "tiers", device,
                                      LS_TORCH_TIER_DIGESTS="1")
    finally:
        shutil.rmtree(t2, ignore_errors=True)
    leader, follower = reports
    if leader["block_bytes"] != block_bytes:
        fail(f"path S [{label}]: whole-head block bytes {leader['block_bytes']} != {block_bytes}")
    drained, st = leader["drained"], leader["stats"]
    if not (drained["demotions_t0_t1"] and drained["demotions_t1_t2"]):
        fail(f"path S [{label}]: the drain must demote to T1 and spill to T2: {drained}")
    if not (st["promotions"] > drained["promotions"]):
        fail(f"path S [{label}]: the warm wave promoted nothing: {st}")
    meshes = {0: leader["mesh"], 1: leader["launched"]["children"][0]["mesh"][0],
              2: follower["mesh"][0], 3: follower["launched"]["children"][0]["mesh"][0]}
    digests = {}
    for rank, mesh in meshes.items():
        if mesh["tier-moves"] != leader["mesh"]["tier-moves"]:
            fail(f"path S [{label}]: rank {rank}'s tier moves {mesh['tier-moves']} are not "
                 f"the leader's {leader['mesh']['tier-moves']}")
        digests[rank] = _digest_check(f"{label} rank {rank}", mesh["tier-digests"], "S")
    ranks = slice_launches("S3", reports, device)
    ref, gaps = reference_run(torch, S_RESOURCE, [prompts], S3_MAX_TOKENS, S_LAYERS, device)
    cold_rule = check_first_tokens(f"{label}: cold", _streams(leader), ref["results"], gaps,
                                   path="S")
    warm_rule = check_first_tokens(f"{label}: warm", _streams(leader["warm"]),
                                   _streams(leader), gaps, path="S")
    demoted = drained["demotions_t0_t1"] * block_bytes
    prom_bytes = sum(e["bytes"] for e in leader["promoted"])
    prom_ms = sum(e["device_ms"] for e in leader["promoted"])
    return {"slice_s": round(slice_s, 3), "seconds": leader["seconds"],
            "block_bytes": block_bytes,
            "tiers_drained": {k: drained[k] for k in ("demotions_t0_t1", "demotions_t1_t2")},
            "tiers_warm": {k: st[k] for k in ("promotions", "hydrations")},
            "demote_bytes": demoted, "demote_fetch_s": drained["t0"]["demote_seconds"],
            "demote_gbps": (round(demoted / drained["t0"]["demote_seconds"] / 1e9, 3)
                            if drained["t0"]["demote_seconds"] else None),
            "promote_bytes": prom_bytes, "promote_device_ms": round(prom_ms, 3),
            "promote_gbps": round(prom_bytes / prom_ms / 1e6, 3) if prom_ms else None,
            "digests_by_rank": digests, "tier_moves": leader["mesh"]["tier-moves"],
            "tier_collectives": leader["mesh"]["collectives"].get("kv-tier"),
            "first_tokens_checked": {"cold": cold_rule["checked"], "warm": warm_rule["checked"]},
            "wave_s_one_rank": round(ref["wall_s"], 3),
            "launches_by_rank": {r: {k: v for k, v in c.items() if v} for r, c in ranks.items()},
            "counts": leader["kernels"]}


def phase_cluster_path(torch, smi: str, device="cuda") -> dict:
    """Path S: the port in the cluster (:func:`s1_placement`,
    :func:`s2_slice`, :func:`s3_tiers`). Returns the leader rank's S2 and
    S3 launches."""
    t0 = time.monotonic()
    s1 = s1_placement(torch, smi)
    print(f"path S [S1 placement]: {json.dumps(s1)}", flush=True)
    s2 = s2_slice(torch, device)
    counts = s2.pop("counts")
    print(f"path S [S2 llama3-8b int8 {S_LAYERS} layers, 2 pods x 2 ranks, dp=2 tp=2, "
          f"from the {S_ACCELERATOR} manifest]: {json.dumps(s2)}", flush=True)
    t3 = time.monotonic()
    s3 = s3_tiers(torch, device)
    s3_counts = s3.pop("counts")
    s3["path_s"] = round(time.monotonic() - t3, 3)
    print(f"path S [S3 llama3-8b int8 {S_LAYERS} layers, 2 pods x 2 ranks, dp=2 tp=2, "
          f"prefix store]: {json.dumps(s3)}", flush=True)
    print(f"path S: {time.monotonic() - t0:.1f} s (S3 {s3['path_s']:.1f} s)", flush=True)
    return {k: counts[k] + s3_counts[k] for k in counts}


# ---------------------------------------------------------------------------
# path T: the application path without JAX
# ---------------------------------------------------------------------------

T_WAVE = 8             # T1's sessions, one question each, all at once
T1B_SESSIONS = 4       # T1b's sessions over /v1/chat
T_TIMEOUT = 300.0      # seconds any one frame may take
#: what the port must run without (none of it may be in sys.modules)
T_REFUSED = ("jax", "jaxlib", "langstream_tpu", "yaml", "aiohttp", "click")
T_APPS = REPO / "examples" / "applications"
T_INSTANCE = REPO / "examples" / "instances" / "memory.yaml"
T_SECRETS = REPO / "examples" / "secrets" / "secrets.yaml"
#: T2's resource: the chat example's at the tiny model, the in-repo HF
#: fixture's weights (so the answer has text)
T2_RESOURCE = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 256,
               "checkpoint": str(REPO / "tests" / "fixtures" / "llama_tiny_golden"),
               "decode-chunk": 4, "decode-chunk-light": 2, "max-tokens": 16,
               "warmup-on-start": True}


def _t_leaks(refused=T_REFUSED) -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in refused)


def _t_stats(values: list[float]) -> dict:
    values = sorted(values)
    return {"p50": round(values[len(values) // 2], 4), "max": round(values[-1], 4),
            "min": round(values[0], 4)} if values else {}


async def _t_topic_counts(run, topics) -> dict:
    counts = {}
    for topic in topics:
        reader = run.runner.reader(topic, "earliest")
        await reader.start()
        counts[topic] = len(await reader.read(timeout=0))
        await reader.close()
    return counts


def t1_chat_app(torch, device="cuda") -> tuple[dict, dict]:
    """T1: the chat-completions example as it is in the repository (its
    resource: llama3-8b int8, 64 slots, 2,048 context, ``decode-chunk-light:
    8``, ``warmup-on-start``), run by the port's ``run`` in this process and
    driven through the port's gateway: a wave of ``T_WAVE`` sessions, each
    a produce socket on ``user-input`` and a consume socket on
    ``bot-output``. Every streamed answer must equal its answers-topic value
    and the greedy text the port's provider gives directly, on the engine
    the agent uses, for the same messages. Returns (the path's line, the
    launches of the app's run)."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.cli.main import LocalRun
    from langstream_tpu_torch.gateway.wire import WebSocketClient

    label = "T1: chat-completions through the port's run and gateway"
    questions = chat_prompts()[:T_WAVE]
    sessions = [f"t1-{i}" for i in range(len(questions))]

    async def drive():
        out = {}
        t0 = time.monotonic()
        run = LocalRun("chat", T_APPS / "chat-completions", T_INSTANCE, device=device,
                       gateway_port=0)
        await run.start()
        out["start_s"] = time.monotonic() - t0
        try:
            # the provider resolves the agent's engine (one per resource)
            cfg = {"type": CHAT_EXAMPLE_RESOURCE["type"], "name": CHAT_EXAMPLE_RESOURCE["name"],
                   **CHAT_EXAMPLE_RESOURCE["configuration"]}
            service = TorchServiceProvider(cfg, device=device).get_completions_service({})
            engine = service.engine
            if engine._warmup_task is None:
                fail(f"{label}: the provider's engine is not the one the app's start warmed")
            out["warmup"] = engine.stats()["warmup"]
            completed = engine.stats()["completed"]
            ascii_head(engine)  # after the warmup: the answers need text
            consumers = [await WebSocketClient.connect(run.url("consume", "bot-output",
                                                               sessionId=s))
                         for s in sessions]
            producers = [await WebSocketClient.connect(run.url("produce", "user-input",
                                                               sessionId=s))
                         for s in sessions]

            async def one(i):
                t = time.monotonic()
                await producers[i].send_json({"value": questions[i]})
                ack = await producers[i].receive_json(T_TIMEOUT)
                if ack.get("status") != "OK":
                    fail(f"{label}: session {i} produce refused: {ack}")
                first, chunks = None, []
                while True:
                    frame = await consumers[i].receive_json(T_TIMEOUT)
                    if first is None:
                        first = time.monotonic() - t
                    headers = frame["record"]["headers"]
                    if headers.get("langstream-client-session-id") != sessions[i]:
                        fail(f"{label}: session {i} got another session's frame: {headers}")
                    chunks.append(frame["record"]["value"])
                    if headers.get("stream-last-message") == "true":
                        return first, chunks

            t = time.monotonic()
            out["streams"] = await asyncio.gather(*(one(i) for i in range(len(questions))))
            out["wave_s"] = time.monotonic() - t
            answers = await run.runner.wait_for_messages("answers-topic", len(questions),
                                                         timeout=T_TIMEOUT)
            out["answers"] = {a.header("langstream-client-session-id"): a for a in answers}
            out["topics"] = await _t_topic_counts(
                run, ("questions-topic", "answers-topic", "stream-topic"))
            for ws in consumers + producers:
                await ws.close()
            out["counts"] = read_counts()
            out["leaks"] = _t_leaks()
            if engine.stats()["completed"] - completed != len(questions):
                fail(f"{label}: the agent's requests did not run on the provider's engine")
            # the provider directly, on the agent's engine, the agent's options
            # (its resolved ``model``), the same messages, as one wave
            out["direct"] = await asyncio.gather(*(
                service.chat_completions([{"role": "user", "content": q}],
                                         {"model": "llama3-8b"})
                for q in questions))
            out["stats"] = engine.stats()
        finally:
            await run.stop()
        return out

    reset_counts()
    out = asyncio.run(drive())
    if out["leaks"]:
        fail(f"{label}: the port's run loaded {out['leaks']}")
    if out["warmup"]["state"] != "done":
        fail(f"{label}: warmup-on-start did not warm the engine inside the start: "
             f"{out['warmup']}")
    gateway_ttft, engine_ttft, n_chunks = [], [], []
    for i, (first, chunks) in enumerate(out["streams"]):
        streamed = "".join(chunks)
        record = out["answers"].get(sessions[i])
        if record is None:
            fail(f"{label}: no answers-topic record for session {i}")
        answer = record.value["answer"]
        direct = out["direct"][i].text
        if not streamed or streamed != answer:
            fail(f"{label}: session {i}: streamed {streamed!r} != answers-topic {answer!r}")
        if answer != direct:
            fail(f"{label}: session {i}: answer {answer!r} != the provider's greedy "
                 f"text {direct!r}")
        gateway_ttft.append(first)
        engine_ttft.append(float(record.header("langstream-ttft-ms")) / 1e3)
        n_chunks.append(len(chunks))
    counts = out["counts"]
    if device == "cuda" and min(counts["flash_attention"], counts["paged_attention"]) == 0:
        fail(f"{label}: flash and the bf16 paged read must launch: {counts}")
    line = {"sessions": len(questions), "start_s": round(out["start_s"], 3),
            "warmup_s": round(out["warmup"]["seconds"], 3), "wave_s": round(out["wave_s"], 3),
            "gateway_ttft_s": _t_stats(gateway_ttft), "engine_ttft_s": _t_stats(engine_ttft),
            "gateway_minus_engine_ttft_s": _t_stats(
                [g - e for g, e in zip(gateway_ttft, engine_ttft)]),
            "chunks_per_answer": _t_stats([float(n) for n in n_chunks]),
            "answer_tokens": sum(r.num_completion_tokens for r in out["direct"]),
            "records_per_topic": out["topics"], "launches": counts,
            "equal_to_provider": True, "modules_refused_and_absent": list(T_REFUSED)}
    return line, counts


def t1b_chat_route(torch, device="cuda") -> tuple[dict, dict]:
    """T1b: the ``chatbot-gateway`` example (llama3-8b int8) through its
    unauthenticated ``/v1/chat`` gateway, the bench's route: ``T1B_SESSIONS``
    chat sockets at once, each a question whose chunks and final answer
    come back on the same socket; the chunks must join to the answer."""
    from langstream_tpu_torch.cli.main import LocalRun
    from langstream_tpu_torch.gateway.wire import WebSocketClient

    label = "T1b: chatbot-gateway over /v1/chat"
    questions = chat_prompts()[2:2 + T1B_SESSIONS]

    async def drive():
        out = {}
        t0 = time.monotonic()
        run = LocalRun("chatbot", T_APPS / "chatbot-gateway", T_INSTANCE, T_SECRETS,
                       device=device, gateway_port=0)
        await run.start()
        out["start_s"] = time.monotonic() - t0
        try:
            from langstream_tpu_torch.agents.provider import TorchServiceProvider
            from langstream_tpu_torch.core.yaml_subset import safe_load

            config = T_APPS / "chatbot-gateway" / "configuration.yaml"
            (resource,) = safe_load(config.read_text(), str(config))["configuration"]["resources"]
            cfg = {"type": resource["type"], "name": resource["name"], **resource["configuration"]}
            ascii_head(TorchServiceProvider(cfg, device=device).get_completions_service({}).engine)

            async def one(i):
                ws = await WebSocketClient.connect(run.url("chat", "chat", sessionId=f"t1b-{i}"))
                t = time.monotonic()
                await ws.send_json({"value": questions[i]})
                ack = await ws.receive_json(T_TIMEOUT)
                if ack.get("status") != "OK":
                    fail(f"{label}: session {i} refused: {ack}")
                first, chunks = None, []
                while True:
                    frame = await ws.receive_json(T_TIMEOUT)
                    value = frame["record"]["value"]
                    if isinstance(value, dict):  # the final answer record
                        await ws.close()
                        return first, chunks, value["answer"]
                    if first is None:
                        first = time.monotonic() - t
                    chunks.append(value)

            t = time.monotonic()
            out["chats"] = await asyncio.gather(*(one(i) for i in range(len(questions))))
            out["wave_s"] = time.monotonic() - t
            out["counts"] = read_counts()
        finally:
            await run.stop()
        return out

    reset_counts()
    out = asyncio.run(drive())
    for i, (first, chunks, answer) in enumerate(out["chats"]):
        if not answer or "".join(chunks) != answer:
            fail(f"{label}: session {i}: chunks {chunks!r} do not join to {answer!r}")
    counts = out["counts"]
    if device == "cuda" and min(counts["flash_attention"], counts["paged_attention"]) == 0:
        fail(f"{label}: flash and the bf16 paged read must launch: {counts}")
    line = {"sessions": len(questions), "start_s": round(out["start_s"], 3),
            "wave_s": round(out["wave_s"], 3),
            "gateway_ttft_s": _t_stats([c[0] for c in out["chats"]]),
            "chunks_per_answer": _t_stats([float(len(c[1])) for c in out["chats"]]),
            "launches": counts}
    return line, counts


def t2_cli_process(device="cuda") -> dict:
    """T2: ``python -m langstream_tpu_torch.cli run`` as its own process on
    the card, the chat example at the tiny model: one question through the
    gateway, then SIGINT; the process must exit 0."""
    import queue
    import shutil
    import signal
    import tempfile
    import threading

    from langstream_tpu_torch.gateway.wire import WebSocketClient

    label = "T2: python -m langstream_tpu_torch.cli run"
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-t2-"))
    app = tmp / "chat"
    app.mkdir()
    for name in ("pipeline.yaml", "gateways.yaml"):
        shutil.copy(T_APPS / "chat-completions" / name, app / name)
    # JSON is YAML's flow style: the port's loader reads it as it is
    (app / "configuration.yaml").write_text(json.dumps({"configuration": {"resources": [{
        "type": "tpu-serving-configuration", "name": "tpu", "configuration": T2_RESOURCE}]}}))
    port = _free_port()
    cmd = [sys.executable, "-m", "langstream_tpu_torch.cli", "run", "chat", "-app", str(app),
           "-i", str(T_INSTANCE), "--device", device, "--gateway-port", str(port),
           "--api-port", str(_free_port())]
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    err_path = tmp / "stderr.log"
    t0 = time.monotonic()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    try:
        try:
            first = lines.get(timeout=240)
        except queue.Empty:
            first = ""
        if "deployed" not in first:
            fail(f"{label}: no 'deployed' line ({first!r}); stderr: "
                 f"{err_path.read_text()[-3000:]}")
        ready_s = time.monotonic() - t0

        async def ask():
            base = f"ws://127.0.0.1:{port}/v1/%s/default/chat/%s?param:sessionId=t2"
            consumer = await WebSocketClient.connect(base % ("consume", "bot-output"))
            producer = await WebSocketClient.connect(base % ("produce", "user-input"))
            t = time.monotonic()
            await producer.send_json({"value": "what is it?"})
            ack = await producer.receive_json(T_TIMEOUT)
            chunks, ttft = [], None
            while True:
                frame = await consumer.receive_json(T_TIMEOUT)
                ttft = ttft if ttft is not None else time.monotonic() - t
                chunks.append(frame["record"]["value"])
                if frame["record"]["headers"]["stream-last-message"] == "true":
                    break
            await producer.close()
            await consumer.close()
            return ack, "".join(chunks), ttft

        ack, answer, ttft = asyncio.run(ask())
        if ack.get("status") != "OK" or not answer:
            fail(f"{label}: ack {ack}, answer {answer!r}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rest = []
    while not lines.empty():
        rest.append(lines.get())
    if rc != 0 or not any("stopped" in x for x in rest):
        fail(f"{label}: exit {rc}, output {rest}; stderr: {err_path.read_text()[-3000:]}")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"ready_s": round(ready_s, 3), "gateway_ttft_s": round(ttft, 4),
            "answer_chars": len(answer), "exit": rc, "wall_s": round(time.monotonic() - t0, 3)}


def phase_app_path(torch, device="cuda") -> dict:
    """Path T: the application path without JAX (:func:`t1_chat_app`,
    :func:`t1b_chat_route`, :func:`t2_cli_process`). Returns T1's and
    T1b's launches (T2's are its own process's)."""
    t0 = time.monotonic()
    with cut_depth("llama3-8b", MAIN_LAYERS):
        t1, t1_counts = t1_chat_app(torch, device)
        gc.collect()
        torch.cuda.empty_cache()
        t1["path_s"] = round(time.monotonic() - t0, 3)
        print(f"path T [T1 chat-completions, llama3-8b int8 {MAIN_LAYERS} layers, "
              f"{T_WAVE} sessions over user-input/bot-output]: {json.dumps(t1)}", flush=True)
        t_b = time.monotonic()
        t1b, t1b_counts = t1b_chat_route(torch, device)
        t1b["path_s"] = round(time.monotonic() - t_b, 3)
        print(f"path T [T1b chatbot-gateway, llama3-8b int8 {MAIN_LAYERS} layers, "
              f"{T1B_SESSIONS} sessions over /v1/chat]: {json.dumps(t1b)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = t2_cli_process(device)
    print(f"path T [T2 the cli run process, tiny f32]: {json.dumps(t2)}", flush=True)
    counts = {k: t1_counts[k] + t1b_counts[k] for k in t1_counts}
    NOTES["T1"] = t1
    NOTES["T1b"] = t1b
    print(f"path T: {time.monotonic() - t0:.1f} s; launches {json.dumps(counts)}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# path U: the control-plane path without JAX
# ---------------------------------------------------------------------------

U_SESSIONS = 4         # U1's and U2's sessions over authenticated-chat, one token each
U_APP = T_APPS / "chatbot-gateway"
#: U2's good update: the example's resource on paged int8 KV
U_PAGED = {"kv-layout": "paged", "kv-quantize": "int8"}
#: U2's bad update: a qos section the engine refuses at deploy
U_BAD_QOS = {"qos": {"classes": {"interactive": {"weight": -1}}}}


def _u_configuration(extra: dict) -> str:
    """The example's ``configuration.yaml`` with ``extra`` merged into its
    resource (JSON is YAML's flow style: the port reads it as it is)."""
    from langstream_tpu_torch.core.yaml_subset import safe_load

    config = U_APP / "configuration.yaml"
    doc = safe_load(config.read_text(), str(config))
    doc["configuration"]["resources"][0]["configuration"].update(extra)
    return json.dumps(doc)


def _u_engine(extra: dict, device: str):
    """The engine the app's ``ai-chat-completions`` agent serves on (one
    engine per resource): its LM head cut to printable ASCII, as T1b's."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.core.yaml_subset import safe_load

    (resource,) = safe_load(_u_configuration(extra))["configuration"]["resources"]
    cfg = {"type": resource["type"], "name": resource["name"], **resource["configuration"]}
    engine = TorchServiceProvider(cfg, device=device).get_completions_service({}).engine
    ascii_head(engine)
    return engine


async def _u_sessions(gateway_port: int, secret: str, label: str, subs: list[str]) -> list:
    """One chat socket per ``sub`` over ``authenticated-chat``, each with its
    own HS256 token, all at once: (gateway TTFT, chunks, answer, the
    ``langstream-client-user`` of every record, the ack's trace id)."""
    from langstream_tpu_torch.auth.jwt import encode_hs256
    from langstream_tpu_torch.gateway.wire import WebSocketClient

    questions = chat_prompts()
    base = f"ws://127.0.0.1:{gateway_port}/v1/chat/default/chatbot/authenticated-chat"

    async def one(i, sub):
        token = encode_hs256({"sub": sub, "exp": time.time() + 3600}, secret)
        ws = await WebSocketClient.connect(f"{base}?credentials={token}")
        t = time.monotonic()
        await ws.send_json({"value": questions[(i + 4) % len(questions)]})
        ack = await ws.receive_json(T_TIMEOUT)
        if ack.get("status") != "OK":
            fail(f"{label}: session {sub} refused: {ack}")
        first, chunks, users = None, [], set()
        while True:
            frame = await ws.receive_json(T_TIMEOUT)
            users.add(frame["record"]["headers"].get("langstream-client-user"))
            value = frame["record"]["value"]
            if isinstance(value, dict):  # the final answer record
                await ws.close()
                if not value["answer"] or "".join(chunks) != value["answer"]:
                    fail(f"{label}: session {sub}: chunks {chunks!r} do not join to "
                         f"{value['answer']!r}")
                if users != {sub}:
                    fail(f"{label}: session {sub}'s records carry users {users}")
                return first, chunks, value["answer"], ack["trace"].split("-")[1]
            if first is None:
                first = time.monotonic() - t
            chunks.append(value)

    return await asyncio.gather(*(one(i, sub) for i, sub in enumerate(subs)))


async def _u_topic_counts(runner) -> dict:
    counts = {}
    for topic in ("chat-in", "chat-out"):
        reader = runner.reader(topic, "earliest")
        await reader.start()
        counts[topic] = len(await reader.read(timeout=0))
        await reader.close()
    return counts


def u123_control_plane(torch, device="cuda") -> tuple[dict, dict]:
    """U1-U3: the JAX ``run``'s layout in this process (a ``ControlPlaneServer``,
    a ``GatewayServer``, one ``LocalComputeRuntime`` over a
    ``GatewayRegistry``), driven only through the port's ``AdminClient`` and
    gateway. U1: ``chatbot-gateway`` deployed as a multipart zip with the
    repository's instance and secrets; ``U_SESSIONS`` sessions over
    ``authenticated-chat`` with their own tokens; no, badly signed and
    expired credentials refused 401 with no record produced; the engine
    routes carry the app's engine, ``/journey`` stitches one session,
    ``/logs`` holds the deploy line. U2: a bad PATCH refused 400 while the
    app answers; a PATCH to paged int8 KV, then ``U_SESSIONS`` sessions on
    the int8 read. U3: DELETE, then 404 and an empty ``/flight``. Returns
    (the path's line, U1's and U2's launches)."""
    from langstream_tpu_torch.admin.client import AdminApiError, AdminClient, multipart_body
    from langstream_tpu_torch.agents import services
    from langstream_tpu_torch.auth.jwt import encode_hs256
    from langstream_tpu_torch.cli.main import close_engines
    from langstream_tpu_torch.controlplane.server import ControlPlaneServer, LocalComputeRuntime
    from langstream_tpu_torch.gateway import wire
    from langstream_tpu_torch.gateway.server import GatewayRegistry, GatewayServer
    from langstream_tpu_torch.runtime.memory_broker import MemoryBroker

    label = "U: chatbot-gateway through the port's control plane"
    app_zip = io_zip({name: (U_APP / name).read_text()
                      for name in ("pipeline.yaml", "gateways.yaml", "configuration.yaml")})
    mem = lambda: torch.cuda.memory_allocated() if device == "cuda" else 0  # noqa: E731

    async def drive():
        out = {"bytes": {"before_u1": mem()}}
        # the in-memory broker's topics wait on asyncio conditions bound to
        # the first loop that used them (in both packages): T1b's
        # ``chat-in``/``chat-out`` belong to its finished loop, so this
        # loop starts from a fresh broker, as a new ``run`` process would
        MemoryBroker.reset()
        previous = services.SERVING_DEVICE
        services.set_serving_device(device)
        registry = GatewayRegistry()
        control = ControlPlaneServer(compute=LocalComputeRuntime(gateway_registry=registry),
                                     port=0)
        gateway = GatewayServer(registry=registry, port=0)
        await control.start()
        await gateway.start()
        client = AdminClient(f"http://127.0.0.1:{control.port}")
        path = "/api/applications/default/chatbot"
        try:
            # -- U1 ------------------------------------------------------------
            await client.put_tenant("default")
            body, ctype = multipart_body([
                ("app", "chatbot-gateway.zip", app_zip, "application/zip"),
                ("instance", None, T_INSTANCE.read_bytes(), None),
                ("secrets", None, T_SECRETS.read_bytes(), None)])
            t = time.monotonic()
            deployed = await client.request("POST", path, data=body,
                                            headers={"Content-Type": ctype})
            out["deploy_s"] = time.monotonic() - t
            if deployed["status"]["status"] != "DEPLOYED" or deployed["files"] != [
                    "configuration.yaml", "gateways.yaml", "pipeline.yaml"]:
                fail(f"{label}: U1 deploy answered {deployed}")
            _u_engine({}, device)
            app = registry.application("default", "chatbot")
            (auth_gw,) = [g for g in app.gateways if g.id == "authenticated-chat"]
            secret = auth_gw.authentication["configuration"]["secret"]
            runner = control.compute.runners[("default", "chatbot")]
            reset_counts()
            t = time.monotonic()
            out["u1"] = await _u_sessions(gateway.port, secret, label,
                                          [f"u-{i}" for i in range(U_SESSIONS)])
            out["u1_wave_s"] = time.monotonic() - t
            before = await _u_topic_counts(runner)
            url = f"ws://127.0.0.1:{gateway.port}/v1/chat/default/chatbot/authenticated-chat"
            refusals = {}
            for name, token in (
                    ("none", None),
                    ("bad-signature", encode_hs256({"sub": "u-x"}, secret + "-not")),
                    ("expired", encode_hs256({"sub": "u-x", "exp": time.time() - 3600}, secret))):
                try:
                    ws = await wire.WebSocketClient.connect(
                        url + (f"?credentials={token}" if token else ""))
                    await ws.close()
                    fail(f"{label}: U1 {name} credentials were let in")
                except wire.HandshakeError as e:
                    refusals[name] = (e.status, e.body.decode())
            if await _u_topic_counts(runner) != before:
                fail(f"{label}: a refused socket produced records")
            out["refusals"] = refusals
            if {s for s, _ in refusals.values()} != {401}:
                fail(f"{label}: U1 refusals {refusals}")
            reports = {r: await client.request("GET", f"{path}/{r}")
                       for r in ("flight", "health", "qos", "slo", "attribution")}
            models = {
                "flight": [e["model"] for e in reports["flight"]],
                "health": [e["model"] for p in reports["health"]["pods"] for e in p["engines"]],
                "qos": [e["model"] for e in reports["qos"]["engines"]],
                "slo": [e["model"] for e in reports["slo"]["engines"]],
                "attribution": [e["model"] for e in reports["attribution"]]}
            if any(v != ["llama3-8b"] for v in models.values()):
                fail(f"{label}: the engine routes do not carry the app's engine: {models}")
            journey = await client.request("GET", f"{path}/journey/{out['u1'][0][3]}")
            kinds = [e["kind"] for e in journey["events"]]
            if not {"gateway-produce", "submit", "finish"} <= set(kinds) or not any(
                    e.get("model") == "llama3-8b" for e in journey["events"]):
                fail(f"{label}: the journey does not stitch the engine's events: {kinds}")
            out["journey_kinds"] = kinds
            logs = await client.application_logs("default", "chatbot")
            if "application chatbot deployed" not in logs:
                fail(f"{label}: /logs lacks the deploy line: {logs[-500:]}")
            # -- U2 ------------------------------------------------------------
            t = time.monotonic()
            try:
                await client.update_application("default", "chatbot", {
                    "files": {"configuration.yaml": _u_configuration(U_BAD_QOS)}})
                fail(f"{label}: U2 the bad PATCH was accepted")
            except AdminApiError as e:
                if e.status != 400 or "qos" not in e.body:
                    fail(f"{label}: U2 the bad PATCH answered {e.status}: {e.body}")
                out["bad_patch"] = (e.status, round(time.monotonic() - t, 4))
            out["after_bad_patch"] = await _u_sessions(gateway.port, secret, label, ["u-9"])
            out["u1_counts"] = read_counts()
            reset_counts()
            t = time.monotonic()
            updated = await client.update_application("default", "chatbot", {
                "files": {"configuration.yaml": _u_configuration(U_PAGED)}})
            out["redeploy_s"] = time.monotonic() - t
            if updated["status"]["status"] != "DEPLOYED":
                fail(f"{label}: U2 the PATCH answered {updated}")
            _u_engine(U_PAGED, device)
            out["bytes"]["after_u2_redeploy"] = mem()
            out["u2"] = await _u_sessions(gateway.port, secret, label,
                                          [f"u-{i}" for i in range(U_SESSIONS)])
            out["u2_counts"] = read_counts()
            # -- U3 ------------------------------------------------------------
            deleted = await client.delete_application("default", "chatbot")
            try:
                got = await client.get_application("default", "chatbot")
                fail(f"{label}: U3 GET after DELETE answered {got}")
            except AdminApiError as e:
                out["get_after_delete"] = e.status
            out["flight_after_delete"] = await client.request("GET", f"{path}/flight")
            if deleted != {"status": "OK"} or out["get_after_delete"] != 404 or (
                    out["flight_after_delete"] != []):
                fail(f"{label}: U3 {deleted}, GET {out['get_after_delete']}, flight "
                     f"{out['flight_after_delete']}")
            out["bytes"]["after_u3_delete"] = mem()
        finally:
            await gateway.stop()
            await control.stop()
            await close_engines()
            services.set_serving_device(previous)
        return out

    out = asyncio.run(drive())
    u1c, u2c = out["u1_counts"], out["u2_counts"]
    if device == "cuda" and (min(u1c["flash_attention"], u1c["paged_attention"]) == 0
                             or u2c["paged_attention_q8"] == 0 or u2c["paged_attention"] != 0):
        fail(f"{label}: U1 must launch #1 and #2, U2 #3 and not #2: U1 {u1c}, U2 {u2c}")
    t1b = NOTES.get("T1b", {}).get("gateway_ttft_s", {})
    line = {"sessions": U_SESSIONS, "deploy_s": round(out["deploy_s"], 3),
            "u1_wave_s": round(out["u1_wave_s"], 3),
            "gateway_ttft_s": _t_stats([s[0] for s in out["u1"]]),
            "t1b_gateway_ttft_s": t1b,
            "auth_cost_p50_s": round(_t_stats([s[0] for s in out["u1"]])["p50"] - t1b["p50"], 4)
            if t1b else None,
            "chunks_per_answer": _t_stats([float(len(s[1])) for s in out["u1"]]),
            "refusals": out["refusals"], "journey_kinds": sorted(set(out["journey_kinds"])),
            "bad_patch": out["bad_patch"], "redeploy_s": round(out["redeploy_s"], 3),
            "u2_gateway_ttft_s": _t_stats([s[0] for s in out["u2"]]),
            "get_after_delete": out["get_after_delete"],
            "allocated_bytes": out["bytes"], "launches_u1": u1c, "launches_u2": u2c}
    return line, {k: u1c[k] + u2c[k] for k in u1c}


def io_zip(files: dict) -> bytes:
    import io
    import zipfile

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, content in files.items():
            zf.writestr(name, content)
    return buf.getvalue()


#: runs the port's CLI in a process and reports whether ``torch`` was loaded
U4_CLI = """
import runpy
import sys

sys.argv = ["langstream_tpu_torch.cli"] + sys.argv[1:]
code = 0
try:
    runpy.run_module("langstream_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    code = e.code or 0
print("TORCH-LOADED", "torch" in sys.modules, file=sys.stderr)
sys.exit(code)
"""


def u4_cli_processes(device="cuda") -> dict:
    """U4: ``python -m langstream_tpu_torch.cli run ... --api-port P
    --gateway-port G`` on the card with ``chatbot-gateway`` at T2's tiny
    resource; then ``apps list``, ``apps get`` and ``gateway chat ...
    --credentials <token>`` each as its own process, in the JAX CLI's output
    format, each ending with no ``torch`` loaded; SIGINT to ``run``, exit 0."""
    import queue
    import shutil
    import signal
    import tempfile
    import threading

    from langstream_tpu_torch.auth.jwt import encode_hs256

    label = "U4: the CLI as processes"
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-u4-"))
    app = tmp / "chatbot"
    app.mkdir()
    for name in ("pipeline.yaml", "gateways.yaml"):
        shutil.copy(U_APP / name, app / name)
    (app / "configuration.yaml").write_text(json.dumps({"configuration": {"resources": [{
        "type": "tpu-serving-configuration", "name": "tpu", "configuration": T2_RESOURCE}]}}))
    instance = tmp / "instance.yaml"
    instance.write_text(json.dumps({"instance": {"streamingCluster": {"type": "memory"},
                                                 "globals": {"chat-model": "tiny"}}}))
    (tmp / "cli.py").write_text(U4_CLI)
    api, gw = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1", HOME=str(tmp))
    err_path = tmp / "run.log"
    t0 = time.monotonic()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "langstream_tpu_torch.cli", "run", "chatbot", "-app", str(app),
             "-i", str(instance), "-s", str(T_SECRETS), "--api-port", str(api),
             "--gateway-port", str(gw), "--device", device],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    out = {}

    def cli(args, stdin=None):
        t = time.monotonic()
        res = subprocess.run([sys.executable, str(tmp / "cli.py"), *args], cwd=str(tmp),
                             env=env, input=stdin, capture_output=True, text=True, timeout=120)
        if res.returncode != 0 or "TORCH-LOADED False" not in res.stderr:
            fail(f"{label}: {args[:2]} exit {res.returncode}: {res.stderr[-2000:]}")
        return res.stdout, round(time.monotonic() - t, 3)

    try:
        head = []
        for _ in range(3):
            try:
                head.append(lines.get(timeout=240))
            except queue.Empty:
                break
        if len(head) < 3 or "deployed" not in head[0] or f":{api}" not in head[1]:
            fail(f"{label}: run printed {head}; stderr: {err_path.read_text()[-3000:]}")
        out["ready_s"] = round(time.monotonic() - t0, 3)
        remote = ["--api-url", f"http://127.0.0.1:{api}"]
        listed, out["apps_list_s"] = cli(["apps", "list", *remote])
        if listed != json.dumps(["chatbot"], indent=2) + "\n":
            fail(f"{label}: apps list printed {listed!r}")
        got, out["apps_get_s"] = cli(["apps", "get", "chatbot", *remote])
        view = json.loads(got)
        if got != json.dumps(view, indent=2) + "\n" or view["status"]["status"] != "DEPLOYED" or (
                sorted(view) != ["application-id", "created-at", "files", "status", "tenant",
                                 "units"]):
            fail(f"{label}: apps get printed {got!r}")
        token = encode_hs256({"sub": "u4"}, "${GATEWAY_JWT_SECRET:-change-me}")
        t = time.monotonic()
        chat = subprocess.Popen(
            [sys.executable, str(tmp / "cli.py"), "gateway", "chat", "chatbot",
             "authenticated-chat", "--credentials", token, "--gateway-url",
             f"http://127.0.0.1:{gw}"], cwd=str(tmp), env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        chat_lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=lambda: [chat_lines.put(x) for x in chat.stdout],
                         daemon=True).start()
        chat.stdin.write("what is it?\n")
        chat.stdin.flush()
        printed = []
        try:
            while not (printed and printed[-1].startswith("{")):
                printed.append(chat_lines.get(timeout=T_TIMEOUT))
        except queue.Empty:
            fail(f"{label}: the chat process printed {printed}")
        chat.stdin.close()
        chat.stdin = None
        _, chat_err = chat.communicate(timeout=60)
        out["chat_s"] = round(time.monotonic() - t, 3)
        answer = json.loads(printed[-1])
        if chat.returncode != 0 or "TORCH-LOADED False" not in chat_err or (
                answer.get("question") != "what is it?" or not answer.get("answer")):
            fail(f"{label}: the chat process exit {chat.returncode}, printed {printed}, "
                 f"stderr {chat_err[-2000:]}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rest = []
    while not lines.empty():
        rest.append(lines.get())
    if rc != 0 or not any("stopped" in x for x in rest):
        fail(f"{label}: run exit {rc}, output {rest}; stderr: {err_path.read_text()[-3000:]}")
    shutil.rmtree(tmp, ignore_errors=True)
    out.update(exit=rc, answer_chars=len(answer["answer"]),
               wall_s=round(time.monotonic() - t0, 3))
    return out


def phase_control_plane_path(torch, device="cuda") -> dict:
    """Path U: the control-plane path without JAX (:func:`u123_control_plane`
    at ``MAIN_LAYERS``, :func:`u4_cli_processes`). Returns U1's and U2's
    launches (U4's are its own process's)."""
    t0 = time.monotonic()
    with cut_depth("llama3-8b", MAIN_LAYERS):
        line, counts = u123_control_plane(torch, device)
    line["path_s"] = round(time.monotonic() - t0, 3)
    print(f"path U [U1-U3 chatbot-gateway through the control plane, llama3-8b int8 "
          f"{MAIN_LAYERS} layers, {U_SESSIONS} authenticated sessions]: {json.dumps(line)}",
          flush=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    u4 = u4_cli_processes(device)
    print(f"path U [U4 the cli as processes, tiny f32]: {json.dumps(u4)}", flush=True)
    print(f"path U: {time.monotonic() - t0:.1f} s; checks: multipart deploy, "
          f"{U_SESSIONS} authenticated sessions with their own sub, 3 refusals without records, "
          f"engine routes, journey, logs, bad PATCH 400, int8 redeploy, DELETE 404, CLI "
          f"processes without torch; launches {json.dumps(counts)}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# path V: the cluster path without JAX
# ---------------------------------------------------------------------------

V_WAVE = 8             # V1's sessions, one question each, all at once
V_PROFILED = 2         # V2's profiled sessions (the chat pod's kernel count)
V_READY_S = 300.0      # what the chat pod's /ready gets to come up (17.6-25.3 s seen)
V_TIMEOUT = 300.0      # seconds any one frame or wait may take
V_APP = T_APPS / "mini-chat"
V_TENANT = "default"
V_NAME = "mini-chat"
#: what no process of the cluster may load (each process's import system
#: refuses them: the sitecustomize below)
V_REFUSED = T_REFUSED + ("cryptography",)
#: the chat agent's resource: path T1's (the chat example's), unchanged
V_RESOURCE = CHAT_EXAMPLE_RESOURCE
V_LAYERS = MAIN_LAYERS
#: a ``sitecustomize`` on the ``PYTHONPATH`` that ``mini up`` hands to every
#: pod (the kubelet passes its environment through): every process of the
#: cluster refuses the packages of ``V_REFUSED``, and in a pod that builds a
#: serving engine the model tables serve every model at ``{layers}`` layers
#: and each engine's LM head keeps only the printable ASCII columns, as
#: path T1's in-process ``cut_depth`` and ``ascii_head`` do
_V_SITE = """
import dataclasses, importlib.abc, importlib.util, sys

REFUSED = {refused!r}
LAYERS = {layers!r}


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"import of {{name}} refused")
        return None


class _Engine(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name != "langstream_tpu_torch.serving.engine":
            return None
        sys.meta_path.remove(self)
        spec = importlib.util.find_spec(name)
        run = spec.loader.exec_module

        def cut(make):
            return lambda **kw: dataclasses.replace(
                make(**kw), layers=min(make(**kw).layers, LAYERS))

        def exec_module(module):
            run(module)
            for table in (module._MODEL_CONFIGS, module._MOE_MODELS):
                for key, make in list(table.items()):
                    table[key] = cut(make)
            init = module.TorchServingEngine.__init__

            def ascii_init(self, *args, **kwargs):
                init(self, *args, **kwargs)
                import torch

                head = self.params["lm_head"]
                vocab = (head.q if hasattr(head, "q") else head).shape[-1]
                keep = torch.zeros(vocab, dtype=torch.bool, device=self.device)
                keep[32:127] = True
                if hasattr(head, "s"):
                    head.s[..., ~keep] = 0
                else:
                    head[:, ~keep] = 0

            module.TorchServingEngine.__init__ = ascii_init

        spec.loader.exec_module = exec_module
        return spec


sys.meta_path.insert(0, _Refuse())
sys.meta_path.insert(0, _Engine())
"""


def _v_app(root: Path) -> Path:
    """A copy of the mini-chat example whose resource is ``V_RESOURCE`` and
    whose chat agent asks for one card (``device-mesh: {tp: 1}``), written
    as JSON (YAML's flow style: the port reads it as it is)."""
    from langstream_tpu_torch.core.yaml_subset import safe_load

    app = root / "app"
    app.mkdir(parents=True)
    (app / "gateways.yaml").write_text((V_APP / "gateways.yaml").read_text())
    pipeline = safe_load((V_APP / "pipeline.yaml").read_text(), "pipeline.yaml")
    (chat,) = [a for a in pipeline["pipeline"] if a["type"] == "ai-chat-completions"]
    chat["resources"] = {"device-mesh": {"tp": 1}}
    (app / "pipeline.yaml").write_text(json.dumps(pipeline))
    (app / "configuration.yaml").write_text(json.dumps(
        {"configuration": {"resources": [V_RESOURCE]}}))
    return app


def _v_pids(under: int) -> dict[int, str]:
    """Every live process whose parent chain reaches ``under``: pid ->
    command line (read from ``/proc``)."""
    parents, cmds = {}, {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            cmd = (entry / "cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] == "Z":
            continue
        parents[int(entry.name)], cmds[int(entry.name)] = int(fields[1]), cmd.strip()
    out = {}
    for pid in parents:
        p, seen = pid, 0
        while p in parents and seen < 64:
            p, seen = parents[p], seen + 1
            if p == under:
                out[pid] = cmds[pid]
                break
    return out


def _v_alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return state[state.rindex(")") + 2] != "Z"


def _v_compute_apps() -> dict[int, int]:
    """pid -> MiB on the card, as ``nvidia-smi --query-compute-apps`` lists
    them (a process in another PID namespace is listed by its host pid)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout
    apps = {}
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = int(parts[1]) if parts[1].isdigit() else -1
    return apps


def _v_get(url: str, timeout: float = 30.0) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _v_trace_launches(trace: Path) -> dict:
    """The kernel wrappers' launches in a ``torch.profiler`` Chrome trace:
    one kernel a launch (flash: ``flash_fwd_*``; the bf16/f32 decode read:
    ``paged_decode_split_kernel``, its combine apart; the int8 read:
    ``paged_decode_split_q8*``; the multi-query read: ``paged_mq_kernel`` or
    ``paged_mq_wgmma_kernel``)."""
    counts = {"flash_attention": 0, "paged_attention": 0, "paged_attention_q8": 0,
              "paged_attention_multiquery": 0}
    for event in json.loads(trace.read_text()).get("traceEvents", []):
        if event.get("cat") != "kernel":
            continue
        name = event.get("name", "")
        if "flash_fwd_" in name:
            counts["flash_attention"] += 1
        elif "paged_decode_split_q8" in name:
            counts["paged_attention_q8"] += 1
        elif "paged_decode_split_kernel" in name:
            counts["paged_attention"] += 1
        elif "paged_mq_kernel" in name or "paged_mq_wgmma_kernel" in name:
            counts["paged_attention_multiquery"] += 1
    return counts


async def _v_wave(gateway: str, label: str, prefix: str, questions: list[str]) -> list:
    """One session a question over ``user-input`` / ``bot-output``, all at
    once: each session's (gateway TTFT s, the streamed chunks)."""
    from langstream_tpu_torch.gateway.wire import WebSocketClient

    base = f"{gateway}/v1/%s/{V_TENANT}/{V_NAME}/%s?param:sessionId=%s"
    sessions = [f"{prefix}-{i}" for i in range(len(questions))]
    consumers = [await WebSocketClient.connect(base % ("consume", "bot-output", s))
                 for s in sessions]
    producers = [await WebSocketClient.connect(base % ("produce", "user-input", s))
                 for s in sessions]

    async def one(i):
        t = time.monotonic()
        await producers[i].send_json({"value": questions[i]})
        ack = await producers[i].receive_json(V_TIMEOUT)
        if ack.get("status") != "OK":
            fail(f"{label}: session {i} produce refused: {ack}")
        first, chunks = None, []
        while True:
            frame = await consumers[i].receive_json(V_TIMEOUT)
            if first is None:
                first = time.monotonic() - t
            headers = frame["record"]["headers"]
            if headers.get("langstream-client-session-id") != sessions[i]:
                fail(f"{label}: session {i} got another session's frame: {headers}")
            chunks.append(frame["record"]["value"])
            if headers.get("stream-last-message") == "true":
                return first, chunks

    try:
        return await asyncio.gather(*(one(i) for i in range(len(questions))))
    finally:
        for ws in consumers + producers:
            await ws.close()


async def _v_gateway_ready(gateway: str, label: str) -> None:
    """Wait until the gateway's registry sync has the app: a consume socket
    on ``bot-output`` opens (the handshake answers 404 before)."""
    from langstream_tpu_torch.gateway.wire import HandshakeError, WebSocketClient

    deadline = time.monotonic() + V_TIMEOUT
    while True:
        try:
            ws = await WebSocketClient.connect(
                f"{gateway}/v1/consume/{V_TENANT}/{V_NAME}/bot-output?param:sessionId=v0")
        except HandshakeError as e:
            if time.monotonic() > deadline:
                fail(f"{label}: the gateway never served the app: {e}")
            await asyncio.sleep(0.25)
            continue
        await ws.close()
        return


async def _v_answers(broker: str, n: int) -> dict:
    """The answers-topic records, by session, read from the cluster's
    tsbroker with the port's client."""
    from langstream_tpu_torch.runtime.tsb import TsbTopicConnectionsRuntime

    runtime = TsbTopicConnectionsRuntime()
    runtime.init({"bootstrap": broker})
    reader = runtime.create_reader({"topic": "answers-topic"}, "earliest")
    await reader.start()
    out, deadline = {}, time.monotonic() + V_TIMEOUT
    try:
        while len(out) < n and time.monotonic() < deadline:
            for record in await reader.read(timeout=0.5):
                out[record.header("langstream-client-session-id")] = record
    finally:
        await reader.close()
    return out


def phase_mini_path(torch, device="cuda") -> dict:
    """Path V: the cluster path without JAX. ``python -m
    langstream_tpu_torch.cli mini up --device <device>`` as a process: the
    kube API server, the control plane in k8s mode, the operator, the
    process kubelet (whose pods run the port's pod entrypoint), the
    tpustream broker and the standalone gateway, no process loading a
    package of ``V_REFUSED``; the mini-chat app (``_v_app``) deployed into
    pods. V1: a wave of ``V_WAVE`` sessions through the gateway, every
    record crossing the broker twice between the pods; V2: the control
    plane reports the app DEPLOYED and reads the pods' health, the chat
    pod answers its probes and metrics, and a profiled wave through its
    ``/profile`` route counts the kernels it launched; V3: a DELETE through
    the REST API reaps every pod and gives the chat pod's card memory back,
    then SIGINT stops mini (exit 0, no process left). Returns the chat
    pod's launches in V2's profiled window."""
    import shutil
    import tempfile
    import threading

    from langstream_tpu_torch.k8s.client import HttpKubeApi

    label = "V: the cluster path (mini up)"
    t_v = time.monotonic()
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-mini-"))
    site = root / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        _V_SITE.format(refused=V_REFUSED, layers=V_LAYERS))
    app = _v_app(root)
    data = root / "data"
    env = {**os.environ, "PYTHONUNBUFFERED": "1",
           "PYTHONPATH": os.pathsep.join(p for p in (str(site), str(REPO),
                                                     os.environ.get("PYTHONPATH")) if p)}
    env.pop("LS_ACCELERATOR", None)
    log_path = root / "mini.log"
    log_f = open(log_path, "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "langstream_tpu_torch.cli", "mini", "up", "--device", device,
         "-app", str(app), "--name", V_NAME, "--tenant", V_TENANT, "--data-dir", str(data),
         "--api-port", "0", "--gateway-port", "0"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=log_f, text=True)
    lines: list[str] = []
    marks: dict[str, float] = {}
    urls: dict[str, str] = {}
    up = threading.Event()

    def read_out():
        for line in proc.stdout:
            lines.append(line)
            words = line.split()
            for key, word in (("kube", "kube"), ("broker", "tsbroker"),
                              ("control", "control"), ("gateway", "gateway")):
                if key not in urls and word in words[:3]:
                    urls[key] = words[-1] if key != "gateway" else words[-1].replace(
                        "ws://", "http://")
            if "deployed (tenant" in line:
                marks.setdefault("deployed", time.monotonic())
            if "agent pod(s) running" in line:
                marks.setdefault("running", time.monotonic())
                up.set()
        up.set()

    def tail() -> str:
        log_f.flush()
        return "".join(lines)[-3000:] + "\n--- stderr ---\n" + log_path.read_text(
            errors="replace")[-6000:]

    reader = threading.Thread(target=read_out, daemon=True)
    reader.start()
    jobs: dict[str, float] = {}
    stop_poll = threading.Event()

    def poll_kube():
        """When the setup and deployer Jobs succeed and the Agent CRs turn
        DEPLOYED, read from mini's API server."""
        while not stop_poll.is_set() and "kube" not in urls:
            time.sleep(0.05)
        api = HttpKubeApi(urls.get("kube", "http://127.0.0.1:1"))
        while not stop_poll.is_set() and proc.poll() is None:
            try:
                ns = f"langstream-{V_TENANT}"
                for job in api.list("Job", ns):
                    kind = "setup" if "setup" in job["metadata"]["name"] else "deployer"
                    if (job.get("status") or {}).get("succeeded"):
                        jobs.setdefault(kind, time.monotonic())
                agents = api.list("Agent", ns)
                if agents and all((a.get("status") or {}).get("status") == "DEPLOYED"
                                  for a in agents):
                    jobs.setdefault("agents", time.monotonic())
            except Exception:  # the namespace is not there yet
                pass
            time.sleep(0.1)

    poller = threading.Thread(target=poll_kube, daemon=True)
    poller.start()
    line: dict = {}
    try:
        if not up.wait(V_TIMEOUT) or "running" not in marks:
            fail(f"{label}: mini did not bring the agent pods up (rc {proc.poll()}):\n"
                 + tail())
        t_deployed = marks["deployed"]
        api = HttpKubeApi(urls["kube"])
        ns = f"langstream-{V_TENANT}"
        placed = {}
        for sts in api.list("StatefulSet", ns):
            runtime = sts["spec"]["template"]["spec"]["containers"][0]
            if runtime["command"][:6] != ["python", "-m", "serve_torch", "--device", device,
                                          "pod"]:
                fail(f"{label}: {sts['metadata']['name']} does not start the port's pod "
                     f"on {device}: {runtime['command']}")
            placed[sts["metadata"]["name"]] = runtime["resources"].get("limits")
        chat = [n for n, limits in placed.items() if limits == {"nvidia.com/gpu": "1"}]
        if len(chat) != 1 or len(placed) != 2:
            fail(f"{label}: want the chat agent's StatefulSet on one card and one "
                 f"without: {placed}")
        chat_pod = f"{chat[0]}-0"
        pod_dir = data / "kubelet" / "pods" / ns / chat_pod
        pod_url = f"http://127.0.0.1:{(pod_dir / 'http-port').read_text().strip()}"
        # the engine's build and warmup: the chat pod's /ready turns 200
        deadline = time.monotonic() + V_READY_S
        while True:
            try:
                status, body = _v_get(pod_url + "/ready", 10)
            except OSError:
                status, body = 0, b""
            if status == 200:
                break
            log_f.flush()
            # a pod that fails (no card, a kernel that does not build or
            # launch) exits and the kubelet restarts it: fail at once
            restarted = f"{chat_pod} exited rc=" in log_path.read_text(errors="replace")
            if time.monotonic() > deadline or proc.poll() is not None or restarted:
                fail(f"{label}: the chat pod is not ready: {status} {body[:500]!r}\n"
                     + (pod_dir / "pod.log").read_text(errors="replace")[-4000:])
            time.sleep(0.25)
        t_ready = time.monotonic()
        served_by = sorted(pid for pid, cmd in _v_pids(proc.pid).items()
                           if "agent-runtime" in cmd and chat_pod in cmd)
        free_ready = torch.cuda.mem_get_info()[0] if device == "cuda" else 0
        # the gateway serves the app once its registry sync read it
        asyncio.run(_v_gateway_ready(urls["gateway"].replace("http://", "ws://"), label))

        # V1: the wave
        questions = chat_prompts()[:V_WAVE]
        t = time.monotonic()
        streams = asyncio.run(_v_wave(urls["gateway"].replace("http://", "ws://"), label,
                                      "v1", questions))
        wave_s = time.monotonic() - t
        answers = asyncio.run(_v_answers(urls["broker"], len(questions)))
        ttft, n_chunks = [], []
        for i, (first, chunks) in enumerate(streams):
            streamed = "".join(chunks)
            record = answers.get(f"v1-{i}")
            if record is None:
                fail(f"{label}: no answers-topic record for session {i}")
            if not streamed or streamed != record.value["answer"]:
                fail(f"{label}: session {i}: streamed {streamed!r} != answers-topic "
                     f"{record.value['answer']!r}")
            if device == "cuda" and not all(32 <= ord(c) < 127 for c in streamed):
                # the head cut reached the pod (its sitecustomize ran there)
                fail(f"{label}: session {i}: {streamed!r} is not printable ASCII")
            ttft.append(first)
            n_chunks.append(float(len(chunks)))

        # V2: the control plane in k8s mode, the chat pod's routes
        app_url = f"{urls['control']}/api/applications/{V_TENANT}/{V_NAME}"
        status, body = _v_get(app_url)
        app_status = (json.loads(body).get("status") or {}).get("status")
        _, agents_body = _v_get(app_url + "/agents")
        agent_states = [(a.get("status") or {}).get("status")
                        for a in json.loads(agents_body)]
        if status != 200 or app_status != "DEPLOYED" or len(agent_states) != 2 or any(
                s != "DEPLOYED" for s in agent_states):
            fail(f"{label}: the control plane does not report the app DEPLOYED: "
                 f"{status} {body[:500]!r} {agents_body[:800]!r}")
        status, body = _v_get(app_url + "/health")
        health = json.loads(body)
        pods = {p.get("pod"): p for p in health.get("pods", [])}
        if status != 200 or chat_pod not in pods or pods[chat_pod].get("unreachable"):
            fail(f"{label}: the control plane read no health from {chat_pod}: "
                 f"{status} {body[:800]!r}")
        probes = {route: _v_get(pod_url + route)[0] for route in ("/healthz", "/ready")}
        status, metrics = _v_get(pod_url + "/metrics")
        if probes != {"/healthz": 200, "/ready": 200} or status != 200 or (
                b"langstream_serving_" not in metrics):
            fail(f"{label}: the chat pod's probes {probes}, /metrics {status} "
                 f"{metrics[:300]!r}")
        trace_dir = root / "profile"
        status, body = _v_get(f"{pod_url}/profile/start?dir={trace_dir}")
        if status != 200 or not any(json.loads(body).values()):
            fail(f"{label}: /profile/start did not start a capture: {status} {body!r}")
        t = time.monotonic()
        asyncio.run(_v_wave(urls["gateway"].replace("http://", "ws://"), label, "v2",
                            chat_prompts()[-V_PROFILED:]))
        profiled_s = time.monotonic() - t
        status, body = _v_get(f"{pod_url}/profile/stop", V_TIMEOUT)
        traces = sorted(trace_dir.glob("trace-*.json"))
        if status != 200 or not traces:
            fail(f"{label}: /profile/stop wrote no trace: {status} {body!r}")
        counts = _v_trace_launches(traces[-1])
        if device == "cuda" and (
                min(counts["flash_attention"], counts["paged_attention"]) == 0
                or counts["flash_attention"] % V_LAYERS or counts["paged_attention"] % V_LAYERS):
            # each prefill and decode step launches once a layer: the pod
            # serves at V_LAYERS layers
            fail(f"{label}: flash and the bf16 paged read must launch in the chat pod, "
                 f"a multiple of {V_LAYERS} times: {counts}")

        # V3: DELETE through the REST API
        before = _v_pids(proc.pid)
        pod_pids = {pid: cmd for pid, cmd in before.items() if "agent-runtime" in cmd}
        chat_pids = [pid for pid, cmd in pod_pids.items() if chat_pod in cmd]
        if len(pod_pids) != 2 or len(chat_pids) != 1:
            fail(f"{label}: want two agent pods, one of them {chat_pod}: {pod_pids}")
        if chat_pids != served_by:
            # the kubelet restarted the chat pod since it turned ready
            fail(f"{label}: the chat pod's process changed ({served_by} -> {chat_pids}):\n"
                 + tail() + "\n--- chat pod ---\n"
                 + (pod_dir / "pod.log").read_text(errors="replace")[-6000:])
        chat_pid = chat_pids[0]
        chat_children = len(_v_pids(chat_pid))
        apps_before = _v_compute_apps() if device == "cuda" else {}
        free_before = torch.cuda.mem_get_info()[0] if device == "cuda" else 0
        t = time.monotonic()
        from langstream_tpu_torch.gateway.wire import http_request

        status, _, _, body = asyncio.run(http_request(
            "DELETE", f"{urls['control']}/api/applications/{V_TENANT}/{V_NAME}", body=None))
        if status != 200:
            fail(f"{label}: DELETE answered {status} {body[:300]!r}")
        deadline = time.monotonic() + V_TIMEOUT
        while any(_v_alive(pid) for pid in pod_pids):
            if time.monotonic() > deadline:
                fail(f"{label}: pods not reaped after the DELETE: "
                     f"{[p for p in pod_pids if _v_alive(p)]}")
            time.sleep(0.1)
        delete_s = time.monotonic() - t
        left = api.list("StatefulSet", ns) + api.list("Agent", ns)
        if left:
            fail(f"{label}: the DELETE left {[o['metadata']['name'] for o in left]}")
        # the GPU's kernel module gives a reaped process's memory back on its own time:
        # wait for it, and say how long it took
        t = time.monotonic()
        free_after = free_before
        while device == "cuda":
            free_after = torch.cuda.mem_get_info()[0]
            if free_after - free_before >= 1 << 30 or time.monotonic() - t > 60:
                break
            time.sleep(0.2)
        memory_back_s = time.monotonic() - t
        apps_after = _v_compute_apps() if device == "cuda" else {}
        if device == "cuda":
            if chat_pid in apps_before and chat_pid in apps_after:
                fail(f"{label}: pid {chat_pid} still holds the card: {apps_after}")
            if free_after - free_before < 1 << 30:
                fail(f"{label}: the card's free memory did not come back within 60 s of the "
                     f"pods' reaping: {free_before} -> {free_after} bytes; compute apps "
                     f"{apps_before} -> {apps_after}; the chat pod had {chat_children} "
                     f"child processes\n" + tail() + "\n--- chat pod ---\n"
                     + (pod_dir / "pod.log").read_text(errors="replace")[-6000:])
        status, _ = _v_get(f"{urls['control']}/api/applications/{V_TENANT}/{V_NAME}")
        if status != 404:
            fail(f"{label}: the deleted app answers {status}")

        # then SIGINT mini: exit 0, nothing left behind
        children = _v_pids(proc.pid)
        t = time.monotonic()
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail(f"{label}: mini did not stop on SIGINT:\n" + tail())
        stop_s = time.monotonic() - t
        reader.join(10)
        if rc != 0 or "stopped" not in "".join(lines):
            fail(f"{label}: mini exited {rc}:\n" + tail())
        alive = [pid for pid in children if _v_alive(pid)]
        if alive:
            fail(f"{label}: processes left behind: {[children[p] for p in alive]}")
        refused = [ln for ln in log_path.read_text(errors="replace").splitlines()
                   if "refused" in ln and "import of" in ln]
        for pod_log in (data / "kubelet" / "pods").rglob("pod.log"):
            refused += [ln for ln in pod_log.read_text(errors="replace").splitlines()
                        if "import of" in ln and "refused" in ln]
        if refused:
            fail(f"{label}: a process of the cluster tried to import a refused package: "
                 f"{refused[:5]}")
        t1 = NOTES.get("T1") or {}
        line = {
            "sessions": len(questions), "wave_s": round(wave_s, 3),
            "gateway_ttft_s": _t_stats(ttft),
            "t1_gateway_ttft_s": t1.get("gateway_ttft_s"),
            "cluster_minus_t1_ttft_p50_s": (
                round(_t_stats(ttft)["p50"] - t1["gateway_ttft_s"]["p50"], 4)
                if t1.get("gateway_ttft_s") else None),
            "chunks_per_answer": _t_stats(n_chunks),
            "mini_to_deployed_s": round(t_deployed - t_v, 3),
            "setup_job_s": round(jobs["setup"] - t_deployed, 3) if "setup" in jobs else None,
            "deployer_job_s": (round(jobs["deployer"] - t_deployed, 3)
                               if "deployer" in jobs else None),
            "agents_deployed_s": (round(jobs["agents"] - t_deployed, 3)
                                  if "agents" in jobs else None),
            "chat_pod_ready_s": round(t_ready - t_deployed, 3),
            "app_status": app_status, "agent_statuses": agent_states,
            "health": health.get("status"), "probes": probes,
            "profiled_sessions": V_PROFILED, "profiled_wave_s": round(profiled_s, 3),
            "chat_pod_launches": counts, "delete_until_reaped_s": round(delete_s, 3),
            "card_free_gb_at_ready": round(free_ready / 1e9, 3),
            "card_free_gb_before_after_delete": [round(free_before / 1e9, 3),
                                                 round(free_after / 1e9, 3)],
            "card_memory_back_after_reap_s": round(memory_back_s, 3),
            "chat_pod_children": chat_children,
            "chat_pod_in_compute_apps": [chat_pid in apps_before, chat_pid in apps_after],
            "compute_apps_mib_before_after_delete": [sorted(apps_before.values()),
                                                     sorted(apps_after.values())],
            "mini_stop_s": round(stop_s, 3), "mini_rc": rc,
            "processes_reaped": len(children),
            "modules_refused_and_absent": list(V_REFUSED),
        }
    finally:
        stop_poll.set()
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                for pid in _v_pids(proc.pid):
                    with contextlib.suppress(OSError):
                        os.kill(pid, signal.SIGKILL)
                proc.kill()
                proc.wait()
        log_f.close()
        shutil.rmtree(root, ignore_errors=True)
    line["path_s"] = round(time.monotonic() - t_v, 3)
    print(f"path V [mini-chat through mini up: llama3-8b int8 {V_LAYERS} layers in its pod, "
          f"{V_WAVE} sessions through tpustream]: {json.dumps(line)}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# path W: the chat app served over Kafka without JAX
# ---------------------------------------------------------------------------

W_WAVE = 8             # W1's sessions, one question each, all at once
#: W3's questions to the second run (none of W1's)
W3_PROMPTS = ("What does a consumer group commit?", "Name the color of a clear sky.")
W_TIMEOUT = 300.0      # seconds any one frame or wait may take
W_APP = T_APPS / "mini-chat"
W_INSTANCE = REPO / "examples" / "instances" / "kafka.yaml"
W_FAKE = REPO / "tests" / "torch_fake_kafka.py"
#: the broker's one SCRAM-SHA-256 user
W_USER = ("langstream-w", "w-scram-secret")
#: what this process may not load while path W serves (T's, and the
#: client libraries the Kafka selector would take with ``client: auto``)
W_REFUSED = T_REFUSED + ("cryptography", "confluent_kafka", "pulsar", "pravega_client")
#: the chat agent's resource: path T1's (the chat example's), unchanged
W_RESOURCE = CHAT_EXAMPLE_RESOURCE
W_LAYERS = MAIN_LAYERS
SESSION = "langstream-client-session-id"


def _w_fake():
    """``tests/torch_fake_kafka.py`` as a module, loaded by its path (the
    card's machine has no JAX, so ``tests/fake_kafka.py`` cannot serve)."""
    import importlib.util

    if not W_FAKE.exists():
        fail(f"W: the port's fake Kafka broker {W_FAKE} is not in the checkout")
    if "torch_fake_kafka" in sys.modules:
        return sys.modules["torch_fake_kafka"]
    spec = importlib.util.spec_from_file_location("torch_fake_kafka", W_FAKE)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def _w_files(root: Path, port: int) -> tuple[Path, Path]:
    """(a copy of mini-chat with ``W_RESOURCE``, an instance file copying
    ``examples/instances/kafka.yaml`` with the broker's address, SASL
    SCRAM-SHA-256 and ``client: wire``), written as JSON (YAML's flow
    style: the port reads it as it is)."""
    from langstream_tpu_torch.core.yaml_subset import safe_load

    app = root / "app"
    app.mkdir(parents=True)
    for name in ("gateways.yaml", "pipeline.yaml"):
        (app / name).write_text((W_APP / name).read_text())
    (app / "configuration.yaml").write_text(json.dumps(
        {"configuration": {"resources": [W_RESOURCE]}}))
    instance = safe_load(W_INSTANCE.read_text(), str(W_INSTANCE))
    configuration = instance["instance"]["streamingCluster"]["configuration"]
    user, password = W_USER
    configuration["admin"].update({
        "bootstrap.servers": f"127.0.0.1:{port}",
        "security.protocol": "SASL_PLAINTEXT",
        "sasl.mechanism": "SCRAM-SHA-256",
        "sasl.jaas.config": ("org.apache.kafka.common.security.scram.ScramLoginModule "
                             f'required username="{user}" password="{password}";'),
    })
    configuration["client"] = "wire"
    path = root / "instance.yaml"
    path.write_text(json.dumps(instance))
    return app, path


def _w_log(broker, topic: str) -> list[dict]:
    """A topic's records as the broker stored them, decoded here: value
    (JSON when its kind header says so), headers as text, offset."""
    out = []
    for partition, part in sorted(broker.topics.get(topic, {}).items()):
        for rec in part.records:
            headers = {k: (v.decode("utf-8") if v is not None else None)
                       for k, v in rec.headers}
            value = rec.value.decode("utf-8") if rec.value is not None else None
            if headers.get("__ls_vkind") == "json":
                value = json.loads(value)
            out.append({"partition": partition, "offset": rec.offset, "value": value,
                        "headers": headers})
    return out


def _w_printable(text: str) -> bool:
    return all(32 <= ord(c) < 127 for c in text)


async def _w_ask(run, sessions: list[str], questions: list[str]) -> list[tuple]:
    """One question per session at once through the gateway's produce and
    consume sockets: [(gateway TTFT s, [chunks])]."""
    from langstream_tpu_torch.gateway.wire import WebSocketClient

    consumers = [await WebSocketClient.connect(run.url("consume", "bot-output", sessionId=s))
                 for s in sessions]
    producers = [await WebSocketClient.connect(run.url("produce", "user-input", sessionId=s))
                 for s in sessions]

    async def one(i):
        t = time.monotonic()
        await producers[i].send_json({"value": questions[i]})
        ack = await producers[i].receive_json(W_TIMEOUT)
        if ack.get("status") != "OK":
            fail(f"W: session {sessions[i]} produce refused: {ack}")
        first, chunks = None, []
        while True:
            frame = await consumers[i].receive_json(W_TIMEOUT)
            if first is None:
                first = time.monotonic() - t
            headers = frame["record"]["headers"]
            if headers.get(SESSION) != sessions[i]:
                fail(f"W: session {sessions[i]} got another session's frame: {headers}")
            chunks.append(frame["record"]["value"])
            if headers.get("stream-last-message") == "true":
                return first, chunks

    try:
        return await asyncio.gather(*(one(i) for i in range(len(sessions))))
    finally:
        for ws in consumers + producers:
            await ws.close()


def _w_check_answers(label, broker, sessions, streams) -> list[float]:
    """Each session's streamed chunks against the broker's own log: equal
    to its stream-topic records in stream-index order, joined equal to its
    one answers-topic record, printable ASCII. Returns the engine TTFTs (s)
    the answers carry."""
    answers = {}
    for rec in _w_log(broker, "answers-topic"):
        session = rec["headers"].get(SESSION)
        if session in answers:
            fail(f"{label}: session {session} answered twice on answers-topic")
        answers[session] = rec
    stream_log = {}
    for rec in _w_log(broker, "stream-topic"):
        stream_log.setdefault(rec["headers"].get(SESSION), []).append(
            (int(rec["headers"]["stream-index"]), rec["value"]))
    engine_ttft = []
    for session, (_, chunks) in zip(sessions, streams):
        logged = [v for _, v in sorted(stream_log.get(session, []))]
        if chunks != logged:
            fail(f"{label}: session {session}: streamed {chunks!r} != stream-topic "
                 f"records {logged!r}")
        record = answers.get(session)
        if record is None:
            fail(f"{label}: no answers-topic record for session {session}")
        answer = record["value"]["answer"]
        if not answer or "".join(chunks) != answer or not _w_printable(answer):
            fail(f"{label}: session {session}: chunks {chunks!r} do not join to the "
                 f"printable answers-topic answer {answer!r}")
        engine_ttft.append(float(record["headers"]["langstream-ttft-ms"]) / 1e3)
    return engine_ttft


def _w_state(label, broker, plan, wire) -> dict:
    """W2: the broker's own state after a wave (see :func:`phase_kafka_path`)."""
    declared = {t.name: max(1, int(t.partitions or 1)) for t in plan.logical_topics()}
    for name, partitions in declared.items():
        if len(broker.topics.get(name, {})) != partitions:
            fail(f"{label}: topic {name} has partitions {sorted(broker.topics.get(name, {}))}, "
                 f"declared {partitions}")
    inputs = {node.input.topic for node in plan.agents.values() if node.input is not None}
    committed = {}
    for (group, topic, partition), offset in broker.offsets.items():
        committed.setdefault((group, topic), {})[partition] = offset
    for topic in inputs:
        ends = {p: part.log_end for p, part in broker.topics[topic].items()}
        groups = {g: offs for (g, t), offs in committed.items() if t == topic}
        if not groups or any(offs != ends for offs in groups.values()):
            fail(f"{label}: input topic {topic} ends at {ends}; the groups committed {groups}")
    dead = {t: sum(len(p.records) for p in parts.values())
            for t, parts in broker.topics.items() if t.endswith("-deadletter")}
    if any(dead.values()):
        fail(f"{label}: records on dead-letter topics: {dead}")
    sasl = {wire.API_SASL_HANDSHAKE, wire.API_SASL_AUTHENTICATE}
    for seen in broker.connections:
        keys = [k for k, _ in seen]
        n_sasl = next((i for i, k in enumerate(keys) if k not in sasl), len(keys))
        if keys and (n_sasl < 2 or sasl & set(keys[n_sasl:])):
            fail(f"{label}: a connection's requests do not open with SASL: {keys[:8]}")
    if broker.auth_failures:
        fail(f"{label}: {broker.auth_failures} failed authentications")
    undeclared = set(broker.requests) - set(wire.API_VERSIONS_SPOKEN.items())
    if undeclared:
        fail(f"{label}: the broker saw (api, version) the client does not declare: "
             f"{sorted(undeclared)}")
    return {"topics": {t: len(broker.topics[t]) for t in declared},
            "groups": {f"{g}@{t}": offs for (g, t), offs in sorted(committed.items())},
            "deadletter_records": sum(dead.values()),
            "connections": len(broker.connections), "requests": len(broker.requests),
            "apis_seen": sorted(set(broker.requests)), "auth_failures": broker.auth_failures}


def _w_all_closed(label, broker, wait_s: float = 5.0) -> None:
    """A stopped run leaves no connection to the broker open: the runners,
    the gateway's sessions and the setup all closed their clients."""
    t = time.monotonic()
    while broker.open_connections and time.monotonic() - t < wait_s:
        time.sleep(0.05)
    if broker.open_connections:
        fail(f"{label}: connections left open after the run stopped, their first "
             f"requests: {[seen[:4] for seen in broker.open_connections]}")


def phase_kafka_path(torch, device="cuda") -> dict:
    """Path W: the mini-chat app over Kafka through the port's own runner,
    gateway and wire client (``client: wire``, SASL SCRAM-SHA-256) against
    the port's fake broker, on the card: W1 a wave of ``W_WAVE`` sessions
    through the gateway, W2 the broker's state, W3 a second run over the
    same broker resuming from the committed offsets. Returns W1's and W3's
    launches."""
    import shutil
    import tempfile

    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.cli.main import LocalRun
    from langstream_tpu_torch.runtime import kafka_wire as wire

    label = "W: mini-chat over Kafka"
    t_w = time.monotonic()
    fake = _w_fake()
    broker = fake.FakeKafkaBroker(sasl={"SCRAM-SHA-256": W_USER}).start()
    if not broker.port:
        fail(f"{label}: the fake broker did not start")
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-w-"))
    app, instance = _w_files(root, broker.port)
    questions = chat_prompts()[:W_WAVE]
    sessions = [f"w1-{i}" for i in range(W_WAVE)]
    w3_questions = list(W3_PROMPTS)
    w3_sessions = [f"w3-{i}" for i in range(len(w3_questions))]
    cfg = {"type": W_RESOURCE["type"], "name": W_RESOURCE["name"],
           **W_RESOURCE["configuration"]}

    async def serve(sessions, questions):
        out = {}
        t0 = time.monotonic()
        run = LocalRun("mini-chat", app, instance, device=device, gateway_port=0)
        await run.start()
        out["start_s"] = time.monotonic() - t0
        try:
            engine = TorchServiceProvider(cfg, device=device).get_completions_service({}).engine
            if engine._warmup_task is None:
                fail(f"{label}: the provider's engine is not the one the app's start warmed")
            out["warmup"] = engine.stats()["warmup"]
            ascii_head(engine)  # after the warmup: the answers need text
            out["plan"] = run.runner.plan
            t = time.monotonic()
            out["streams"] = await _w_ask(run, sessions, questions)
            out["wave_s"] = time.monotonic() - t
            # the answers-topic record lands after the last stream chunk
            t = time.monotonic()
            while sum(r["headers"].get(SESSION) in sessions
                      for r in _w_log(broker, "answers-topic")) < len(sessions):
                if time.monotonic() - t > W_TIMEOUT:
                    fail(f"{label}: the answers-topic records did not land")
                await asyncio.sleep(0.05)
            # ... and the groups commit after their writes are acknowledged
            t = time.monotonic()
            while True:
                ends = {p: part.log_end
                        for p, part in broker.topics["questions-topic"].items()}
                done = [offs for (g, tp, p), offs in broker.offsets.items()
                        if tp == "questions-topic" and offs == ends.get(p)]
                if len(done) >= len(ends):
                    break
                if time.monotonic() - t > 30:
                    break  # W2 reports what the groups committed
                await asyncio.sleep(0.05)
            out["counts"] = read_counts()
            out["leaks"] = _t_leaks(W_REFUSED)
        finally:
            t = time.monotonic()
            await run.stop()
            out["stop_s"] = time.monotonic() - t
        return out

    try:
        with cut_depth(W_RESOURCE["configuration"]["model"], W_LAYERS):
            reset_counts()
            w1 = asyncio.run(serve(sessions, questions))
            if w1["leaks"]:
                fail(f"{label}: the run loaded {w1['leaks']}")
            if w1["warmup"]["state"] != "done":
                fail(f"{label}: warmup-on-start did not warm the engine inside the start: "
                     f"{w1['warmup']}")
            engine_ttft = _w_check_answers("W1", broker, sessions, w1["streams"])
            w2 = _w_state("W2", broker, w1["plan"], wire)
            _w_all_closed("W2", broker)
            before = {rec["offset"] for rec in _w_log(broker, "questions-topic")}
            committed_w1 = dict(broker.offsets)
            gc.collect()
            torch.cuda.empty_cache()
            reset_counts()
            w3 = asyncio.run(serve(w3_sessions, w3_questions))
        _w_check_answers("W3", broker, w3_sessions, w3["streams"])
        answered = [r["headers"].get(SESSION) for r in _w_log(broker, "answers-topic")]
        if sorted(answered) != sorted(sessions + w3_sessions):
            fail(f"W3: the answers topic holds sessions {sorted(answered)}: a W1 question "
                 "was consumed again or a W3 question was not answered once")
        w3_state = _w_state("W3", broker, w3["plan"], wire)
        _w_all_closed("W3", broker)
        resumed = {k: v for k, v in committed_w1.items() if k[1] == "questions-topic"}
        if not resumed or len(before) != W_WAVE:
            fail(f"W3: W1 committed {resumed} over {len(before)} questions")
    finally:
        broker.stop()
        shutil.rmtree(root, ignore_errors=True)
    t1 = NOTES.get("T1") or {}
    counts = {k: w1["counts"][k] + w3["counts"][k] for k in w1["counts"]}
    if device == "cuda" and min(counts["flash_attention"], counts["paged_attention"]) == 0:
        fail(f"{label}: flash and the bf16 paged read must launch: {counts}")
    gateway_ttft = [first for first, _ in w1["streams"]]
    line = {
        "sessions": W_WAVE, "start_s": round(w1["start_s"], 3),
        "warmup_s": round(w1["warmup"]["seconds"], 3), "wave_s": round(w1["wave_s"], 3),
        "gateway_ttft_s": _t_stats(gateway_ttft),
        "t1_gateway_ttft_s": t1.get("gateway_ttft_s"),
        "engine_ttft_s": _t_stats(engine_ttft),
        "gateway_minus_engine_ttft_s": _t_stats(
            [g - e for g, e in zip(gateway_ttft, engine_ttft)]),
        "chunks_per_answer": _t_stats([float(len(c)) for _, c in w1["streams"]]),
        "stop_s": round(w1["stop_s"], 3), "launches": w1["counts"],
        "modules_refused_and_absent": list(W_REFUSED)}
    w3_line = {"questions": len(w3_questions), "second_start_s": round(w3["start_s"], 3),
               "wave_s": round(w3["wave_s"], 3),
               "gateway_ttft_s": _t_stats([first for first, _ in w3["streams"]]),
               "answers_topic_sessions": len(answered), "redelivered": 0,
               "groups": w3_state["groups"], "launches": w3["counts"]}
    print(f"path W [W1 mini-chat over Kafka (wire client, SASL SCRAM-SHA-256), llama3-8b "
          f"int8 {W_LAYERS} layers, {W_WAVE} sessions over user-input/bot-output]: "
          f"{json.dumps(line)}", flush=True)
    print(f"path W [W2 the broker's state, every connection closed at the stop]: "
          f"{json.dumps(w2)}", flush=True)
    print(f"path W [W3 a second run over the same broker]: {json.dumps(w3_line)}",
          flush=True)
    print(f"path W: {time.monotonic() - t_w:.1f} s; launches {json.dumps(counts)}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# path X: the retrieval path without JAX
# ---------------------------------------------------------------------------

X_DOCS = 512           # X1's ingested documents
X_DOC_CHARS = 2000     # characters per document, about
X_CHUNK = 300          # text-splitter chunk-size: rag-pipeline's 5 chunks and its
                       # template stay under the 2,048-token context
X_WAVE = 8             # X1's questions through the gateway, all at once
X_SESSIONS = 4         # X2's sessions, two turns each
X_TIMEOUT = 300.0      # seconds any one frame or wait may take
X_TIE = 1e-6           # a related id may swap with another within this similarity
X_LAYERS = MAIN_LAYERS
#: what this process may not load while path X serves
X_REFUSED = T_REFUSED + ("cryptography", "psycopg")
#: the ingestion app: documents split, embedded by the rag-pipeline
#: resource's encoder (minilm-l6) and written into its ``vector-db``
X_INGEST_PIPELINE = """
topics:
  - name: "documents-topic"
    creation-mode: create-if-not-exists
pipeline:
  - name: "split"
    type: "text-splitter"
    input: "documents-topic"
    configuration:
      chunk-size: %(chunk)d
      chunk-overlap: %(overlap)d
  - name: "to-json"
    type: "document-to-json"
    configuration:
      text-field: "text"
  - name: "embed"
    type: "compute-ai-embeddings"
    configuration:
      model: "minilm-l6"
      embeddings-field: "value.embeddings"
      text: "{{ value.text }}"
      batch-size: 64
      flush-interval: 20
  - name: "write"
    type: "vector-db-sink"
    configuration:
      datasource: "vector-db"
      collection-name: "docs"
      fields:
        - name: "id"
          expression: "fn:concat(key, '-', properties.chunk_id)"
        - name: "vector"
          expression: "value.embeddings"
        - name: "text"
          expression: "value.text"
"""
X_SYLLABLES = ("ka ro mi tu se la vo ne pi da fe gu ho ji lu ma no pa qui re si ta "
               "ve wo xa yo ze").split()


def x_corpus(seed: int = 0):
    """``X_DOCS`` documents of about ``X_DOC_CHARS`` printable characters
    from a seed: sentences of words drawn from a 600-word vocabulary of
    syllables, and ``X_WAVE`` questions, each six words of one document."""
    import numpy as np

    n, chars = X_DOCS, X_DOC_CHARS
    rng = np.random.default_rng(seed)
    vocab = sorted({"".join(rng.choice(X_SYLLABLES, int(rng.integers(2, 4))))
                    for _ in range(900)})[:600]
    docs = []
    for i in range(n):
        words, size = [], 0
        while size < chars:
            sentence = " ".join(rng.choice(vocab, int(rng.integers(6, 14))))
            words.append(sentence.capitalize() + ".")
            size += len(sentence) + 2
        docs.append((f"doc{i:04d}", " ".join(words)))
    picks = rng.choice(n, X_WAVE, replace=n < X_WAVE)
    questions = [f"What about {' '.join(docs[int(d)][1].split()[3:9]).rstrip('.')}?"
                 for d in picks]
    return docs, questions


def _x_files(root: Path) -> dict[str, Path]:
    """The apps in ``root``: the ingestion app and copies of rag-pipeline
    (and chat-completions' gateways over its topics) and
    chatbot-rag-memory (its SQLite file in ``root``), each with
    ``examples/instances/memory.yaml`` on a broker cluster of its own (a
    memory topic serves only the first event loop that used it, and path T
    used these topic names)."""
    import shutil

    instance = root / "instance.yaml"
    instance.write_text(T_INSTANCE.read_text().replace(
        'type: "memory"', 'type: "memory"\n    configuration: {cluster: "chip-smoke-x"}', 1))
    ingest, rag, memory = root / "ingest", root / "rag-pipeline", root / "chatbot-rag-memory"
    for d in (ingest, rag, memory):
        d.mkdir()
    (ingest / "pipeline.yaml").write_text(
        X_INGEST_PIPELINE % {"chunk": X_CHUNK, "overlap": X_CHUNK // 10})
    shutil.copy(T_APPS / "rag-pipeline" / "configuration.yaml", ingest / "configuration.yaml")
    for name in ("pipeline.yaml", "configuration.yaml"):
        shutil.copy(T_APPS / "rag-pipeline" / name, rag / name)
    shutil.copy(T_APPS / "chat-completions" / "gateways.yaml", rag / "gateways.yaml")
    db = root / "chat-history.db"
    for name in ("pipeline.yaml", "configuration.yaml", "gateways.yaml"):
        text = (T_APPS / "chatbot-rag-memory" / name).read_text()
        (memory / name).write_text(text.replace("/tmp/chat-history.db", str(db)))
    return {"instance": instance, "ingest": ingest, "rag": rag, "memory": memory, "db": db}


def _x_engine(app: Path, device: str):
    """The app's llama3-8b engine (one per resource), its LM head cut to
    printable ASCII."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.core.yaml_subset import safe_load

    config = app / "configuration.yaml"
    resource = next(r for r in safe_load(config.read_text(), str(config))["configuration"][
        "resources"] if r["type"] == "tpu-serving-configuration")
    cfg = {"type": resource["type"], "name": resource["name"], **resource["configuration"]}
    engine = TorchServiceProvider(cfg, device=device).get_completions_service({}).engine
    ascii_head(engine)
    return engine


def _x_check_related(label: str, value: dict, ids: list, vectors) -> None:
    """``related`` against a plain numpy top-20 over the store's rows: at
    each rank the similarity numpy ranks there, and each id's own numpy
    similarity, within ``X_TIE`` (so ties may swap); ``context`` 5 of them."""
    import numpy as np

    q = np.asarray(value["question_embeddings"], np.float32)
    sims = vectors @ (q / (float(np.linalg.norm(q)) or 1.0))
    top = np.sort(sims)[::-1][:20]
    own = dict(zip(ids, sims.tolist()))
    related = [(r["id"], r["similarity"]) for r in value["related"]]
    if len(related) != len(top) or len({i for i, _ in related}) != len(related):
        fail(f"{label}: related holds {len(related)} ids, numpy's top-20 {len(top)}")
    for rank, (item, similarity) in enumerate(related):
        if abs(similarity - float(top[rank])) > X_TIE or abs(own[item] - similarity) > X_TIE:
            fail(f"{label}: related[{rank}] {item} at {similarity} (its row: {own[item]}), "
                 f"numpy's rank {rank} at {float(top[rank])}")
    context = [c["id"] for c in value["context"]]
    if len(context) != 5 or not set(context) <= {i for i, _ in related}:
        fail(f"{label}: context {context} is not 5 of the related ids")


def x1_rag(torch, files: dict, device="cuda") -> tuple[dict, dict]:
    """X1: the ingestion app, then ``rag-pipeline`` through the port's
    gateway. Returns (the path's line, the launches of both runs)."""
    from langstream_tpu_torch.agents import text as port_text
    from langstream_tpu_torch.agents.vector import InMemoryVectorStore
    from langstream_tpu_torch.cli.main import LocalRun
    from langstream_tpu_torch.gateway.wire import WebSocketClient

    import numpy as np

    label = "X1: ingestion, then rag-pipeline through the port's run and gateway"
    docs, questions = x_corpus()
    sessions = [f"x1-{i}" for i in range(len(questions))]
    splitter = port_text.RecursiveCharacterTextSplitter(chunk_size=X_CHUNK,
                                                        chunk_overlap=X_CHUNK // 10)
    n_chunks = sum(len(splitter.split_text(text)) for _, text in docs)

    async def drive():
        out = {}
        run = LocalRun("ingest", files["ingest"], files["instance"], device=device,
                       gateway_port=0)
        await run.start()
        try:
            coll = InMemoryVectorStore.get("vector-db").collection("docs")
            t = time.monotonic()
            for key, text in docs:
                await run.runner.produce("documents-topic", text, key=key)
            while len(coll.ids) < n_chunks:
                if time.monotonic() - t > X_TIMEOUT:
                    fail(f"{label}: {len(coll.ids)} of {n_chunks} chunks stored")
                await asyncio.sleep(0.02)
            out["ingest_s"] = time.monotonic() - t
        finally:
            await run.stop()
        t0 = time.monotonic()
        run = LocalRun("rag-pipeline", files["rag"], files["instance"], device=device,
                       gateway_port=0)
        await run.start()
        out["start_s"] = time.monotonic() - t0
        try:
            engine = _x_engine(files["rag"], device)
            completed = engine.stats()["completed"]
            consumers = [await WebSocketClient.connect(run.url("consume", "bot-output",
                                                               sessionId=s))
                         for s in sessions]
            producers = [await WebSocketClient.connect(run.url("produce", "user-input",
                                                               sessionId=s))
                         for s in sessions]

            async def one(i):
                t = time.monotonic()
                await producers[i].send_json({"value": questions[i]})
                ack = await producers[i].receive_json(X_TIMEOUT)
                if ack.get("status") != "OK":
                    fail(f"{label}: session {i} produce refused: {ack}")
                first, chunks = None, []
                while True:
                    frame = await consumers[i].receive_json(X_TIMEOUT)
                    if first is None:
                        first = time.monotonic() - t
                    headers = frame["record"]["headers"]
                    if headers.get(SESSION) != sessions[i]:
                        fail(f"{label}: session {i} got another session's frame: {headers}")
                    chunks.append(frame["record"]["value"])
                    if headers.get("stream-last-message") == "true":
                        return first, chunks

            t = time.monotonic()
            out["streams"] = await asyncio.gather(*(one(i) for i in range(len(questions))))
            out["wave_s"] = time.monotonic() - t
            answers = await run.runner.wait_for_messages("answers-topic", len(questions),
                                                         timeout=X_TIMEOUT)
            out["answers"] = {a.header(SESSION): a for a in answers}
            for ws in consumers + producers:
                await ws.close()
            out["counts"] = read_counts()
            out["leaks"] = _t_leaks(X_REFUSED)
            if engine.stats()["completed"] - completed != len(questions):
                fail(f"{label}: the agent's requests did not run on the resource's engine")
            out["stats"] = engine.stats()
        finally:
            await run.stop()
        return out

    out = asyncio.run(drive())
    if out["leaks"]:
        fail(f"{label}: the port's run loaded {out['leaks']}")
    coll = InMemoryVectorStore.get("vector-db").collection("docs")
    ids, vectors = list(coll.ids), np.stack(coll.vectors)
    if len(ids) != n_chunks or not np.isfinite(vectors).all():
        fail(f"{label}: the store holds {len(ids)} rows of {n_chunks}, or a vector not finite")
    gateway_ttft, engine_ttft, n_chunks_answer, prompt_chars = [], [], [], []
    for i, (first, chunks) in enumerate(out["streams"]):
        record = out["answers"].get(sessions[i])
        if record is None:
            fail(f"{label}: no answers-topic record for session {i}")
        value = record.value
        streamed = "".join(chunks)
        if not streamed or streamed != value["answer"]:
            fail(f"{label}: session {i}: streamed {streamed!r} != answers-topic "
                 f"{value['answer']!r}")
        _x_check_related(f"{label}: session {i}", value, ids, vectors)
        gateway_ttft.append(first)
        engine_ttft.append(float(record.header("langstream-ttft-ms")) / 1e3)
        n_chunks_answer.append(len(chunks))
        prompt_chars.append(sum(len(c["text"]) for c in value["context"]))
    counts, stats = out["counts"], out["stats"]
    sp = stats["speculative"]
    if device == "cuda" and min(counts["flash_attention"], counts["paged_attention"]) == 0:
        fail(f"{label}: flash and the bf16 paged read must launch: {counts}")
    if device == "cuda" and sp["steps"] and counts["paged_attention_multiquery"] == 0:
        fail(f"{label}: {sp['steps']} verify steps ran without the multi-query kernel")
    t1 = NOTES.get("T1") or {}
    line = {"documents": len(docs), "chunks": len(ids), "ingest_s": round(out["ingest_s"], 3),
            "chunks_per_s": round(len(ids) / out["ingest_s"], 1),
            "sessions": len(questions), "start_s": round(out["start_s"], 3),
            "wave_s": round(out["wave_s"], 3), "gateway_ttft_s": _t_stats(gateway_ttft),
            "t1_gateway_ttft_s": t1.get("gateway_ttft_s"),
            "engine_ttft_s": _t_stats(engine_ttft),
            "gateway_minus_engine_ttft_s": _t_stats(
                [g - e for g, e in zip(gateway_ttft, engine_ttft)]),
            "chunks_per_answer": _t_stats([float(n) for n in n_chunks_answer]),
            "context_chars": _t_stats([float(n) for n in prompt_chars]),
            "speculative": {k: sp.get(k) for k in ("steps", "drafts_accepted", "rejected",
                                                   "uplift", "flips")},
            "related_equal_numpy_top20": True, "launches": counts,
            "modules_refused_and_absent": list(X_REFUSED)}
    return line, counts


def x2_memory(torch, files: dict, device="cuda") -> tuple[dict, dict]:
    """X2: ``chatbot-rag-memory`` over its ``chat`` gateway, ``X_SESSIONS``
    sessions of two turns on one socket each (the sessions at once)."""
    import sqlite3

    from langstream_tpu_torch.cli.main import LocalRun
    from langstream_tpu_torch.gateway.wire import WebSocketClient

    label = "X2: chatbot-rag-memory through the port's chat gateway"
    _, questions = x_corpus()
    sessions = [f"x2-{i}" for i in range(X_SESSIONS)]
    turns = [(questions[i % len(questions)], f"And what else of {questions[i][11:-1]}?")
             for i in range(X_SESSIONS)]
    if files["db"].exists():
        fail(f"{label}: {files['db']} exists before the app is deployed")

    async def drive():
        out = {}
        t0 = time.monotonic()
        run = LocalRun("chatbot-rag-memory", files["memory"], files["instance"], device=device,
                       gateway_port=0)
        await run.start()
        out["start_s"] = time.monotonic() - t0
        try:
            out["tables"] = sqlite3.connect(files["db"]).execute(
                "SELECT name FROM sqlite_master WHERE type='table'").fetchall()
            engine = _x_engine(files["memory"], device)
            completed = engine.stats()["completed"]

            async def one(i):
                ws = await WebSocketClient.connect(run.url("chat", "chat", sessionId=sessions[i]))
                got = []
                for question in turns[i]:
                    t = time.monotonic()
                    await ws.send_json({"value": question})
                    ack = await ws.receive_json(X_TIMEOUT)
                    if ack.get("status") != "OK":
                        fail(f"{label}: session {i} refused: {ack}")
                    first, chunks = None, []
                    while True:
                        frame = await ws.receive_json(X_TIMEOUT)
                        value = frame["record"]["value"]
                        if isinstance(value, dict):  # save-turn's record
                            got.append((first, chunks, value))
                            break
                        if first is None:
                            first = time.monotonic() - t
                        chunks.append(value)
                await ws.close()
                return got

            t = time.monotonic()
            out["chats"] = await asyncio.gather(*(one(i) for i in range(X_SESSIONS)))
            out["wave_s"] = time.monotonic() - t
            out["counts"] = read_counts()
            out["leaks"] = _t_leaks(X_REFUSED)
            if engine.stats()["completed"] - completed != 2 * X_SESSIONS:
                fail(f"{label}: the agent's requests did not run on the resource's engine")
        finally:
            await run.stop()
        return out

    out = asyncio.run(drive())
    if out["leaks"]:
        fail(f"{label}: the port's run loaded {out['leaks']}")
    if out["tables"] != [("history",)]:
        fail(f"{label}: the jdbc-table asset made {out['tables']}, not the history table")
    rows = sqlite3.connect(files["db"]).execute(
        "SELECT session_id, question, answer FROM history").fetchall()
    streamed = set()
    for i, chat in enumerate(out["chats"]):
        for (first, chunks, value), question in zip(chat, turns[i]):
            joined = "".join(chunks)
            if not joined or joined != value["answer"] or value["question"] != question:
                fail(f"{label}: session {i}: chunks {chunks!r} do not join to "
                     f"{value['answer']!r} for {question!r}")
            if value["inserted"] != {"count": 1}:
                fail(f"{label}: session {i}: the turn was not saved: {value['inserted']}")
            streamed.add((sessions[i], question, joined))
        first_turn = {"question": turns[i][0], "answer": chat[0][2]["answer"]}
        if first_turn not in chat[1][2]["history"]:
            fail(f"{label}: session {i}'s second turn read history {chat[1][2]['history']}, "
                 f"without its first turn")
    if len(rows) != 2 * X_SESSIONS or set(rows) != streamed:
        fail(f"{label}: the history table holds {len(rows)} rows unlike the streamed answers")
    counts = out["counts"]
    if device == "cuda" and min(counts["flash_attention"], counts["paged_attention"]) == 0:
        fail(f"{label}: flash and the bf16 paged read must launch: {counts}")
    line = {"sessions": X_SESSIONS, "turns": 2 * X_SESSIONS, "start_s": round(out["start_s"], 3),
            "wave_s": round(out["wave_s"], 3),
            "gateway_ttft_s": _t_stats([t[0] for chat in out["chats"] for t in chat]),
            "history_rows": len(rows), "launches": counts}
    return line, counts


def phase_retrieval_path(torch, device="cuda") -> dict:
    """Path X: the retrieval path without JAX (:func:`x1_rag`,
    :func:`x2_memory`) at ``X_LAYERS``. Returns both runs' launches."""
    import shutil
    import tempfile

    from langstream_tpu_torch.agents.jdbc import JdbcDataSource
    from langstream_tpu_torch.agents.vector import InMemoryVectorStore

    t0 = time.monotonic()
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-x-"))
    try:
        files = _x_files(root)
        with cut_depth("llama3-8b", X_LAYERS):
            reset_counts()
            x1, x1_counts = x1_rag(torch, files, device)
            print(f"path X [X1 ingestion and rag-pipeline, llama3-8b int8 {X_LAYERS} layers, "
                  f"minilm-l6, {X_WAVE} questions over user-input/bot-output]: "
                  f"{json.dumps(x1)}", flush=True)
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
            reset_counts()
            x2, x2_counts = x2_memory(torch, files, device)
            print(f"path X [X2 chatbot-rag-memory, llama3-8b int8 {X_LAYERS} layers, "
                  f"{X_SESSIONS} sessions of 2 turns over /v1/chat]: {json.dumps(x2)}",
                  flush=True)
    finally:
        InMemoryVectorStore.reset()
        JdbcDataSource.reset_shared()
        shutil.rmtree(root, ignore_errors=True)
    counts = {k: x1_counts[k] + x2_counts[k] for k in x1_counts}
    print(f"path X: {time.monotonic() - t0:.1f} s; launches {json.dumps(counts)}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# path Y: the document and HTTP agents without JAX
# ---------------------------------------------------------------------------

Y_LAYERS = MAIN_LAYERS
Y_TIMEOUT = 600.0      # seconds any one wait may take
Y_GAP = 0.05           # a summary may first differ from the engine's own greedy
                       # output only where the top-2 logprob gap is under this
#: Y1's documents: their kinds and the characters of their text
Y_KINDS = ("pdf", "docx", "html", "text", "pdf-flate", "docx", "html", "text")
Y_DOC_CHARS = (1000, 1900, 2700, 3600, 4400, 5300, 6400, 7500)
Y2_PAGES = 16
#: what this process may not load while path Y serves
Y_REFUSED = T_REFUSED + ("cryptography", "psycopg")


def _y_pdf(content: bytes, compress: bool) -> bytes:
    """A one-page PDF around one content stream, raw or FlateDecode."""
    import zlib

    body = zlib.compress(content) if compress else content
    head = b"/Filter /FlateDecode " if compress else b""
    return (b"%PDF-1.4\n1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n"
            b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj\n"
            b"3 0 obj << /Type /Page /Parent 2 0 R /Contents 4 0 R >> endobj\n"
            b"4 0 obj << " + head + b"/Length %d >>\nstream\n" % len(body) + body
            + b"\nendstream\nendobj\ntrailer << /Root 1 0 R >>\n%%EOF\n")


def _y_docx(lines: list[str]) -> bytes:
    import io
    import zipfile

    ns = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
    body = "".join(f"<w:p><w:r><w:t>{line}</w:t></w:r></w:p>" for line in lines)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", "<Types/>")
        zf.writestr("word/document.xml",
                    f'<w:document xmlns:w="{ns}"><w:body>{body}</w:body></w:document>')
    return buf.getvalue()


def _y_html(title: str, lines: list[str]) -> bytes:
    return (f"<html><head><title>{title}</title><style>p {{ margin: 0 }}</style></head>"
            f"<body>{''.join(f'<p>{line}</p>' for line in lines)}"
            "<script>var seen = 1;</script></body></html>").encode()


def _y_lines(rng, vocab, chars: int) -> list[str]:
    lines, size = [], 0
    while size < chars:
        line = " ".join(rng.choice(vocab, int(rng.integers(8, 14)))).capitalize() + "."
        lines.append(line)
        size += len(line) + 1
    return lines


def y_documents(seed: int = 0) -> list[dict]:
    """Y1's documents from a seed, each written here with no library: two
    PDFs (one stream raw, one compressed), two docx, two HTML pages and two
    plain texts; each one's text is its lines joined by newlines, from
    1,000 to 7,500 characters."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = sorted({"".join(rng.choice(X_SYLLABLES, int(rng.integers(2, 4))))
                    for _ in range(900)})[:600]
    docs = []
    for i, (kind, chars) in enumerate(zip(Y_KINDS, Y_DOC_CHARS)):
        lines = _y_lines(rng, vocab, chars)
        if kind.startswith("pdf"):
            content = b"".join(b"BT /F1 11 Tf 72 %d Td (%s) Tj ET\n" % (760 - 12 * j, line.encode())
                               for j, line in enumerate(lines))
            data = _y_pdf(content, kind == "pdf-flate")
        elif kind == "docx":
            data = _y_docx(lines)
        elif kind == "html":
            data = _y_html(f"Document {i}", lines)
        else:
            data = "\n".join(lines).encode()
        docs.append({"key": f"doc{i}-{kind}", "kind": kind, "data": data,
                     "text": "\n".join(lines)})
    return docs


def y_extract_on_cpu(doc: dict) -> str:
    """The document's text as ``pdftext`` or the HTML parser gives it for
    its bytes (the plain text decoded)."""
    from langstream_tpu_torch.agents import pdftext
    from langstream_tpu_torch.agents.text import _HTMLTextExtractor

    data = doc["data"]
    if data[:4] == b"%PDF":
        return pdftext.extract_pdf_text(data)
    kind = pdftext.sniff_ooxml_kind(data)
    if kind is not None:
        return pdftext.extract_ooxml_text(data, kind)
    text = data.decode("utf-8")
    if "<html" in text.lower():
        parser = _HTMLTextExtractor()
        parser.feed(text)
        return "\n".join(parser.parts)
    return text


def _y_summarizer(root: Path) -> tuple[Path, Path]:
    """A copy of ``long-context-summarizer`` whose one change is that its
    resource has no ``mesh`` (one card serves it), and
    ``examples/instances/memory.yaml`` on a broker cluster of its own."""
    source = T_APPS / "long-context-summarizer"
    app = root / "long-context-summarizer"
    app.mkdir()
    (app / "pipeline.yaml").write_text((source / "pipeline.yaml").read_text())
    config = (source / "configuration.yaml").read_text()
    cut = re.sub(r"\n        mesh:\n          sp: 4\n          tp: 2\n", "\n", config)
    if cut == config:
        fail("Y1: the summarizer example's mesh is not where the copy removes it")
    (app / "configuration.yaml").write_text(cut)
    instance = root / "instance.yaml"
    instance.write_text(T_INSTANCE.read_text().replace(
        'type: "memory"', 'type: "memory"\n    configuration: {cluster: "chip-smoke-y"}', 1))
    return app, instance


def _y_gap(torch, engine, prompt: str, tokens: list[int]) -> float:
    """The top-2 logprob gap of the next token after ``prompt`` and
    ``tokens``, from one prefill on the engine's own params."""
    from langstream_tpu_torch.models.llama import prefill_forward

    ids = engine.tokenizer.encode(prompt) + list(tokens)
    with torch.no_grad():
        logits = prefill_forward(
            engine.model_config, engine.params, torch.tensor([ids], device=engine.device),
            torch.tensor([len(ids)], device=engine.device), ffn=engine._ffn)[0]
    top = torch.log_softmax(logits[0].float(), dim=-1).topk(2).values
    return float(top[0] - top[1])


def y1_summarizer(torch, device="cuda") -> tuple[dict, dict]:
    """Y1: ``long-context-summarizer`` through ``cli.main.LocalRun``: the
    documents produced as bytes to ``documents-in``, the summaries read
    from ``summaries-out`` and held to the engine's own greedy output.
    Returns (the path's line, its launches)."""
    import shutil
    import tempfile

    from langstream_tpu_torch.api.record import MutableRecord
    from langstream_tpu_torch.cli.main import LocalRun
    from langstream_tpu_torch.core.expressions import render_template
    from langstream_tpu_torch.core.yaml_subset import safe_load

    label = "Y1: long-context-summarizer through the port's run"
    docs = y_documents()
    for doc in docs:
        if y_extract_on_cpu(doc) != doc["text"]:
            fail(f"{label}: {doc['key']}: the CPU extraction is not the text written")
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-y1-"))
    try:
        app, instance = _y_summarizer(root)
        pipeline = safe_load((app / "pipeline.yaml").read_text(), "pipeline.yaml")
        step = next(a for a in pipeline["pipeline"] if a["type"] == "ai-text-completions")
        template, max_tokens = step["configuration"]["prompt"][0], step["configuration"][
            "max-tokens"]
        prompts = {doc["key"]: render_template(template, MutableRecord(value=doc["text"]))
                   for doc in docs}

        async def drive():
            out = {}
            t0 = time.monotonic()
            run = LocalRun("long-context-summarizer", app, instance, device=device,
                           gateway_port=0)
            await run.start()
            out["start_s"] = time.monotonic() - t0
            try:
                engine = _x_engine(app, device)
                calls = []
                generate = engine.generate

                async def recorded(prompt, options=None, **kw):
                    t = time.monotonic()
                    result = await generate(prompt, options, **kw)
                    calls.append({"prompt": prompt, "options": dict(options or {}),
                                  "result": result, "s": time.monotonic() - t})
                    return result

                engine.generate = recorded
                completed = engine.stats()["completed"]
                reset_counts()
                t = time.monotonic()
                for doc in docs:
                    await run.runner.produce("documents-in", doc["data"], key=doc["key"])
                records = await run.runner.wait_for_messages("summaries-out", len(docs),
                                                             timeout=Y_TIMEOUT)
                out["wave_s"] = time.monotonic() - t
                out["counts"] = read_counts()
                out["stats"] = engine.stats()
                out["leaks"] = _t_leaks(Y_REFUSED)
                if engine.stats()["completed"] - completed != len(docs):
                    fail(f"{label}: the agent's requests did not run on the resource's engine")
                engine.generate = generate
                out["eos"] = engine.tokenizer.eos_id
                out["records"] = {r.key: r.value for r in records}
                out["calls"] = calls
                # the engine's own greedy output for each rendered prompt, one wave
                out["reference"] = await asyncio.gather(*(
                    generate(c["prompt"], c["options"]) for c in calls))
                out["gaps"] = {}
                for call, ref in zip(calls, out["reference"]):
                    got, want = call["result"]["tokens"], ref["tokens"]
                    if got != want:
                        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                                 min(len(got), len(want)))
                        out["gaps"][call["prompt"]] = (i, _y_gap(torch, engine, call["prompt"],
                                                                 want[:i]))
            finally:
                await run.stop()
            return out

        out = asyncio.run(drive())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if out["leaks"]:
        fail(f"{label}: the port's run loaded {out['leaks']}")
    by_prompt = {c["prompt"]: c for c in out["calls"]}
    eos = out["eos"]
    rows = []
    for doc in docs:
        call = by_prompt.get(prompts[doc["key"]])
        if call is None:
            fail(f"{label}: {doc['key']}: no request's prompt holds the CPU extraction of "
                 f"its bytes")
        record = out["records"].get(doc["key"])
        tokens = call["result"]["tokens"]
        if record is None or record.get("summary") != call["result"]["text"]:
            fail(f"{label}: {doc['key']}: summaries-out holds {record!r}, not the completion")
        if not (len(tokens) == max_tokens or (tokens and tokens[-1] == eos)):
            fail(f"{label}: {doc['key']}: {len(tokens)} tokens, neither {max_tokens} nor "
                 f"ended at EOS")
        first_diff, gap = out["gaps"].get(call["prompt"], (None, None))
        if first_diff is not None and not gap < Y_GAP:
            fail(f"{label}: {doc['key']}: the summary first differs from the engine's greedy "
                 f"output at token {first_diff}, where the top-2 gap is {gap:.4f} >= {Y_GAP}")
        rows.append({"key": doc["key"], "chars": len(doc["text"]),
                     "prompt_tokens": call["result"]["num_prompt_tokens"],
                     "ttft_s": round(call["result"]["ttft"], 4), "seconds": round(call["s"], 3),
                     "tokens": len(tokens), "greedy_equal": first_diff is None,
                     "first_diff": first_diff, "gap": None if gap is None else round(gap, 4)})
    counts, sp = out["counts"], out["stats"]["speculative"]
    if device == "cuda" and min(counts["flash_attention"], counts["paged_attention"]) == 0:
        fail(f"{label}: flash and the bf16 paged read must launch: {counts}")
    if device == "cuda" and sp["steps"] and counts["paged_attention_multiquery"] == 0:
        fail(f"{label}: {sp['steps']} verify steps ran without the multi-query kernel")
    line = {"documents": rows, "start_s": round(out["start_s"], 3),
            "wave_s": round(out["wave_s"], 3),
            "speculative": {k: sp.get(k) for k in ("steps", "drafts_accepted", "rejected",
                                                   "uplift", "flips", "auto_disabled")},
            "launches": counts, "modules_refused_and_absent": list(Y_REFUSED)}
    return line, counts


def y2_site(seed: int = 0) -> dict:
    """Y2's site of ``Y2_PAGES`` seeded HTML pages: a tree from ``/`` whose
    deepest pages lie beyond ``max-depth`` 5, a ``/private/`` subtree that
    ``robots.txt`` disallows, and three pages only the sitemap (named by
    ``robots.txt``) leads to. Returns {path: (links, lines)} and the
    sitemap's paths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = sorted({"".join(rng.choice(X_SYLLABLES, int(rng.integers(2, 4))))
                    for _ in range(900)})[:600]
    links = {
        "/": ["/docs/a1.html", "/docs/a2.html", "/docs/a3.html", "/private/x.html"],
        "/docs/a1.html": ["/docs/b1.html", "/"], "/docs/a2.html": ["/docs/b2.html",
                                                                    "/private/y.html"],
        "/docs/a3.html": ["/"], "/docs/b1.html": ["/docs/c1.html"],
        "/docs/b2.html": ["/docs/a1.html"], "/docs/c1.html": ["/docs/d1.html"],
        "/docs/d1.html": ["/docs/e1.html"], "/docs/e1.html": ["/docs/f1.html"],
        "/docs/f1.html": ["/docs/g1.html"], "/docs/g1.html": [],
        "/private/x.html": ["/private/y.html"], "/private/y.html": [],
        "/orphan/a.html": ["/orphan/c.html"], "/orphan/b.html": [], "/orphan/c.html": []}
    if len(links) != Y2_PAGES:
        fail(f"Y2: the site has {len(links)} pages, not {Y2_PAGES}")
    pages = {path: (out, _y_lines(rng, vocab, int(rng.integers(600, 1600))))
             for path, out in links.items()}
    return {"pages": pages, "sitemap": ["/orphan/a.html", "/orphan/b.html"],
            "disallow": "/private/"}


def y2_page(path: str, page: tuple) -> str:
    """A page of :func:`y2_site` as the site serves it."""
    links, lines = page
    return (f"<html><head><title>{path}</title></head><body>"
            + "".join(f"<p>{line}</p>" for line in lines)
            + "".join(f'<a href="{link}">next</a>' for link in links) + "</body></html>")


def y2_walk(site: dict, max_depth: int) -> set[str]:
    """A plain breadth-first walk: from ``/`` and the sitemap's pages (depth
    0), links followed from pages above ``max_depth``, robots rules kept."""
    depth = {p: 0 for p in ["/"] + site["sitemap"]}
    queue = list(depth)
    while queue:
        path = queue.pop(0)
        if depth[path] >= max_depth:
            continue
        for link in site["pages"][path][0]:
            if link not in depth:
                depth[link] = depth[path] + 1
                queue.append(link)
    return {p for p in depth if not p.startswith(site["disallow"])}


def _y2_serve(site: dict):
    """The site on a stdlib ``http.server`` at 127.0.0.1 in a thread: (the
    server, its base URL, the paths it was asked for)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    hits: list[str] = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            hits.append(self.path)
            base = f"http://127.0.0.1:{self.server.server_address[1]}"
            page = site["pages"].get(self.path)
            if self.path == "/robots.txt":
                body, ctype = (f"User-agent: *\nDisallow: {site['disallow']}\n"
                               f"Sitemap: {base}/sitemap.xml\n").encode(), "text/plain"
            elif self.path == "/sitemap.xml":
                body = ('<?xml version="1.0"?><urlset xmlns="http://www.sitemaps.org/schemas/'
                        'sitemap/0.9">' + "".join(f"<url><loc>{base}{p}</loc></url>"
                                                  for p in site["sitemap"]) + "</urlset>")
                body, ctype = body.encode(), "application/xml"
            elif page is not None:
                body, ctype = y2_page(self.path, page).encode(), "text/html; charset=utf-8"
            else:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, name="y2-site", daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}", hits


def y2_crawl(torch, device="cuda") -> tuple[dict, dict]:
    """Y2: a copy of ``webcrawler-to-vector`` over :func:`y2_site`, its
    ``seed-urls`` and ``allowed-domains`` pointing at the site and the
    minilm-l6 encoder of a serving resource computing its embeddings (the
    example declares none, so it would embed with the mock), the default
    500 ms between requests kept. Returns (the path's line, its
    launches)."""
    import shutil
    import tempfile

    import numpy as np

    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.agents.text import RecursiveCharacterTextSplitter, TextExtractorAgent
    from langstream_tpu_torch.agents.vector import InMemoryVectorStore
    from langstream_tpu_torch.cli.main import LocalRun
    from langstream_tpu_torch.core.yaml_subset import safe_load

    label = "Y2: webcrawler-to-vector through the port's run"
    site = y2_site()
    source = T_APPS / "webcrawler-to-vector"
    pipeline = safe_load((source / "pipeline.yaml").read_text(), "pipeline.yaml")
    crawl = next(a for a in pipeline["pipeline"] if a["type"] == "webcrawler")["configuration"]
    split = next(a for a in pipeline["pipeline"] if a["type"] == "text-splitter")[
        "configuration"]
    server, base, hits = _y2_serve(site)
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-y2-"))
    try:
        app = root / "webcrawler-to-vector"
        app.mkdir()
        port = server.server_address[1]
        text = (source / "pipeline.yaml").read_text()
        # two repairs beside the site's address, each a fault of the example in
        # both packages: a chunk reaches ``compute-ai-embeddings`` as a string,
        # whose ``value.text`` is empty, so ``document-to-json`` wraps it first
        # (as path X's ingestion app does); and ``fn:uuid()`` is in neither
        # package's expression language (the sink fails at its first record),
        # so the id is the chunk's page and number
        embed = '  - name: "embed"\n    type: "compute-ai-embeddings"\n'
        for old, new in ((embed + '    input: "chunks-topic"\n',
                          '  - name: "to-json"\n    type: "document-to-json"\n'
                          '    input: "chunks-topic"\n    configuration:\n'
                          '      text-field: "text"\n' + embed),
                         ('seed-urls: ["https://docs.example.com/"]', f'seed-urls: ["{base}/"]'),
                         ('allowed-domains: ["docs.example.com"]',
                          f'allowed-domains: ["127.0.0.1:{port}"]'),
                         ('expression: "fn:uuid()"',
                          "expression: \"fn:concat(key, '-', properties.chunk_id)\"")):
            if old not in text:
                fail(f"{label}: the example no longer says {old}")
            text = text.replace(old, new)
        (app / "pipeline.yaml").write_text(text)
        resource = {"embeddings-model": "minilm-l6"}
        (app / "configuration.yaml").write_text(
            (source / "configuration.yaml").read_text().rstrip("\n")
            + '\n    - type: "tpu-serving-configuration"\n      name: "encoder"\n'
              '      configuration:\n        embeddings-model: "minilm-l6"\n')
        instance = root / "instance.yaml"
        instance.write_text(T_INSTANCE.read_text().replace(
            'type: "memory"', 'type: "memory"\n    configuration: {cluster: "chip-smoke-y2"}', 1))
        visited = y2_walk(site, int(crawl["max-depth"]))
        extractor = TextExtractorAgent()
        splitter = RecursiveCharacterTextSplitter(chunk_size=int(split["chunk-size"]),
                                                  chunk_overlap=int(split["chunk-overlap"]))
        expected = []
        for path in sorted(visited):
            expected += splitter.split_text(extractor._extract_html(y2_page(path,
                                                                            site["pages"][path])))

        async def drive():
            out = {}
            run = LocalRun("webcrawler-to-vector", app, instance, device=device, gateway_port=0)
            t0 = time.monotonic()
            await run.start()
            out["start_s"] = time.monotonic() - t0
            try:
                coll = InMemoryVectorStore.get("vector-db").collection("docs")
                reset_counts()
                t = time.monotonic()
                while len(coll.ids) < len(expected):
                    if time.monotonic() - t > Y_TIMEOUT:
                        fail(f"{label}: {len(coll.ids)} of {len(expected)} chunks stored")
                    await asyncio.sleep(0.05)
                out["crawl_s"] = time.monotonic() - t
                await asyncio.sleep(2 * float(crawl.get("min-time-between-requests", 500)) / 1e3)
                out["counts"] = read_counts()
                out["leaks"] = _t_leaks(Y_REFUSED)
            finally:
                await run.stop()
            return out

        out = asyncio.run(drive())
        coll = InMemoryVectorStore.get("vector-db").collection("docs")
        texts = [p["text"] for p in coll.payloads]
        vectors = np.stack(coll.vectors)
        fetched = {h for h in hits if h not in ("/robots.txt", "/sitemap.xml")}
        if fetched != visited:
            fail(f"{label}: the crawler fetched {sorted(fetched)}, a plain walk of the site "
                 f"visits {sorted(visited)}")
        if sorted(texts) != sorted(expected):
            fail(f"{label}: the store holds {len(texts)} rows, extract and split on the CPU "
                 f"give {len(expected)} chunks, or their texts differ")
        cpu = TorchServiceProvider({"type": "tpu-serving-configuration", **resource},
                                   device="cpu").get_embeddings_service({})
        want = np.asarray(asyncio.run(cpu.compute_embeddings(texts)), np.float32)
        want /= np.maximum(np.linalg.norm(want, axis=1, keepdims=True), 1e-12)
        err = float(np.abs(vectors - want).max())
        if not np.isfinite(vectors).all() or not err <= TOL_EMBED:
            fail(f"{label}: a stored vector is {err} from the CPU encoder's (tolerance "
                 f"{TOL_EMBED})")
    finally:
        server.shutdown()
        server.server_close()
        shutil.rmtree(root, ignore_errors=True)
        InMemoryVectorStore.reset()
    if out["leaks"]:
        fail(f"{label}: the port's run loaded {out['leaks']}")
    line = {"pages": len(fetched), "chunks": len(texts), "start_s": round(out["start_s"], 3),
            "crawl_s": round(out["crawl_s"], 3),
            "pages_per_s": round(len(fetched) / out["crawl_s"], 3),
            "chunks_per_s": round(len(texts) / out["crawl_s"], 3),
            "min_time_between_requests_ms": int(crawl.get("min-time-between-requests", 500)),
            "max_abs_err_vs_cpu": err, "tolerance": TOL_EMBED, "visited_equal_walk": True,
            "launches": out["counts"]}
    return line, out["counts"]


def phase_document_path(torch, device="cuda") -> dict:
    """Path Y: the document and HTTP agents without JAX (:func:`y1_summarizer`
    at ``Y_LAYERS``, :func:`y2_crawl`). Returns both runs' launches."""
    from langstream_tpu_torch.serving.embeddings import EmbeddingEngine

    t0 = time.monotonic()
    with cut_depth("llama3-8b", Y_LAYERS):
        y1, y1_counts = y1_summarizer(torch, device)
    print(f"path Y [Y1 long-context-summarizer, llama3-8b int8 {Y_LAYERS} layers, "
          f"{len(Y_KINDS)} documents over documents-in/summaries-out]: {json.dumps(y1)}",
          flush=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    y2, y2_counts = y2_crawl(torch, device)
    print(f"path Y [Y2 webcrawler-to-vector, minilm-l6, {Y2_PAGES} pages on 127.0.0.1]: "
          f"{json.dumps(y2)}", flush=True)
    for engine_ in list(EmbeddingEngine._instances.values()):
        engine_.close()
    EmbeddingEngine.reset_instances()
    counts = {k: y1_counts[k] + y2_counts[k] for k in y1_counts}
    print(f"path Y: {time.monotonic() - t0:.1f} s; launches {json.dumps(counts)}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# path Z: the gRPC sidecar lane without JAX
# ---------------------------------------------------------------------------

Z_LAYERS = MAIN_LAYERS
Z_RECORDS = 64         # Z1's records through each lane
Z_WAVE = 8             # Z2's and Z3's sessions, one question each
Z_TIMEOUT = 300.0      # seconds any one frame or wait may take
Z_RETRIES = 5          # the sidecar step's ``errors: retries``
Z_SIDE = "z2-side"     # the topic the sidecar step writes one record to per question
#: what the lane must run without, grpcio and protobuf among them
Z_REFUSED = T_REFUSED + ("cryptography", "grpc")
Z_WHEEL = "lsz4_marker"
Z_STEPS = '''
import sys
import time


class Trim:
    """Z2's sidecar step: trims the question and writes one side record."""

    def init(self, config):
        self.side = config["side-topic"]

    def set_context(self, context):
        self.context = context

    async def process(self, record):
        question = str(record.value).strip()
        await self.context.get_topic_producer(self.side).write(
            ({"question": question, "t": time.time()}, record.key,
             {"langstream-client-session-id": record.header("langstream-client-session-id")}))
        return [question]


class Numbers:
    """Z1's source: ``count`` records, each committed into ``out``."""

    def init(self, config):
        self.left = int(config["count"])
        self.out = config["out"]
        self.n = 0

    def read(self):
        if not self.left:
            time.sleep(0.05)
            return []
        batch = []
        while self.left and len(batch) < 8:
            self.n += 1
            self.left -= 1
            batch.append(({"n": self.n}, str(self.n).encode(), {"from": "z1-source"}))
        return batch

    def commit(self, records):
        with open(self.out + ".committed", "a") as f:
            f.writelines(f"{r.value['n']}\\n" for r in records)


class Store:
    """Z1's sink: every record written into ``out``."""

    def init(self, config):
        self.out = config["out"]

    def write(self, record):
        with open(self.out + ".sunk", "a") as f:
            f.write(f"{record.value['n']} {record.key.decode()} {record.header('from')}\\n")


class Isolated:
    """Z4's step: runs only where the app's wheel is installed."""

    def process(self, record):
        import lsz4_marker
        return [(record.value + "@" + lsz4_marker.VALUE, None, None)]

    def agent_info(self):
        import lsz4_marker
        return {"executable": sys.executable, "prefix": sys.prefix,
                "marker": lsz4_marker.VALUE}
'''
Z_PIPELINE_Z1 = """
topics:
  - name: "z1-numbers"
    creation-mode: create-if-not-exists
pipeline:
  - name: "numbers"
    type: "grpc-python-source"
    output: "z1-numbers"
    configuration:
      className: "z_steps.Numbers"
      count: %d
      out: "%s"
  - name: "store"
    type: "grpc-python-sink"
    input: "z1-numbers"
    configuration:
      className: "z_steps.Store"
      out: "%s"
"""
Z_PIPELINE_Z4 = """
topics:
  - name: "z4-in"
    creation-mode: create-if-not-exists
  - name: "z4-out"
    creation-mode: create-if-not-exists
pipeline:
  - name: "isolated"
    type: "grpc-python-processor"
    input: "z4-in"
    output: "z4-out"
    configuration:
      className: "z_steps.Isolated"
"""


def z_wheel(directory: Path, name: str = Z_WHEEL, version: str = "1.0",
            value: str = "from-the-app-wheel") -> Path:
    """A pure-Python wheel zipped by hand (``METADATA``, ``WHEEL``,
    ``RECORD`` and the module), so pip installs it with nothing downloaded."""
    import base64
    import hashlib
    import zipfile

    dist = f"{name}-{version}.dist-info"
    files = {
        f"{name}.py": f"VALUE = {value!r}\n".encode(),
        f"{dist}/METADATA": (f"Metadata-Version: 2.1\nName: {name.replace('_', '-')}\n"
                             f"Version: {version}\n").encode(),
        f"{dist}/WHEEL": (b"Wheel-Version: 1.0\nGenerator: chip-smoke\n"
                          b"Root-Is-Purelib: true\nTag: py3-none-any\n"),
    }
    record = [f"{path},sha256="
              f"{base64.urlsafe_b64encode(hashlib.sha256(data).digest()).rstrip(b'=').decode()}"
              f",{len(data)}" for path, data in files.items()]
    files[f"{dist}/RECORD"] = ("\n".join(record + [f"{dist}/RECORD,,"]) + "\n").encode()
    directory.mkdir(parents=True, exist_ok=True)
    wheel = directory / f"{name}-{version}-py3-none-any.whl"
    with zipfile.ZipFile(wheel, "w") as archive:
        for path, data in files.items():
            archive.writestr(path, data)
    return wheel


def _z_instance(root: Path, cluster: str) -> Path:
    """``examples/instances/memory.yaml`` on a broker cluster of its own."""
    instance = root / f"instance-{cluster}.yaml"
    instance.write_text(T_INSTANCE.read_text().replace(
        'type: "memory"', f'type: "memory"\n    configuration: {{cluster: "{cluster}"}}', 1))
    return instance


def _z_app(root: Path, name: str, pipeline: str, configuration: str | None = None) -> Path:
    app = root / name
    (app / "python").mkdir(parents=True)
    (app / "python" / "z_steps.py").write_text(Z_STEPS)
    (app / "pipeline.yaml").write_text(pipeline)
    if configuration is not None:
        (app / "configuration.yaml").write_text(configuration)
    return app


def _z_sidecar_agents(runner) -> list:
    """A running app's ``grpc-*`` agents (inside composite nodes too)."""
    from langstream_tpu_torch.grpc.client import _GrpcAgentBase

    found, todo = [], [r.processor for r in runner.runners if hasattr(r, "processor")]
    todo += [r.source for r in runner.runners if hasattr(r, "source")]
    todo += [r.sink for r in runner.runners if hasattr(r, "sink")]
    while todo:
        agent = todo.pop()
        if isinstance(agent, _GrpcAgentBase):
            found.append(agent)
        todo.extend(getattr(agent, "processors", []))
    return found


async def _z_values(run, topic: str, n: int) -> list:
    return [m.value for m in await run.runner.wait_for_messages(topic, n, timeout=Z_TIMEOUT)]


def z1_lane(root: Path, device="cuda") -> dict:
    """Z1: the lane without a model. (a) The ``grpc-sidecar-agent`` example
    unchanged through the port's ``run`` (``LocalRun``): ``Z_RECORDS``
    records in and out through its sidecar interpreter, equal to the
    in-process ``python-processor`` lane's on the same records and class.
    (b) A ``grpc-agent`` step whose ``endpoint`` is a port ``AgentServer``
    started here. (c) ``grpc-python-source`` into ``grpc-python-sink``:
    every record read is written by the sink and committed by the source."""
    from langstream_tpu_torch.cli.main import LocalRun
    from langstream_tpu_torch.grpc.server import AgentServer

    label = "Z1"
    example = T_APPS / "grpc-sidecar-agent"
    records = [f"z1 record {i:02d} " + "x" * (i % 7) for i in range(Z_RECORDS)]
    in_process = root / "z1-in-process"
    in_process.mkdir()
    (in_process / "python").symlink_to(example / "python")
    pipeline = (example / "pipeline.yaml").read_text()
    if '"grpc-python-processor"' not in pipeline:
        fail(f"{label}: the example's step is not a grpc-python-processor")
    (in_process / "pipeline.yaml").write_text(
        pipeline.replace('"grpc-python-processor"', '"python-processor"', 1))
    endpoint_app = root / "z1-endpoint"
    endpoint_app.mkdir()
    (endpoint_app / "pipeline.yaml").write_text(pipeline.replace(
        '"grpc-python-processor"', '"grpc-agent"', 1).replace(
        'className: "example.Exclamation"', 'endpoint: "%s"', 1))
    out = root / "z1-source-sink"
    pair = _z_app(root, "z1-pair", Z_PIPELINE_Z1 % (Z_RECORDS, out, out))

    async def one(app, name: str, cluster: str) -> tuple[list, float, dict]:
        t0 = time.monotonic()
        run = await LocalRun(name, app, _z_instance(root, cluster), device=device,
                             gateway_port=0).start()
        try:
            for value in records:
                await run.runner.produce("in-topic", value)
            values = await _z_values(run, "out-topic", len(records))
            agents = _z_sidecar_agents(run.runner)
            info = await agents[0].fetch_agent_info() if agents else {}
            info = {**info, **(agents[0].agent_info() if agents else {})}
        finally:
            await run.stop()
        return values, time.monotonic() - t0, info

    async def drive():
        result = {}
        result["sidecar"] = await one(example, "z1-sidecar", "chip-smoke-z1a")
        result["in_process"] = await one(in_process, "z1-in-process", "chip-smoke-z1b")
        server = AgentServer({"className": "example.Exclamation",
                              "__application_directory__": str(example)})
        port = await server.start()
        try:
            text = (endpoint_app / "pipeline.yaml").read_text()
            (endpoint_app / "pipeline.yaml").write_text(text % f"127.0.0.1:{port}")
            result["endpoint"] = await one(endpoint_app, "z1-endpoint", "chip-smoke-z1c")
        finally:
            await server.stop(1)
        t0 = time.monotonic()
        run = await LocalRun("z1-pair", pair, _z_instance(root, "chip-smoke-z1d"),
                             device=device, gateway_port=0).start()
        try:
            committed = Path(str(out) + ".committed")
            for _ in range(int(Z_TIMEOUT / 0.1)):
                if committed.exists() and len(committed.read_text().split()) >= Z_RECORDS:
                    break
                await asyncio.sleep(0.1)
            agents = [type(a).__name__ for a in _z_sidecar_agents(run.runner)]
        finally:
            await run.stop()
        result["pair"] = (time.monotonic() - t0, agents)
        return result

    result = asyncio.run(drive())
    want = sorted(v + "!" for v in records)
    for lane in ("sidecar", "in_process", "endpoint"):
        if sorted(result[lane][0]) != want:
            fail(f"{label}: the {lane} lane's records differ: {sorted(result[lane][0])[:3]} ...")
    if result["sidecar"][2].get("execution") != "sidecar" or (
            result["endpoint"][2].get("execution") != "external-endpoint"):
        fail(f"{label}: the lanes' executions: {result['sidecar'][2]}, {result['endpoint'][2]}")
    sunk = Path(str(out) + ".sunk").read_text().split("\n")
    committed = sorted(int(n) for n in Path(str(out) + ".committed").read_text().split())
    sunk_n = sorted(int(line.split()[0]) for line in sunk if line)
    if committed != list(range(1, Z_RECORDS + 1)) or sunk_n != committed:
        fail(f"{label}: source-sink: {len(sunk_n)} sunk, {len(committed)} committed")
    if any(line.split()[1:] != [line.split()[0], "z1-source"] for line in sunk if line):
        fail(f"{label}: the sink got other keys or headers than the source read: {sunk[:2]}")
    if sorted(result["pair"][1]) != ["GrpcAgentSink", "GrpcAgentSource"]:
        fail(f"{label}: the pair ran as {result['pair'][1]}")
    return {"records": Z_RECORDS, "sidecar_s": round(result["sidecar"][1], 3),
            "in_process_s": round(result["in_process"][1], 3),
            "endpoint_s": round(result["endpoint"][1], 3),
            "source_sink_s": round(result["pair"][0], 3),
            "sidecar_equal_to_in_process": True, "endpoint_equal": True,
            "committed": len(committed), "sunk": len(sunk_n),
            "sidecar_info": result["sidecar"][2]}


def _z_chat_app(root: Path) -> Path:
    """A copy of ``chat-completions`` with a ``grpc-python-processor`` step
    (``z_steps.Trim``, ``errors: retries``) first, in front of
    ``document-to-json`` and ``ai-chat-completions``."""
    source = T_APPS / "chat-completions"
    pipeline = (source / "pipeline.yaml").read_text()
    head = '''  - name: "convert-to-structure"
    type: "document-to-json"
    input: "questions-topic"
'''
    if head not in pipeline:
        fail("Z2: the chat example's first step is not where the copy puts the sidecar's")
    step = f'''  - name: "trim"
    type: "grpc-python-processor"
    input: "questions-topic"
    configuration:
      className: "z_steps.Trim"
      side-topic: "{Z_SIDE}"
    errors:
      retries: {Z_RETRIES}
  - name: "convert-to-structure"
    type: "document-to-json"
'''
    pipeline = pipeline.replace(head, step, 1).replace(
        'pipeline:\n', f'  - name: "{Z_SIDE}"\n    creation-mode: create-if-not-exists\n'
                      'pipeline:\n', 1)
    app = _z_app(root, "chat-sidecar", pipeline, (source / "configuration.yaml").read_text())
    (app / "gateways.yaml").write_text((source / "gateways.yaml").read_text())
    return app


def z23_chat(torch, root: Path, device="cuda") -> tuple[dict, dict, dict]:
    """Z2: the chat app with a sidecar step (:func:`_z_chat_app`) through the
    port's ``run`` and gateway, a wave of ``Z_WAVE`` sessions at once as in
    T1, each question padded with white space the sidecar trims: every
    streamed answer equals its answers-topic value and the provider's greedy
    text for the trimmed question on the agent's engine; the side topic
    holds one record per question. Z3: a second wave on the same run, the
    sidecar killed (SIGKILL) once the first session's answer is in, the
    other sessions sent at once: the step restarts its sidecar once, its
    ``errors: retries`` resends what the dead sidecar held, every session
    is answered. Each wave's launches are counted from 0 at its start to its
    end, so the greedy reference run between them is in neither. Returns
    (Z2's line, Z3's line, the launches of both waves)."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.cli.main import LocalRun
    from langstream_tpu_torch.gateway.wire import WebSocketClient

    label = "Z2: chat-completions with a sidecar step"
    app = _z_chat_app(root)
    questions = [q.strip() for q in chat_prompts()[:Z_WAVE]]
    padded = [f"  {q}\n\t " for q in questions]

    async def session(run, question: str, sid: str) -> tuple[float, list, float]:
        consumer = await WebSocketClient.connect(run.url("consume", "bot-output", sessionId=sid))
        producer = await WebSocketClient.connect(run.url("produce", "user-input", sessionId=sid))
        try:
            t = time.monotonic()
            await producer.send_json({"value": question})
            ack = await producer.receive_json(Z_TIMEOUT)
            if ack.get("status") != "OK":
                fail(f"{label}: session {sid} produce refused: {ack}")
            first, chunks = None, []
            while True:
                frame = await consumer.receive_json(Z_TIMEOUT)
                if first is None:
                    first = time.monotonic() - t
                headers = frame["record"]["headers"]
                if headers.get("langstream-client-session-id") != sid:
                    fail(f"{label}: session {sid} got another session's frame: {headers}")
                chunks.append(frame["record"]["value"])
                if headers.get("stream-last-message") == "true":
                    return first, chunks, time.monotonic()
        finally:
            await consumer.close()
            await producer.close()

    async def drive():
        out = {}
        t0 = time.monotonic()
        run = LocalRun("chat-sidecar", app, _z_instance(root, "chip-smoke-z2"), device=device,
                       gateway_port=0)
        await run.start()
        out["start_s"] = time.monotonic() - t0
        try:
            cfg = {"type": CHAT_EXAMPLE_RESOURCE["type"], "name": CHAT_EXAMPLE_RESOURCE["name"],
                   **CHAT_EXAMPLE_RESOURCE["configuration"]}
            service = TorchServiceProvider(cfg, device=device).get_completions_service({})
            engine = service.engine
            ascii_head(engine)  # after the warmup: the answers need text
            (sidecar,) = _z_sidecar_agents(run.runner)
            out["sidecar_pid"] = sidecar.sidecar.process.pid
            sessions = [f"z2-{i}" for i in range(Z_WAVE)]
            t = time.monotonic()
            out["z2"] = await asyncio.gather(*(session(run, padded[i], sessions[i])
                                               for i in range(Z_WAVE)))
            out["z2_wave_s"] = time.monotonic() - t
            answers = await run.runner.wait_for_messages("answers-topic", Z_WAVE,
                                                         timeout=Z_TIMEOUT)
            out["answers"] = {a.header("langstream-client-session-id"): a for a in answers}
            out["side"] = await run.runner.wait_for_messages(Z_SIDE, Z_WAVE, timeout=Z_TIMEOUT)
            out["counts_z2"] = read_counts()
            out["direct"] = await asyncio.gather(*(
                service.chat_completions([{"role": "user", "content": q}],
                                         {"model": "llama3-8b"})
                for q in questions))
            # the reference's launches are not path Z's: Z3 counts from 0
            reset_counts()
            # Z3: the second wave, the sidecar killed after its first answer
            later = [f"z3-{i}" for i in range(Z_WAVE)]
            first = await session(run, padded[0], later[0])
            kill_t, kill_wall = time.monotonic(), time.time()
            os.kill(out["sidecar_pid"], signal.SIGKILL)
            rest = await asyncio.gather(*(session(run, padded[i], later[i])
                                          for i in range(1, Z_WAVE)))
            out["z3"] = [first, *rest]
            out["z3_kill_to_last_answer_s"] = max(r[2] for r in rest) - kill_t
            answers = await run.runner.wait_for_messages("answers-topic", 2 * Z_WAVE,
                                                         timeout=Z_TIMEOUT)
            out["answers_z3"] = {a.header("langstream-client-session-id"): a for a in answers
                                 if a.header("langstream-client-session-id") in later}
            side = await run.runner.wait_for_messages(Z_SIDE, 2 * Z_WAVE, timeout=Z_TIMEOUT)
            out["z3_side_after_kill"] = sorted(m.value["t"] - kill_wall for m in side
                                               if m.value["t"] > kill_wall)
            out["restarts"] = getattr(sidecar, "_restarts", 0)
            out["respawned_pid"] = sidecar.sidecar.process.pid
            out["info"] = await sidecar.fetch_agent_info()
            out["counts_z3"] = read_counts()
            out["leaks"] = _t_leaks(Z_REFUSED) + sorted(
                m for m in sys.modules if m.startswith("google.protobuf"))
        finally:
            await run.stop()
        return out

    reset_counts()
    out = asyncio.run(drive())
    if out["leaks"]:
        fail(f"{label}: the port's run loaded {out['leaks']}")
    gateway_ttft, engine_ttft = [], []
    for i, (first, chunks, _) in enumerate(out["z2"]):
        record = out["answers"].get(f"z2-{i}")
        if record is None:
            fail(f"{label}: no answers-topic record for session {i}")
        streamed, answer = "".join(chunks), record.value["answer"]
        if not streamed or streamed != answer:
            fail(f"{label}: session {i}: streamed {streamed!r} != answers-topic {answer!r}")
        if answer != out["direct"][i].text:
            fail(f"{label}: session {i}: answer {answer!r} != the provider's greedy text "
                 f"{out['direct'][i].text!r} for the trimmed question")
        if record.value.get("question") != questions[i]:
            fail(f"{label}: session {i}: the chat step saw {record.value.get('question')!r}")
        gateway_ttft.append(first)
        engine_ttft.append(float(record.header("langstream-ttft-ms")) / 1e3)
    side = sorted((m.value["question"], m.header("langstream-client-session-id"))
                  for m in out["side"])
    if side != sorted((q, f"z2-{i}") for i, q in enumerate(questions)):
        fail(f"{label}: the side topic holds {side}")
    counts_z2 = out["counts_z2"]
    if device == "cuda" and min(counts_z2["flash_attention"], counts_z2["paged_attention"]) == 0:
        fail(f"{label}: flash and the bf16 paged read must launch: {counts_z2}")
    t1 = NOTES.get("T1", {}).get("gateway_ttft_s", {})
    z2 = {"sessions": Z_WAVE, "start_s": round(out["start_s"], 3),
          "wave_s": round(out["z2_wave_s"], 3), "gateway_ttft_s": _t_stats(gateway_ttft),
          "engine_ttft_s": _t_stats(engine_ttft),
          "gateway_minus_engine_ttft_s": _t_stats(
              [g - e for g, e in zip(gateway_ttft, engine_ttft)]),
          "t1_gateway_ttft_p50_s": t1.get("p50"),
          "sidecar_hop_p50_s": round(_t_stats(gateway_ttft)["p50"] - t1["p50"], 4)
          if t1 else None,
          "side_records": len(out["side"]), "equal_to_provider": True, "launches": counts_z2}
    label = "Z3: the sidecar killed mid-wave"
    for i, (_, chunks, _) in enumerate(out["z3"]):
        record = out["answers_z3"].get(f"z3-{i}")
        if record is None or not record.value["answer"] or (
                "".join(chunks) != record.value["answer"]):
            fail(f"{label}: session {i} was not answered whole")
    if out["restarts"] != 1 or out["respawned_pid"] == out["sidecar_pid"]:
        fail(f"{label}: {out['restarts']} restarts, pid {out['sidecar_pid']} -> "
             f"{out['respawned_pid']}")
    if not out["z3_side_after_kill"]:
        fail(f"{label}: no record went through the sidecar after the kill")
    if out["info"].get("className") != "z_steps.Trim":
        fail(f"{label}: the respawned sidecar answers {out['info']}")
    counts_z3 = out["counts_z3"]
    z3 = {"sessions": Z_WAVE, "restarts": out["restarts"],
          "kill_to_next_record_s": round(out["z3_side_after_kill"][0], 3),
          "kill_to_last_answer_s": round(out["z3_kill_to_last_answer_s"], 3),
          "records_through_after_kill": len(out["z3_side_after_kill"]),
          "pids": [out["sidecar_pid"], out["respawned_pid"]],
          "launches": counts_z3}
    return z2, z3, {k: counts_z2[k] + counts_z3[k] for k in counts_z2}


def z4_isolation(root: Path, device="cuda") -> dict:
    """Z4: an app whose ``python/requirements.txt`` names a wheel written
    here by hand into ``python/wheels/``: the port's ``python
    install-requirements`` provisions its venv (its seconds); the sidecar
    of a ``grpc-python-processor`` step runs on the venv's interpreter
    (its ``agent_info`` says so) and imports the wheel's module, which the
    base interpreter cannot; a second call returns the same interpreter and
    leaves the marker as it was; the app runs through the dev runner on its
    own directory (``run`` stores only YAML and ``python/*.py``). Then
    ``apps ui --once --no-open`` serves the port's ``app_ui.html`` byte for
    byte."""
    import urllib.request

    from langstream_tpu_torch.runtime.isolation import ensure_app_interpreter
    from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner

    label = "Z4"
    app = _z_app(root, "z4-isolated", Z_PIPELINE_Z4)
    z_wheel(app / "python" / "wheels")
    (app / "python" / "requirements.txt").write_text(f"{Z_WHEEL.replace('_', '-')}==1.0\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("LS_VENV_ROOT", None)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "langstream_tpu_torch.cli", "python",
                          "install-requirements", "-app", str(app)], env=env,
                         capture_output=True, text=True, timeout=600)
    provision_s = time.monotonic() - t0
    if out.returncode != 0:
        fail(f"{label}: install-requirements exited {out.returncode}: {out.stderr[-2000:]}")
    interpreter = out.stdout.split()[-1]
    marker = app / ".venv" / ".requirements.sha256"
    stamp = (marker.read_text(), marker.stat().st_mtime_ns)
    base = subprocess.run([sys.executable, "-c", f"import {Z_WHEEL}"], capture_output=True,
                          text=True, timeout=60)
    if base.returncode == 0:
        fail(f"{label}: the base interpreter imports {Z_WHEEL}")
    pip = subprocess.run([interpreter, "-m", "pip", "--version"], capture_output=True,
                         text=True, timeout=60)

    async def drive():
        # the dev runner on the app's own directory: ``run`` and a deploy
        # store only an app's YAML and ``python/*.py`` (as the JAX control
        # plane does), so its requirements and wheels stay behind
        runner = LocalApplicationRunner.from_directory(app, _z_instance(root, "chip-smoke-z4"))
        async with runner:
            await runner.produce("z4-in", "isolated")
            values = [m.value for m in await runner.wait_for_messages("z4-out", 1,
                                                                      timeout=Z_TIMEOUT)]
            (sidecar,) = _z_sidecar_agents(runner)
            info = await sidecar.fetch_agent_info()
        return values, info

    values, info = asyncio.run(drive())
    again = ensure_app_interpreter(app)
    if again != interpreter or (marker.read_text(), marker.stat().st_mtime_ns) != stamp:
        fail(f"{label}: a second call gave {again} (first {interpreter}) or moved the marker")
    if info.get("executable") != interpreter or values != ["isolated@from-the-app-wheel"]:
        fail(f"{label}: the sidecar ran on {info.get('executable')} (the venv's is "
             f"{interpreter}) and answered {values}")
    page = REPO / "langstream_tpu_torch" / "cli" / "app_ui.html"
    proc = subprocess.Popen([sys.executable, "-m", "langstream_tpu_torch.cli", "apps", "ui",
                             "z", "--port", "0", "--once", "--no-open"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        if not line.startswith("chat UI: "):
            fail(f"{label}: apps ui printed {line!r}")
        with urllib.request.urlopen(line.removeprefix("chat UI: "), timeout=60) as answer:
            served = answer.read()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    if served != page.read_bytes() or proc.returncode != 0:
        fail(f"{label}: apps ui served {len(served)} bytes, exit {proc.returncode}")
    return {"provision_s": round(provision_s, 3), "interpreter": interpreter,
            "sidecar_executable": info["executable"], "marker": info["marker"],
            "base_imports_wheel": False, "second_call_same": True,
            "venv_pip": pip.stdout.strip() or pip.stderr.strip()[-200:],
            "apps_ui_bytes": len(served)}


def phase_sidecar_path(torch, device="cuda") -> dict:
    """Path Z: the gRPC sidecar lane without JAX (:func:`z1_lane`,
    :func:`z23_chat` at ``Z_LAYERS``, :func:`z4_isolation`), each app on a
    memory broker cluster of its own. Returns Z2's and Z3's launches."""
    import shutil
    import tempfile

    t0 = time.monotonic()
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-z-"))
    try:
        z1 = z1_lane(root, device)
        print(f"path Z [Z1 the sidecar lane: grpc-sidecar-agent, grpc-agent, source and sink, "
              f"{Z_RECORDS} records each]: {json.dumps(z1)}", flush=True)
        t_z2 = time.monotonic()
        with cut_depth("llama3-8b", Z_LAYERS):
            z2, z3, counts = z23_chat(torch, root, device)
        print(f"path Z [Z2 chat-completions with a sidecar step, llama3-8b int8 {Z_LAYERS} "
              f"layers, {Z_WAVE} sessions]: {json.dumps(z2)}", flush=True)
        print(f"path Z [Z3 the sidecar killed after the first answer of a second wave]: "
              f"{json.dumps(z3)}", flush=True)
        z23_s = time.monotonic() - t_z2
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        z4 = z4_isolation(root, device)
        print(f"path Z [Z4 an app venv from a wheel in python/wheels, apps ui]: "
              f"{json.dumps(z4)}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"path Z: {time.monotonic() - t0:.1f} s (Z2 and Z3 {z23_s:.1f} s); launches "
          f"{json.dumps(counts)}", flush=True)
    return counts


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
    import threading

    from langstream_tpu_torch import native

    # the tsbroker (path V's streaming cluster) builds with g++ beside the
    # kernels' nvcc builds, as a cluster's first start would build it
    broker: dict = {}

    def build_broker():
        t = time.monotonic()
        try:
            broker["binary"] = native.ensure_broker_binary()
        except native.NativeBuildError as e:
            broker["error"] = e
        broker["s"] = time.monotonic() - t

    broker_thread = threading.Thread(target=build_broker, name="tsbroker-build")
    t0 = time.monotonic()
    broker_thread.start()
    built = _build.build_all()
    build_s = time.monotonic() - t0
    broker_thread.join()
    if "error" in broker:
        fail(f"the tsbroker did not build: {broker['error']}")
    print(f"built {sorted(built)} in {build_s:.1f} s into {_build.build_dir()}", flush=True)
    # what a pod's first start pays unless its image carries the libraries
    print("first build: " + json.dumps({
        "first_build_s": round(build_s, 3) if built else None, "built": sorted(built),
        "build_dir": str(_build.build_dir()), "tsbroker_build_s": round(broker["s"], 3),
        "nvidia_smi": smi}), flush=True)
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
    depth = contextlib.ExitStack()  # every llama3-8b engine at MAIN_LAYERS at most
    depth.enter_context(cut_depth(base["model"], MAIN_LAYERS))
    t0 = time.monotonic()
    secs: dict[str, float] = {}  # each main path's seconds
    params, dense_counts = phase_main_path(torch, "dense bf16 KV", base, profile=True,
                                           note="A")
    secs["A"] = time.monotonic() - t0
    if dense_counts["flash_attention"] == 0 or dense_counts["paged_attention"] == 0:
        fail(f"dense main path did not launch flash and paged kernels: {dense_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.monotonic()
    q8_counts = phase_main_path(
        torch, "paged int8 KV",
        {**base, "kv-layout": "paged", "kv-quantize": "int8", "prefix-cache": False},
        params=params, profile=True, note="B",
    )[1]  # (its params are path A's: bound to no name, freed with them below)
    if q8_counts["paged_attention_q8"] == 0 or q8_counts["flash_attention"] == 0:
        fail(f"int8-KV main path did not launch flash and q8 kernels: {q8_counts}")
    secs["B"] = time.monotonic() - t_b
    gc.collect()
    torch.cuda.empty_cache()
    t_c = time.monotonic()
    c_counts = phase_prefix_path(
        torch, "paged bf16 KV, prefix cache, prefill-chunk 512",
        {**base, "kv-layout": "paged", "prefix-cache": True, "prefill-chunk": 512},
        params=params,
    )
    secs["C"] = time.monotonic() - t_c
    gc.collect()
    torch.cuda.empty_cache()
    t_d = time.monotonic()
    with cut_depth(base["model"], D_LAYERS):  # path A's first D_LAYERS layers
        d_counts = phase_spec_path(
            torch, "paged bf16 KV, speculative-drafts 4",
            {**base, "kv-layout": "paged", "prefix-cache": False, "speculative-drafts": 4},
            params=at_depth(params, D_LAYERS),
        )
    secs["D"] = time.monotonic() - t_d
    gc.collect()
    torch.cuda.empty_cache()
    t_i = time.monotonic()
    with cut_depth(base["model"], I_LAYERS):  # path A's first I_LAYERS layers
        i1_counts = phase_tier_path(torch, at_depth(params, I_LAYERS))
        gc.collect()
        torch.cuda.empty_cache()
        i2_counts, i2_tokens = phase_handoff_path(torch, at_depth(params, I_LAYERS))
    i_counts = {k: i1_counts[k] + i2_counts[k] for k in i1_counts}
    secs["I"] = time.monotonic() - t_i
    print(f"path I: {secs['I']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t_j = time.monotonic()
    with cut_depth(base["model"], J_LAYERS):  # path A's first J_LAYERS layers
        j1_counts = phase_lora_path(torch, at_depth(params, J_LAYERS))
        gc.collect()
        torch.cuda.empty_cache()
        j2_counts = phase_lora_spec_path(torch, at_depth(params, J_LAYERS))
    j_counts = {k: j1_counts[k] + j2_counts[k] for k in j1_counts}
    secs["J"] = time.monotonic() - t_j
    print(f"path J: {secs['J']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t_k = time.monotonic()
    with cut_depth(base["model"], K_LAYERS):  # K1, K2 and K4 on A's first layers
        k1_counts, k1_line, _ = phase_chaos_path(torch, at_depth(params, K_LAYERS))
        NOTES["K1"] = k1_line
        gc.collect()
        torch.cuda.empty_cache()
        k2_counts = phase_wedge_path(torch, at_depth(params, K_LAYERS))
    gc.collect()
    torch.cuda.empty_cache()
    k3_counts = phase_crash_requeue_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    with cut_depth(base["model"], K_LAYERS):
        k4_counts = phase_drain_path(torch, at_depth(params, K_LAYERS))
    k_counts = {k: sum(c[k] for c in (k1_counts, k2_counts, k3_counts, k4_counts))
                for k in k1_counts}
    if k_counts["flash_attention"] == 0 or k_counts["paged_attention_q8"] == 0:
        fail(f"path K did not launch flash and the int8 paged read: {k_counts}")
    secs["K"] = time.monotonic() - t_k
    print(f"path K: {secs['K']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t_l = time.monotonic()
    with cut_depth(base["model"], K_LAYERS):  # L1 at K1's depth: like for like
        l1_counts = phase_evidence_path(torch, at_depth(params, K_LAYERS), k1_line)[0]
    gc.collect()
    torch.cuda.empty_cache()
    with cut_depth(base["model"], I_LAYERS):  # L2 at I2's depth: its tokens
        l2_counts = phase_chainer_path(torch, at_depth(params, I_LAYERS), i2_tokens)[0]
    l_counts = {k: l1_counts[k] + l2_counts[k] for k in l1_counts}
    if l_counts["flash_attention"] == 0 or l_counts["paged_attention_q8"] == 0 or (
            l_counts["paged_attention"] == 0):
        fail(f"path L did not launch flash and both paged reads: {l_counts}")
    secs["L"] = time.monotonic() - t_l
    print(f"path L: {secs['L']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t_m = time.monotonic()
    m3_counts = phase_dense_int8_path(torch, params, base)
    gc.collect()
    torch.cuda.empty_cache()
    m2_counts = phase_writer_path(torch)
    m_counts = {k: m2_counts[k] + m3_counts[k] for k in m2_counts}
    m_s = time.monotonic() - t_m
    del params  # path E makes its own weights: two 8B sets never share the card
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_e = time.monotonic()
    with cut_depth(CHAT_EXAMPLE_RESOURCE["configuration"]["model"], E_LAYERS):
        e_counts = phase_provider_path(torch, CHAT_EXAMPLE_RESOURCE)
    secs["E"] = time.monotonic() - t_e
    gc.collect()
    torch.cuda.empty_cache()
    t_f = time.monotonic()
    with cut_depth(base["model"], F_LAYERS):
        f_counts = phase_saturated(torch, base)
    gc.collect()
    torch.cuda.empty_cache()
    t_g = time.monotonic()
    g1_counts, g2_counts = phase_moe_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t_h = time.monotonic()
    with cut_depth(CHAT_EXAMPLE_RESOURCE["configuration"]["model"], H_LAYERS):
        h_counts = phase_qos_path(torch)
    t_m1 = time.monotonic()
    phase_metrics_path(torch)  # M1: after every plane's engines have served
    m_s += time.monotonic() - t_m1
    gc.collect()
    torch.cuda.empty_cache()
    t_n = time.monotonic()
    n_counts = phase_mesh_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t_o = time.monotonic()
    o_counts = phase_sp_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t_p = time.monotonic()
    p_counts = phase_train_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t_q = time.monotonic()
    q_counts = phase_launch_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t_r = time.monotonic()
    r_counts = phase_store_mesh_path(torch)
    depth.close()
    gc.collect()
    torch.cuda.empty_cache()
    t_s = time.monotonic()
    s_counts = phase_cluster_path(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    t_t = time.monotonic()
    t_counts = phase_app_path(torch)
    if t_counts["flash_attention"] == 0 or t_counts["paged_attention"] == 0:
        fail(f"path T did not launch flash and the bf16 paged read: {t_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    t_u = time.monotonic()
    u_counts = phase_control_plane_path(torch)
    if min(u_counts["flash_attention"], u_counts["paged_attention"],
           u_counts["paged_attention_q8"]) == 0:
        fail(f"path U did not launch flash and both paged reads: {u_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    t_v = time.monotonic()
    v_counts = phase_mini_path(torch)  # the chat pod's, read from its profile
    gc.collect()
    torch.cuda.empty_cache()
    t_w = time.monotonic()
    w_counts = phase_kafka_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t_x = time.monotonic()
    x_counts = phase_retrieval_path(torch)
    if x_counts["flash_attention"] == 0 or x_counts["paged_attention"] == 0:
        fail(f"path X did not launch flash and the bf16 paged read: {x_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    t_y = time.monotonic()
    y_counts = phase_document_path(torch)
    if y_counts["flash_attention"] == 0 or y_counts["paged_attention"] == 0:
        fail(f"path Y did not launch flash and the bf16 paged read: {y_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    t_z = time.monotonic()
    z_counts = phase_sidecar_path(torch)
    if z_counts["flash_attention"] == 0 or z_counts["paged_attention"] == 0:
        fail(f"path Z did not launch flash and the bf16 paged read: {z_counts}")
    secs.update(F=t_g - t_f, G=t_h - t_g, H=t_m1 - t_h, M=m_s, N=t_o - t_n, O=t_p - t_o,
                P=t_q - t_p, Q=t_r - t_q, R=t_s - t_r, S=t_t - t_s, T=t_u - t_t,
                U=t_v - t_u, V=t_w - t_v, W=t_x - t_w, X=t_y - t_x, Y=t_z - t_y,
                Z=time.monotonic() - t_z)
    print(f"phase main path: {time.monotonic() - t0:.1f} s; path seconds "
          f"{json.dumps({k: round(v, 1) for k, v in sorted(secs.items())})}", flush=True)

    # -- phase 5: card against CPU -----------------------------------------
    t0 = time.monotonic()
    phase_card_vs_cpu(torch)
    print(f"phase card vs CPU: {time.monotonic() - t0:.1f} s", flush=True)

    # -- phase 6: kernels line, then the device line ------------------------
    g_counts = {k: g1_counts[k] + g2_counts[k] for k in g1_counts}
    paths = {"A": dense_counts, "B": q8_counts, "C": c_counts, "D": d_counts,
             "E": e_counts, "F": f_counts, "G": g_counts, "H": h_counts, "I": i_counts,
             "J": j_counts, "K": k_counts, "L": l_counts, "M": m_counts, "N": n_counts,
             "O": o_counts, "P": p_counts, "Q": q_counts, "R": r_counts, "S": s_counts,
             "T": t_counts, "U": u_counts, "V": v_counts, "W": w_counts, "X": x_counts,
             "Y": y_counts, "Z": z_counts}
    meta = {  # launches: summed over the 26 main paths (rank 0's on N, O, Q, R, S; V's
        # the chat pod's, in its profiled window)
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
    if sys.argv[1:2] == ["--k3-child"]:  # path K3's crashing process
        sys.path.insert(0, str(REPO))
        sys.exit(k3_child(sys.argv[2], sys.argv[3], json.loads(sys.argv[4])))
    if sys.argv[1:2] == ["--o2-rank"]:  # path O2's rank 1
        sys.path.insert(0, str(REPO))
        sys.exit(o2_rank(*sys.argv[2:7]))
    if sys.argv[1:2] == ["--p-rank"]:  # path P's rank 1
        sys.path.insert(0, str(REPO))
        sys.exit(p_rank(*sys.argv[2:7]))
    if sys.argv[1:2] == ["--q2-pod"]:  # one pod of a slice (paths Q2 and S)
        sys.path.insert(0, str(REPO))
        sys.exit(q2_pod(*sys.argv[2:9]))
    sys.exit(main())
