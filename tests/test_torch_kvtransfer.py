"""The KV handoff wire, the slot gather/scatter and the pool roles of the
port (``langstream_tpu_torch/serving/kvtransfer.py`` and the engine's
``take_export``/``import_handoff``) against the JAX package.

- The wire: for the same header and rows (f32, int8 ``{"q","s"}``, bf16)
  the port's ``serialize_handoff`` gives the JAX package's bytes; each
  package reads the other's; the JAX rejections raise the port's
  ``LayoutMismatch``. The JAX side makes bf16 rows with ``ml_dtypes``, the
  port with torch (raw 2-byte words).
- Gather and scatter: a partial-block round trip (f32, int8); the port's
  ``gather_slot`` + ``fetch_rows`` equal the JAX functions on the same pool
  contents, carried across with ``models/convert.py``.
- The block manager's tier hooks give the JAX manager's answers under the
  same operations.
- Engines, tiny f32 model on the JAX engine's parameters: a JAX prefill
  pool's export decodes on a port decode pool and the reverse, f32 and
  int8 KV, greedy tokens and text equal to the JAX combined engine's; a
  fingerprint mismatch is refused; a full decode pool sheds explicitly and
  a retry lands.
"""

import asyncio

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from langstream_tpu.models.paged import BlockManager as JaxBlockManager
from langstream_tpu.models.paged import PagedLayout as JaxPagedLayout
from langstream_tpu.serving import kvtransfer as jax_kvt
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.models.convert import params_from_numpy, tensor_from_numpy
from langstream_tpu_torch.models.paged import BlockManager, PagedLayout, gather_kv
from langstream_tpu_torch.serving import kvtransfer
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from langstream_tpu_torch.serving.kvtransfer import LayoutMismatch
from langstream_tpu_torch.serving.qos import RateLimited
from test_torch_engine import flatten_jax_params

HEADER = {
    "fingerprint": {"model": "tiny", "dtype": "float32", "kv-quantize": None,
                    "kv-block-size": 16, "layers": 2, "kv-heads": 2,
                    "head-dim": 8, "max-seq-len": 256},
    "request": "tiny-00000001",
    "prompt-digest": jax_kvt.prompt_digest([1, 2, 3]),
    "prompt-tokens": [1, 2, 3],
    "generated": [7],
    "kv-rows": 37,
    "deadline": None,
    "timings": {"ttft": 0.25},
}


def _rows(kind: str, seed: int = 7, L: int = 2, rows: int = 37, khd: int = 16):
    """Numpy rows as the JAX package holds them (bf16 through ml_dtypes)."""
    rng = np.random.default_rng(seed)
    if kind == "int8":
        return {
            f"{p}.{leaf}": (rng.integers(-127, 127, (L, rows, khd), dtype=np.int8)
                            if leaf == "q" else
                            rng.standard_normal((L, rows, 2)).astype(np.float32))
            for p in ("k", "v") for leaf in ("q", "s")
        }
    dtype = np.float32 if kind == "f32" else ml_dtypes.bfloat16
    return {p: rng.standard_normal((L, rows, khd)).astype(dtype) for p in ("k", "v")}


def _as_torch(a: np.ndarray) -> torch.Tensor:
    """The port's host tensor of the same rows (bf16 built from the bits)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t) -> np.ndarray:
    """Comparable bits of a port tensor or a JAX-side numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy()
    return t.view(np.int16) if t.dtype.name == "bfloat16" else np.asarray(t)


# --------------------------------------------------------------------------
# the wire
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_wire_bytes_equal_jax_and_cross_read(kind):
    rows = _rows(kind)
    jax_bytes = jax_kvt.serialize_handoff(HEADER, rows)
    port_bytes = kvtransfer.serialize_handoff(
        HEADER, {name: _as_torch(a) for name, a in rows.items()})
    assert port_bytes == jax_bytes
    # numpy arrays in gives the same bytes as tensors
    if kind != "bf16":
        assert kvtransfer.serialize_handoff(HEADER, rows) == jax_bytes
    header, back = kvtransfer.deserialize_handoff(jax_bytes)
    assert header["request"] == "tiny-00000001" and sorted(back) == sorted(rows)
    for name, a in rows.items():
        assert back[name].shape == a.shape
        np.testing.assert_array_equal(_bits(back[name]), _bits(a))
    jax_header, jax_back = jax_kvt.deserialize_handoff(port_bytes)
    assert jax_header == header
    for name, a in rows.items():
        assert jax_back[name].dtype == a.dtype
        np.testing.assert_array_equal(_bits(jax_back[name]), _bits(a))
    if kind == "bf16":
        assert {e["dtype"] for e in header["arrays"]} == {"bfloat16"}


def test_peek_digest_and_trace_match_jax():
    payload = kvtransfer.serialize_handoff(
        {**HEADER, "trace": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"},
        {"k": np.zeros((1, 1, 4), np.float32)})
    ours, theirs = kvtransfer.peek_header(payload), jax_kvt.peek_header(payload)
    assert ours == theirs
    assert kvtransfer.prompt_digest([5, 6, 7]) == jax_kvt.prompt_digest([5, 6, 7])
    assert kvtransfer.journey_id(ours) == jax_kvt.journey_id(theirs) == "ab" * 16
    assert kvtransfer.trace_context(ours).to_header() == jax_kvt.trace_context(theirs).to_header()
    for bad in ({"trace": "garbage"}, {}, {"journey": "j-1"}):
        assert kvtransfer.journey_id(bad) == jax_kvt.journey_id(bad)
    assert kvtransfer.FINGERPRINT_KEYS == jax_kvt.FINGERPRINT_KEYS
    assert (kvtransfer.WIRE_MAGIC, kvtransfer.WIRE_VERSION) == (
        jax_kvt.WIRE_MAGIC, jax_kvt.WIRE_VERSION)


def _unknown_dtype_payload(payload: bytes) -> bytes:
    """``payload`` with its one array's dtype renamed to one nobody knows
    (the header length grows by the same bytes it says)."""
    hlen = int.from_bytes(payload[8:12], "little")
    hjson = payload[12:12 + hlen].replace(b'"float32"', b'"float80"')
    return payload[:8] + len(hjson).to_bytes(4, "little") + hjson + payload[12 + hlen:]


REJECTIONS = {
    "bad-magic": (lambda p: b"XXXX" + p[4:], "magic"),
    "wrong-version": (lambda p: p[:4] + (jax_kvt.WIRE_VERSION + 1).to_bytes(4, "little")
                      + p[8:], "wire version"),
    "truncated": (lambda p: p[:-3], "truncated"),
    "truncated-header": (lambda p: p[:14], "truncated"),
    "unknown-dtype": (_unknown_dtype_payload, "dtype"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_wire_rejections_raise_layout_mismatch_as_jax(case):
    mutate, match = REJECTIONS[case]
    payload = jax_kvt.serialize_handoff({"kv-rows": 1}, {"k": np.zeros((1, 1, 4), np.float32)})
    bad = mutate(payload)
    with pytest.raises(jax_kvt.LayoutMismatch, match=match):
        jax_kvt.deserialize_handoff(bad)
    with pytest.raises(LayoutMismatch, match=match):
        kvtransfer.deserialize_handoff(bad)


def test_fingerprint_check_names_the_keys_as_jax():
    ours = dict(HEADER["fingerprint"])
    theirs = {**ours, "kv-block-size": 32, "dtype": "bfloat16"}
    with pytest.raises(jax_kvt.LayoutMismatch) as jax_err:
        jax_kvt.check_fingerprint(ours, theirs)
    with pytest.raises(LayoutMismatch) as err:
        kvtransfer.check_fingerprint(ours, theirs)
    assert str(err.value) == str(jax_err.value)
    kvtransfer.check_fingerprint(ours, dict(ours))  # identical: silent


# --------------------------------------------------------------------------
# gather and scatter
# --------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_scatter_gather_roundtrip_partial_block(int8):
    """Rows written by ``scatter_slot`` read back exactly through
    ``gather_kv``, with a partial last block (19 rows over blocks of 8)."""
    L, bs, khd, rows = 2, 8, 16, 19
    nrb = -(-rows // bs)
    table = np.array([1, 2, 3, 0], dtype=np.int32)
    if int8:
        arrays = _rows("int8", seed=3, L=L, rows=rows, khd=khd)

        def make():
            return {"q": torch.zeros((L, 6, bs, khd), dtype=torch.int8),
                    "s": torch.zeros((L, 6, bs, 2), dtype=torch.float32)}
    else:
        arrays = _rows("f32", seed=3, L=L, rows=rows, khd=khd)

        def make():
            return torch.zeros((L, 6, bs, khd), dtype=torch.float32)
    _, back = kvtransfer.deserialize_handoff(kvtransfer.serialize_handoff({"kv-rows": rows}, arrays))
    out_k, out_v = kvtransfer.scatter_slot(make(), make(), back, table, rows, padded_rows=24)
    tables = torch.from_numpy(table[None, :nrb])
    for out, prefix in ((out_k, "k"), (out_v, "v")):
        got = gather_kv(out, tables, nrb)
        if int8:
            for leaf in ("q", "s"):
                np.testing.assert_array_equal(got[leaf][:, 0, :rows].numpy(),
                                              arrays[f"{prefix}.{leaf}"])
        else:
            np.testing.assert_array_equal(got[:, 0, :rows].numpy(), arrays[prefix])
        # pad rows went to scratch block 0, not past the slot's rows
        unused = (out["q"] if int8 else out)[:, 4:]
        assert not unused.any()


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_gather_fetch_rows_equal_jax(kind):
    """The same pool contents (the JAX pools carried across with
    ``tensor_from_numpy``): the port's ``gather_slot`` + ``fetch_rows``
    give the JAX package's arrays, names and shapes, and the same wire
    bytes."""
    rng = np.random.default_rng(11)
    L, nb, bs, khd, kh = 2, 9, 16, 16, 2
    if kind == "int8":
        def pool():
            return {"q": rng.integers(-127, 127, (L, nb, bs, khd), dtype=np.int8),
                    "s": rng.standard_normal((L, nb, bs, kh)).astype(np.float32)}
    else:
        dtype = np.float32 if kind == "f32" else ml_dtypes.bfloat16

        def pool():
            return rng.standard_normal((L, nb, bs, khd)).astype(dtype)
    pk, pv = pool(), pool()

    def to_jax(p):
        return {k: jnp.asarray(v) for k, v in p.items()} if isinstance(p, dict) else jnp.asarray(p)

    def to_port(p):
        if isinstance(p, dict):
            return {k: tensor_from_numpy(v, device="cpu") for k, v in p.items()}
        return tensor_from_numpy(p, device="cpu")

    table_row = np.array([5, 2, 7, 0, 0], dtype=np.int32)
    rows = 37  # a partial third block
    jk, jv = jax_kvt.gather_slot(to_jax(pk), to_jax(pv), table_row, 3)
    want, _ = jax_kvt._fetch_rows(jk, jv, rows)
    tk, tv = kvtransfer.gather_slot(to_port(pk), to_port(pv), table_row, 3)
    got, device_s = kvtransfer.fetch_rows(tk, tv, rows)
    assert device_s >= 0.0
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape == (L, rows) + want[name].shape[2:]
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))
    assert (kvtransfer.serialize_handoff(HEADER, got)
            == jax_kvt.serialize_handoff(HEADER, want))


def _pools(kind: str, seed: int = 5, L: int = 2, nb: int = 9, bs: int = 16):
    """Random K and V pools as numpy (the JAX package's layout)."""
    rng = np.random.default_rng(seed)
    if kind == "int8":
        def pool():
            return {"q": rng.integers(-127, 127, (L, nb, bs, 16), dtype=np.int8),
                    "s": rng.standard_normal((L, nb, bs, 2)).astype(np.float32)}
    else:
        def pool():
            return rng.standard_normal((L, nb, bs, 16)).astype(np.float32)
    return pool(), pool()


def _port_pool(p):
    if isinstance(p, dict):
        return {k: tensor_from_numpy(v, device="cpu") for k, v in p.items()}
    return tensor_from_numpy(p, device="cpu")


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_fetch_blocks_equal_one_block_fetches_of_jax(kind):
    """The demotion's one fetch of several blocks gives, per block, the
    arrays the JAX engine's one-block gather + ``_fetch_rows`` gives."""
    pk, pv = _pools(kind)
    blocks = [6, 2, 8]
    got, _ = kvtransfer.fetch_blocks(
        *kvtransfer.gather_slot(_port_pool(pk), _port_pool(pv), np.array(blocks), 3), 3)
    assert len(got) == len(blocks)
    for arrays, b in zip(got, blocks):
        jk, jv = jax_kvt.gather_slot(
            {k: jnp.asarray(v) for k, v in pk.items()} if kind == "int8" else jnp.asarray(pk),
            {k: jnp.asarray(v) for k, v in pv.items()} if kind == "int8" else jnp.asarray(pv),
            np.array([b]), 1)
        want, _ = jax_kvt._fetch_rows(jk, jv, 16)
        assert sorted(arrays) == sorted(want)
        for name in want:
            assert arrays[name].is_contiguous()
            np.testing.assert_array_equal(arrays[name].numpy(), want[name])


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_scatter_of_block_lists_equals_scatter_of_one_array(kind):
    """A promotion hands ``scatter_slot`` each name's rows as a list of
    blocks; the pools it writes equal those one concatenated array
    writes."""
    pk, pv = _pools(kind)
    blocks, _ = kvtransfer.fetch_blocks(
        *kvtransfer.gather_slot(_port_pool(pk), _port_pool(pv), np.array([3, 1]), 2), 2)
    as_lists = {name: [b[name] for b in blocks] for name in blocks[0]}
    as_array = {name: torch.cat(parts, dim=1) for name, parts in as_lists.items()}
    table = np.array([4, 7, 0, 0], dtype=np.int32)
    outs = []
    for arrays in (as_lists, as_array):
        empty_k, empty_v = _pools(kind, seed=9)
        outs.append(kvtransfer.scatter_slot(_port_pool(empty_k), _port_pool(empty_v),
                                            arrays, table, 30, padded_rows=32))
    for a, b in zip(outs[0], outs[1]):
        for x, y in (zip(a.values(), b.values()) if kind == "int8" else [(a, b)]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the block manager's tier hooks
# --------------------------------------------------------------------------


def _hook_script(mgr, evicted: list):
    """One sequence of prefix-cache and tier-hook operations; returns every
    answer (block ids, candidate lists, stats) for comparison."""
    mgr.on_prefix_evict = lambda digest_hex, block: evicted.append((digest_hex, block))
    out = []
    prompts = [list(range(1, 50)), list(range(1, 34)) + [90] * 16, list(range(200, 249))]
    for slot, prompt in enumerate(prompts[:2]):
        mgr.admit(slot, len(prompt) + 8)
        blocks, reuse = mgr.match_prefix(prompt)
        if blocks:
            mgr.adopt_prefix(slot, blocks)
        mgr.ensure_capacity(slot, len(prompt))
        mgr.register_prefix(slot, prompt)
        out.append((blocks, reuse))
    mgr.release(0)
    out.append(mgr.evictable_prefixes(8))
    mgr.release(1)
    cands = mgr.evictable_prefixes(8)
    out.append(cands)
    out.append([mgr.drop_prefix(d) for d, _, _ in cands[:2]])
    out.append(mgr.drop_prefix(b"\x00" * 16))
    chain = mgr.chain_digests(prompts[0])
    # re-install the dropped tail of the first chain, then a broken link
    missing = [(d, chain[i - 1] if i else b"") for i, d in enumerate(chain)
               if not mgr.prefix_has(d)]
    out.append(missing)
    out.append(mgr.install_prefix_chain(missing))
    out.append(mgr.install_prefix_chain([(b"\x01" * 16, b"\x02" * 16)]))
    # pool pressure: a slot big enough to evict cached leaves organically
    mgr.admit(2, 8 * 16)
    mgr.ensure_capacity(2, 8 * 16)
    out.append(mgr.stats())
    out.append(mgr.evictable_prefixes(8))
    return out


def test_block_manager_tier_hooks_match_jax():
    layout = dict(block_size=16, num_blocks=11, max_blocks_per_slot=8)
    jax_evicted, port_evicted = [], []
    want = _hook_script(JaxBlockManager(JaxPagedLayout(**layout), 3), jax_evicted)
    got = _hook_script(BlockManager(PagedLayout(**layout), 3), port_evicted)
    assert got == want
    assert port_evicted == jax_evicted and port_evicted  # pressure evicted some


# --------------------------------------------------------------------------
# engines: JAX <-> port handoffs on the tiny f32 model
# --------------------------------------------------------------------------

DISAGG = {"model": "tiny", "slots": 2, "max-seq-len": 128, "decode-chunk": 4,
          "model-dtype": "float32", "kv-layout": "paged", "kv-block-size": 16,
          "kv-pool-blocks": 24, "prefix-cache": False}
PROMPTS = ["disaggregated serving byte identity prompt",
           "int8 rows travel verbatim over the handoff"]
OPTS = {"max-tokens": 12, "temperature": 0}


def _port(cfg: dict, params) -> TorchServingEngine:
    return TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu", params=params)


async def _handoff(pre, dec, prompt: str) -> dict:
    ticket = await pre.generate(prompt, dict(OPTS))
    assert ticket["finish_reason"] == "handoff" and len(ticket["tokens"]) == 1
    payload = pre.take_export(ticket["handoff"])
    assert payload is not None and pre.take_export(ticket["handoff"]) is None
    return await dec.import_handoff(payload)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32-kv", "int8-kv"])
def test_handoffs_cross_packages_with_jax_combined_tokens(kv):
    """JAX prefill -> port decode and port prefill -> JAX decode give the
    JAX combined engine's greedy tokens and text."""
    cfg = {**DISAGG, "kv-quantize": kv}

    async def jax_side():
        combined = TpuServingEngine(JaxServingConfig.from_dict(cfg))
        pre = TpuServingEngine(JaxServingConfig.from_dict({**cfg, "pool-role": "prefill"}))
        try:
            base = [await combined.generate(p, dict(OPTS)) for p in PROMPTS]
            tickets = [await pre.generate(p, dict(OPTS)) for p in PROMPTS]
            payloads = [pre.take_export(t["handoff"]) for t in tickets]
            return flatten_jax_params(combined.params), base, payloads
        finally:
            await combined.close()
            await pre.close()

    flat, base, jax_payloads = asyncio.run(jax_side())
    params = params_from_numpy(flat, device="cpu", dtype=torch.float32)

    async def port_side():
        pre = _port({**cfg, "pool-role": "prefill"}, params)
        dec = _port({**cfg, "pool-role": "decode"}, params)
        try:
            imported = [await dec.import_handoff(p) for p in jax_payloads]
            tickets = [await pre.generate(p, dict(OPTS)) for p in PROMPTS]
            assert pre.stats()["kvtransfer"]["exports"] == len(PROMPTS)
            assert pre.stats()["attribution"]["memory"]["hbm_bytes_by_owner"]["in-transit"] > 0
            payloads = [pre.take_export(t["handoff"]) for t in tickets]
            assert pre.stats()["kvtransfer"]["in_transit_bytes"] == 0
            assert dec.stats()["kvtransfer"]["imports"] == len(PROMPTS)
            assert all(t.get("imported") == 1.0 for t in dec.request_timings)
            return imported, payloads
        finally:
            await pre.close()
            await dec.close()

    from_jax, port_payloads = asyncio.run(port_side())
    # the port's payload headers and rows are the JAX prefill pool's, but
    # for the per-request timings and the journey id (no journey plane in
    # the port); logprobs and rows agree to f32 rounding
    for ours, theirs in zip(port_payloads, jax_payloads):
        h1, a1 = kvtransfer.deserialize_handoff(ours)
        h2, a2 = kvtransfer.deserialize_handoff(theirs)
        np.testing.assert_allclose(h1.pop("logprobs"), h2.pop("logprobs"), atol=1e-5)
        for h in (h1, h2):
            h.pop("timings"), h.pop("arrays"), h.pop("journey")
        assert h1 == h2
        for name in a2:
            np.testing.assert_allclose(a1[name].numpy(), a2[name].numpy(), atol=1e-5)

    async def jax_decode():
        dec = TpuServingEngine(JaxServingConfig.from_dict({**cfg, "pool-role": "decode"}))
        try:
            return [await dec.import_handoff(p) for p in port_payloads]
        finally:
            await dec.close()

    from_port = asyncio.run(jax_decode())
    for want, a, b in zip(base, from_jax, from_port):
        assert a["tokens"] == b["tokens"] == want["tokens"]
        assert a["text"] == b["text"] == want["text"]


@pytest.mark.parametrize("dtype,kv", [("float32", None), ("float32", "int8"),
                                      ("bfloat16", None)],
                         ids=["f32", "int8-kv", "bf16"])
def test_port_disaggregated_equals_port_combined(dtype, kv):
    """Within the port, every pool dtype through the wire (bf16 rows as raw
    words): the decode pool's greedy tokens equal the combined engine's,
    with kv-export/kv-import events carrying the payload's bytes."""
    cfg = {**DISAGG, "model-dtype": dtype, "kv-quantize": kv}

    async def main():
        combined = _port(cfg, None)
        base = [await combined.generate(p, dict(OPTS)) for p in PROMPTS]
        await combined.close()
        pre = _port({**cfg, "pool-role": "prefill"}, None)
        dec = _port({**cfg, "pool-role": "decode"}, None)
        try:
            for want, prompt in zip(base, PROMPTS):
                got = await _handoff(pre, dec, prompt)
                assert got["tokens"] == want["tokens"] and got["text"] == want["text"]
            exports = [e for e in pre.flight.recent_events(0) if e["kind"] == "kv-export"]
            imports = [e for e in dec.flight.recent_events(0) if e["kind"] == "kv-import"]
            assert [e["bytes"] for e in exports] == [e["bytes"] for e in imports]
            assert all(e["blocks"] >= 1 and e["ms"] >= 0 for e in exports + imports)
            assert pre.kv_fingerprint()["dtype"] == dtype
            assert pre.stats()["kv"]["reserved_blocks"] == 0
        finally:
            await pre.close()
            await dec.close()
        assert dec.stats()["kv"]["reserved_blocks"] == 0

    asyncio.run(main())


def test_fingerprint_mismatch_refused_on_import():
    async def main():
        pre = _port({**DISAGG, "pool-role": "prefill"}, None)
        other = _port({**DISAGG, "pool-role": "decode", "kv-block-size": 32,
                       "kv-pool-blocks": 12}, None)
        try:
            ticket = await pre.generate("mismatch probe", {"max-tokens": 4})
            payload = pre.take_export(ticket["handoff"])
            with pytest.raises(LayoutMismatch, match="kv-block-size"):
                await other.import_handoff(payload)
            with pytest.raises(LayoutMismatch, match="prefill-role"):
                await pre.import_handoff(payload)
            with pytest.raises(LayoutMismatch, match="magic"):
                await other.import_handoff(b"not a handoff")
            assert other.stats()["kvtransfer"]["imports"] == 0
        finally:
            await pre.close()
            await other.close()

    asyncio.run(main())


def test_full_decode_pool_sheds_explicitly_and_retry_lands():
    """A decode pool that cannot reserve an import's worst case refuses it
    with ``RateLimited`` and a retry hint; the same payload lands once the
    first import finished."""
    async def main():
        pre = _port({**DISAGG, "pool-role": "prefill"}, None)
        dec = _port({**DISAGG, "pool-role": "decode", "kv-pool-blocks": 9, "slots": 1}, None)
        try:
            tickets = [await pre.generate(p, {"max-tokens": 100}) for p in
                       ("capacity probe one", "capacity probe two")]
            p1, p2 = (pre.take_export(t["handoff"]) for t in tickets)
            # both queue before the loop's next pass: the first takes the
            # only slot and most blocks, the second finds no room
            first = asyncio.ensure_future(dec.import_handoff(p1))
            second = asyncio.ensure_future(dec.import_handoff(p2))
            with pytest.raises(RateLimited) as exc:
                await second
            assert exc.value.retry_after > 0
            assert exc.value.reason in ("kv-import-capacity", "no-free-slot")
            assert dec.stats()["kvtransfer"]["import_sheds"] == 1
            assert (await first)["tokens"]
            retried = await dec.import_handoff(p2)  # the pool has room again
            assert len(retried["tokens"]) > 1
            assert dec.stats()["kvtransfer"]["imports"] == 2
        finally:
            await pre.close()
            await dec.close()

    asyncio.run(main())


def test_pool_role_config_and_validation(monkeypatch):
    assert ServingConfig.from_dict({**DISAGG, "pool-role": "prefill"}).pool_role == "prefill"
    assert ServingConfig.from_dict({"model": "tiny"}).pool_role == "combined"
    monkeypatch.setenv("LS_POOL_ROLE", "decode")
    assert ServingConfig.from_dict({"model": "tiny"}).pool_role == "decode"
    monkeypatch.delenv("LS_POOL_ROLE")
    with pytest.raises(ValueError, match="pool_role"):
        TorchServingEngine(ServingConfig.from_dict({**DISAGG, "pool-role": "both"}),
                           device="cpu")
    with pytest.raises(ValueError, match="paged"):
        TorchServingEngine(ServingConfig(model="tiny", slots=2, max_seq_len=64,
                                         kv_layout="dense", pool_role="prefill"),
                           device="cpu")


def test_export_cap_drops_the_oldest_loudly(monkeypatch):
    monkeypatch.setenv("LS_TPU_KV_EXPORT_CAP", "8")

    async def main():
        pre = _port({**DISAGG, "pool-role": "prefill"}, None)
        try:
            tickets = [await pre.generate(f"export number {i}", {"max-tokens": 4})
                       for i in range(9)]
            st = pre.stats()["kvtransfer"]
            assert st["exports"] == 9 and st["exports_evicted"] == 1
            assert st["pending_exports"] == 8
            assert pre.take_export(tickets[0]["handoff"]) is None  # the lost one
            dropped = [e for e in pre.flight.recent_events(0)
                       if e["kind"] == "kv-export-dropped"]
            assert [e["request"] for e in dropped] == [tickets[0]["handoff"]]
            assert st["in_transit_bytes"] == sum(
                e["bytes"] for e in pre._exports.values())
        finally:
            await pre.close()

    asyncio.run(main())
