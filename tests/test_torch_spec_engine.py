"""``TorchServingEngine`` with ``speculative-drafts``: ports of the engine
tests of ``tests/test_speculative.py`` and ``tests/test_fused_tail.py``.

The tiny f32 model on the CPU (the verify step's history read takes the
multi-query kernel's plain version here): greedy speculative streams equal
plain decode, sampled requests speculate, penalties fall back to plain
decode, every step is one dispatch and one packed fetch, and the
measured-uplift plane turns speculation off and on again.
"""

import asyncio
import dataclasses
from collections import deque

import pytest
import torch

from langstream_tpu_torch.models.llama import LlamaConfig, init_llama_params
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

BASE = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 256,
        "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16}
SPEC = {**BASE, "speculative-drafts": 4}
REPETITIVE = "the cat sat on the mat. " * 6


def _params(max_seq_len=256):
    c = dataclasses.replace(LlamaConfig.tiny(max_seq_len=max_seq_len), dtype=torch.float32)
    return init_llama_params(c, torch.Generator().manual_seed(3), device="cpu")


PARAMS = _params()


def _engine(cfg, params=PARAMS):
    return TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu", params=params)


def _gen(cfg, prompt, options, params=PARAMS):
    async def run():
        engine = _engine(cfg, params)
        try:
            out = await engine.generate(prompt, options)
        finally:
            # close() joins the loop: the ledger read below is the settled one
            await engine.close()
        return out, engine.stats()

    return asyncio.run(run())


@pytest.mark.parametrize("kv", [{}, {"kv-quantize": "int8"}], ids=["f32-pool", "int8-pool"])
def test_speculative_stream_identical_and_accepts(kv):
    r0, _ = _gen({**BASE, **kv}, REPETITIVE, {"max-tokens": 24})
    r1, stats = _gen({**SPEC, **kv}, REPETITIVE, {"max-tokens": 24})
    assert r1["tokens"] == r0["tokens"] and r1["text"] == r0["text"]
    spec = stats["speculative"]
    assert spec["steps"] > 0 and spec["drafts_accepted"] > 0
    assert spec["steps"] < 24  # fewer forwards than tokens
    assert stats["kernels"]["paged_attention_multiquery"] == 0  # plain on CPU


def test_spec_fetches_track_dispatches_one_to_one():
    """One dispatch and one packed fetch per draft+verify step."""
    _, stats = _gen(SPEC, REPETITIVE, {"max-tokens": 24})
    spec = stats["speculative"]
    assert spec["steps"] >= 2
    assert spec["dispatches"] == spec["steps"] == spec["fetches"]


def test_speculative_sampled_requests_speculate():
    """Sampled requests speculate too (rejection sampling against the
    filtered target)."""
    r, stats = _gen(SPEC, REPETITIVE, {"max-tokens": 12, "temperature": 0.8, "top-k": 20})
    assert 0 < len(r["tokens"]) <= 12
    assert stats["speculative"]["steps"] > 0


def test_speculative_penalty_requests_fall_back():
    """Presence/frequency penalties change the distribution per emitted
    token and the verify step keeps no counts: plain decode serves them."""
    r, stats = _gen(SPEC, REPETITIVE,
                    {"max-tokens": 8, "temperature": 0.8, "presence-penalty": 0.5})
    assert len(r["tokens"]) > 0
    assert stats["speculative"]["steps"] == 0
    assert stats["decode-chunks"]["dispatched"] > 0


def test_speculative_concurrent_requests_complete():
    """More requests than slots, all at once: each gets its tokens and its
    plain greedy stream."""
    prompts = [REPETITIVE + f" q{i}" for i in range(6)]

    async def run(cfg):
        engine = _engine(cfg)
        try:
            return await asyncio.gather(*(engine.generate(p, {"max-tokens": 10})
                                          for p in prompts)), engine.stats()
        finally:
            await engine.close()

    spec, stats = asyncio.run(run(SPEC))
    plain, _ = asyncio.run(run(BASE))
    assert all(len(o["tokens"]) == 10 for o in spec)
    assert [o["tokens"] for o in spec] == [o["tokens"] for o in plain]
    assert stats["speculative"]["steps"] > 0 and stats["completed"] == 6


def test_speculative_with_chunked_prefill_and_prefix_cache():
    """A long prompt chunk-prefills while another slot decodes
    speculatively: the verify commits must not touch the mid-prefill slot's
    blocks (inactive rows go to scratch). Both streams start as a plain
    engine's."""
    short = REPETITIVE
    long_ = "copy this exact phrase again and again. " * 24
    params = _params(2048)

    def run(spec, chunk):
        async def main():
            engine = _engine({**BASE, "max-seq-len": 2048, "decode-chunk": 2,
                              "speculative-drafts": spec, "prefill-chunk": chunk,
                              "prefix-cache": True}, params)
            try:
                short_task = asyncio.ensure_future(engine.generate(short, {"max-tokens": 24}))
                await asyncio.sleep(0.05)  # the short request starts decoding
                long_out = await engine.generate(long_, {"max-tokens": 12})
                short_out = await short_task
                return short_out["tokens"], long_out["tokens"], engine.stats()
            finally:
                await engine.close()

        return asyncio.run(main())

    plain = run(0, 0)
    combined = run(4, 64)
    # the first 8 tokens, as the JAX test: the long prompt's chunked prefill
    # sums in another order than its one-shot prefill
    assert combined[0][:8] == plain[0][:8]  # short stream unchanged
    assert combined[1][:8] == plain[1][:8]  # long stream unchanged
    stats = combined[2]
    assert stats["speculative"]["steps"] > 0 and stats["prefill-continue-calls"] > 0


def test_speculative_at_context_cap_matches_plain():
    """Near max_seq_len a verify wider than the remaining room must not
    write past the cap (write_rows' block clamp would overwrite committed
    rows of the slot's last block): the stream equals plain greedy decode up
    to the forced stop."""
    cfg = {**BASE, "slots": 2, "max-seq-len": 64, "decode-chunk": 2,
           "kv-pool-blocks": 12}
    params = _params(64)
    prompt = "the cat sat on the mat. the cat sat on the "
    r0, _ = _gen(cfg, prompt, {"max-tokens": 60}, params)
    r1, stats = _gen({**cfg, "speculative-drafts": 4}, prompt, {"max-tokens": 60}, params)
    assert r1["tokens"] == r0["tokens"]
    assert len(r1["tokens"]) + r1["num_prompt_tokens"] >= 62  # ran into the cap
    assert stats["speculative"]["steps"] > 0


def test_speculative_section_only_when_configured():
    _, stats = _gen(BASE, "hello", {"max-tokens": 3})
    assert "speculative" not in stats
    _, stats = _gen(SPEC, "hello", {"max-tokens": 3})
    assert set(stats["speculative"]) == {
        "steps", "drafts_accepted", "rejected", "dispatches", "fetches", "uplift",
        "auto_disabled", "flips", "window_steps", "window_plain"}


# ---------------------------------------------------------------------------
# measured-uplift auto-disable
# ---------------------------------------------------------------------------


def test_spec_auto_disable_on_measured_uplift_below_one():
    """Port of ``tests/test_fused_tail.py::
    test_spec_auto_disable_on_measured_uplift_below_one``: no verdict until
    the window is full and a plain sample exists; uplift 0.5 turns
    speculation off and clears the windows; after ``_spec_retry_plain``
    plain decode chunks it turns on again with a calibration due at once."""

    async def main():
        engine = _engine(SPEC)
        try:
            assert (engine._spec_window.maxlen, engine._spec_cal_every,
                    engine._spec_retry_plain) == (32, 32, 256)  # the JAX defaults
            engine._spec_note_step(4, 1.0)
            assert engine._spec_uplift() is None
            assert engine._spec_check_uplift() is False
            for _ in range(engine._spec_window.maxlen):
                engine._spec_note_step(4, 1.0)    # speculative: 4 tok/s
            assert engine._spec_uplift() is None  # still no plain sample
            engine._spec_note_plain(8, 1.0)       # plain: 8 tok/s, uplift 0.5
            assert engine._spec_check_uplift() is True
            assert engine._spec_auto_disabled is True
            assert engine._spec_last_uplift == pytest.approx(0.5)
            assert not engine._spec_window and not engine._plain_window
            spec = engine.stats()["speculative"]
            assert spec["auto_disabled"] is True and spec["flips"] == 1
            assert spec["uplift"] == pytest.approx(0.5)
            assert not engine._speculating([0])
            for _ in range(engine._spec_retry_plain):
                engine._spec_count_plain_chunk()
            assert engine._spec_auto_disabled is False
            assert engine._spec_cal_due() is True  # recalibrate at once
            assert engine.stats()["speculative"]["flips"] == 2
        finally:
            await engine.close()

    asyncio.run(main())


def test_spec_uplift_at_or_above_one_keeps_speculating():
    """uplift >= 1 records the verdict and flips nothing."""

    async def main():
        engine = _engine(SPEC)
        try:
            for _ in range(engine._spec_window.maxlen):
                engine._spec_note_step(12, 1.0)   # speculative: 12 tok/s
            engine._spec_note_plain(8, 1.0)       # plain: 8 tok/s, uplift 1.5
            assert engine._spec_check_uplift() is False
            assert engine._spec_auto_disabled is False
            assert engine._spec_last_uplift == pytest.approx(1.5)
            assert len(engine._spec_window) == engine._spec_window.maxlen
            assert engine.stats()["speculative"]["flips"] == 0
        finally:
            await engine.close()

    asyncio.run(main())


def test_spec_uplift_reads_the_environment(monkeypatch):
    monkeypatch.setenv("LS_TPU_SPEC_UPLIFT_WINDOW", "5")
    monkeypatch.setenv("LS_TPU_SPEC_CALIBRATE_EVERY", "7")
    monkeypatch.setenv("LS_TPU_SPEC_RETRY_CHUNKS", "9")

    async def main():
        engine = _engine(SPEC)
        try:
            return (engine._spec_window.maxlen, engine._plain_window.maxlen,
                    engine._spec_cal_every, engine._spec_retry_plain)
        finally:
            await engine.close()

    assert asyncio.run(main()) == (5, 5, 7, 9)


def test_spec_auto_disable_in_the_loop_keeps_the_stream(monkeypatch):
    """Driven through generate(): calibration chunks every 2 steps over a
    window of 2, with plain chunks made to look far faster, turn speculation
    off inside the burst; plain decode takes over and, after one plain
    chunk, speculation re-auditions. The stream equals plain decode."""
    monkeypatch.setenv("LS_TPU_SPEC_UPLIFT_WINDOW", "2")
    monkeypatch.setenv("LS_TPU_SPEC_CALIBRATE_EVERY", "2")
    monkeypatch.setenv("LS_TPU_SPEC_RETRY_CHUNKS", "1")
    r0, _ = _gen(BASE, REPETITIVE, {"max-tokens": 40})

    async def main():
        engine = _engine(SPEC)
        real = engine._spec_note_plain
        engine._spec_note_plain = lambda tokens, wall_s: real(tokens * 1000, wall_s)
        try:
            return await engine.generate(REPETITIVE, {"max-tokens": 40}), engine.stats()
        finally:
            await engine.close()

    r1, stats = asyncio.run(main())
    assert r1["tokens"] == r0["tokens"]
    spec = stats["speculative"]
    assert spec["flips"] >= 2  # off, then on again
    assert spec["uplift"] is not None and spec["uplift"] < 1.0
    assert spec["dispatches"] == spec["fetches"] == spec["steps"] > 0
    assert stats["decode-chunks"]["dispatched"] >= 2  # calibration + plain chunks


def test_ctx_ledger_resets_on_release():
    """The device context rows are re-synced from the host for a slot's new
    request: release zeroes the ledger, so a second request in the same slot
    drafts from its own tokens (its stream equals plain decode)."""
    prompts = [REPETITIVE, "a different prompt, a different prompt, a different"]

    async def run(cfg):
        engine = _engine({**cfg, "slots": 2})  # each request lands in slot 0
        try:
            outs = [await engine.generate(p, {"max-tokens": 16}) for p in prompts]
            return [o["tokens"] for o in outs], engine
        finally:
            await engine.close()

    spec, engine = asyncio.run(run(SPEC))
    plain, _ = asyncio.run(run(BASE))
    assert spec == plain
    assert int(engine._ctx_synced[0]) == 0


def test_deque_windows_are_bounded():
    engine = _engine(SPEC)
    try:
        assert isinstance(engine._spec_window, deque)
        for _ in range(100):
            engine._spec_note_step(1, 1.0)
            engine._spec_note_plain(1, 1.0)
            engine._spec_note_step(0, 1.0)   # empty samples are dropped
        assert len(engine._spec_window) == len(engine._plain_window) == 32
    finally:
        asyncio.run(engine.close())
