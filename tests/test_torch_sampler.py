"""The port's sampler against the JAX package's.

Greedy choices, penalties and the filtered distribution must match the JAX
package exactly on the same logits. Random draws come from different RNGs
(``torch.Generator`` vs ``jax.random``), so sampled tokens are held to the
filtered distribution by frequency instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.serving.sampler import (
    filtered_logits as jax_filtered,
    sample_tokens as jax_sample,
)
from langstream_tpu_torch.serving.sampler import filtered_logits, sample_tokens


def _logits(B=4, V=384, seed=0):
    return np.random.default_rng(seed).standard_normal((B, V), dtype=np.float32) * 3


def test_greedy_matches_jax():
    logits = _logits()
    B = logits.shape[0]
    tj, lj = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0), jnp.zeros(B),
                        jnp.zeros(B, jnp.int32), all_greedy=True)
    tt, lt = sample_tokens(torch.from_numpy(logits), None, torch.zeros(B),
                           torch.zeros(B, dtype=torch.int32), all_greedy=True)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6, atol=1e-6)


def test_greedy_rows_inside_a_sampled_batch():
    """temperature 0 rows take the argmax even when others sample."""
    logits = _logits()
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7])
    tt, _ = sample_tokens(torch.from_numpy(logits), torch.Generator().manual_seed(1),
                          temps, torch.zeros(4, dtype=torch.int32), use_top_k=False)
    am = logits.argmax(-1)
    assert tt[0] == am[0] and tt[2] == am[2]


@pytest.mark.parametrize(
    "use_top_k,use_top_p",
    [(True, False), (False, True), (True, True)],
)
def test_filtered_logits_match_jax(use_top_k, use_top_p):
    logits = _logits(seed=1)
    temps = np.array([0.5, 1.0, 1.3, 0.0], np.float32)
    topks = np.array([5, 0, 64, 1], np.int32)
    topps = np.array([0.9, 0.5, 1.0, 0.3], np.float32)
    want = jax_filtered(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
                        use_top_p=use_top_p, top_ps=jnp.asarray(topps),
                        use_top_k=use_top_k)
    got = filtered_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                          torch.from_numpy(topks), use_top_p=use_top_p,
                          top_ps=torch.from_numpy(topps), use_top_k=use_top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_penalties_match_jax():
    logits = _logits(seed=2)
    B, V = logits.shape
    counts = np.random.default_rng(3).integers(0, 3, (B, V)).astype(np.int32)
    pres = np.array([0.0, 0.5, 1.5, 2.0], np.float32)
    freq = np.array([0.0, 0.3, 0.0, 1.0], np.float32)
    common = dict(all_greedy=True, use_penalties=True)
    tj, lj = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0), jnp.zeros(B),
                        jnp.zeros(B, jnp.int32), presences=jnp.asarray(pres),
                        frequencies=jnp.asarray(freq), counts=jnp.asarray(counts),
                        **common)
    tt, lt = sample_tokens(torch.from_numpy(logits), None, torch.zeros(B),
                           torch.zeros(B, dtype=torch.int32),
                           presences=torch.from_numpy(pres),
                           frequencies=torch.from_numpy(freq),
                           counts=torch.from_numpy(counts), **common)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8)])
def test_temperature_sampling_frequencies(top_k, top_p):
    """20k draws of one row against softmax(filtered_logits): the empirical
    frequencies agree within 0.01 everywhere, and nothing outside the
    filter is ever drawn."""
    V, N = 80, 20000  # V >= 64: the top-k window
    row = np.linspace(-2.0, 2.0, V, dtype=np.float32)
    logits = torch.from_numpy(np.tile(row, (N, 1)))
    temps = torch.full((N,), 0.8)
    topks = torch.full((N,), top_k, dtype=torch.int32)
    topps = torch.full((N,), top_p)
    kw = dict(use_top_k=top_k > 0, use_top_p=top_p < 1.0)
    tokens, lps = sample_tokens(logits, torch.Generator().manual_seed(4), temps, topks,
                                top_ps=topps, **kw)
    expected = torch.softmax(
        filtered_logits(logits[:1], temps[:1], topks[:1], top_ps=topps[:1], **kw), -1
    )[0].numpy()
    # the JAX package defines the same distribution
    want = jax.nn.softmax(jax_filtered(
        jnp.asarray(row[None]), jnp.asarray([0.8]), jnp.asarray([top_k], jnp.int32),
        top_ps=jnp.asarray([top_p]), **kw), -1)[0]
    np.testing.assert_allclose(expected, np.asarray(want), rtol=1e-5, atol=1e-7)
    freq = np.bincount(tokens.numpy(), minlength=V) / N
    assert np.abs(freq - expected).max() < 0.01
    assert (freq[expected == 0] == 0).all()
    # the returned logprob is the unfiltered model logprob of the drawn token
    np.testing.assert_allclose(
        lps.numpy(), torch.log_softmax(logits, -1)[torch.arange(N), tokens.long()].numpy(),
        rtol=1e-6,
    )
