"""The port's Mixtral family (``langstream_tpu_torch/models/moe.py`` and its
quantizer, loader and converter) against the JAX package's.

Inputs come from a numpy seed and go through both packages
(``JAX_PLATFORMS=cpu``): top-2 gating (dispatch identical, combine and aux
within 1e-6; the index form the main path runs equal to the one-hot form),
the routed FFN (1e-5 in f32, 3e-2 in bf16, int8 experts through
``QTensor``), the forward, the FFN hook on the prompt forward, parameter
layouts, and the HF golden fixture ``tests/fixtures/moe_tiny_golden``
(logits within 2e-3, greedy continuations equal).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import checkpoints as jck
from langstream_tpu.models import llama as jl
from langstream_tpu.models import moe as jm
from langstream_tpu.models import quant as jq
from langstream_tpu_torch.models import checkpoints as tck
from langstream_tpu_torch.models import llama as tl
from langstream_tpu_torch.models import moe as tm
from langstream_tpu_torch.models import quant as tq
from langstream_tpu_torch.models.convert import params_from_numpy
from test_torch_checkpoints import _assert_trees_equal, _flat
from test_torch_engine import flatten_jax_params

FIXTURES = Path(__file__).parent / "fixtures" / "moe_tiny_golden"
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    return jnp.asarray(a, dtype=dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, dtype=jnp.float32))


def _dense_from_index(experts, slots, weights, B, S, E, C):
    """The one-hot (dispatch, combine) the index form stands for."""
    combine = torch.zeros((B * S, E, C + 1), dtype=torch.float32)
    rows = torch.arange(B * S)[:, None].expand(-1, 2)
    combine.index_put_((rows, experts, slots), weights, accumulate=True)
    combine = combine[..., :C].reshape(B, S, E, C)
    return combine > 0.0, combine


# ---------------------------------------------------------------------------
# top-2 gating
# ---------------------------------------------------------------------------

GATING = [  # (B, S, E, capacity, with a valid mask, whether choices drop)
    (1, 16, 4, 3, False, True),
    (3, 1, 4, 2, False, False),  # decode at 3 slots on moe-tiny: capacity 2
    (6, 1, 4, 2, True, True),
    (4, 8, 8, 5, True, True),
    (2, 32, 8, 64, False, False),
    (8, 1, 8, 1, True, True),
]


@pytest.mark.parametrize("B,S,E,C,masked,drops", GATING)
def test_top2_gating_matches_jax_and_index_form(B, S, E, C, masked, drops):
    rng = np.random.default_rng(B * 100 + S * 10 + E)
    logits = rng.standard_normal((B, S, E)).astype(np.float32) * 2.0
    valid = rng.random((B, S)) < 0.85 if masked else None
    want_d, want_c, want_aux = jm.top2_gating(
        _j(logits), C, valid=None if valid is None else _j(valid))
    got_d, got_c, got_aux = tm.top2_gating(
        _t(logits), C, valid=None if valid is None else _t(valid))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-6, atol=1e-6)
    # the index form the main path runs: the same dispatch and combine
    flat_valid = None if valid is None else _t(valid).reshape(-1)
    experts, slots, weights, aux = tm.top2_routing(
        _t(logits).reshape(B * S, E), C, valid=flat_valid)
    d, c = _dense_from_index(experts, slots, weights, B, S, E, C)
    np.testing.assert_array_equal(d.numpy(), got_d.numpy())
    np.testing.assert_allclose(c.numpy(), got_c.numpy(), rtol=1e-6, atol=1e-6)
    assert aux.item() == got_aux.item()
    # the case holds drops where it is meant to
    kept = int(got_d.sum())
    chosen = 2 * (B * S if valid is None else int(valid.sum()))
    assert (kept < chosen) == drops, (kept, chosen)


def test_routing_takes_the_first_index_on_ties():
    """argmax's first index, as jnp.argmax: equal logits pick experts 0 and 1."""
    logits = np.zeros((1, 3, 4), np.float32)
    logits[0, 1, 2:] = 1.0
    experts, _, weights, _ = tm.top2_routing(_t(logits).reshape(3, 4), 6)
    assert experts.tolist() == [[0, 1], [2, 3], [0, 1]]
    np.testing.assert_allclose(weights.numpy(), 0.5, atol=1e-6)
    want_d, _, _ = jm.top2_gating(_j(logits), 6)
    got_d, _, _ = tm.top2_gating(_t(logits), 6)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


# ---------------------------------------------------------------------------
# the routed FFN
# ---------------------------------------------------------------------------


def _ffn_inputs(rng, B, S, H=64, E=4, I=128):
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    router = (rng.standard_normal((H, E)) / np.sqrt(H)).astype(np.float32)
    ws = [(rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
          for shape in ((E, H, I), (E, H, I), (E, I, H))]
    return x, router, ws


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,S,masked", [(5, 1, True), (3, 12, True), (2, 16, False)])
def test_moe_ffn_matches_jax(dtype, tol, B, S, masked):
    rng = np.random.default_rng(7 * B + S)
    x, router, ws = _ffn_inputs(rng, B, S)
    valid = rng.random((B, S)) < 0.75 if masked else None
    C = max(1, (B * S) // 3)  # well under the 2.5 * B*S / E of a drop-free batch
    jd = JAX_DTYPES[dtype]
    want, want_aux = jm.moe_ffn(
        _j(x, jd), _j(router), *(_j(w, jd) for w in ws), C,
        valid=None if valid is None else _j(valid))
    args = (_t(x, dtype), _t(router), *(_t(w, dtype) for w in ws), C)
    kw = {"valid": None if valid is None else _t(valid)}
    got, got_aux = tm.moe_ffn(*args, **kw)
    assert got.dtype == dtype and got.shape == (B, S, 64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-6, atol=1e-6)
    # index form against the one-hot plain version
    ref, ref_aux = tm.moe_ffn_reference(*args, **kw)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    assert got_aux.item() == ref_aux.item()
    if valid is not None:  # invalid positions get nothing from the experts
        assert not got[~_t(valid)].any()


@pytest.mark.parametrize("decode", [True, False], ids=["decode", "prefill"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_moe_serving_ffn_matches_jax(decode, int8):
    """The hook on (B, H) decode activations with a (B,) active mask, or on
    (B, S, H) prefill activations with a (B, S) mask; capacity from the
    padded batch (drops at moe-tiny's factor 1.25); int8 experts through
    QTensor on both sides."""
    jc = dataclasses.replace(jm.MoEConfig.tiny(), dtype=jnp.float32)
    tc = dataclasses.replace(tm.MoEConfig.tiny(), dtype=torch.float32)
    rng = np.random.default_rng(11 if decode else 12)
    shape = (6, 64) if decode else (3, 10, 64)
    x = rng.standard_normal(shape).astype(np.float32)
    valid = rng.random(shape[:-1]) < 0.8
    _, router, ws = _ffn_inputs(rng, 1, 1)
    jlp = {"router": _j(router)}
    tlp = {"router": _t(router)}
    for name, w in zip(("w_gate", "w_up", "w_down"), ws):
        if int8:
            qt = jq.quantize_tensor(_j(w), axis=1)
            jlp[name] = qt
            tlp[name] = tq.QTensor(q=_t(np.asarray(qt.q)), s=_t(np.asarray(qt.s)),
                                   dtype=torch.float32)
        else:
            jlp[name], tlp[name] = _j(w), _t(w)
    want = jm.moe_serving_ffn(jc)(_j(x), jlp, _j(valid))
    got = tm.moe_serving_ffn(tc)(_t(x), tlp, _t(valid))
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# forwards on carried-across parameters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_params():
    """moe-tiny f32 params made by the JAX package, carried across."""
    import jax

    jc = dataclasses.replace(jm.MoEConfig.tiny(), dtype=jnp.float32)
    jp = jm.init_moe_params(jc, jax.random.PRNGKey(3))
    tc = dataclasses.replace(tm.MoEConfig.tiny(), dtype=torch.float32)
    tp = params_from_numpy(flatten_jax_params(jp), device="cpu", dtype=torch.float32)
    return jc, jp, tc, tp


def test_moe_forward_matches_jax(tiny_params):
    jc, jp, tc, tp = tiny_params
    tokens = np.random.default_rng(5).integers(0, 300, (3, 20))
    want, want_aux = jm.moe_forward(jc, jp, _j(tokens, jnp.int32))
    got, got_aux = tm.moe_forward(tc, tp, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-5, atol=1e-6)


def test_llama_forward_hook_gives_moe_forward(tiny_params):
    """``llama_forward`` with the routed FFN at the whole batch's capacity
    computes ``moe_forward`` (the same attention on the CPU)."""
    _, _, tc, tp = tiny_params
    tokens = _t(np.random.default_rng(6).integers(0, 300, (2, 24)))
    capacity = tc.capacity(tokens.numel())

    def ffn(h, lp, valid=None):
        return tm.moe_ffn(h, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
                          capacity, valid=valid)[0]

    want, _ = tm.moe_forward(tc, tp, tokens)
    np.testing.assert_allclose(tl.llama_forward(tc, tp, tokens, ffn=ffn).numpy(),
                               want.numpy(), rtol=1e-6, atol=1e-6)


def test_prefill_forward_hook_matches_jax(tiny_params):
    """The FFN hook on the shared prompt forward: right-padded rows, so the
    real-token mask decides which positions take capacity."""
    jc, jp, tc, tp = tiny_params
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 300, (4, 32))
    lengths = np.array([32, 5, 17, 1])
    want, wk, _ = jl.prefill_forward(jc, jp, _j(tokens, jnp.int32), _j(lengths),
                                     use_flash=False, ffn=jm.moe_serving_ffn(jc))
    got, gk, _ = tl.prefill_forward(tc, tp, _t(tokens), _t(lengths),
                                    ffn=tm.moe_serving_ffn(tc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    valid = np.arange(32)[None, :] < lengths[:, None]
    np.testing.assert_allclose(gk.numpy()[:, valid], np.asarray(wk)[:, valid],
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# parameter layouts
# ---------------------------------------------------------------------------


def _layout(tree):
    return {name: (tuple(a.shape), str(a.dtype).split(".")[-1])
            for name, a in _flat(tree)}


def test_q8_init_and_quantizer_match_jax_layouts():
    """Shapes, dtypes and scale axes: experts (L, E, in, out) with scales
    (L, E, 1, out); the router float32 and never quantized."""
    import jax

    jc, tc = jm.MoEConfig.tiny(), tm.MoEConfig.tiny()
    g = torch.Generator().manual_seed(0)
    want_init = _layout(jq.init_moe_params_q8(jc, jax.random.PRNGKey(0)))
    got_init = _layout(tq.init_moe_params_q8(tc, g, device="cpu"))
    assert got_init == want_init
    want_q = _layout(jq.quantize_moe_params(jm.init_moe_params(jc, jax.random.PRNGKey(0))))
    got_q = _layout(tq.quantize_moe_params(tm.init_moe_params(tc, g, device="cpu")))
    assert got_q == want_q == want_init
    assert got_q["layers.router."] == ((2, 64, 4), "float32")
    assert got_q["layers.w_down.s"] == ((2, 4, 1, 64), "float32")


def test_quantize_moe_params_matches_jax_values(tiny_params):
    _, jp, _, tp = tiny_params
    _assert_trees_equal(jq.quantize_moe_params(jp), tq.quantize_moe_params(tp))


def test_params_from_numpy_keeps_the_router_float32(tiny_params):
    _, jp, _, _ = tiny_params
    tp = params_from_numpy(flatten_jax_params(jp), device="cpu", dtype=torch.bfloat16)
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["w_gate"].dtype == tp["embed"].dtype == torch.bfloat16


def test_param_count_matches_jax():
    for name in ("tiny", "mixtral_8x7b"):
        jc, tc = getattr(jm.MoEConfig, name)(), getattr(tm.MoEConfig, name)()
        assert tm.moe_param_count(tc) == jm.moe_param_count(jc)
        assert tc.capacity(32) == jc.capacity(32) and tc.capacity(3) == jc.capacity(3)
    assert tm.MoEConfig.mixtral_8x7b().capacity(32) == 10


# ---------------------------------------------------------------------------
# the HF golden fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    g = np.load(FIXTURES / "golden.npz")
    # drop-free, as tests/test_golden_moe.py: HF routes every token
    tc = dataclasses.replace(tm.MoEConfig.tiny(128), dtype=torch.float32,
                             capacity_factor=8.0)
    return g, tc, tck.load_moe_checkpoint(str(FIXTURES), tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_loader_matches_jax_loader(dtype):
    jc = dataclasses.replace(jm.MoEConfig.tiny(128), dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(tm.MoEConfig.tiny(128), dtype=getattr(torch, dtype))
    got = tck.load_moe_checkpoint(str(FIXTURES), tc)
    _assert_trees_equal(jck.load_moe_checkpoint(str(FIXTURES), jc), got)
    assert got["layers"]["router"].dtype == torch.float32


@pytest.mark.parametrize("p", [0, 1])
def test_moe_forward_logits_match_golden(golden, p):
    g, tc, params = golden
    logits, _ = tm.moe_forward(tc, params, _t(g[f"prompt_{p}"][None, :]).long())
    np.testing.assert_allclose(logits[0].numpy(), g[f"logits_{p}"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("p", [0, 1])
def test_moe_greedy_continuation_matches_golden(golden, p):
    """Teacher-forced greedy continuation, a full forward per token as HF's
    generate reference."""
    g, tc, params = golden
    seq = [int(t) for t in g[f"prompt_{p}"]]
    for expected in (int(t) for t in g[f"greedy_{p}"]):
        logits, _ = tm.moe_forward(tc, params, torch.tensor([seq]))
        nxt = int(torch.argmax(logits[0, -1]))
        assert nxt == expected, (seq, nxt, expected)
        seq.append(nxt)
