"""``prefix-store`` and ``pool-role`` on a slice of two hosts: a 2 x 2 slice
(``LS_SLICE_HOSTS=2``, two pod processes of ``LOCAL_WORLD_SIZE=2`` ranks,
``chip_smoke.py --q2-pod`` as in ``tests/test_torch_launch.py``) through the
port's pod seam, against the JAX engine under the same mesh on the 8
virtual CPU devices, ``tiny`` f32 on the HF fixture at ``{dp: 2, tp: 2}``.

The ordinal-0 pod's engine leads all four ranks; the other pod and both
pods' started ranks replay its dispatches and its tier moves (the lockstep
``kv_gather`` and ``kv_scatter`` frames), as on one host.

- Prefix tiers: a cold request, its blocks demoted to T2 through T1, the
  request again (promotion): both streams equal the JAX engine's, the
  tier counters equal its counters, and on each of the four ranks every
  demoted block's rows came back byte for byte
  (``LS_TORCH_TIER_DIGESTS``), every rank counting the same moves.
- Pool roles across packages: the slice as a ``pool-role: prefill`` pool
  whose LSKV exports a JAX decode pool decodes, and the slice as a
  ``pool-role: decode`` pool importing the JAX prefill pool's exports; the
  tokens equal the JAX combined engine's, the slice's exports hold the
  JAX exports' rows under an equal fingerprint, every rank replays each
  gather or scatter.

``adapter-store`` on a slice stays refused
(``tests/test_torch_mesh_stores.py``).
"""

import json
import os
import subprocess
import sys

import pytest

from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.serving.engine import TorchServingEngine
from test_torch_lockstep import REPO, free_port
from test_torch_mesh_stores import (OPTS, PAGED, PROMPT, PROMPTS, _combined, _decode,
                                    _first_and_warm, _jax, _prefill, _same_payloads, _store)

SLICE = {**PAGED, "seed": 0, "mesh": {"dp": 2, "tp": 2}}


@pytest.fixture(autouse=True)
def _reset():
    yield
    TorchServingEngine.reset_instances()
    TpuServingEngine.reset_instances()


def run_slice(tmp_path, resource: dict, prompts: list, scenario: str,
              payloads: list[bytes] | None = None, **env: str) -> tuple[dict, dict]:
    """Two pod processes of a 2 x 2 slice driving ``scenario`` on
    ``resource``; the leader pod's and the follower pod's reports, after
    every pod exited 0."""
    coordinator, lockstep = f"127.0.0.1:{free_port()}", free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "LS_SLICE_HOSTS": "2",
           "LOCAL_WORLD_SIZE": "2", "LS_COORDINATOR_ADDRESS": coordinator,
           "LS_LOCKSTEP_PORT": str(lockstep), "LS_LOCKSTEP_TOKEN": "slice-token",
           "LS_TORCH_COLLECTIVE_TIMEOUT_S": "60", **env}
    env.pop("JAX_PLATFORMS", None)
    extra = []
    if payloads is not None:
        path = tmp_path / "payloads.json"
        path.write_text(json.dumps([p.hex() for p in payloads]))
        extra = [str(path)]
    pods = []
    for name in ("q-0", "q-1"):
        out = tmp_path / f"{name}.json"
        with open(tmp_path / f"{name}.log", "wb") as log:  # a file, not a pipe
            pods.append((subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--q2-pod", json.dumps(resource),
                 json.dumps(prompts), str(OPTS["max-tokens"]), "cpu", str(out), scenario,
                 *extra], cwd=REPO, env={**env, "LS_POD_NAME": name},
                stdout=subprocess.DEVNULL, stderr=log), out, tmp_path / f"{name}.log"))
    try:
        for proc, _, log in pods:
            proc.wait(timeout=180)
            assert proc.returncode == 0, log.read_text(errors="replace")[-3000:]
    finally:
        for proc, _, _ in pods:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    leader, follower = (json.loads(out.read_text()) for _, out, _ in pods)
    assert leader["mesh"]["world-size"] == 4 and leader["mesh"]["rank"] == 0
    children = leader["launched"]["children"] + follower["launched"]["children"]
    dispatches = leader["mesh"]["lockstep-dispatches"]
    assert [(c["rank"], c["exit-code"], c["replayed"]) for c in children] == [
        (1, 0, dispatches), (3, 0, dispatches)]
    assert follower["replayed"] == dispatches
    return leader, follower


def _ranks(leader: dict, follower: dict) -> list[dict]:
    """The four ranks' mesh sections, in rank order."""
    return [leader["mesh"], leader["launched"]["children"][0]["mesh"][0],
            follower["mesh"][0], follower["launched"]["children"][0]["mesh"][0]]


def test_prefix_tiers_on_a_slice_give_the_jax_engines_tokens(tmp_path):
    """Cold, demoted to T2 through T1, promoted back: the JAX engine's
    streams and tier counters at ``{dp: 2, tp: 2}``; each rank's promoted
    rows byte-equal to its demoted ones."""
    cfg = {**SLICE, "prefix-cache": True}
    (jax_tokens, _), (jax_warm, _), jax_st = _jax(
        {**cfg, "prefix-store": _store(tmp_path / "jax-t2")}, _first_and_warm)
    leader, follower = run_slice(tmp_path, {**cfg, "prefix-store": _store(tmp_path / "t2")},
                                 [PROMPT], "tiers", LS_TORCH_TIER_DIGESTS="1")
    assert leader["tokens"] == leader["warm"]["tokens"] == [jax_tokens] == [jax_warm]
    st = leader["stats"]
    for key in ("demotions_t0_t1", "demotions_t1_t2", "promotions"):
        assert st[key] == jax_st[key] >= 1, key
    moves = leader["mesh"]["tier-moves"]
    assert moves["kv_gather"] >= 1 and moves["kv_scatter"] >= 1
    for rank, mesh in enumerate(_ranks(leader, follower)):
        assert mesh["rank"] == rank and mesh["tier-moves"] == moves
        digests = mesh["tier-digests"]
        demoted = [d for op, ds in digests if op == "kv_gather" for d in ds]
        promoted = [d for op, ds in digests if op == "kv_scatter" for d in ds]
        assert len(demoted) == st["demotions_t0_t1"], rank
        assert sorted(promoted) == sorted(demoted), rank


@pytest.fixture(scope="module")
def jax_slice_handoff():
    """The JAX engine's combined tokens and its prefill pool's payloads at
    ``{dp: 2, tp: 2}``."""
    combined = _jax(SLICE, _combined)
    payloads = _jax({**SLICE, "pool-role": "prefill"}, _prefill)
    TpuServingEngine.reset_instances()
    return combined, payloads


@pytest.mark.parametrize("route", ["slice-prefill-jax-decode", "jax-prefill-slice-decode"])
def test_pool_roles_on_a_slice_hand_off_across_packages(route, tmp_path, jax_slice_handoff):
    """The decode side's tokens equal the JAX combined engine's, whichever
    side the slice is; its exports hold the JAX exports' rows; every rank
    replays one gather or scatter a request."""
    combined, jax_payloads = jax_slice_handoff
    if route == "jax-prefill-slice-decode":
        leader, follower = run_slice(tmp_path, {**SLICE, "pool-role": "decode"}, PROMPTS,
                                     "decode", payloads=jax_payloads)
        assert leader["tokens"] == combined
        op = "kv_scatter"
    else:
        leader, follower = run_slice(tmp_path, {**SLICE, "pool-role": "prefill"}, PROMPTS,
                                     "prefill")
        payloads = [bytes.fromhex(x) for x in leader["payloads"]]
        assert _jax({**SLICE, "pool-role": "decode"},
                    lambda e: _decode(e, payloads)) == combined
        _same_payloads(payloads, jax_payloads)
        op = "kv_gather"
    for mesh in _ranks(leader, follower):
        assert mesh["tier-moves"][op] == len(PROMPTS)
