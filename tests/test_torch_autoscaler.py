"""The port's fleet autoscaler (``langstream_tpu_torch/controlplane/
autoscaler.py``) against the JAX package's: both driven through the same
scripted fleets on a fake clock give equal decisions, equal backend calls
and equal event rings; the specs parse and refuse alike, and
``validate_application_autoscale`` and ``observation_from_summary`` agree."""

import asyncio
import json

import pytest

from langstream_tpu.controlplane import autoscaler as jax_as
from langstream_tpu_torch.controlplane import autoscaler as port_as

SIDES = {"jax": jax_as, "port": port_as}


def _obs(replica="app-0", **kw):
    return {"replica": replica, "slots": 8, **kw}


class ScriptedBackend:
    """Observations from a script (one fleet per step, the last repeats),
    a call log, and drains that report what they moved; ``fail_writes``
    replica writes raise before the count changes."""

    def __init__(self, script, fail_writes=0):
        self.script = list(script)
        self.calls = []
        self.fail_writes = fail_writes

    def observe(self):
        return self.script.pop(0) if len(self.script) > 1 else self.script[0]

    def set_replicas(self, n):
        self.calls.append(("set_replicas", n))
        if self.fail_writes:
            self.fail_writes -= 1
            raise RuntimeError("apiserver unavailable")

    async def drain(self, replica, grace_s):
        self.calls.append(("drain", replica, grace_s))
        return {"requeued": 1, "completed": 2, "shed": 0}


SCENARIOS = {
    "flood-then-cooldown": (
        {"max-replicas": 3, "scale-up-window-s": 5, "cooldown-s": 30,
         "queue-depth-per-replica": 4},
        [[_obs(queued=40)]] * 3 + [[_obs("app-0", queued=40), _obs("app-1", queued=40)]] * 6,
        [0, 3, 6, 10, 20, 40, 50, 60, 70], 0),
    "idle-drains-the-highest-ordinal": (
        {"min-replicas": 1, "max-replicas": 3, "scale-down-window-s": 10, "cooldown-s": 0,
         "drain-grace-s": 7},
        [[_obs("app-0"), _obs("app-1"), _obs("app-2")]] * 3 + [[_obs("app-0"), _obs("app-1")]] * 3,
        [0, 5, 12, 14, 30, 31], 0),
    "signals-kv-shed-slo-degraded": (
        {"max-replicas": 8, "scale-up-window-s": 0, "cooldown-s": 0},
        [[_obs(kv_used=0.99), _obs("app-1")], [_obs(shed_total=5)], [_obs(shed_total=9)],
         [_obs(slo_alerting=("ttft",))], [_obs(state="degraded")],
         [_obs("a-0", queued=5), _obs("a-1", state="wedged")]],
        [0, 1, 2, 3, 4, 5], 0),
    "unreachable-blocks-scale-down": (
        {"scale-down-window-s": 0, "idle-occupancy": 0.2, "cooldown-s": 0},
        [[_obs("a-0"), {"replica": "a-1", "unreachable": True}], [_obs("a-0"), _obs("a-1")]],
        [0, 1, 2], 0),
    "a-failed-write-retries-without-redrain": (
        {"min-replicas": 1, "max-replicas": 3, "scale-down-window-s": 0, "cooldown-s": 0},
        [[_obs("app-0"), _obs("app-1")]] * 4,
        [0, 1, 2, 3], 1),
    "clamped-at-max-collapses": (
        {"max-replicas": 2, "scale-up-window-s": 0, "queue-depth-per-replica": 1},
        [[_obs("a-0", queued=9), _obs("a-1", queued=9)]] * 6,
        [0, 1, 2, 3, 4, 5], 0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_fleets_give_equal_decisions_and_rings(name):
    spec, script, times, fail_writes = SCENARIOS[name]
    out = {}
    for side, mod in SIDES.items():
        clock = [0.0]
        backend = ScriptedBackend(script, fail_writes)
        seen = []
        scaler = mod.FleetAutoscaler(mod.AutoscaleSpec.from_dict(spec), backend,
                                     clock=lambda: clock[0], on_observation=seen.append)

        async def main():
            entries = []
            for t in times:
                clock[0] = float(t)
                try:
                    entries.append(await scaler.step())
                except RuntimeError as e:  # a failed write: run() logs it and goes on
                    entries.append({"raised": str(e)})
            return entries

        entries = asyncio.run(main())
        status = scaler.status()
        json.dumps(status)  # the /autoscaler route serves it verbatim
        out[side] = (entries, backend.calls, status, seen)
    assert out["port"] == out["jax"]
    entries, calls, status, seen = out["port"]
    assert len(seen) == len(times) and status["decisions"]
    if name == "flood-then-cooldown":
        assert ("set_replicas", 2) in calls and status["scale_ups"] >= 1
        assert any(e and e.get("outcome") == "cooldown" for e in entries)
    if name == "idle-drains-the-highest-ordinal":
        assert calls[:2] == [("drain", "app-2", 7.0), ("set_replicas", 2)]


@pytest.mark.parametrize("bad", [
    {"min-replicas": 0}, {"min-replicas": 3, "max-replicas": 2}, {"cooldown-s": -1},
    {"drain-grace-s": 0}, {"kv-reserved": 1.5}, {"idle-occupancy": 1.0},
    {"queue-depth-per-replica": 0}, {"shed-delta": 0}, {"replicas": 4}, "everything",
    {"enabled": "maybe"}, {"max-replicas": "x"},
])
def test_specs_refuse_alike(bad):
    def verdict(mod):
        try:
            return "ok", mod.AutoscaleSpec.from_dict(bad).to_dict()
        except Exception as e:  # noqa: BLE001 — the verdict is the comparison
            return type(e).__name__, str(e)

    assert verdict(port_as) == verdict(jax_as)


def test_a_spec_round_trips_alike():
    raw = {"min-replicas": 2, "max-replicas": 6, "scale-up-window-s": 10,
           "scale-down-window-s": 60, "cooldown-s": 30, "queue-depth-per-replica": 4,
           "agent": "ai"}
    port = port_as.AutoscaleSpec.from_dict(raw)
    assert port.to_dict() == jax_as.AutoscaleSpec.from_dict(raw).to_dict()
    assert port_as.AutoscaleSpec.from_dict(port.to_dict()) == port


class _Res:
    type = "tpu-serving-configuration"

    def __init__(self, configuration):
        self.configuration = configuration


class _App:
    def __init__(self, configuration):
        self.resources = {"tpu": _Res(configuration)}


@pytest.mark.parametrize("configuration", [
    {"autoscale": {"min-replicas": 0}}, {"autoscale": None}, {"autoscale": {"max-replicas": 3}},
    {"autoscale": {"enabled": False}}, {},
    {"autoscale": {"max-replicas": 3}, "pools": {"prefill": {"replicas": 1},
                                                  "decode": {"replicas": 2}}},
    {"pools": {"prefill": {"autoscale": {"max-replicas": 2}}, "decode": {"autoscale": True}}},
    {"pools": {"decode": {"autoscale": {"min-replicas": 0}}}},
])
def test_application_specs_and_validation_agree(configuration):
    def verdict(mod):
        app = _App(configuration)
        try:
            mod.validate_application_autoscale(app)
        except Exception as e:  # noqa: BLE001
            return type(e).__name__, str(e)
        return "ok", [s.to_dict() for s in mod.application_autoscale_specs(app)], (
            (mod.application_autoscale_spec(app) or mod.AutoscaleSpec()).to_dict())

    assert verdict(port_as) == verdict(jax_as)


@pytest.mark.parametrize("case", [
    ("p-0", None, None),
    ("p-0", [{"model": "a", "health": {"state": "ok", "occupancy": 1}},
             {"model": "b", "health": {"state": "degraded", "draining": True},
              "drain": {"shed": 3}}], None),
    ("p-1", [], {"status": "wedged"}),
])
def test_observation_from_summary_agrees(case):
    replica, summary, healthz = case
    port = port_as.observation_from_summary(replica, summary, healthz=healthz)
    jax = jax_as.observation_from_summary(replica, summary, healthz=healthz)
    assert port.to_dict() == jax.to_dict()
