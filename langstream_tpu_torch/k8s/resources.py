"""Agent CR -> StatefulSet(s) + headless Service + PDBs, for the port's pods
(port of ``AgentResourcesFactory`` in ``langstream_tpu/k8s/resources.py``).

The manifests are the JAX factory's for the same CR, but for the placement:

- an agent whose ``resources.deviceMesh`` is set asks for ``nvidia.com/gpu``
  cards (in ``limits``, where an extended resource must be, and the same
  value in ``requests``) instead of ``google.com/tpu`` chips, with the node
  selector of a :data:`GPU_TOPOLOGIES` entry, a toleration of the
  ``nvidia.com/gpu`` taint that GPU node pools carry, a memory-backed
  ``/dev/shm`` (NCCL and the pinned staging of gloo outgrow a container's
  default 64 MiB) and ``LOCAL_WORLD_SIZE`` = the cards of the pod, so the
  launcher (:func:`langstream_tpu_torch.parallel.launch.local_ranks`) runs
  exactly the ranks the manifest asked for;
- a mesh larger than one host's cards is a multi-host slice: one
  StatefulSet per logical replica whose ``hosts`` pods form one
  ``torch.distributed`` world, the ordinal-0 pod's store at
  ``LS_COORDINATOR_ADDRESS`` (through the headless service); each pod takes
  all of its host's cards, so no pod anti-affinity is needed to spread
  them;
- every pod, with or without a mesh, starts through the port's pod
  entrypoint, ``python -m serve_torch --device <device> pod ...``
  (``serve_torch.py`` registers the port, then runs the platform's pod).

It works on the Agent CR as the dict the operator receives, and imports
nothing of JAX or of ``langstream_tpu``: what it needs of the JAX package's
``k8s/resources.py`` and ``k8s/crds.py`` is copied here.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from typing import Any, NamedTuple

AGENT_PORT = 8080  # /metrics + /info + /healthz + /ready (the platform's pod)
AGENT_SERVICE_PORT = 8790  # custom service agents (gateway agent-proxy target)
COORDINATOR_PORT = 8476  # the slice's torch.distributed store, on pod 0
LOCKSTEP_PORT = 7077  # leader->follower step-descriptor channel (serving/lockstep.py)

#: what H100 hosts hold, from public documentation:
#: - GKE: the ``cloud.google.com/gke-accelerator`` node label of A3 High
#:   (``nvidia-h100-80gb``: ``a3-highgpu-8g`` hosts of 8 cards, and the
#:   smaller ``a3-highgpu-2g`` shape, pinned by its
#:   ``node.kubernetes.io/instance-type``) and A3 Mega
#:   (``nvidia-h100-mega-80gb``, ``a3-megagpu-8g``) machines
#:   (cloud.google.com/kubernetes-engine/docs/how-to/gpus,
#:   cloud.google.com/compute/docs/accelerator-optimized-machines);
#: - elsewhere: the NVIDIA GPU Operator's GPU Feature Discovery label
#:   ``nvidia.com/gpu.product`` on an HGX H100 host of 8 SXM cards
#:   (github.com/NVIDIA/gpu-feature-discovery, "Generated Labels").
#: ``card`` is what ``torch.cuda.get_device_name()`` reports on them.
class GpuTopology(NamedTuple):
    node_selector: dict[str, str]
    cards_per_host: int
    card: str


H100 = "NVIDIA H100 80GB HBM3"
GPU_TOPOLOGIES: dict[str, GpuTopology] = {
    "h100": GpuTopology({"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}, 8, H100),
    "h100-mega": GpuTopology({"cloud.google.com/gke-accelerator": "nvidia-h100-mega-80gb"},
                             8, H100),
    "h100-2g": GpuTopology({"cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                            "node.kubernetes.io/instance-type": "a3-highgpu-2g"}, 2, H100),
    "h100-gpu-operator": GpuTopology({"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"},
                                     8, H100),
}
DEFAULT_ACCELERATOR = "h100"


def accelerator_from_env() -> str:
    """The port's placement name: ``LS_ACCELERATOR`` when set, else
    :data:`DEFAULT_ACCELERATOR`. A name that is not a port entry (a TPU
    name such as the operator's ``v5e`` among them) is refused naming the
    port's entries: a port pod is never placed on a TPU node pool."""
    name = os.environ.get("LS_ACCELERATOR") or DEFAULT_ACCELERATOR
    if name not in GPU_TOPOLOGIES:
        raise ValueError(
            f"LS_ACCELERATOR={name!r} names no GPU the port places on; set one of "
            f"{sorted(GPU_TOPOLOGIES)} (or leave it unset for {DEFAULT_ACCELERATOR!r})")
    return name


def mesh_cards(device_mesh: dict[str, int] | None) -> int:
    """The cards one logical replica needs: the product of the mesh's axis
    sizes, 0 without a mesh."""
    cards = 1
    for axis_size in (device_mesh or {}).values():
        cards *= int(axis_size)
    return cards if device_mesh else 0


def gpu_placement(accelerator: str, cards: int) -> dict[str, Any]:
    """Node selector and cards per pod for one slice of ``cards``: one host
    at or below the entry's cards per host, else ``cards // per_host``
    hosts of ``per_host`` cards each (only a multiple of ``per_host``)."""
    if accelerator not in GPU_TOPOLOGIES:
        raise ValueError(
            f"unknown GPU accelerator {accelerator!r}; known: {sorted(GPU_TOPOLOGIES)}")
    topology = GPU_TOPOLOGIES[accelerator]
    per_host = topology.cards_per_host
    if cards < 1 or (cards > per_host and cards % per_host):
        raise ValueError(
            f"no {accelerator} placement for {cards} cards; available: 1 to {per_host} "
            f"on one host, or a multiple of {per_host} ({2 * per_host}, {3 * per_host}, "
            f"...) over hosts of {per_host}")
    return {
        "hosts": max(1, cards // per_host),
        "cards_per_pod": min(cards, per_host),
        "node_selector": dict(topology.node_selector),
    }


class _Agent(NamedTuple):
    """The fields of an Agent CR (the dict on the wire) the factory reads,
    with the JAX CR model's defaults (``langstream_tpu/k8s/crds.py``)."""

    namespace: str
    tenant: str
    application_id: str
    agent_id: str
    image: str
    config_secret: str
    checksum: str
    parallelism: int
    size: int
    device_mesh: dict[str, int] | None
    disk: dict[str, Any] | None
    options: dict[str, Any]

    @classmethod
    def of(cls, cr: dict[str, Any]) -> "_Agent":
        spec = cr.get("spec") or {}
        resources = spec.get("resources") or {}
        disk = spec.get("disk")
        return cls(
            namespace=(cr.get("metadata") or {}).get("namespace", "default"),
            tenant=spec.get("tenant", ""),
            application_id=spec.get("applicationId", ""),
            agent_id=spec.get("agentId", ""),
            image=spec.get("image", ""),
            config_secret=spec.get("agentConfigSecretRef", ""),
            checksum=spec.get("agentConfigSecretRefChecksum", ""),
            parallelism=int(resources.get("parallelism", 1)),
            size=int(resources.get("size", 1)),
            device_mesh=resources.get("deviceMesh"),
            disk={"enabled": False, "size": "128M", "type": "default", **disk} if disk else None,
            options=spec.get("options") or {},
        )


def _lockstep_token(agent: _Agent) -> str:
    """Join token for the lockstep channel: HMAC of the slice identity keyed
    by the agent config checksum (cluster-internal secret material)."""
    key = (agent.checksum or "unconfigured").encode()
    msg = f"{agent.tenant}/{agent.application_id}/{agent.agent_id}".encode()
    return hmac.new(key, msg, hashlib.sha256).hexdigest()


def _agent_labels(agent: _Agent) -> dict[str, str]:
    return {
        "app": "langstream-tpu-runtime",
        "langstream-application": agent.application_id,
        "langstream-agent": agent.agent_id,
    }


class AgentResourcesFactory:
    """Turns one Agent CR (a dict) into the port's StatefulSet(s), headless
    Service and PDB manifests."""

    #: grace budget the preStop /drain hands the serving engines; the pod's
    #: terminationGracePeriod is sized above it
    DRAIN_GRACE_S = 45
    TERMINATION_GRACE_S = 90

    @staticmethod
    def agent_resource_name(application_id: str, agent_id: str) -> str:
        return f"{application_id}-{agent_id}".lower().replace("_", "-")

    @classmethod
    def generate_headless_service(cls, cr: dict[str, Any]) -> dict[str, Any]:
        agent = _Agent.of(cr)
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": cls.agent_resource_name(agent.application_id, agent.agent_id),
                "namespace": agent.namespace,
                "labels": _agent_labels(agent),
            },
            "spec": {
                "clusterIP": "None",
                # a slice's pods resolve the coordinator pod's name before
                # it is Ready (the world's rendezvous waits for every pod)
                "publishNotReadyAddresses": True,
                "selector": _agent_labels(agent),
                "ports": [
                    {"name": "http", "port": AGENT_PORT},
                    {"name": "coordinator", "port": COORDINATOR_PORT},
                    {"name": "lockstep", "port": LOCKSTEP_PORT},
                    {"name": "agent-service", "port": AGENT_SERVICE_PORT},
                ],
            },
        }

    @staticmethod
    def pool_roles(cr: dict[str, Any]) -> dict[str, int] | None:
        """The agent's disaggregated pools, ``{role: replicas}``, from the
        ``poolRoles`` option (a list, ``parallelism`` replicas each, or a
        mapping); None = combined serving. Unknown roles raise."""
        agent = _Agent.of(cr)
        declared = agent.options.get("poolRoles") or agent.options.get("pool-roles")
        if not declared:
            return None
        parallelism = max(1, agent.parallelism)
        if isinstance(declared, dict):
            roles = {str(k): max(1, int(v)) for k, v in declared.items()}
        else:
            roles = {str(r): parallelism for r in declared}
        unknown = sorted(set(roles) - {"prefill", "decode"})
        if unknown:
            raise ValueError(f"unknown pool role(s) {unknown}; known: prefill, decode")
        return roles

    @classmethod
    def generate_statefulsets(cls, cr: dict[str, Any], accelerator: str = DEFAULT_ACCELERATOR,
                              image_pull_policy: str = "IfNotPresent",
                              device: str = "cuda") -> list[dict[str, Any]]:
        """One STS for a single-host agent (replicas = parallelism); one per
        pool role (``<name>-prefill`` / ``<name>-decode``, ``LS_POOL_ROLE``
        in the env); one per logical replica of a multi-host slice
        (replicas = hosts). ``device`` is the pods' ``--device``."""
        agent = _Agent.of(cr)
        cards = mesh_cards(agent.device_mesh)
        parallelism = max(1, agent.parallelism)
        base = cls.agent_resource_name(agent.application_id, agent.agent_id)
        pools = cls.pool_roles(cr)

        def sts(name, replicas, placement, logical_replica=None, pool_role=None):
            return cls._statefulset(agent, name=name, service=base, replicas=replicas,
                                    placement=placement, image_pull_policy=image_pull_policy,
                                    logical_replica=logical_replica, pool_role=pool_role,
                                    device=device)

        placement = gpu_placement(accelerator, cards) if cards else None
        if placement is None or placement["hosts"] == 1:
            if pools:
                return [sts(f"{base}-{role}", replicas, placement, pool_role=role)
                        for role, replicas in sorted(pools.items())]
            return [sts(base, parallelism, placement)]
        if pools:
            # a multi-host slice's STS replica count is the slice's HOST
            # count: there is no per-pool replica axis to split on
            raise ValueError(
                "poolRoles is not supported on multi-host slices: the "
                "slice's StatefulSet replicas are its hosts, not serving "
                "capacity (scale pools as single-host agents)"
            )
        return [sts(f"{base}-r{i}", placement["hosts"], placement, logical_replica=i)
                for i in range(parallelism)]

    @classmethod
    def generate_pod_disruption_budgets(cls, cr: dict[str, Any],
                                        statefulsets: list[dict[str, Any]] | None = None,
                                        accelerator: str = DEFAULT_ACCELERATOR,
                                        ) -> list[dict[str, Any]]:
        """One PDB per StatefulSet, ``maxUnavailable: 1``: voluntary
        evictions take pods one at a time, each through the preStop
        ``/drain``."""
        agent = _Agent.of(cr)
        if statefulsets is None:
            statefulsets = cls.generate_statefulsets(cr, accelerator=accelerator)
        return [
            {
                "apiVersion": "policy/v1",
                "kind": "PodDisruptionBudget",
                "metadata": {
                    "name": sts["metadata"]["name"],
                    "namespace": agent.namespace,
                    "labels": _agent_labels(agent),
                },
                "spec": {"maxUnavailable": 1, "selector": sts["spec"]["selector"]},
            }
            for sts in statefulsets
        ]

    @classmethod
    def _statefulset(cls, agent: _Agent, name: str, service: str, replicas: int,
                     placement: dict[str, Any] | None, image_pull_policy: str,
                     logical_replica: int | None, pool_role: str | None,
                     device: str) -> dict[str, Any]:
        env = [
            {"name": "LS_APPLICATION_ID", "value": agent.application_id},
            {"name": "LS_AGENT_ID", "value": agent.agent_id},
            {"name": "LS_TENANT", "value": agent.tenant},
            {"name": "LS_POD_NAME", "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}}},
            {"name": "LS_NUM_REPLICAS", "value": str(max(1, agent.parallelism))},
        ]
        resources: dict[str, Any] = {
            "requests": {"cpu": f"{agent.size * 0.5}", "memory": f"{agent.size * 512}M"}
        }
        volume_mounts = [
            {"name": "app-config", "mountPath": "/app-config"},
            {"name": "app-code-download", "mountPath": "/app-code-download"},
        ]
        volumes: list[dict[str, Any]] = [
            {"name": "app-config", "secret": {"secretName": agent.config_secret}},
            {"name": "app-code-download", "emptyDir": {}},
        ]
        if placement:
            cards = str(placement["cards_per_pod"])
            resources.setdefault("limits", {})["nvidia.com/gpu"] = cards
            resources["requests"]["nvidia.com/gpu"] = cards
            env += [
                {"name": "LS_SLICE_HOSTS", "value": str(placement["hosts"])},
                {"name": "LS_COORDINATOR_ADDRESS",
                 "value": f"{name}-0.{service}:{COORDINATOR_PORT}"},
                {"name": "LS_LOCKSTEP_PORT", "value": str(LOCKSTEP_PORT)},
                # deterministic (a random value would roll the pods every
                # reconcile), derived from the config-secret checksum
                {"name": "LS_LOCKSTEP_TOKEN", "value": _lockstep_token(agent)},
                {"name": "LOCAL_WORLD_SIZE", "value": cards},
            ]
            volumes.append({"name": "dshm", "emptyDir": {"medium": "Memory"}})
        if logical_replica is not None:
            env.append({"name": "LS_LOGICAL_REPLICA", "value": str(logical_replica)})
        if pool_role is not None:
            env.append({"name": "LS_POOL_ROLE", "value": pool_role})
        volume_claim_templates: list[dict[str, Any]] = []
        disk = agent.disk
        if disk is not None and disk["enabled"]:
            volume_mounts.append({"name": "agent-state", "mountPath": "/agent-state"})
            claim: dict[str, Any] = {
                "metadata": {"name": "agent-state"},
                "spec": {"accessModes": ["ReadWriteOnce"],
                         "resources": {"requests": {"storage": disk["size"]}}},
            }
            if disk["type"] != "default":
                claim["spec"]["storageClassName"] = disk["type"]
            volume_claim_templates.append(claim)
        runtime_mounts = volume_mounts + (
            [{"name": "dshm", "mountPath": "/dev/shm"}] if placement else [])

        # the port's pod entrypoint; the platform pod's subcommand follows
        entrypoint = ["python", "-m", "serve_torch", "--device", device, "pod"]
        pod_spec: dict[str, Any] = {
            "terminationGracePeriodSeconds": cls.TERMINATION_GRACE_S,
            "initContainers": [
                {
                    "name": "code-download",
                    "image": agent.image,
                    "imagePullPolicy": image_pull_policy,
                    "command": entrypoint
                    + ["agent-code-download", "/app-config/config", "/app-code-download"],
                    "volumeMounts": volume_mounts,
                }
            ],
            "containers": [
                {
                    "name": "runtime",
                    "image": agent.image,
                    "imagePullPolicy": image_pull_policy,
                    "command": entrypoint
                    + ["agent-runtime", "/app-config/config", "/app-code-download"],
                    "env": env,
                    "ports": [
                        {"name": "http", "containerPort": AGENT_PORT},
                        {"name": "coordinator", "containerPort": COORDINATOR_PORT},
                    ],
                    "resources": resources,
                    "volumeMounts": runtime_mounts,
                    "readinessProbe": {
                        "httpGet": {"path": "/ready", "port": AGENT_PORT},
                        "initialDelaySeconds": 5,
                        "periodSeconds": 10,
                    },
                    "livenessProbe": {
                        "httpGet": {"path": "/healthz", "port": AGENT_PORT},
                        "initialDelaySeconds": 30,
                        "periodSeconds": 10,
                        "failureThreshold": 3,
                    },
                    "lifecycle": {
                        "preStop": {
                            "httpGet": {"path": f"/drain?grace-s={cls.DRAIN_GRACE_S}",
                                        "port": AGENT_PORT}
                        }
                    },
                }
            ],
            "volumes": volumes,
        }
        if placement:
            pod_spec["nodeSelector"] = placement["node_selector"]
            pod_spec["tolerations"] = [
                {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"}]

        labels = _agent_labels(agent)
        return {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {"name": name, "namespace": agent.namespace, "labels": labels},
            "spec": {
                "serviceName": service,
                "replicas": replicas,
                "podManagementPolicy": "Parallel",
                "selector": {"matchLabels": {**labels, "sts": name}},
                "template": {
                    "metadata": {
                        "labels": {**labels, "sts": name},
                        "annotations": {
                            "langstream.tpu/config-checksum": agent.checksum,
                            "prometheus.io/scrape": "true",
                            "prometheus.io/port": str(AGENT_PORT),
                            "prometheus.io/path": "/metrics",
                        },
                    },
                    "spec": pod_spec,
                },
                "volumeClaimTemplates": volume_claim_templates,
            },
        }
