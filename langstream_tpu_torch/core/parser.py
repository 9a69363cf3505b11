"""YAML → Application parser.

Parity: ``ModelBuilder`` (``langstream-core/.../parser/ModelBuilder.java:370``):
an application directory holds

- one or more *pipeline files* (``*.yaml`` with top-level ``topics:`` /
  ``pipeline:`` / ``assets:`` / ``errors:`` / ``module:``),
- ``configuration.yaml`` (``configuration: {resources: [...],
  dependencies: [...]}``),
- ``gateways.yaml`` (``gateways: [...]``),

plus, supplied separately (as the CLI does): ``instance.yaml``
(``instance: {streamingCluster, computeCluster, globals}``,
``ModelBuilder.java:837``) and ``secrets.yaml`` (``secrets: [{id,name,data}]``,
``ModelBuilder.java:812``).

The port's copy of ``langstream_tpu/core/parser.py``: every file is read
by the port's own YAML loader (:mod:`langstream_tpu_torch.core.yaml_subset`),
never PyYAML, and a construct outside its subset fails naming the file and
line.
"""

from __future__ import annotations

import re
from pathlib import Path

from langstream_tpu_torch.api.application import (
    AgentConfiguration,
    Application,
    AssetDefinition,
    ComputeCluster,
    ErrorsSpec,
    Gateway,
    Instance,
    Pipeline,
    Resource,
    ResourcesSpec,
    Secret,
    Secrets,
    StreamingCluster,
    TopicDefinition,
    DEFAULT_MODULE,
)
from langstream_tpu_torch.core.yaml_subset import safe_load

_RESERVED_FILES = {"configuration.yaml", "gateways.yaml", "secrets.yaml", "instance.yaml"}

_ID_SANITISE = re.compile(r"[^a-z0-9-]")


def _sanitise_id(name: str) -> str:
    return _ID_SANITISE.sub("-", name.lower()).strip("-")


class ApplicationParseError(ValueError):
    pass


class ModelBuilder:
    """Incremental builder: feed files, then :meth:`build`."""

    def __init__(self) -> None:
        self.application = Application()

    # ---- per-file entry points ------------------------------------------

    def add_pipeline_file(self, name: str, content: str) -> None:
        data = safe_load(content, name)
        if data is None:
            return
        if not isinstance(data, dict):
            raise ApplicationParseError(f"{name}: expected a mapping at top level")
        module = self.application.get_module(data.get("module", DEFAULT_MODULE))

        for topic_data in data.get("topics") or []:
            topic = TopicDefinition.from_dict(topic_data)
            existing = module.topics.get(topic.name)
            if existing is not None and existing.creation_mode != topic.creation_mode:
                raise ApplicationParseError(
                    f"{name}: topic {topic.name!r} redeclared with a different "
                    f"creation-mode"
                )
            module.topics.setdefault(topic.name, topic)

        for asset_data in data.get("assets") or []:
            module.assets.append(
                AssetDefinition(
                    id=asset_data.get("id") or _sanitise_id(asset_data.get("name", "asset")),
                    name=asset_data.get("name", ""),
                    asset_type=asset_data.get("asset-type", ""),
                    creation_mode=asset_data.get("creation-mode", "none"),
                    deletion_mode=asset_data.get("deletion-mode", "none"),
                    config=asset_data.get("config") or {},
                    events_topic=asset_data.get("events-topic"),
                )
            )

        steps = data.get("pipeline")
        if steps is None:
            return
        pipeline_id = data.get("id") or Path(name).stem
        pipeline = Pipeline(
            id=pipeline_id,
            name=data.get("name") or pipeline_id,
            resources=ResourcesSpec.from_dict(data.get("resources")),
            errors=ErrorsSpec.from_dict(data.get("errors")),
        )
        seen_ids: set[str] = set()
        for idx, step in enumerate(steps):
            if "type" not in step:
                raise ApplicationParseError(
                    f"{name}: pipeline step #{idx} has no 'type'"
                )
            agent_id = step.get("id") or _sanitise_id(
                step.get("name") or f"{step['type']}-{idx}"
            )
            if agent_id in seen_ids:
                agent_id = f"{agent_id}-{idx}"
            seen_ids.add(agent_id)
            agent = AgentConfiguration(
                id=agent_id,
                name=step.get("name", agent_id),
                type=step["type"],
                input=step.get("input"),
                output=step.get("output"),
                configuration=step.get("configuration") or {},
                resources=ResourcesSpec.from_dict(
                    step.get("resources") or data.get("resources")
                ),
                errors=ErrorsSpec.from_dict(step.get("errors")),
            )
            pipeline.agents.append(agent)
        if pipeline.id in module.pipelines:
            raise ApplicationParseError(f"duplicate pipeline id {pipeline.id!r}")
        module.pipelines[pipeline.id] = pipeline

    def add_configuration_file(self, content: str, source: str = "configuration.yaml") -> None:
        data = safe_load(content, source) or {}
        configuration = data.get("configuration") or {}
        for res in configuration.get("resources") or []:
            resource = Resource(
                id=res.get("id") or _sanitise_id(res.get("name") or res.get("type")),
                name=res.get("name", ""),
                type=res.get("type", ""),
                configuration=res.get("configuration") or {},
            )
            self.application.resources[resource.id] = resource
        self.application.dependencies.extend(configuration.get("dependencies") or [])

    def add_gateways_file(self, content: str, source: str = "gateways.yaml") -> None:
        data = safe_load(content, source) or {}
        for gw in data.get("gateways") or []:
            self.application.gateways.append(Gateway.from_dict(gw))

    def add_instance(self, content: str, source: str = "instance.yaml") -> None:
        data = safe_load(content, source) or {}
        instance = data.get("instance") or {}
        streaming = instance.get("streamingCluster") or {}
        compute = instance.get("computeCluster") or {}
        self.application.instance = Instance(
            streaming_cluster=StreamingCluster(
                type=streaming.get("type", "memory"),
                configuration=streaming.get("configuration") or {},
            ),
            compute_cluster=ComputeCluster(
                type=compute.get("type", "local"),
                configuration=compute.get("configuration") or {},
            ),
            globals_=instance.get("globals") or {},
        )

    def add_secrets(self, content: str, source: str = "secrets.yaml") -> None:
        data = safe_load(content, source) or {}
        secrets: dict[str, Secret] = {}
        for s in data.get("secrets") or []:
            secret = Secret(
                id=s.get("id") or _sanitise_id(s.get("name", "")),
                name=s.get("name", ""),
                data=s.get("data") or {},
            )
            secrets[secret.id] = secret
        self.application.secrets = Secrets(secrets=secrets)

    # ---- named-file dispatch --------------------------------------------

    def add_named_file(self, name: str, content: str) -> None:
        """Route one application file by its reserved name (the single
        dispatch point shared by the directory and in-memory entry points)."""
        if name == "configuration.yaml":
            self.add_configuration_file(content)
        elif name == "gateways.yaml":
            self.add_gateways_file(content)
        elif name == "secrets.yaml":
            self.add_secrets(content)
        elif name == "instance.yaml":
            self.add_instance(content)
        elif name.endswith((".yaml", ".yml")):
            self.add_pipeline_file(name, content)

    def add_application_directory(self, directory: Path | str) -> None:
        directory = Path(directory)
        if not directory.is_dir():
            raise ApplicationParseError(f"not a directory: {directory}")
        self.application.directory = str(directory)
        for path in sorted(directory.glob("*.yaml")) + sorted(directory.glob("*.yml")):
            self.add_named_file(path.name, path.read_text())

    def build(self) -> Application:
        return self.application


def build_application_from_files(
    files: dict[str, str],
    instance: str | None = None,
    secrets: str | None = None,
) -> Application:
    """Parse from an in-memory filename→content map (the shape stored by the
    control plane and shipped to in-cluster setup/deployer Jobs)."""
    builder = ModelBuilder()
    for name in sorted(files):
        builder.add_named_file(name, files[name])
    if instance is not None:
        builder.add_instance(instance)
    if secrets is not None:
        builder.add_secrets(secrets)
    return builder.build()


def build_application_from_directory(
    directory: Path | str,
    instance: str | Path | None = None,
    secrets: str | Path | None = None,
) -> Application:
    """One-shot parse of an application directory plus optional instance and
    secrets files (paths or YAML strings)."""
    builder = ModelBuilder()
    builder.add_application_directory(directory)

    def _content(source: str | Path, default_name: str) -> tuple[str, str]:
        p = Path(source) if not isinstance(source, Path) else source
        try:
            if p.exists():
                return p.read_text(), str(p)
        except OSError:
            pass
        return str(source), default_name

    if instance is not None:
        builder.add_instance(*_content(instance, "instance.yaml"))
    if secrets is not None:
        builder.add_secrets(*_content(secrets, "secrets.yaml"))
    return builder.build()
