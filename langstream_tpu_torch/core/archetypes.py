"""Archetypes: parameterized application templates (the port's copy of
``langstream_tpu/core/archetypes.py``; ``archetype.yaml`` read by the port's
:mod:`~langstream_tpu_torch.core.yaml_subset`).

Parity: ``ModelBuilder.buildApplicationInstanceFromArchetype``
(``langstream-core/.../parser/ModelBuilder.java:78``) and the control plane's
``/api/archetypes`` (``archetype/ArchetypeResource.java``): an archetype is a
directory holding ``archetype.yaml`` (metadata + a parameters schema) and an
``application/`` subdirectory of template files; instantiation substitutes
``${param.<name>}`` placeholders with caller-provided values and yields a
deployable files map.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from langstream_tpu_torch.core.yaml_subset import safe_load

_PARAM = re.compile(r"\$\{\s*param\.([A-Za-z0-9_-]+)\s*\}")


class ArchetypeError(ValueError):
    pass


@dataclass
class ArchetypeParameter:
    name: str
    description: str = ""
    required: bool = False
    default: Any = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ArchetypeParameter":
        return cls(
            name=d["name"],
            description=d.get("description", ""),
            required=bool(d.get("required", False)),
            default=d.get("default"),
        )


@dataclass
class Archetype:
    id: str
    title: str = ""
    description: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    parameters: list[ArchetypeParameter] = field(default_factory=list)
    path: Path | None = None

    def public_view(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "title": self.title,
            "description": self.description,
            "labels": self.labels,
            "parameters": [
                {
                    "name": p.name,
                    "description": p.description,
                    "required": p.required,
                    "default": p.default,
                }
                for p in self.parameters
            ],
        }


def load_archetype(directory: Path | str) -> Archetype:
    directory = Path(directory)
    meta_path = directory / "archetype.yaml"
    if not meta_path.exists():
        raise ArchetypeError(f"{directory} has no archetype.yaml")
    data = (safe_load(meta_path.read_text(), str(meta_path)) or {}).get("archetype") or {}
    return Archetype(
        id=data.get("id", directory.name),
        title=data.get("title", directory.name),
        description=data.get("description", ""),
        labels=data.get("labels") or {},
        parameters=[
            ArchetypeParameter.from_dict(p) for p in data.get("parameters") or []
        ],
        path=directory,
    )


def list_archetypes(root: Path | str) -> list[Archetype]:
    root = Path(root)
    out = []
    if root.is_dir():
        for child in sorted(root.iterdir()):
            if (child / "archetype.yaml").exists():
                out.append(load_archetype(child))
    return out


def instantiate(
    archetype: Archetype, parameters: dict[str, Any] | None = None
) -> dict[str, str]:
    """Render the archetype's application files with parameter values.
    Returns a filename → content map ready for the deploy path."""
    parameters = dict(parameters or {})
    values: dict[str, Any] = {}
    for p in archetype.parameters:
        if p.name in parameters:
            values[p.name] = parameters[p.name]
        elif p.default is not None:
            values[p.name] = p.default
        elif p.required:
            raise ArchetypeError(f"missing required parameter {p.name!r}")
    unknown = set(parameters) - {p.name for p in archetype.parameters}
    if unknown:
        raise ArchetypeError(f"unknown parameters: {sorted(unknown)}")

    app_dir = (archetype.path or Path(".")) / "application"
    if not app_dir.is_dir():
        raise ArchetypeError(f"archetype {archetype.id!r} has no application/")

    def render(content: str, fname: str) -> str:
        def sub(match: re.Match) -> str:
            name = match.group(1)
            if name not in values:
                raise ArchetypeError(
                    f"{fname}: parameter {name!r} referenced but not provided"
                )
            value = values[name]
            if isinstance(value, str):
                return value
            if isinstance(value, (bool, int, float)):
                return str(value).lower() if isinstance(value, bool) else str(value)
            import json

            return json.dumps(value)  # lists/dicts inline as JSON (valid YAML)

        return _PARAM.sub(sub, content)

    files: dict[str, str] = {}
    for path in sorted(app_dir.rglob("*")):
        if path.is_file():
            rel = path.relative_to(app_dir).as_posix()
            files[rel] = render(path.read_text(), rel)
    return files
