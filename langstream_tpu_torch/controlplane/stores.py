"""Tenant + application stores: the port's copy of
``langstream_tpu/controlplane/stores.py``.

Parity: ``ApplicationStore``/``GlobalMetadataStore`` SPIs
(``langstream-api/.../storage/``) with the reference's k8s-backed
implementations (CRs + Secrets per tenant namespace,
``KubernetesApplicationStore.java:67``) mapped to: in-memory (tests/dev) and
filesystem (single-node durable). The file-system layout is the JAX
package's, so a store written by either package loads in the other.

Stored per application: the raw YAML files (so redeploys re-parse
faithfully), the serialized instance/secrets, and deployment status.
"""

from __future__ import annotations

import abc
import json
import re
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

_SAFE_FILENAME = re.compile(r"^[A-Za-z0-9._-]+\.(yaml|yml)$")
# application python code ships alongside the YAML (the reference ships the
# whole app dir as a code archive): python/x.py and python/lib/x.py
_SAFE_PYTHON = re.compile(r"^python/(lib/)?[A-Za-z0-9._-]+\.py$")
# a tenant or application name becomes one directory of the file-system
# store and of the app's code directory: a letter or digit first, so "."
# and ".." are out, and no "/", "\\" or NUL anywhere
_SAFE_NAME = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,252}")


def validate_filenames(files: dict[str, str]) -> None:
    """Reject path-traversal / unexpected names before anything touches disk."""
    for fname in files:
        ok = _SAFE_FILENAME.match(fname) or _SAFE_PYTHON.match(fname)
        if not ok or ".." in fname:
            raise ValueError(f"illegal application file name {fname!r}")


def validate_name(kind: str, name: str) -> None:
    """Reject a tenant or application name that is not one plain path
    segment, before the store or the code directory joins it to a path."""
    if not isinstance(name, str) or not _SAFE_NAME.fullmatch(name):
        raise ValueError(f"illegal {kind} name {name!r}")


@dataclass
class StoredApplication:
    tenant: str
    name: str
    files: dict[str, str]                  # filename → YAML content
    instance: str | None = None
    secrets: str | None = None
    status: str = "CREATED"                # CREATED | DEPLOYING | DEPLOYED | ERROR | DELETING
    error: str | None = None
    created_at: float = field(default_factory=time.time)
    # resource units (Σ parallelism × size over agents) — computed at deploy,
    # consumed by the tenant quota check (parity: per-tenant unit quotas,
    # ApplicationService.java:98-121)
    units: int = 0
    # code-storage archive id, stamped by the compute runtime at deploy so
    # the k8s store persists it into the Application CR — the operator's
    # deployer Job must write the SAME Agent CRs (incl. code coordinates)
    # the control plane's direct path writes, or the two lanes flap the
    # StatefulSet template and restart agent pods
    code_archive_id: str | None = None

    def public_view(self) -> dict[str, Any]:
        return {
            "application-id": self.name,
            "tenant": self.tenant,
            "status": {"status": self.status, "error": self.error},
            "created-at": self.created_at,
            "units": self.units,
            "files": sorted(self.files),
        }


class ApplicationStore(abc.ABC):
    @abc.abstractmethod
    def put_tenant(self, tenant: str, config: dict[str, Any] | None = None) -> None: ...

    @abc.abstractmethod
    def delete_tenant(self, tenant: str) -> None: ...

    @abc.abstractmethod
    def list_tenants(self) -> dict[str, dict[str, Any]]: ...

    def tenant_exists(self, tenant: str) -> bool:
        return tenant in self.list_tenants()

    @abc.abstractmethod
    def put_application(self, app: StoredApplication) -> None: ...

    @abc.abstractmethod
    def get_application(self, tenant: str, name: str) -> StoredApplication | None: ...

    @abc.abstractmethod
    def delete_application(self, tenant: str, name: str) -> None: ...

    @abc.abstractmethod
    def list_applications(self, tenant: str) -> list[str]: ...


class InMemoryApplicationStore(ApplicationStore):
    def __init__(self) -> None:
        self._tenants: dict[str, dict[str, Any]] = {}
        self._apps: dict[tuple[str, str], StoredApplication] = {}

    def put_tenant(self, tenant: str, config: dict[str, Any] | None = None) -> None:
        self._tenants[tenant] = config or {}

    def delete_tenant(self, tenant: str) -> None:
        self._tenants.pop(tenant, None)
        for key in [k for k in self._apps if k[0] == tenant]:
            del self._apps[key]

    def list_tenants(self) -> dict[str, dict[str, Any]]:
        return dict(self._tenants)

    def put_application(self, app: StoredApplication) -> None:
        self._apps[(app.tenant, app.name)] = app

    def get_application(self, tenant: str, name: str) -> StoredApplication | None:
        return self._apps.get((tenant, name))

    def delete_application(self, tenant: str, name: str) -> None:
        self._apps.pop((tenant, name), None)

    def list_applications(self, tenant: str) -> list[str]:
        return sorted(n for t, n in self._apps if t == tenant)


class FileSystemApplicationStore(ApplicationStore):
    """Durable single-node store: one directory per tenant, one per app."""

    def __init__(self, root: Path | str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _tenant_dir(self, tenant: str) -> Path:
        validate_name("tenant", tenant)
        return self.root / "tenants" / tenant

    def _app_dir(self, tenant: str, name: str) -> Path:
        validate_name("application", name)
        return self._tenant_dir(tenant) / "apps" / name

    def put_tenant(self, tenant: str, config: dict[str, Any] | None = None) -> None:
        d = self._tenant_dir(tenant)
        d.mkdir(parents=True, exist_ok=True)
        (d / "tenant.json").write_text(json.dumps(config or {}))

    def delete_tenant(self, tenant: str) -> None:
        shutil.rmtree(self._tenant_dir(tenant), ignore_errors=True)

    def list_tenants(self) -> dict[str, dict[str, Any]]:
        out = {}
        tenants_dir = self.root / "tenants"
        if tenants_dir.is_dir():
            for d in tenants_dir.iterdir():
                if (d / "tenant.json").exists():
                    out[d.name] = json.loads((d / "tenant.json").read_text())
        return out

    def put_application(self, app: StoredApplication) -> None:
        validate_filenames(app.files)
        d = self._app_dir(app.tenant, app.name)
        files_dir = d / "files"
        files_dir.mkdir(parents=True, exist_ok=True)
        for fname, content in app.files.items():
            target = files_dir / fname
            target.parent.mkdir(parents=True, exist_ok=True)  # python/ code
            target.write_text(content)
        meta = {
            "status": app.status,
            "error": app.error,
            "created_at": app.created_at,
            "units": app.units,
        }
        (d / "meta.json").write_text(json.dumps(meta))
        if app.instance is not None:
            (d / "instance.yaml").write_text(app.instance)
        if app.secrets is not None:
            (d / "secrets.yaml").write_text(app.secrets)

    def get_application(self, tenant: str, name: str) -> StoredApplication | None:
        d = self._app_dir(tenant, name)
        if not (d / "meta.json").exists():
            return None
        meta = json.loads((d / "meta.json").read_text())
        files = {
            f.relative_to(d / "files").as_posix(): f.read_text()
            for pattern in ("*.yaml", "*.yml", "python/*.py", "python/lib/*.py")
            for f in (d / "files").glob(pattern)
        }
        instance = (
            (d / "instance.yaml").read_text() if (d / "instance.yaml").exists() else None
        )
        secrets = (
            (d / "secrets.yaml").read_text() if (d / "secrets.yaml").exists() else None
        )
        return StoredApplication(
            tenant=tenant,
            name=name,
            files=files,
            instance=instance,
            secrets=secrets,
            status=meta.get("status", "CREATED"),
            error=meta.get("error"),
            created_at=meta.get("created_at", 0),
            units=int(meta.get("units", 0)),
        )

    def delete_application(self, tenant: str, name: str) -> None:
        shutil.rmtree(self._app_dir(tenant, name), ignore_errors=True)

    def list_applications(self, tenant: str) -> list[str]:
        apps_dir = self._tenant_dir(tenant) / "apps"
        if not apps_dir.is_dir():
            return []
        return sorted(d.name for d in apps_dir.iterdir() if d.is_dir())
