"""Asset managers: provision external resources declared in ``assets:``.

Parity: the reference's ``AssetManager`` SPI + per-store providers
(``langstream-core/.../assets/*.java``,
``langstream-vector-agents/.../*AssetsManagerProvider.java``). First-party
implementation: the in-memory vector store's tables; external stores register
here when their client libraries are present.

The port's copy of ``langstream_tpu/agents/assets.py``; it imports only the port.
"""

from __future__ import annotations

import abc

from langstream_tpu_torch.api.application import AssetDefinition


class AssetManager(abc.ABC):
    @abc.abstractmethod
    async def asset_exists(self, asset: AssetDefinition) -> bool: ...

    @abc.abstractmethod
    async def deploy_asset(self, asset: AssetDefinition) -> None: ...

    async def delete_asset(self, asset: AssetDefinition) -> None:
        pass


class AssetManagerRegistry:
    _managers: dict[str, AssetManager] = {}

    @classmethod
    def register(cls, asset_type: str, manager: AssetManager) -> None:
        cls._managers[asset_type] = manager

    @classmethod
    def get(cls, asset_type: str) -> AssetManager | None:
        import langstream_tpu_torch.agents  # noqa: F401  (self-registration)

        return cls._managers.get(asset_type)
