"""Deployer facade: create → setup → deploy → delete → cleanup.

Parity: ``ApplicationDeployer``
(``langstream-core/.../deploy/ApplicationDeployer.java:58-252``):
``create_implementation`` plans the app (placeholder resolution + planner),
``setup`` provisions topics and assets, ``deploy``/``delete`` hand the plan to
the compute-cluster runtime (in-process local runner, or the k8s layer).

The port's copy of ``langstream_tpu/core/deployer.py``; it imports only the port.
"""

from __future__ import annotations

from langstream_tpu_torch.api.application import Application, TopicDefinition
from langstream_tpu_torch.api.execution_plan import ExecutionPlan
from langstream_tpu_torch.api.topics import TopicConnectionsRuntimeRegistry
from langstream_tpu_torch.core.placeholders import resolve_placeholders
from langstream_tpu_torch.core.planner import build_execution_plan


class ApplicationDeployer:
    def create_implementation(
        self, application_id: str, application: Application
    ) -> ExecutionPlan:
        resolve_placeholders(application)
        return build_execution_plan(application_id, application)

    async def setup(self, plan: ExecutionPlan) -> None:
        """Create topics (+ provision assets) before agents start."""
        streaming = plan.application.instance.streaming_cluster
        runtime = TopicConnectionsRuntimeRegistry.get_runtime(
            {"type": streaming.type, "configuration": streaming.configuration}
        )
        admin = runtime.create_topic_admin()
        for topic in plan.logical_topics():
            if topic.creation_mode == TopicDefinition.CREATE_IF_NOT_EXISTS:
                await admin.create_topic(
                    topic.name, partitions=topic.partitions, options=topic.options
                )
        await self._setup_assets(plan)
        await runtime.close()

    async def _setup_assets(self, plan: ExecutionPlan) -> None:
        from langstream_tpu_torch.agents.assets import AssetManagerRegistry

        for asset in plan.assets:
            if asset.creation_mode != "create-if-not-exists":
                continue
            manager = AssetManagerRegistry.get(asset.asset_type)
            if manager is None:
                continue
            exists = await manager.asset_exists(asset)
            if not exists:
                await manager.deploy_asset(asset)

    async def cleanup(self, plan: ExecutionPlan) -> None:
        streaming = plan.application.instance.streaming_cluster
        runtime = TopicConnectionsRuntimeRegistry.get_runtime(
            {"type": streaming.type, "configuration": streaming.configuration}
        )
        admin = runtime.create_topic_admin()
        for topic in plan.logical_topics():
            if topic.deletion_mode == "delete":
                await admin.delete_topic(topic.name)
        await runtime.close()
