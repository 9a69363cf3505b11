"""In-process application runner: the dev-mode / test workhorse.

Parity: ``LocalApplicationRunner`` + the runtime-tester
(``langstream-runtime-tester/.../tester/LocalApplicationRunner.java:55,179``):
parse → plan → setup topics/assets → run every agent replica as an in-process
task against the in-memory broker; expose produce/consume helpers the way the
reference's tests use gateways. This is also the fixture our integration
tests build on (SURVEY.md §4: AbstractApplicationRunner role).

The port's copy of ``langstream_tpu/runtime/local_runner.py``; it imports only the port.
"""

from __future__ import annotations

import asyncio
from pathlib import Path
from typing import Any

from langstream_tpu_torch.api.application import Application
from langstream_tpu_torch.api.execution_plan import ExecutionPlan
from langstream_tpu_torch.api.record import Record, make_record
from langstream_tpu_torch.api.topics import TopicConnectionsRuntimeRegistry
from langstream_tpu_torch.core.deployer import ApplicationDeployer
from langstream_tpu_torch.core.parser import build_application_from_directory
from langstream_tpu_torch.runtime.runner import AgentRunner


class LocalApplicationRunner:
    def __init__(
        self,
        application: Application,
        application_id: str = "app",
        state_dir: Path | None = None,
    ):
        self.application = application
        self.application_id = application_id
        self.state_dir = state_dir
        self.deployer = ApplicationDeployer()
        self.plan: ExecutionPlan | None = None
        self.runners: list[AgentRunner] = []
        self._topics_runtime = None

    @classmethod
    def from_directory(
        cls,
        directory: Path | str,
        instance: str | Path | None = None,
        secrets: str | Path | None = None,
        application_id: str = "app",
        state_dir: Path | None = None,
    ) -> "LocalApplicationRunner":
        app = build_application_from_directory(directory, instance, secrets)
        return cls(app, application_id=application_id, state_dir=state_dir)

    async def start(self) -> ExecutionPlan:
        self.plan = self.deployer.create_implementation(
            self.application_id, self.application
        )
        await self.deployer.setup(self.plan)
        for node in self.plan.agents.values():
            for replica in range(max(1, node.resources.parallelism)):
                runner = AgentRunner(
                    self.plan, node, replica=replica, state_dir=self.state_dir
                )
                await runner.start()
                self.runners.append(runner)
        return self.plan

    async def stop(self) -> None:
        errors = []
        for runner in self.runners:
            try:
                await runner.stop()
            except Exception as e:
                errors.append(e)
        self.runners.clear()
        if self._topics_runtime is not None:
            await self._topics_runtime.close()
        if errors:
            raise errors[0]

    # ---- client-side helpers (what gateways do over WS) ------------------

    def _runtime(self):
        if self._topics_runtime is None:
            streaming = self.application.instance.streaming_cluster
            self._topics_runtime = TopicConnectionsRuntimeRegistry.get_runtime(
                {"type": streaming.type, "configuration": streaming.configuration}
            )
        return self._topics_runtime

    async def produce(
        self,
        topic: str,
        value: Any,
        key: Any = None,
        headers: dict[str, Any] | None = None,
    ) -> None:
        producer = self._runtime().create_producer("local-client", {"topic": topic})
        await producer.start()
        await producer.write(make_record(value=value, key=key, headers=headers))
        await producer.close()

    def reader(self, topic: str, position: str = "earliest"):
        return self._runtime().create_reader({"topic": topic}, initial_position=position)

    async def wait_for_messages(
        self, topic: str, count: int, timeout: float = 10.0, position: str = "earliest"
    ) -> list[Record]:
        """Test helper (parity: AbstractKafkaApplicationRunner.waitForMessages)."""
        reader = self.reader(topic, position)
        await reader.start()
        got: list[Record] = []
        deadline = asyncio.get_event_loop().time() + timeout
        while len(got) < count:
            remaining = deadline - asyncio.get_event_loop().time()
            if remaining <= 0:
                raise TimeoutError(
                    f"expected {count} records on {topic!r}, got {len(got)}"
                )
            got.extend(await reader.read(timeout=min(0.5, remaining)))
        await reader.close()
        return got

    def agent_info(self) -> list[dict[str, Any]]:
        return [r.info() for r in self.runners]

    async def __aenter__(self) -> "LocalApplicationRunner":
        await self.start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.stop()
