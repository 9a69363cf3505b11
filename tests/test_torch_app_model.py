"""The port's application model against the JAX package's: the parser on
every example (with ``examples/instances/memory.yaml`` and
``examples/secrets/secrets.yaml``), compared as plain data; the planner on
every example (topics, agent nodes, fusion groups, connections,
gateways), the four ``grpc-*`` types and a type no registry knows planned
as the JAX planner plans them; the expression language and templates on
``tests/test_expressions.py``'s cases."""

import dataclasses
from pathlib import Path

import pytest

from langstream_tpu.api.record import MutableRecord as JaxMutableRecord
from langstream_tpu.core import expressions as jax_expressions
from langstream_tpu.core.deployer import ApplicationDeployer as JaxDeployer
from langstream_tpu.core.parser import build_application_from_directory as jax_parse
from langstream_tpu_torch.api.record import MutableRecord
from langstream_tpu_torch.core import expressions
from langstream_tpu_torch.core.deployer import ApplicationDeployer
from langstream_tpu_torch.core.parser import build_application_from_directory

REPO = Path(__file__).resolve().parents[1]
APPS = REPO / "examples" / "applications"
INSTANCE = REPO / "examples" / "instances" / "memory.yaml"
SECRETS = REPO / "examples" / "secrets" / "secrets.yaml"
EXAMPLES = sorted(p.name for p in APPS.iterdir() if p.is_dir())
PLANNED = ["chat-completions", "chatbot-gateway", "compute-embeddings", "embeddings-fanout-dp",
           "mini-chat", "moe-mixtral-ep", "react-chatbot-ui", "text-completions", "llama-70b-tp",
           # the in-process custom Python agents and the Connect bridges
           "kafka-connect", "langchain-document-loader", "langchain-style-chat",
           "llamaindex-style-sink", "python-agents", "service-agent-proxy",
           # transforms, flow, the vector stores, query and re-rank
           "chatbot-rag-memory", "flow-dispatch", "gateway-authentication", "multi-store-rag",
           "query-astradb", "query-jdbc-chat-history", "query-milvus", "query-opensearch",
           "query-pinecone", "query-solr", "rag-pipeline", "timer-heartbeat",
           # the document, HTTP and source agents, FLARE
           "azure-document-ingestion", "flare", "http-enrichment", "langserve-invoke",
           "long-context-summarizer", "s3-document-ingestion", "slack-alerts",
           "webcrawler-to-vector", "external-openai-compat",
           # the sidecar lane
           "grpc-sidecar-agent"]


def _parse_both(name):
    return (jax_parse(APPS / name, INSTANCE, SECRETS),
            build_application_from_directory(APPS / name, INSTANCE, SECRETS))


@pytest.mark.parametrize("name", EXAMPLES)
def test_parser_equals_the_jax_parser(name):
    jax_app, app = _parse_both(name)
    assert dataclasses.asdict(app) == dataclasses.asdict(jax_app)
    assert app.directory == str(APPS / name)


def _plan_data(plan):
    data = dataclasses.asdict(plan)
    data.pop("application")
    return data


def test_every_example_is_planned():
    assert sorted(PLANNED) == EXAMPLES and len(EXAMPLES) == 37


@pytest.mark.parametrize("name", PLANNED)
def test_planner_equals_the_jax_planner(name):
    jax_app, app = _parse_both(name)
    jax_plan = JaxDeployer().create_implementation("app", jax_app)
    plan = ApplicationDeployer().create_implementation("app", app)
    assert _plan_data(plan) == _plan_data(jax_plan)
    # placeholders resolved the same way (``${globals.chat-model}``)
    assert dataclasses.asdict(plan.application) == dataclasses.asdict(jax_plan.application)
    groups = {node_id: [a.id for a in node.agents] for node_id, node in plan.agents.items()}
    assert groups == {node_id: [a.id for a in node.agents]
                      for node_id, node in jax_plan.agents.items()}
    assert [g.id for g in plan.application.gateways] == [g.id for g in jax_app.gateways]


def test_chat_example_fuses_into_one_composite_node():
    _, app = _parse_both("chat-completions")
    plan = ApplicationDeployer().create_implementation("app", app)
    (node,) = plan.agents.values()
    assert node.agent_type == "composite"
    assert [a.type for a in node.agents] == ["document-to-json", "ai-chat-completions"]
    assert (node.input.topic, node.output.topic) == ("questions-topic", "answers-topic")
    assert node.agents[1].configuration["model"] == "llama3-8b"


#: the grpc types: the example that names one, and a minimal app for each other
UNPORTED = [("grpc-sidecar-agent", "grpc-python-processor"), (None, "grpc-agent"),
            (None, "grpc-python-source"), (None, "grpc-python-sink")]
GRPC_APP = """
topics:
  - name: "in"
    creation-mode: create-if-not-exists
  - name: "out"
    creation-mode: create-if-not-exists
pipeline:
  - name: "step"
    type: "%s"
    input: "in"
    output: "out"
    configuration: {}
"""


def _parse_files_both(agent_type: str):
    from langstream_tpu.core.parser import build_application_from_files as jax_files
    from langstream_tpu_torch.core.parser import build_application_from_files

    files = {"pipeline.yaml": GRPC_APP % agent_type}
    return jax_files(files), build_application_from_files(files)


@pytest.mark.parametrize("name,agent_type", UNPORTED)
def test_an_unported_agent_type_is_refused_at_planning(name, agent_type):
    """The four ``grpc-*`` types (refused at planning until the sidecar
    lane was ported) plan in both packages to equal plans, the source and
    sink as the JAX metadata makes them (the name is from that refusal)."""
    jax_app, app = _parse_both(name) if name else _parse_files_both(agent_type)
    jax_plan = JaxDeployer().create_implementation("app", jax_app)
    plan = ApplicationDeployer().create_implementation("app", app)
    assert _plan_data(plan) == _plan_data(jax_plan)
    assert [a.type for node in plan.agents.values() for a in node.agents] == [agent_type]


def test_an_unknown_agent_type_plans_and_fails_at_start_as_in_jax():
    """A type no registry knows plans in both packages as a composable
    processor and fails when its agent is made, with the same message."""
    from langstream_tpu.api.registry import AgentCodeRegistry as JaxRegistry
    from langstream_tpu_torch.api.registry import AgentCodeRegistry

    jax_app, app = _parse_files_both("no-such-agent")
    jax_plan = JaxDeployer().create_implementation("app", jax_app)
    plan = ApplicationDeployer().create_implementation("app", app)
    assert _plan_data(plan) == _plan_data(jax_plan)
    with pytest.raises(ValueError) as jax_error:
        JaxRegistry.get_agent_code("no-such-agent")
    with pytest.raises(ValueError) as port_error:
        AgentCodeRegistry.get_agent_code("no-such-agent")
    assert str(port_error.value) == str(jax_error.value)
    assert str(port_error.value).startswith("no agent implementation for type 'no-such-agent'")
    assert AgentCodeRegistry.known_types() == JaxRegistry.known_types()
    assert len(AgentCodeRegistry.known_types()) == 46


def test_unported_transport_and_assets_are_refused(monkeypatch):
    """``kafka`` resolves to the selector; ``pulsar`` without its client is
    refused naming the library; an unknown type is refused by name."""
    from langstream_tpu_torch.api.topics import TopicConnectionsRuntimeRegistry
    from langstream_tpu_torch.runtime.kafka_wire_runtime import (
        KafkaTopicConnectionsRuntimeSelector,
    )

    kafka = TopicConnectionsRuntimeRegistry.get_runtime(
        {"type": "kafka", "configuration": {"client": "wire"}})
    assert isinstance(kafka, KafkaTopicConnectionsRuntimeSelector)
    monkeypatch.delitem(TopicConnectionsRuntimeRegistry._factories, "pulsar", raising=False)
    with pytest.raises(ValueError, match="'pulsar' needs the 'pulsar' client library"):
        TopicConnectionsRuntimeRegistry.get_runtime({"type": "pulsar"})
    with pytest.raises(ValueError, match="no TopicConnectionsRuntime for type 'nope'"):
        TopicConnectionsRuntimeRegistry.get_runtime({"type": "nope"})


# ---------------------------------------------------------------------------
# expressions and templates: tests/test_expressions.py's cases on both
# ---------------------------------------------------------------------------

def _both(value=None, key=None, props=None):
    return (JaxMutableRecord(value=value, key=key, properties=dict(props or {})),
            MutableRecord(value=value, key=key, properties=dict(props or {})))


EXPRESSION_CASES = [
    ({"question": "hi", "nested": {"x": 3}}, None, ["value.question", "value.nested.x",
                                                   "value.missing"]),
    ({"a": 2, "b": "yes"}, None, ["value.a == 2 && value.b == 'yes'",
                                  "value.a > 5 || value.b == 'yes'", "!(value.a == 2)",
                                  "value.a + 3"]),
    ({"s": "  Hello  "}, None, ["fn:trim(value.s)", "fn:lowercase(value.s)",
                                "fn:concat('a', 'b', 1)", "fn:coalesce(value.missing, 'x')",
                                "fn:len(value.s)"]),
    ("v", {"lang": "en"}, ["properties.lang == 'en'"]),
    ({"flag": "true", "op": "eq", "brace": "}"}, None, [
        "value.flag == 'true'", "value.op == 'eq'", "value.brace == '}'",
        "fn:contains('not a keyword', 'a')"]),
    ({}, None, ["{'a': 1}"]),
]


@pytest.mark.parametrize("case", range(len(EXPRESSION_CASES)))
def test_evaluate_equals_the_jax_evaluator(case):
    value, props, exprs = EXPRESSION_CASES[case]
    jax_rec, rec = _both(value, props=props)
    for expr in exprs:
        assert expressions.evaluate(expr, rec) == jax_expressions.evaluate(expr, jax_rec), expr


@pytest.mark.parametrize("expr", ["__import__('os')", "[x for x in value]", "value.__class__"])
def test_evaluate_refuses_what_the_jax_evaluator_refuses(expr):
    jax_rec, rec = _both({})
    with pytest.raises(jax_expressions.ExpressionError):
        jax_expressions.evaluate(expr, jax_rec)
    with pytest.raises(expressions.ExpressionError):
        expressions.evaluate(expr, rec)


ACCESSOR_CASES = [
    ({"a": {"b": 1}}, None, ["value.a.b", "value.a.b + 1"]),
    ({"a": 7, "b": 3}, {"langstream-client-session-id": "s1"},
     ["properties.langstream-client-session-id", "value.a - value.b", "value.a-value.b"]),
]


@pytest.mark.parametrize("case", range(len(ACCESSOR_CASES)))
def test_evaluate_accessor_equals_the_jax_one(case):
    value, props, exprs = ACCESSOR_CASES[case]
    jax_rec, rec = _both(value, props=props)
    for expr in exprs:
        assert (expressions.evaluate_accessor(expr, rec)
                == jax_expressions.evaluate_accessor(expr, jax_rec)), expr


TEMPLATE_CASES = [
    ({"question": "what?"}, "Q: {{ value.question }}"),
    ({"question": "what?"}, "{{ value.missing }}"),
    ({"docs": [{"text": "a"}, {"text": "b"}], "none": []},
     "{{# value.docs}}[{{ text}}]{{/ value.docs}}"),
    ({"docs": [], "none": []}, "{{^ value.none}}empty{{/ value.none}}"),
    ({"items": ["x", "y"]}, "{{# value.items}}{{.}},{{/ value.items}}"),
    ({"question": "why?"}, "{{ value.question }}"),
]


@pytest.mark.parametrize("case", range(len(TEMPLATE_CASES)))
def test_render_template_equals_the_jax_renderer(case):
    value, template = TEMPLATE_CASES[case]
    jax_rec, rec = _both(value)
    got = expressions.render_template(template, rec)
    assert got == jax_expressions.render_template(template, jax_rec)
