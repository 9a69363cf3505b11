"""The port's YAML loader (``langstream_tpu_torch/core/yaml_subset.py``)
against PyYAML's ``yaml.safe_load``: every YAML file of ``examples/`` (one
case per file), ``yaml.safe_dump`` of random JSON-like trees read back
equal, the YAML 1.1 typing of plain scalars, and the refusals, which name
the file and the line."""

import datetime
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings, strategies as st

from langstream_tpu_torch.core.yaml_subset import YamlSubsetError, safe_load

REPO = Path(__file__).resolve().parents[1]
EXAMPLE_FILES = sorted(
    p.relative_to(REPO).as_posix()
    for pattern in ("*.yaml", "*.yml")
    for p in (REPO / "examples").rglob(pattern)
)


def test_the_examples_are_all_here():
    assert len(EXAMPLE_FILES) == 81


@pytest.mark.parametrize("name", EXAMPLE_FILES)
def test_every_example_file_equals_safe_load(name):
    text = (REPO / name).read_text()
    want = yaml.safe_load(text)
    got = safe_load(text, name)
    assert got == want
    assert repr(got) == repr(want)  # types too: 1 vs 1.0 vs True


_TEXT = st.text(alphabet=st.characters(blacklist_categories=("Cs",)), max_size=120)
_KEYS = st.text(alphabet=st.characters(blacklist_categories=("Cs",)), max_size=40)
_SCALARS = st.none() | st.booleans() | st.integers() | st.floats(allow_nan=False) | _TEXT
_TREES = st.recursive(
    _SCALARS,
    lambda children: st.lists(children, max_size=5) | st.dictionaries(_KEYS, children, max_size=5),
    max_leaves=30,
)


@settings(max_examples=400, deadline=None, suppress_health_check=list(HealthCheck))
@given(_TREES, st.sampled_from([False, True, None]), st.sampled_from([20, 80, 200]),
       st.booleans())
def test_safe_dump_round_trips(tree, flow, width, allow_unicode):
    """Block and flow styles, narrow widths (long scalars folded over
    lines, plain and quoted) and raw unicode: the loader reads what
    ``yaml.safe_load`` reads."""
    dumped = yaml.safe_dump(tree, default_flow_style=flow, width=width,
                            allow_unicode=allow_unicode)
    want = yaml.safe_load(dumped)
    assert safe_load(dumped, "tree.yaml") == want
    if not allow_unicode:
        assert want == tree


PLAIN_SCALARS = [
    "yes", "No", "ON", "off", "true", "FALSE", "y", "n", "~", "null", "Null", "",
    "0", "-17", "+3", "0755", "0x1F", "0b101", "1_000", "190:20:30", "08", "0o17",
    "1.5", "-.5e+3", ".5", "1e3", "1.0e+3", "6.8523015e+5", "190:20:30.15", ".inf",
    "-.Inf", "+.INF", ".NaN", "2001-12-14", "2001-12-14t21:59:43.10-05:00",
    "2001-12-14 21:59:43.10 -5", "2002-12-14 12:00:00Z", "1_2.3_4", "12:30", "-0",
    "abc", "a b c", "http://x:8080/y", "key:value", "a#b", "3.", "Yes please",
]


@pytest.mark.parametrize("text", PLAIN_SCALARS)
def test_plain_scalars_are_typed_as_yaml_1_1(text):
    doc = f"v: {text}\nl: [{text}]\n" if text else "v:\nl: []\n"
    want = yaml.safe_load(doc)
    got = safe_load(doc, "s.yaml")
    if isinstance(want["v"], float) and math.isnan(want["v"]):
        assert math.isnan(got["v"])
        return
    assert got == want
    assert type(got["v"]) is type(want["v"])
    if isinstance(want["v"], datetime.datetime):
        assert got["v"].utcoffset() == want["v"].utcoffset()


SNIPPETS = {
    "block scalars": """
a: |
  line one
    indented
  line three

b: >-
  folded
  text

  para two
c: |+
  keep

d: >2
   leading
e: |-
  strip
f: end
""",
    "nested collections": """
top:
- name: x
  items:
    - 1
    - [2, 3]
  map: {k: v, other: [a, {b: c}]}
-   - deep
    - er
key:
  sub: value  # comment
  'quoted key': "double \\"q\\" \\u00e9\\x41\\t"
  "": empty key
  multi: this is
    a folded plain
    scalar
seq_at_key:
- a
- b
""",
    "flow across lines": """
list: [a,
  b, "c, d",
  'e''s']
map: {
  x: 1, y: [true, ~],
  z: }
""",
    "quoted folding": """
s: 'one
  two

  three'
d: "a\\
  b c\\n
  d"
""",
    "document markers": "---\na: 1\n...\n",
    "comments only": "# nothing here\n\n",
    "explicit keys": "? a\n: 1\n? |\n  long\n: [x]\n",
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippets_equal_safe_load(name):
    text = SNIPPETS[name]
    assert safe_load(text, "s.yaml") == yaml.safe_load(text)


# (name, text, line of the refusal, words of its message, PyYAML reads it)
REFUSALS = [
    ("anchor", "a: &x 1\nb: *x\n", 1, "anchors", True),
    ("alias", "a: 1\nb: *x\n", 2, "anchors", False),
    ("tag", "a:\n  b: !!str 1\n", 2, "tags", True),
    ("directive", "%YAML 1.1\n---\na: 1\n", 1, "directives", True),
    ("two documents", "a: 1\n---\nb: 2\n", 2, "several documents", False),
    ("flow key", "[a, b]: c\n", 1, "flow collection as a mapping key", False),
    ("collection key", "? [a]\n: b\n", 1, "collection as a mapping key", False),
    ("bad indentation", "a:\n  b: 1\n c: 2\n", 3, "indentation", False),
    ("unterminated quote", "a: 'open\nb: 2\n", 1, "unterminated", False),
    ("mapping in a value", "a: b: c\n", 1, "not allowed", False),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_refusals_name_the_file_and_line(case):
    """Constructs outside the subset and malformed YAML raise with
    ``<file>:<line>:``; PyYAML reads the first kind and refuses the second."""
    _, text, line, words, pyyaml_reads = case
    with pytest.raises(YamlSubsetError, match=words) as info:
        safe_load(text, "apps/pipeline.yaml")
    assert str(info.value).startswith(f"apps/pipeline.yaml:{line}: ")
    assert (info.value.source, info.value.line) == ("apps/pipeline.yaml", line)
    if pyyaml_reads:
        yaml.safe_load(text)
    else:
        with pytest.raises(yaml.YAMLError):
            yaml.safe_load(text)
