"""Safe expression language + templates for agent configuration.

Parity: the reference evaluates ``when:`` guards and field expressions with
JSTL/EL (``langstream-agents-commons/.../jstl/JstlEvaluator.java`` +
``JstlFunctions.java``) and renders prompts with Mustache
(``ChatCompletionsStep.java`` message templating). Here:

- :func:`evaluate` — a whitelisted-AST Python-expression evaluator over the
  record context (``value``, ``key``, ``properties``, plus ``fn.*`` helper
  functions). No attribute access on arbitrary objects, no calls except
  whitelisted helpers: safe against config-injection.
- :func:`render_template` — a minimal Mustache renderer: ``{{ path }}``
  interpolation, ``{{# path }}…{{/ path}}`` sections (lists & truthiness),
  ``{{^ path}}`` inverted sections.

Expressions accept both EL-ish dotted paths (``value.question``) and Python
operators (``==``, ``&&``→``and`` is normalised).

The port's copy of ``langstream_tpu/core/expressions.py``; it imports only the port.
"""

from __future__ import annotations

import ast
import json
import re
from typing import Any, Mapping

from langstream_tpu_torch.api.record import MutableRecord

_ALLOWED_NODES = (
    ast.Expression,
    ast.BoolOp, ast.And, ast.Or,
    ast.UnaryOp, ast.Not, ast.USub, ast.UAdd,
    ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
    ast.Pow,
    ast.Compare, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.In, ast.NotIn, ast.Is, ast.IsNot,
    ast.IfExp,
    ast.Call,
    ast.Attribute,
    ast.Subscript, ast.Index if hasattr(ast, "Index") else ast.Subscript,
    ast.Name, ast.Load,
    ast.Constant,
    ast.List, ast.Tuple, ast.Dict,
    ast.Slice,
)


class _Fn:
    """Whitelisted helper functions (parity: ``JstlFunctions.java``)."""

    @staticmethod
    def lowercase(s: Any) -> Any:
        return s.lower() if isinstance(s, str) else s

    @staticmethod
    def uppercase(s: Any) -> Any:
        return s.upper() if isinstance(s, str) else s

    @staticmethod
    def trim(s: Any) -> Any:
        return s.strip() if isinstance(s, str) else s

    @staticmethod
    def concat(*parts: Any) -> str:
        return "".join("" if p is None else str(p) for p in parts)

    @staticmethod
    def contains(haystack: Any, needle: Any) -> bool:
        try:
            return needle in haystack
        except TypeError:
            return False

    @staticmethod
    def coalesce(*vals: Any) -> Any:
        for v in vals:
            if v is not None:
                return v
        return None

    @staticmethod
    def split(s: Any, sep: str = ",") -> list:
        return s.split(sep) if isinstance(s, str) else []

    @staticmethod
    def replace(s: Any, old: str, new: str) -> Any:
        return s.replace(old, new) if isinstance(s, str) else s

    @staticmethod
    def len(x: Any) -> int:
        try:
            return len(x)
        except TypeError:
            return 0

    @staticmethod
    def str(x: Any) -> str:
        return "" if x is None else str(x)

    @staticmethod
    def toJson(x: Any) -> str:
        return json.dumps(x)

    @staticmethod
    def fromJson(s: Any) -> Any:
        return json.loads(s) if isinstance(s, str) else s

    @staticmethod
    def toInt(x: Any) -> int | None:
        try:
            return int(x)
        except (TypeError, ValueError):
            return None

    @staticmethod
    def toDouble(x: Any) -> float | None:
        try:
            return float(x)
        except (TypeError, ValueError):
            return None

    @staticmethod
    def startsWith(s: Any, prefix: str) -> bool:
        return isinstance(s, str) and s.startswith(prefix)

    @staticmethod
    def endsWith(s: Any, suffix: str) -> bool:
        return isinstance(s, str) and s.endswith(suffix)


class _DotDict(dict):
    """dict whose attribute access falls through to keys, so both
    ``value['a']`` and ``value.a`` work in expressions; missing keys are
    ``None`` (EL semantics, not KeyError)."""

    def __getattr__(self, name: str) -> Any:
        return _wrap(self.get(name))

    def __getitem__(self, name: Any) -> Any:
        return _wrap(self.get(name) if isinstance(name, str) else dict.get(self, name))


def _wrap(obj: Any) -> Any:
    if isinstance(obj, Mapping) and not isinstance(obj, _DotDict):
        return _DotDict(obj)
    if isinstance(obj, list):
        return [_wrap(o) for o in obj]
    return obj


class ExpressionError(ValueError):
    pass


_EL_NORMALISE = [
    (re.compile(r"&&"), " and "),
    (re.compile(r"\|\|"), " or "),
    (re.compile(r"(?<![=!<>])!(?!=)"), " not "),
    (re.compile(r"\bfn:(\w+)"), r"fn.\1"),
    (re.compile(r"\bnull\b"), "None"),
    (re.compile(r"\btrue\b"), "True"),
    (re.compile(r"\bfalse\b"), "False"),
    (re.compile(r"\beq\b"), "=="),
    (re.compile(r"\bne\b"), "!="),
]

_STRING_SPLIT = re.compile(r"('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\")")


def _normalise(expr: str) -> str:
    """EL → Python normalisation, applied *outside* string literals only
    (so ``value.flag == 'true'`` keeps its literal intact)."""
    expr = expr.strip()
    # strip full-expression wrappers: {{ expr }} / ${ expr }
    for open_, close in (("{{", "}}"), ("${", "}")):
        if expr.startswith(open_) and expr.endswith(close):
            inner = expr[len(open_) : -len(close)]
            # only unwrap when the braces actually pair around the whole body
            if open_ == "${" and "{" in inner:
                break
            expr = inner.strip()
    parts = _STRING_SPLIT.split(expr)
    for i in range(0, len(parts), 2):  # even indices are outside strings
        for pat, repl in _EL_NORMALISE:
            parts[i] = pat.sub(repl, parts[i])
    return "".join(parts).strip()


def _check(node: ast.AST) -> None:
    for child in ast.walk(node):
        if not isinstance(child, _ALLOWED_NODES):
            raise ExpressionError(
                f"disallowed construct {type(child).__name__} in expression"
            )
        if isinstance(child, ast.Attribute) and child.attr.startswith("_"):
            raise ExpressionError("dunder access is not allowed")
        if isinstance(child, ast.Name) and child.id.startswith("_"):
            raise ExpressionError("underscore names are not allowed")


class _Evaluator(ast.NodeVisitor):
    def __init__(self, names: dict[str, Any]):
        self.names = names

    def run(self, tree: ast.Expression) -> Any:
        return self._eval(tree.body)

    def _eval(self, node: ast.AST) -> Any:
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id not in self.names:
                return None
            return _wrap(self.names[node.id])
        if isinstance(node, ast.Attribute):
            base = self._eval(node.value)
            if base is None:
                return None
            if isinstance(base, _DotDict):
                return getattr(base, node.attr)
            if isinstance(base, _Fn) or base is _Fn:
                return getattr(base, node.attr)
            if isinstance(base, Mapping):
                return _wrap(base.get(node.attr))
            return None
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value)
            if base is None:
                return None
            idx = self._eval(node.slice)
            try:
                return _wrap(base[idx])
            except (KeyError, IndexError, TypeError):
                return None
        if isinstance(node, ast.Call):
            func = self._eval(node.func)
            if not callable(func):
                raise ExpressionError("call of non-function")
            args = [self._eval(a) for a in node.args]
            return func(*args)
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                result: Any = True
                for v in node.values:
                    result = self._eval(v)
                    if not result:
                        return result
                return result
            result = False
            for v in node.values:
                result = self._eval(v)
                if result:
                    return result
            return result
        if isinstance(node, ast.UnaryOp):
            operand = self._eval(node.operand)
            if isinstance(node.op, ast.Not):
                return not operand
            if isinstance(node.op, ast.USub):
                return -operand
            return +operand
        if isinstance(node, ast.BinOp):
            left, right = self._eval(node.left), self._eval(node.right)
            ops = {
                ast.Add: lambda a, b: a + b,
                ast.Sub: lambda a, b: a - b,
                ast.Mult: lambda a, b: a * b,
                ast.Div: lambda a, b: a / b,
                ast.FloorDiv: lambda a, b: a // b,
                ast.Mod: lambda a, b: a % b,
                ast.Pow: lambda a, b: a ** b,
            }
            return ops[type(node.op)](left, right)
        if isinstance(node, ast.Compare):
            left = self._eval(node.left)
            for op, comp in zip(node.ops, node.comparators):
                right = self._eval(comp)
                ok = {
                    ast.Eq: lambda a, b: a == b,
                    ast.NotEq: lambda a, b: a != b,
                    ast.Lt: lambda a, b: a < b,
                    ast.LtE: lambda a, b: a <= b,
                    ast.Gt: lambda a, b: a > b,
                    ast.GtE: lambda a, b: a >= b,
                    ast.In: lambda a, b: a in b if b is not None else False,
                    ast.NotIn: lambda a, b: a not in b if b is not None else True,
                    ast.Is: lambda a, b: a is b,
                    ast.IsNot: lambda a, b: a is not b,
                }[type(op)](left, right)
                if not ok:
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            return (
                self._eval(node.body) if self._eval(node.test) else self._eval(node.orelse)
            )
        if isinstance(node, ast.List):
            return [self._eval(e) for e in node.elts]
        if isinstance(node, ast.Tuple):
            return tuple(self._eval(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return {
                self._eval(k): self._eval(v)
                for k, v in zip(node.keys, node.values)
            }
        if isinstance(node, ast.Slice):
            return slice(
                self._eval(node.lower) if node.lower else None,
                self._eval(node.upper) if node.upper else None,
                self._eval(node.step) if node.step else None,
            )
        raise ExpressionError(f"unsupported node {type(node).__name__}")


def context_names(record: MutableRecord | None, extra: Mapping[str, Any] | None = None) -> dict[str, Any]:
    names: dict[str, Any] = {"fn": _Fn()}
    if record is not None:
        names.update(
            value=record.value,
            key=record.key,
            properties=record.properties,
            origin=record.origin,
            timestamp=record.timestamp,
        )
    if extra:
        names.update(extra)
    return names


def evaluate(
    expression: str,
    record: MutableRecord | None = None,
    extra: Mapping[str, Any] | None = None,
) -> Any:
    """Evaluate an expression against a record context."""
    src = _normalise(expression)
    if not src:
        return None
    try:
        tree = ast.parse(src, mode="eval")
    except SyntaxError as e:
        raise ExpressionError(f"bad expression {expression!r}: {e}") from e
    _check(tree)
    return _Evaluator(context_names(record, extra)).run(tree)


_ACCESSOR_MISS = object()


def evaluate_accessor(
    accessor: str, record: MutableRecord, extra: Mapping[str, Any] | None = None
) -> Any:
    """Fast path for plain dotted accessors; falls back to full evaluation."""
    if re.fullmatch(r"[A-Za-z_][\w]*(\.[\w]+)*", accessor or ""):
        if accessor.split(".", 1)[0] in ("value", "key", "properties", "origin", "timestamp"):
            return record.get_field(accessor)
    # Dotted paths whose segments contain hyphens (gateway headers like
    # properties.langstream-client-session-id) are valid field accessors but
    # would parse as subtraction in the EL; resolve as an accessor first and
    # only hand genuine misses to the evaluator.
    if re.fullmatch(r"[A-Za-z_][\w]*(\.[\w][\w-]*)+", accessor or ""):
        if accessor.split(".", 1)[0] in ("value", "key", "properties", "origin", "timestamp"):
            hit = record.get_field(accessor, _ACCESSOR_MISS)
            if hit is not _ACCESSOR_MISS:
                return hit
    return evaluate(accessor, record, extra)


# ---------------------------------------------------------------------------
# Mustache-style templates
# ---------------------------------------------------------------------------

_TAG = re.compile(r"\{\{\s*([#^/!]?)\s*([^}]*?)\s*\}\}")


def _lookup(path: str, stack: list[Any]) -> Any:
    parts = path.split(".")
    for frame in reversed(stack):
        cur = frame
        found = True
        for i, p in enumerate(parts):
            if isinstance(cur, Mapping) and p in cur:
                cur = cur[p]
            elif p == "." and i == 0:
                break
            else:
                found = False
                break
        if found:
            return cur
    return None


def render_template(
    template: str,
    record: MutableRecord | None = None,
    extra: Mapping[str, Any] | None = None,
) -> str:
    """Render a Mustache template against the record context.

    Supports ``{{ path }}``, sections ``{{# path}}…{{/path}}`` (list
    iteration, truthy gating), inverted ``{{^ path}}``, comments ``{{! }}``,
    and ``{{.}}`` for the current list item.
    """
    root = context_names(record, extra)
    del root["fn"]
    tokens = _tokenise(template)
    out: list[str] = []
    _render_tokens(tokens, 0, len(tokens), [root], out)
    return "".join(out)


def _tokenise(template: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    for m in _TAG.finditer(template):
        if m.start() > pos:
            tokens.append(("text", template[pos : m.start()]))
        sigil, path = m.group(1), m.group(2)
        kind = {"#": "open", "^": "inv", "/": "close", "!": "comment"}.get(sigil, "var")
        tokens.append((kind, path))
        pos = m.end()
    if pos < len(template):
        tokens.append(("text", template[pos:]))
    return tokens


def _find_close(tokens: list[tuple[str, str]], start: int, path: str) -> int:
    depth = 0
    for i in range(start, len(tokens)):
        kind, p = tokens[i]
        if kind in ("open", "inv"):
            depth += 1
        elif kind == "close":
            if depth == 0 and (p == path or not p):
                return i
            depth -= 1
    raise ExpressionError(f"unclosed section {{#{path}}}")


def _render_tokens(
    tokens: list[tuple[str, str]],
    start: int,
    end: int,
    stack: list[Any],
    out: list[str],
) -> None:
    i = start
    while i < end:
        kind, payload = tokens[i]
        if kind == "text":
            out.append(payload)
        elif kind == "comment":
            pass
        elif kind == "var":
            if payload == ".":
                v = stack[-1].get(".", stack[-1]) if isinstance(stack[-1], Mapping) else stack[-1]
            else:
                v = _lookup(payload, stack)
            if v is not None:
                out.append(v if isinstance(v, str) else json.dumps(v) if isinstance(v, (dict, list)) else str(v))
        elif kind in ("open", "inv"):
            close = _find_close(tokens, i + 1, payload)
            v = _lookup(payload, stack)
            if kind == "open":
                if isinstance(v, list):
                    for item in v:
                        frame = item if isinstance(item, Mapping) else {".": item}
                        _render_tokens(tokens, i + 1, close, stack + [frame], out)
                elif v:
                    frame = v if isinstance(v, Mapping) else {".": v}
                    _render_tokens(tokens, i + 1, close, stack + [frame], out)
            else:
                if not v:
                    _render_tokens(tokens, i + 1, close, stack, out)
            i = close
        i += 1
