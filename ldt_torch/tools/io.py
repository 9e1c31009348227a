"""Config and file helpers, counterpart of `ldt_tpu/tools/io.py`, with a
reader for the YAML the repository's configs are written in (the card's
machine has no PyYAML).

`load_yaml` reads a subset of YAML: nested block mappings, block sequences
of scalars (`- x`), plain and quoted scalars, and `#` comments, full-line or
trailing. Plain scalars resolve as `yaml.safe_load` resolves them (YAML 1.1:
`1.0e-05` is a float, `1e-5` the string '1e-5'; yes/no/on/off are bools;
`~`, `null` and an empty value are None; octal, hex, binary and base-60
ints; `.inf`, `.nan`). Flow collections, anchors, aliases, tags,
multi-line scalars, document markers, timestamps, merge keys and duplicate
keys raise a ValueError naming the line: nothing is read approximately.
"""

from __future__ import annotations

import os
import re
from types import SimpleNamespace


def makedirs(dirname: str) -> None:
    os.makedirs(dirname, exist_ok=True)


def dict2namespace(config):
    """Recursively convert a dict into attribute-style namespaces."""
    namespace = SimpleNamespace()
    for key, value in config.items():
        if isinstance(value, dict):
            value = dict2namespace(value)
        setattr(namespace, key, value)
    return namespace


def namespace2dict(ns):
    """Inverse of dict2namespace (for embedding a config in a checkpoint)."""
    return {key: namespace2dict(value) if isinstance(value, SimpleNamespace)
            else value for key, value in vars(ns).items()}


# yaml.resolver.Resolver's implicit resolvers (PyYAML 6), in the order it
# tries them; each applies only to scalars whose first character is listed.
_RESOLVERS = (
    ("bool", "yYnNtTfFoO", re.compile(
        r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
        r"|on|On|ON|off|Off|OFF)$")),
    ("float", "-+0123456789.", re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""", re.X)),
    ("int", "-+0123456789", re.compile(
        r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)),
    ("merge", "<", re.compile(r"^(?:<<)$")),
    ("null", "~nN", re.compile(r"^(?:~|null|Null|NULL)$")),
    ("timestamp", "0123456789", re.compile(
        r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
        (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)),
    ("value", "=", re.compile(r"^(?:=)$")),
)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}
# characters a plain scalar may not start with (YAML 1.1 indicators; "-",
# "?" and ":" may start one only when a non-space follows)
_INDICATORS = "[]{},#&*!|>'\"%@`"


class _Error(ValueError):
    pass


def _base60(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _int(value: str) -> int:
    """yaml.constructor.SafeConstructor.construct_yaml_int."""
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _base60(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    """yaml.constructor.SafeConstructor.construct_yaml_float."""
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _base60(value, float)
    return sign * float(value)


def _resolve(text: str):
    """A plain scalar's value, as yaml.safe_load resolves it."""
    if text == "":
        return None
    for kind, first, regex in _RESOLVERS:
        if text[0] in first and regex.match(text):
            if kind == "bool":
                return _BOOLS[text.lower()]
            if kind == "float":
                return _float(text)
            if kind == "int":
                return _int(text)
            if kind == "null":
                return None
            raise _Error(f"a {kind} scalar ({text!r}) is not supported")
    return text


def _scalar(text: str):
    """A scalar with its trailing comment: a quoted string, or a plain
    scalar resolved."""
    if text[:1] == "'":
        out, i = [], 1
        while True:
            j = text.find("'", i)
            if j < 0:
                raise _Error("an unterminated or multi-line quoted scalar")
            out.append(text[i:j])
            if text[j + 1:j + 2] == "'":  # '' is a quote
                out.append("'")
                i = j + 2
                continue
            rest = text[j + 1:]
            break
        value = "".join(out)
    elif text[:1] == '"':
        j = text.find('"', 1)
        if j < 0:
            raise _Error("an unterminated or multi-line quoted scalar")
        value, rest = text[1:j], text[j + 1:]
        if "\\" in value:
            raise _Error("escapes in double-quoted scalars are not supported")
    else:
        cut = re.search(r"\s#", text)
        plain = (text[:cut.start()] if cut else text).rstrip()
        if plain[:1] in _INDICATORS or re.match(r"[-?:](\s|$)", plain):
            raise _Error(f"unsupported syntax {plain!r} (flow collections, "
                         "anchors, aliases, tags, block scalars and "
                         "directives are not read)")
        if re.search(r":(\s|$)", plain):
            raise _Error(f"a mapping inside the scalar {plain!r}")
        return _resolve(plain)
    if rest.strip() and not re.match(r"\s+#", rest):
        raise _Error(f"text after a quoted scalar: {rest.strip()!r}")
    return value


class _Lines:
    """The document's significant lines: (line number, indent, content)."""

    def __init__(self, text: str):
        self.items = []
        for number, line in enumerate(text.splitlines(), 1):
            stripped = line.lstrip(" ")
            if not stripped.strip() or stripped.startswith("#"):
                continue
            if stripped[0] == "\t":
                raise _Error(f"line {number}: a tab in the indentation")
            if line.startswith(("---", "...", "%")):
                raise _Error(f"line {number}: document markers and "
                             "directives are not supported")
            self.items.append((number, len(line) - len(stripped),
                               stripped.rstrip()))
        self.i = 0

    def peek(self):
        return self.items[self.i] if self.i < len(self.items) else None


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: _Lines, indent: int):
    first = lines.peek()
    if _is_item(first[2]):
        return _sequence(lines, indent)
    return _mapping(lines, indent)


def _sequence(lines: _Lines, indent: int) -> list:
    out = []
    while (line := lines.peek()) and line[1] == indent and _is_item(line[2]):
        number, _, content = line
        lines.i += 1
        item = content[1:].strip()
        try:
            if not item or item.startswith("#") or _is_item(item):
                raise _Error("only scalars are supported as sequence items")
            out.append(_scalar(item))
        except _Error as e:
            raise _Error(f"line {number}: {e}") from None
    return out


def _mapping(lines: _Lines, indent: int) -> dict:
    out = {}
    while (line := lines.peek()) and line[1] == indent:
        number, _, content = line
        if _is_item(content):
            raise _Error(f"line {number}: a sequence item where a mapping "
                         "key was expected")
        lines.i += 1
        match = re.match(r"([^\s'\"#][^:]*?)\s*:(?:\s+(.*))?$", content)
        if match is None:
            raise _Error(f"line {number}: expected 'key: value', got "
                         f"{content!r}")
        try:
            key = _scalar(match.group(1))
            text = (match.group(2) or "").strip()
            if text and not text.startswith("#"):
                value = _scalar(text)
                nxt = lines.peek()
                if nxt and nxt[1] > indent:
                    raise _Error("a multi-line scalar")
            else:
                nxt = lines.peek()
                if nxt and (nxt[1] > indent
                            or (nxt[1] == indent and _is_item(nxt[2]))):
                    value = _block(lines, nxt[1])
                else:
                    value = None
            if key in out:
                raise _Error(f"duplicate key {key!r}")
        except _Error as e:
            raise _Error(f"line {number}: {e}") from None
        out[key] = value
    line = lines.peek()
    if line and line[1] > indent:
        raise _Error(f"line {line[0]}: unexpected indentation")
    return out


def load_yaml(path: str):
    """The YAML file at `path` as `yaml.safe_load` reads it, for the subset
    described in the module docstring; None for an empty file."""
    with open(path) as f:
        text = f.read()
    try:
        lines = _Lines(text)
        first = lines.peek()
        if first is None:
            return None
        if first[1] != 0:
            raise _Error(f"line {first[0]}: the document is indented")
        out = _block(lines, 0)
        if lines.peek() is not None:
            raise _Error(f"line {lines.peek()[0]}: unexpected content")
        return out
    except _Error as e:
        raise ValueError(f"{path}: {e}") from None
