"""Config loading: presets, Hydra-style dotlist overrides, validation.

The port's copy of ``dl_vqa_tpu/config/core.py`` without PyYAML, which the
card does not assure: the presets are Python dicts
(:mod:`dl_vqa_tpu_torch.config.presets`) and an override's value is read by
:func:`_parse_value`, which gives what ``yaml.safe_load`` (YAML 1.1) gives
for the values an override carries: ints (``0x``, ``0b``, octal, ``_``,
base 60), floats (also ``5e-4``, which YAML 1.1 reads as a string),
booleans (``on``/``off``/``yes``/``no`` too), ``null`` and ``~``, quoted
strings, flow lists (``[3, 8]``), and the literal text where YAML finds a
syntax error (``*``). YAML it does not read (mappings, comments, anchors,
tags, block sequences, timestamps) raises ``ValueError`` instead of being
read another way. ``tests/test_torch_copies.py`` holds it to the original.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, List, Optional, Sequence

from dl_vqa_tpu_torch.config import schema as config_schema
from dl_vqa_tpu_torch.config.presets import preset

__all__ = ["compose", "apply_overrides", "flatten", "select"]

_SCI_FLOAT = re.compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")
_BLOCK_SCALAR_INDICATORS = {"|", "|-", "|+", ">", ">-", ">+"}

# PyYAML's implicit resolvers (YAML 1.1), tried in its order.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# A YAML syntax error in the original, which then keeps the literal text.
_ERROR_STARTS = ("*", "%", "@", "`")


class _Unsupported(ValueError):
    pass


def _sexagesimal(value: str, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _yaml_int(text: str) -> int:
    value = text.replace("_", "")
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
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _yaml_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _plain(text: str, flow: bool) -> Any:
    """A plain (unquoted) scalar as the YAML 1.1 resolvers type it."""
    if ": " in text or text.endswith(":") or " #" in text or "\t#" in text:
        raise _Unsupported(f"{text!r} is a YAML mapping or holds a comment")
    if flow and any(c in text for c in ",[]{}"):
        raise _Unsupported(f"{text!r} in a flow collection")
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _yaml_float(text)
    if _INT.match(text):
        return _yaml_int(text)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text) or text == "<<":
        raise _Unsupported(f"{text!r} is a YAML timestamp or merge key")
    return text


def _quoted(text: str) -> str:
    quote, body = text[0], text[1:-1]
    if len(text) < 2 or text[-1] != quote:
        raise _Unsupported(f"unterminated quoted string {text!r}")
    if quote == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise _Unsupported(f"{text!r} is not one quoted string")
        return body.replace("''", "'")
    if re.search(r'(?<!\\)"', body):
        raise _Unsupported(f"{text!r} is not one quoted string")
    escapes = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "r": "\r",
               "0": "\0", "/": "/", " ": " ", "a": "\a", "b": "\b",
               "e": "\x1b", "f": "\f", "v": "\v"}
    return re.sub(r"\\(.)", lambda m: escapes.get(m.group(1), m.group(0)),
                  body)


def _node(text: str, flow: bool) -> Any:
    text = text.strip(" ")
    if not text:
        return None
    if text[0] in "'\"":
        return _quoted(text)
    if text[0] == "[":
        return _sequence(text)
    first = text[0]
    if first in "{#&!?|>" or (first == "-" and (len(text) == 1
                                                or text[1] == " ")):
        raise _Unsupported(f"{text!r}: YAML syntax the port does not read")
    return _plain(text, flow)


def _split_items(body: str) -> List[str]:
    """Top-level comma-separated items of a flow sequence's body."""
    items, depth, quote, start = [], 0, None, 0
    for i, c in enumerate(body):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
            if depth < 0:
                raise _Unsupported(f"unbalanced ']' in {body!r}")
        elif c == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    if quote or depth:
        raise _Unsupported(f"unbalanced flow sequence {body!r}")
    tail = body[start:]
    if tail.strip(" "):
        items.append(tail)
    elif items and not items[-1].strip(" "):
        raise _Unsupported(f"empty item in flow sequence {body!r}")
    return items


def _sequence(text: str) -> List[Any]:
    if not text.endswith("]"):
        raise _Unsupported(f"{text!r} is not one flow sequence")
    items = _split_items(text[1:-1])
    if any(not item.strip(" ") for item in items):
        raise _Unsupported(f"empty item in flow sequence {text!r}")
    return [_node(item, flow=True) for item in items]


def _parse_value(raw: str) -> Any:
    """The value of an override, as ``dl_vqa_tpu.config.core._parse_value``
    reads it with PyYAML (see the module docstring)."""
    if raw == "":
        return ""  # Hydra: `key=` assigns the empty string, not null
    if raw.strip() in _BLOCK_SCALAR_INDICATORS:
        return raw
    if "\n" in raw or "\r" in raw:
        raise ValueError(f"override value {raw!r}: multi-line YAML is not "
                         "read by the port")
    if raw.strip(" ").startswith(_ERROR_STARTS):
        return raw  # a YAML syntax error: Hydra users mean the literal
    try:
        value = _node(raw, flow=False)
    except _Unsupported as e:
        raise ValueError(f"override value {raw!r}: {e}") from None
    if value == "" and raw.strip() not in ("''", '""'):
        return raw
    # YAML 1.1 reads '5e-4' (no mantissa dot) as a string; Hydra users
    # expect a float. Only when the input was unquoted.
    if isinstance(value, str) and value == raw and _SCI_FLOAT.match(value):
        return float(value)
    return value


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str]
                    ) -> Dict[str, Any]:
    """Apply Hydra-style dotlist overrides (``train.image.stride=2``):
    ``+key=value`` appends a key that must not exist, ``++key=value``
    appends or overrides, ``~key`` / ``~key=value`` deletes (the value, if
    given, must equal the current one); a bare ``key=value`` on a missing
    key creates it, and validation refuses it afterwards."""
    cfg = copy.deepcopy(cfg)
    for item in overrides:
        if item.startswith("~"):
            body = item[1:]
            dotted, _, raw = body.partition("=")
            dotted = dotted.strip()
            keys = dotted.split(".")
            node = cfg
            for key in keys[:-1]:
                if not isinstance(node, dict) or key not in node:
                    raise ValueError(
                        f"Could not delete from config. '{dotted}' is not found"
                    )
                node = node[key]
            if not isinstance(node, dict) or keys[-1] not in node:
                raise ValueError(
                    f"Could not delete from config. '{dotted}' is not found"
                )
            if "=" in body:
                expected = _parse_value(raw)
                current = node[keys[-1]]
                if current != expected:
                    raise ValueError(
                        f"Could not delete from config. The value of "
                        f"'{dotted}' is {current!r} and not {expected!r}"
                    )
            del node[keys[-1]]
            continue
        force_add = item.startswith("++")
        append = not force_add and item.startswith("+")
        body = item[2:] if force_add else (item[1:] if append else item)
        if body.startswith("+"):
            raise ValueError(
                f"Invalid override prefix in {item!r}: at most two leading "
                f"'+' are allowed (+key=value to append, ++key=value to "
                f"append-or-override)"
            )
        if "=" not in body:
            raise ValueError(f"Override must be key=value, got {item!r}")
        dotted, raw = body.split("=", 1)
        node = cfg
        keys = dotted.strip().split(".")
        for key in keys[:-1]:
            if key not in node or not isinstance(node[key], dict):
                node[key] = {}
            node = node[key]
        if append and keys[-1] in node:
            raise ValueError(
                f"Could not append to config. An item is already at "
                f"'{dotted.strip()}'. Either remove + prefix: "
                f"'{dotted.strip()}={raw}', or add a second + to add or "
                f"override the key: '+{item}'"
            )
        node[keys[-1]] = _parse_value(raw)
    return cfg


def compose(
    config_name: str = "config",
    overrides: Optional[Sequence[str]] = None,
    validate: bool = True,
) -> Dict[str, Any]:
    """Preset + overrides + validation: a plain nested dict, read as
    ``cfg['main'][...]``, equal to what ``dl_vqa_tpu.config.compose``
    gives for the same preset and overrides."""
    cfg = preset(config_name)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    if validate:
        config_schema.validate(cfg)
    return cfg


def select(cfg: Dict[str, Any], dotted: str) -> Any:
    """Fetch ``cfg['a']['b']['c']`` from ``'a.b.c'``."""
    node: Any = cfg
    for key in dotted.split("."):
        node = node[key]
    return node


def flatten(d: Dict[str, Any], parent_key: str = "", sep: str = "_"
            ) -> Dict[str, Any]:
    """Flatten a nested config for hparam reporting; lists become indexed
    keys (``num_channels0``, ``num_channels1``, ...)."""
    items: List = []
    for k, v in d.items():
        new_key = f"{parent_key}{sep}{k}" if parent_key else k
        if isinstance(v, list):
            items.extend((new_key + str(i), elem) for i, elem in enumerate(v))
        elif isinstance(v, dict):
            items.extend(flatten(v, new_key, sep=sep).items())
        else:
            items.append((new_key, v))
    return dict(items)
