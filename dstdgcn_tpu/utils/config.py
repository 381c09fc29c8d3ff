"""YAML experiment configuration.

Schema parity with the reference config system (``utils/misc.py:20-119`` and
the ``configs/dstdgcn/*.yaml`` layout): attribute/key hybrid access,
``!!python``-prefixed expression values, CLI overrides, and resolved-config
dumping.  Expressions are evaluated with a restricted namespace (numpy +
arithmetic) rather than the reference's bare ``eval``.

The files are read and written by a small reader for the subset of YAML
the configs use (:func:`load_yaml`, :func:`dump_yaml`): block mappings,
block sequences, flow lists and maps (also spanning several lines),
comments, quoted strings, and the YAML 1.1 plain scalars of PyYAML's
``safe_load`` (``true/false/yes/no/on/off``, ``null``/``~``, decimal
ints, floats such as ``3.e-3``).  Anchors, tags, multi-document streams
and block scalars (``|``/``>``) are rejected.
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["EasyDict", "get_config", "save_config", "update_config",
           "load_yaml", "dump_yaml"]


class EasyDict:
    """Dict with attribute access (reference utils/misc.py:20-55)."""

    def __init__(self, opt: Dict[str, Any]):
        object.__setattr__(self, "opt", opt)

    def __getattr__(self, name):
        opt = object.__getattribute__(self, "opt")
        if name in opt:
            return opt[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        self.opt[name] = value

    def __getitem__(self, name):
        return self.opt[name]

    def __setitem__(self, name, value):
        self.opt[name] = value

    def __contains__(self, item):
        return item in self.opt

    def __repr__(self):
        return repr(self.opt)

    def get(self, name, default=None):
        return self.opt.get(name, default)

    def keys(self):
        return self.opt.keys()

    def values(self):
        return self.opt.values()

    def items(self):
        return self.opt.items()

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self.opt)


# -- YAML subset -------------------------------------------------------------
# Plain-scalar resolution follows PyYAML's YAML 1.1 resolver, so a value
# means the same thing here as under yaml.safe_load.

_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _plain(text: str) -> Any:
    if text in _NULL:
        return None
    if text.lower() in _BOOL and text in (
            text.lower(), text.capitalize(), text.upper()):
        return _BOOL[text.lower()]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    if text[0] in "&*!|>%@`":
        raise ValueError(f"unsupported YAML construct: {text!r}")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """Parse the quoted string starting at ``text[i]``; return (value,
    index after the closing quote)."""
    q = text[i]
    j = i + 1
    while j < len(text):
        if q == "'" and text[j] == "'":
            if text[j + 1:j + 2] == "'":
                j += 2
                continue
            return text[i + 1:j].replace("''", "'"), j + 1
        if q == '"' and text[j] == "\\":
            j += 2
            continue
        if q == '"' and text[j] == '"':
            return json.loads(text[i:j + 1]), j + 1
        j += 1
    raise ValueError(f"unterminated string: {text[i:]!r}")


def _strip_comment(line: str) -> str:
    quote = None
    for j, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (j == 0 or line[j - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (j == 0 or line[j - 1] in " \t"):
            return line[:j].rstrip()
    return line.rstrip()


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """Parse one flow node at ``text[i]`` (after spaces)."""
    while text[i] == " ":
        i += 1
    ch = text[i]
    if ch in "[{":
        close = "]" if ch == "[" else "}"
        seq: List[Any] = []
        mapping: Dict[Any, Any] = {}
        i += 1
        while True:
            while text[i] in " ,":
                i += 1
            if text[i] == close:
                return (seq if ch == "[" else mapping), i + 1
            node, i = _flow(text, i)
            while text[i] == " ":
                i += 1
            if ch == "{":
                if text[i] != ":":
                    raise ValueError(f"flow map needs 'key: value': {text!r}")
                mapping[node], i = _flow(text, i + 1)
            else:
                seq.append(node)
            while text[i] == " ":
                i += 1
            if text[i] not in "," + close:
                raise ValueError(f"bad flow collection: {text!r}")
    if ch in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",]}" and not (
            text[j] == ":" and text[j + 1:j + 2] in (" ", "")):
        j += 1
    return _plain(text[i:j].strip()), j


def _value(text: str) -> Any:
    """An inline value: a flow collection, a quoted or a plain scalar."""
    if text[0] in "[{'\"":
        node, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after value: {text!r}")
        return node
    return _plain(text)


def _split_key(text: str) -> Tuple[Any, str]:
    if text[0] in "'\"":
        key, j = _quoted(text, 0)
        rest = text[j:].lstrip()
        if not rest.startswith(":"):
            raise ValueError(f"expected ':' after key: {text!r}")
        return key, rest[1:].strip()
    m = re.search(r":(?:\s|$)", text)
    if m is None:
        raise ValueError(f"expected 'key: value': {text!r}")
    return _plain(text[:m.start()].strip()), text[m.end():].strip()


def _logical_lines(src: str) -> List[Tuple[int, str]]:
    """(indent, text) per logical line: comments and blank lines dropped,
    a flow collection that spans lines joined into one."""
    out: List[Tuple[int, str]] = []
    depth = 0
    for raw in src.splitlines():
        if raw.strip() in ("---", "...") and not out:
            continue
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError("tabs are not valid YAML indentation")
        text = line.strip()
        if depth > 0 or (out and text[0] in "[{" and
                         out[-1][1].endswith(":")):
            out[-1] = (out[-1][0], out[-1][1] + " " + text)
        else:
            out.append((len(line) - len(line.lstrip()), text))
        depth = _depth(out[-1][1])
    if depth:
        raise ValueError("unbalanced flow collection")
    return out


def _depth(text: str) -> int:
    depth, quote = 0, None
    for j, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (j == 0 or text[j - 1] in " \t[{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    if _is_item(lines[i][1]):
        seq = []
        while i < len(lines) and lines[i][0] == indent \
                and _is_item(lines[i][1]):
            item = lines[i][1][1:].strip()
            i += 1
            if item:
                if re.search(r":(?:\s|$)", item) and item[0] not in "[{'\"":
                    raise ValueError(f"mappings in sequences: {item!r}")
                seq.append(_value(item))
            elif i < len(lines) and lines[i][0] > indent:
                node, i = _block(lines, i, lines[i][0])
                seq.append(node)
            else:
                seq.append(None)
        return seq, i
    mapping: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        if _is_item(lines[i][1]):
            raise ValueError(f"sequence item inside a mapping: {lines[i]}")
        key, rest = _split_key(lines[i][1])
        if key in mapping:
            raise ValueError(f"duplicate key {key!r}")
        i += 1
        if rest:
            mapping[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_item(lines[i][1]))):
            mapping[key], i = _block(lines, i, lines[i][0])
        else:
            mapping[key] = None
    return mapping, i


def load_yaml(src: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = _logical_lines(src)
    if not lines:
        return None
    if len(lines) == 1 and lines[0][1][0] in "[{":
        return _value(lines[0][1])
    node, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"bad indentation at {lines[i]}")
    return node


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        v = float(v)
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "." not in text:            # 1e-05 -> 1.0e-05 (YAML 1.1 float)
            mant, _, exp = text.partition("e")
            text = mant + ".0" + ("e" + exp if exp else "")
        return text
    if isinstance(v, str):
        # quote whatever YAML 1.1 could read as another type (digits and
        # signs cover its octal, hex and sexagesimal forms too)
        if v and v == v.strip() and not re.search(r"[:#\[\]{},\"'\n]", v) \
                and v[0] not in "-+.?&*!|>%@`" and not v[0].isdigit() \
                and isinstance(_plain_or_none(v), str):
            return v
        return json.dumps(v)
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def _plain_or_none(text: str) -> Any:
    try:
        return _plain(text)
    except ValueError:
        return None


def _flow_text(v: Any) -> str:
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow_text(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar_text(k)}: {_flow_text(x)}"
                               for k, x in v.items()) + "}"
    return _scalar_text(v)


def dump_yaml(obj: Any, indent: int = 0) -> str:
    """Block mappings for dicts, flow lists for sequences; the output is
    valid YAML and reads back equal through :func:`load_yaml`."""
    if not isinstance(obj, dict):
        return _flow_text(obj) + "\n"
    pad = " " * indent
    out = []
    for k, v in obj.items():
        key = _scalar_text(k)
        if isinstance(v, dict) and v:
            out.append(f"{pad}{key}:\n" + dump_yaml(v, indent + 2))
        else:
            out.append(f"{pad}{key}: {_flow_text(v)}\n")
    return "".join(out)


# -- experiment configs ------------------------------------------------------

_EXPR_GLOBALS = {"__builtins__": {}, "np": np, "list": list, "range": range,
                 "len": len, "min": min, "max": max, "sum": sum,
                 "sorted": sorted, "abs": abs, "int": int, "float": float}


def _resolve(config):
    if isinstance(config, dict):
        return {k: _resolve(v) for k, v in config.items()}
    if isinstance(config, list):
        return [_resolve(v) for v in config]
    if isinstance(config, str) and config.startswith("!!python"):
        return eval(config[len("!!python"):], dict(_EXPR_GLOBALS))
    return config


def get_config(config_file: str, config_names: List[str] | str = ()) \
        -> EasyDict:
    with open(config_file) as f:
        config = _resolve(load_yaml(f.read()))
    if isinstance(config_names, str):
        return EasyDict(config[config_names])
    for name in config_names:
        config = config[name]
    return EasyDict(config)


def update_config(config, args) -> None:
    """Recursively overwrite matching keys (utils/misc.py:90-105)."""
    if args is None:
        return
    if hasattr(args, "__dict__"):
        args = vars(args)
    for arg, val in args.items():
        if arg in config:
            config[arg] = val
    for val in (config.values() if hasattr(config, "values") else ()):
        if isinstance(val, dict):
            update_config(val, args)


def save_config(config, config_file: str, print_opts: bool = True,
                logger=None) -> None:
    opt = config.to_dict() if isinstance(config, EasyDict) else dict(config)
    opt = {k: v for k, v in opt.items() if k != "logger"}
    text = dump_yaml(opt)
    with open(config_file, "w") as f:
        f.write(text)
    if print_opts:
        out = logger.info if logger is not None else print
        out("================= Options =================")
        out(text[:-1])
        out("===========================================")
