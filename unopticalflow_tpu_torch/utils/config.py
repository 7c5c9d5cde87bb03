"""YAML + CLI config of the port's entry points.

The port's copy of ``unopticalflow_tpu/utils/config.py``, with the reference
trainer's semantics: the YAML file is loaded flat, ``img_hw`` becomes a
tuple, the argparse attributes are copied *over* the YAML dict (the command
line wins), and the merged dict becomes an attribute object.  The file is
read by ``parse_flat_yaml``, not pyyaml, so the entry points read the same
config on every machine: it takes the flat YAML that ``config/*.yaml``
holds, as ``yaml.safe_load`` (YAML 1.1) resolves it, and raises on anything
else.
"""

from __future__ import annotations

import re

# yaml.safe_load's (YAML 1.1) implicit scalar types
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INDICATORS = "&*!|>%@`{"  # anchors, aliases, tags, block scalars, flow maps, ...


class Config:
    """Flat attribute bag; ``to_dict`` for the trainer's ``config.pkl``."""

    def __init__(self, d: dict | None = None):
        for k, v in (d or {}).items():
            setattr(self, k, v)

    def to_dict(self) -> dict:
        return {k: v for k, v in vars(self).items() if not k.startswith("__")}

    def __repr__(self):
        return f"Config({self.to_dict()!r})"


def _bare(text: str, where: str):
    """A plain scalar as yaml.safe_load resolves it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        return float("nan") if t.endswith("nan") else float(t)
    if text[0] in _INDICATORS or text.startswith(("- ", "? ", "---", "...")):
        raise ValueError(f"{where}: {text!r}: the flat YAML reader takes scalars and one "
                         "flow list only")
    return text


def _scalar(text: str, where: str):
    """One scalar, quoted or plain, with its comment already removed."""
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"{where}: unterminated quoted string {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"' or "\\" in text:
            raise ValueError(f"{where}: {text!r}: double-quoted strings without escapes only")
        return text[1:-1]
    return _bare(text, where)


def _strip_comment(line: str) -> str:
    """The line without its comment: '#' at the start or after a blank, outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:[,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(body: str, where: str) -> list[str]:
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch in "[]{}":
            raise ValueError(f"{where}: nested flow collections are not supported")
        elif ch == ",":
            items.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if quote:
        raise ValueError(f"{where}: unterminated quoted string in a flow list")
    items.append(cur.strip())
    if items[-1] == "":  # a trailing comma, or an empty list
        items.pop()
    if any(not it for it in items):
        raise ValueError(f"{where}: empty entry in a flow list")
    return items


def parse_flat_yaml(text: str, name: str = "<yaml>") -> dict:
    """``key: value`` lines -> dict, as ``yaml.safe_load`` reads such a file.

    Takes comments, quoted and plain strings, ints, floats, booleans and
    null as YAML 1.1 resolves them (``1e-4`` has no dot and stays a string,
    as in pyyaml; ``1.0e-4`` is a float), and flow lists of scalars such as
    ``img_hw: [256, 832]``.  Raises, naming the line, on anything else:
    nesting, block lists, anchors, aliases, tags, multi-line values.
    """
    out = {}
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: indented line: the flat YAML reader takes no nesting "
                             "or multi-line values")
        m = re.match(r"^('[^']*'|\"[^\"]*\"|[^'\"\s#:][^:]*?)\s*:(?:\s+(.*))?$", line)
        if m is None:
            raise ValueError(f"{where}: {line!r} is no 'key: value' line")
        key = m.group(1)
        key = key[1:-1] if key[0] in "'\"" else key
        value = (m.group(2) or "").strip()
        if value.startswith("["):
            if not value.endswith("]"):
                raise ValueError(f"{where}: a flow list must end on its line")
            out[key] = [_scalar(v, where) for v in _split_flow(value[1:-1], where)]
        else:
            out[key] = _scalar(value, where)
    return out


def load_yaml_config(path: str) -> dict:
    with open(path, "r") as f:
        cfg = parse_flat_yaml(f.read(), path)
    if "img_hw" in cfg:
        cfg["img_hw"] = (int(cfg["img_hw"][0]), int(cfg["img_hw"][1]))
    return cfg


def merge_cli_args(cfg: dict, args) -> Config:
    """Copy the argparse attributes over the YAML dict."""
    for attr in vars(args):
        cfg[attr] = getattr(args, attr)
    return Config(cfg)
