"""Experiment files: YAML with ``base_config`` chains, read into a
``Config``.

The counterpart of ``visinger_tpu/config/loader.py``, so that the JAX
package's experiment files (``configs/*.yaml``) run on the port.  A YAML
file may list parent files under ``base_config`` (a string or a list); they
merge depth first, each later one and then the file itself winning, with a
set of visited files against cycles and a path that starts with ``.``
taken relative to the including file, as in the JAX loader.  A file of the
JAX package's defaults (``visinger_tpu/config/defaults/<name>.yaml``) is
read from the port's copy, ``config_defaults/<name>.yaml``, so no file of
the JAX package is opened.  The merged mapping is applied to the default
``Config`` (the ``visinger_csd`` recipe): ``Config.apply`` drops the keys
the port does not read (``config.UNREAD_KEYS``) and raises ``KeyError`` on
any other unknown key.

``parse_yaml`` is a reader written here (the machine with the card has no
PyYAML).  It reads the part of YAML that experiment files use: block
mappings and block sequences, flow sequences (nested, on one line), plain,
single-quoted and double-quoted scalars (each on one line) and comments.
A plain scalar resolves as ``yaml.safe_load`` resolves it (YAML 1.1):
``true``/``false``/``yes``/``no``/``on``/``off`` in their three cases,
``null``/``~``, integers (decimal, ``0b``, ``0x``, octal with a leading 0,
base 60 with ``:``) and floats, which need a dot (``1e-9`` stays a string,
``1.0e-9`` is a float).  Anything else raises ``ValueError`` with the file
and line: anchors, aliases, tags, ``|`` and ``>`` blocks, flow mappings,
complex keys, timestamps, merge keys, a scalar or flow sequence that runs
over several lines, several documents in one file.
"""

from __future__ import annotations

import math
import os
import re
from collections.abc import Mapping
from pathlib import Path

from visinger_tpu_torch.config import Config, parse_overrides

DEFAULTS_DIR = Path(__file__).resolve().parent / "config_defaults"
_JAX_DEFAULTS = ("visinger_tpu", "config", "defaults")

# PyYAML's implicit resolvers of YAML 1.1 (yaml/resolver.py)
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
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
_NULL = re.compile(r"^(?:~|null|Null|NULL)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters that cannot start a plain scalar, with what they would begin
_REFUSED_START = {"&": "anchors", "*": "aliases", "!": "tags",
                  "|": "literal blocks", ">": "folded blocks",
                  "{": "flow mappings", "?": "complex keys",
                  "%": "directives", "@": "reserved indicators",
                  "`": "reserved indicators", ",": "a value starting with ','",
                  "]": "a value starting with ']'",
                  "}": "a value starting with '}'"}


def _sexagesimal(text: str, kind):
    value, base = kind(0), 1
    for part in reversed(text.split(":")):
        value += kind(part) * base
        base *= 60
    return value


def _to_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _to_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _is_dash(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _comment_at(text: str) -> int:
    """Index of the first ``#`` that begins a comment (after a space or a
    tab), else len(text)."""
    for i in range(1, len(text)):
        if text[i] == "#" and text[i - 1] in " \t":
            return i
    return len(text)


class _Reader:
    """One document's lines, parsed by indentation."""

    def __init__(self, text: str, path: str):
        self.path = path
        self.lines = []         # [line number, indent, text], content only
        if text.startswith("\ufeff"):
            text = text[1:]
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" \t")
            if not body.strip() or body.startswith("#"):
                continue
            indent = len(raw) - len(body)
            if "\t" in raw[:indent]:
                self.fail(no, "a tab in the indentation")
            body = body.rstrip()
            if indent == 0 and (body == "---" or body.startswith(("--- ",
                                                                  "...",
                                                                  "%"))):
                if body != "---" or self.lines:
                    self.fail(no, "document markers other than one leading "
                              "'---' (several documents), and directives")
                continue
            self.lines.append([no, indent, body])
        self.i = 0

    def fail(self, no: int, what: str):
        raise ValueError(f"{self.path}:{no}: {what} (the port's YAML reader "
                         "does not read this)")

    def document(self):
        if not self.lines:
            return None
        value = self.block(self.lines[0][1])
        if self.i < len(self.lines):
            self.fail(self.lines[self.i][0], "unexpected indentation")
        return value

    def block(self, indent: int):
        """The node whose first line is the current one, at ``indent``."""
        no, _, text = self.lines[self.i]
        if _is_dash(text):
            return self.sequence(indent)
        if self.key_split(text, no) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.inline(text, no)

    def sequence(self, indent: int) -> list:
        items = []
        while self.i < len(self.lines):
            no, ind, text = self.lines[self.i]
            if ind < indent or (ind == indent and not _is_dash(text)):
                break
            if ind > indent:
                self.fail(no, "unexpected indentation")
            rest = text[1:].lstrip(" ")
            if rest.startswith("#"):
                rest = ""
            if rest:
                # the entry's node starts on this line, at its column
                self.lines[self.i] = [no, ind + len(text) - len(rest), rest]
                items.append(self.block(self.lines[self.i][1]))
                continue
            self.i += 1
            if self.i < len(self.lines) and self.lines[self.i][1] > indent:
                items.append(self.block(self.lines[self.i][1]))
            else:
                items.append(None)
        return items

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            no, ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                self.fail(no, "unexpected indentation")
            split = self.key_split(text, no)
            if split is None:
                if _is_dash(text):
                    break
                self.fail(no, "expected a 'key: value' line")
            key, rest = split
            self.i += 1
            if rest.startswith("#"):
                rest = ""
            if rest:
                out[key] = self.inline(rest, no)
                continue
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if nxt is not None and (nxt[1] > indent or (
                    nxt[1] == indent and _is_dash(nxt[2]))):
                out[key] = self.block(nxt[1])
            else:
                out[key] = None
        return out

    def key_split(self, text: str, no: int):
        """(key, the rest of the line after ': ') for a mapping line, else
        None."""
        if text[0] in "'\"":
            key, end = self.quoted(text, 0, no)
            end = len(text) - len(text[end:].lstrip(" "))
            if end < len(text) and text[end] == ":" and (
                    end + 1 == len(text) or text[end + 1] in " \t"):
                return key, text[end + 1:].strip()
            return None
        if text.startswith("? ") or text == "?":
            self.fail(no, "complex keys")
        comment = _comment_at(text)
        for j in range(comment):
            if text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " \t"):
                key = text[:j].rstrip()
                if not key:
                    self.fail(no, "an empty key")
                if key[0] in "[{":
                    self.fail(no, "flow collections as keys")
                return self.plain(key, no), text[j + 1:].strip()
        return None

    def inline(self, text: str, no: int):
        """A value that starts and ends on this line."""
        if text[0] == "[":
            value, end = self.flow_sequence(text, 0, no)
        elif text[0] in "'\"":
            value, end = self.quoted(text, 0, no)
        else:
            if _is_dash(text):
                self.fail(no, "a block sequence inside a value")
            if text[0] in _REFUSED_START:
                self.fail(no, _REFUSED_START[text[0]])
            plain = text[:_comment_at(text)].rstrip()
            if re.search(r":(\s|$)", plain):
                self.fail(no, "a mapping inside a value")
            return self.plain(plain, no)
        rest = text[end:]
        if rest.strip() and not (rest[0] in " \t"
                                 and rest.lstrip().startswith("#")):
            self.fail(no, f"text after a value: {rest.strip()!r}")
        return value

    def plain(self, text: str, no: int):
        """A plain scalar, resolved as YAML 1.1 (PyYAML's ``safe_load``)."""
        if text[0] in _REFUSED_START:
            self.fail(no, _REFUSED_START[text[0]])
        if _BOOL.match(text):
            return text.lower() in ("yes", "true", "on")
        if _FLOAT.match(text):
            return _to_float(text)
        if _INT.match(text):
            return _to_int(text)
        if text == "<<":
            self.fail(no, "merge keys")
        if _NULL.match(text):
            return None
        if _TIMESTAMP.match(text):
            self.fail(no, f"timestamps ({text!r})")
        if text == "=":
            self.fail(no, "the value key '='")
        return text

    def quoted(self, text: str, pos: int, no: int):
        """The quoted scalar at ``pos`` -> (string, index after it)."""
        quote, i, out = text[pos], pos + 1, []
        while i < len(text):
            ch = text[i]
            if quote == "'":
                if ch == "'":
                    if text[i + 1:i + 2] == "'":
                        out.append("'")
                        i += 2
                        continue
                    return "".join(out), i + 1
            elif ch == '"':
                return "".join(out), i + 1
            elif ch == "\\":
                esc = text[i + 1:i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    i += 2
                    continue
                if esc in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[esc]
                    digits = text[i + 2:i + 2 + n]
                    if len(digits) != n or not re.fullmatch(
                            r"[0-9a-fA-F]+", digits):
                        self.fail(no, f"a bad escape '\\{esc}{digits}'")
                    out.append(chr(int(digits, 16)))
                    i += 2 + n
                    continue
                self.fail(no, "a line break or unknown escape in a "
                          "double-quoted scalar" if not esc else
                          f"the unknown escape '\\{esc}'")
            out.append(ch)
            i += 1
        self.fail(no, "a quoted scalar that runs over several lines")

    def flow_sequence(self, text: str, pos: int, no: int):
        """The flow sequence at ``pos`` -> (list, index after it)."""
        items, i = [], pos + 1
        while True:
            while i < len(text) and text[i] in " \t":
                i += 1
            if i >= len(text) or (text[i] == "#" and text[i - 1] in " \t"):
                self.fail(no, "a flow sequence that runs over several lines")
            ch = text[i]
            if ch == "]":
                return items, i + 1
            if ch == "[":
                item, i = self.flow_sequence(text, i, no)
            elif ch in "'\"":
                item, i = self.quoted(text, i, no)
            else:
                end = i
                while end < len(text) and text[end] not in ",[]{}" and not (
                        text[end] == "#" and text[end - 1] in " \t"):
                    end += 1
                word = text[i:end].rstrip()
                if not word:
                    self.fail(no, "an empty entry in a flow sequence")
                if re.search(r":(\s|$)", word):
                    self.fail(no, "a mapping inside a flow sequence")
                item, i = self.plain(word, no), end
            items.append(item)
            while i < len(text) and text[i] in " \t":
                i += 1
            if i < len(text) and text[i] == ",":
                i += 1
            elif not (i < len(text) and text[i] == "]"):
                self.fail(no, "expected ',' or ']' in a flow sequence")


def parse_yaml(text: str, path: str = "<string>"):
    """The document in ``text`` as Python values (``path`` names it in
    errors)."""
    return _Reader(text, path).document()


def read_yaml(path: str):
    with open(path, encoding="utf-8") as f:
        return parse_yaml(f.read(), path)


def _port_path(path: str) -> str:
    """``path``, or the port's copy for a file of the JAX package's
    defaults."""
    parts = Path(path).parts
    if len(parts) >= 4 and parts[-4:-1] == _JAX_DEFAULTS:
        return str(DEFAULTS_DIR / parts[-1])
    return path


def _deep_copy_plain(d):
    if isinstance(d, dict):
        return {k: _deep_copy_plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_deep_copy_plain(v) for v in d]
    return d


def _deep_merge(dst: dict, src: Mapping) -> dict:
    """Merge ``src`` into ``dst`` recursively, ``src`` winning."""
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = _deep_copy_plain(v)
    return dst


def load_yaml_chain(path: str, visited: set) -> dict:
    """The merged mapping of ``path`` and its ``base_config`` files, depth
    first (``visited`` guards against cycles)."""
    path = _port_path(os.path.normpath(path))
    if not os.path.exists(path):
        raise FileNotFoundError(f"config file not found: {path}")
    visited.add(path)
    raw = read_yaml(path) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: an experiment file is a mapping of keys")
    bases = raw.pop("base_config", [])
    if not isinstance(bases, list):
        bases = [bases]
    merged: dict = {}
    for base in bases:
        if base.startswith("."):
            base = os.path.normpath(os.path.join(os.path.dirname(path), base))
        if _port_path(base) not in visited:
            _deep_merge(merged, load_yaml_chain(base, visited))
    _deep_merge(merged, raw)
    return merged


def load_config(path: str, overrides: str | Mapping | None = None) -> Config:
    """The ``Config`` of the experiment file ``path`` and its chain, with
    ``overrides`` (a dotted-key string or a nested dict) applied last."""
    merged = load_yaml_chain(path, set())
    if overrides:
        if isinstance(overrides, str):
            overrides = parse_overrides(overrides)
        _deep_merge(merged, overrides)
    return Config().apply(merged)
