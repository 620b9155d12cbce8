"""A reader of the YAML subset the repo's runfiles use, with PyYAML's
YAML 1.1 meanings (`yaml.load(..., Loader=FullLoader)`), for machines
without PyYAML.

The subset: block mappings and block sequences nested by indentation
(spaces), flow sequences (also over several lines), single- and
double-quoted scalars, plain scalars resolved as null, bool, decimal int
or float, comments, `&anchor`, `*alias` and `<<:` merge keys. Anything
else (flow mappings, block scalars, tags, documents, directives, octal,
hex or sexagesimal numbers, multi-line plain scalars, compact mappings
in sequence items) raises YAMLSubsetError.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# YAML 1.1 numbers outside the subset: binary, octal, hex, sexagesimal
_OTHER_NUMBER = re.compile(r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$"
                           r"|[-+]?0x[0-9a-fA-F_]+$"
                           r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_INDICATORS = set("&*!|>'\"%@`{}[],#?")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
            "r": "\r", "0": "\0", " ": " "}


class YAMLSubsetError(ValueError):
    """The text is outside the YAML subset this reader takes."""


def _resolve_plain(s: str, where: str):
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s[0] == "-" else float("inf")
    if _NAN.match(s):
        return float("nan")
    if _OTHER_NUMBER.match(s):
        raise YAMLSubsetError(f"{where}: number {s!r} outside the subset")
    if s[0] in _INDICATORS or s.startswith(("- ", ": ")) \
            or ": " in s or s.endswith(":") or " #" in s:
        raise YAMLSubsetError(f"{where}: plain scalar {s!r} outside the "
                              "subset")
    return s


def _quoted(s: str, i: int, where: str) -> Tuple[str, int]:
    """Parse the quoted scalar starting at s[i] -> (value, index after)."""
    q = s[i]
    out = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = s[j + 1:j + 2]
            if esc not in _ESCAPES:
                raise YAMLSubsetError(f"{where}: escape \\{esc} outside "
                                      "the subset")
            out.append(_ESCAPES[esc])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise YAMLSubsetError(f"{where}: unterminated quoted scalar")


def _strip_comment(line: str) -> str:
    """Drop a trailing comment (a # at the line start or after a space,
    outside quoted scalars)."""
    i = 0
    prev = ""
    while i < len(line):
        c = line[i]
        if c in "'\"" and prev in ("", ":", "-", "[", ",", "{"):
            _, i = _quoted(line, i, "comment scan")
            prev = c
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        if not c.isspace():
            prev = c
        i += 1
    return line.rstrip()


def _bracket_depth(s: str) -> int:
    depth, i, prev = 0, 0, ""
    while i < len(s):
        c = s[i]
        if c in "'\"" and prev in ("", ":", "-", "[", ","):
            _, i = _quoted(s, i, "flow sequence")
            prev = c
            continue
        depth += (c == "[") - (c == "]")
        if not c.isspace():
            prev = c
        i += 1
    return depth


class _Reader:
    def __init__(self, text: str):
        self.anchors: Dict[str, Any] = {}
        self.lines: List[Tuple[int, str, int]] = []   # (indent, text, no)
        pending = None
        for no, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw)
            if pending is not None:
                ind, txt, start = pending
                txt = f"{txt} {body.strip()}"
                if _bracket_depth(txt) <= 0:
                    self.lines.append((ind, txt, start))
                    pending = None
                else:
                    pending = (ind, txt, start)
                continue
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                raise YAMLSubsetError(f"line {no}: tab indentation")
            if stripped.startswith(("---", "...", "%")):
                raise YAMLSubsetError(f"line {no}: documents and directives "
                                      "are outside the subset")
            ind = len(body) - len(stripped)
            if _bracket_depth(stripped) > 0:
                pending = (ind, stripped, no)
            else:
                self.lines.append((ind, stripped, no))
        if pending is not None:
            raise YAMLSubsetError(f"line {pending[2]}: unclosed [")
        self.i = 0

    def parse(self):
        if not self.lines:
            return None
        node = self._block(self.lines[0][0])
        if self.i != len(self.lines):
            raise YAMLSubsetError(f"line {self.lines[self.i][2]}: bad "
                                  "indentation")
        return node

    def _block(self, indent: int):
        if self.lines[self.i][1] == "-" or \
                self.lines[self.i][1].startswith("- "):
            return self._sequence(indent)
        return self._mapping(indent)

    def _nested(self, indent: int, no: int, seq_ok: bool):
        """The block under a key or item whose value is on the next
        lines (or null when there is none)."""
        if self.i < len(self.lines):
            ind, txt, _ = self.lines[self.i]
            if ind > indent:
                return self._block(ind)
            if seq_ok and ind == indent and (txt == "-"
                                             or txt.startswith("- ")):
                return self._sequence(indent)
        return None

    def _sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, txt, no = self.lines[self.i]
            if ind != indent or not (txt == "-" or txt.startswith("- ")):
                break
            self.i += 1
            rest = txt[1:].strip()
            if re.match(r"[^'\"\[&*][^:]*:(?: |$)", rest):
                raise YAMLSubsetError(f"line {no}: a mapping in a sequence "
                                      "item is outside the subset")
            out.append(self._value(rest, indent, no, seq_ok=False))
        return out

    def _mapping(self, indent: int) -> dict:
        explicit: Dict[Any, Any] = {}
        merges = []
        while self.i < len(self.lines):
            ind, txt, no = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent or txt == "-" or txt.startswith("- "):
                raise YAMLSubsetError(f"line {no}: bad indentation or a "
                                      "multi-line plain scalar")
            self.i += 1
            key, rest = self._key(txt, no)
            value = self._value(rest, indent, no, seq_ok=True)
            if key == "<<":
                if isinstance(value, dict):
                    merges.append(value)
                elif isinstance(value, list) and all(
                        isinstance(v, dict) for v in value):
                    merges.extend(reversed(value))
                else:
                    raise YAMLSubsetError(f"line {no}: << takes a mapping "
                                          "or a list of mappings")
            else:
                explicit[key] = value
        out: Dict[Any, Any] = {}
        for m in merges:
            out.update(m)
        out.update(explicit)
        return out

    def _key(self, txt: str, no: int):
        where = f"line {no}"
        if txt[0] in "'\"":
            key, j = _quoted(txt, 0, where)
            if txt[j:j + 1] != ":" or txt[j + 1:j + 2] not in ("", " "):
                raise YAMLSubsetError(f"{where}: expected ':' after key")
            return key, txt[j + 1:].strip()
        m = re.match(r"(.*?):(?: |$)", txt)
        if m is None:
            raise YAMLSubsetError(f"{where}: expected 'key: value'")
        raw = m.group(1).strip()
        if raw == "<<":
            return "<<", txt[m.end():].strip()
        return _resolve_plain(raw, where), txt[m.end():].strip()

    def _value(self, rest: str, indent: int, no: int, seq_ok: bool):
        where = f"line {no}"
        anchor = None
        if rest.startswith("&"):
            m = re.match(r"&(\S+)\s*(.*)$", rest)
            anchor, rest = m.group(1), m.group(2)
        if rest == "":
            value = self._nested(indent, no, seq_ok)
        elif rest.startswith("*"):
            value = self._alias(rest, where)
        elif rest.startswith("["):
            value, j = self._flow(rest, 0, where)
            if rest[j:].strip():
                raise YAMLSubsetError(f"{where}: text after ]")
        elif rest[0] in "'\"":
            value, j = _quoted(rest, 0, where)
            if rest[j:].strip():
                raise YAMLSubsetError(f"{where}: text after a quoted "
                                      "scalar")
        else:
            value = _resolve_plain(rest, where)
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def _alias(self, s: str, where: str):
        name = s[1:].strip()
        if name not in self.anchors:
            raise YAMLSubsetError(f"{where}: unknown alias *{name}")
        return self.anchors[name]

    def _flow(self, s: str, i: int, where: str):
        """Parse the flow sequence starting at s[i] == '['."""
        out = []
        i += 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i >= len(s):
                raise YAMLSubsetError(f"{where}: unclosed [")
            c = s[i]
            if c == "]":
                return out, i + 1
            if c == "[":
                item, i = self._flow(s, i, where)
            elif c in "'\"":
                item, i = _quoted(s, i, where)
            elif c == "{":
                raise YAMLSubsetError(f"{where}: flow mappings are outside "
                                      "the subset")
            else:
                m = re.compile(r"[^,\]]*").match(s, i)
                tok = m.group(0).strip()
                i = m.end()
                item = self._alias(tok, where) if tok.startswith("*") \
                    else _resolve_plain(tok, where)
            out.append(item)
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == ",":
                i += 1
            elif i < len(s) and s[i] != "]":
                raise YAMLSubsetError(f"{where}: expected , or ]")


def load(text: str):
    """The Python value of a YAML document in the subset."""
    return _Reader(text).parse()
