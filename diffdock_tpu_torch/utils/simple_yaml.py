"""A reader and writer for the YAML of run directories, without PyYAML.

The subset is what ``yaml.safe_dump(..., sort_keys=True)`` writes for a
run directory's ``model_parameters.yml`` (``{"model": asdict(cfg),
**extra}``), which also covers the reference's flat
``default_inference_args.yaml``:

* block mappings and block sequences, nested by indentation, including
  the sequence written at its key's indentation (``key:`` then ``- item``)
  and compact items (``- key: value``, ``- - x``);
* the empty collections ``[]`` and ``{}``;
* scalars: ``null``/``~``/empty, ``true``/``false``, decimal ints, floats
  with a dot (``1.0e-05``; ``1e-05`` is a string, as in YAML 1.1),
  ``.inf``/``-.inf``/``.nan``, single-quoted strings on one line and
  plain strings (``safe_dump`` writes a string with characters outside
  ASCII double-quoted with escapes, which raises);
* ``#`` comments.

Anything else raises :class:`YAMLError` with the line number, among it
every plain scalar that ``yaml.safe_load`` would read as another type in
a form ``safe_dump`` never writes (``yes``/``no``/``on``/``off``, ``0x``,
octal or sexagesimal numbers, timestamps), so no input is read otherwise
than PyYAML reads it. :func:`dump` writes the subset in ``safe_dump``'s
block style with sorted keys; ``yaml.safe_load`` reads it.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple


class YAMLError(ValueError):
    """Input outside the supported subset, with its line number."""


_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOATS = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf, ".nan": math.nan}
# what PyYAML's SafeLoader resolves to a bool, null, int, float, timestamp
# or merge key in forms outside the subset
_OTHER_IMPLICIT = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|True|TRUE|False|FALSE|on|On|ON|off|Off|OFF|Null|NULL|<<|="
    r"|[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[-+]?[0-9][0-9_]*_[0-9_]*|[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)$")
_PLAIN_SAFE = re.compile(r"^[A-Za-z_][A-Za-z0-9_./-]*$")


def _resolve(text: str, line: int) -> Any:
    """A plain scalar's value, as ``yaml.safe_load`` gives it."""
    if text in ("", "~", "null"):
        return None
    if text in ("true", "false"):
        return text == "true"
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _OTHER_IMPLICIT.match(text) or text[0] in "&*!|>%@`[]{}\"" or text.startswith(("- ", "? ")):
        raise YAMLError(f"line {line}: {text!r} is outside the supported YAML subset")
    return text


def _single_quoted_end(text: str, line: int) -> int:
    """The index of the quote closing the single-quoted scalar at ``text[0]``."""
    j = 1
    while j < len(text):
        if text[j] == "'":
            if text[j + 1:j + 2] != "'":
                return j
            j += 1
        j += 1
    raise YAMLError(f"line {line}: unterminated or multi-line quoted string")


def _strip_comment(text: str, line: int) -> str:
    """``text`` without a trailing ``# comment`` (outside single quotes)."""
    i = 0
    while i < len(text):
        if text[i] == "'" and (i == 0 or text[i - 1] in " -:"):
            i += _single_quoted_end(text[i:], line) + 1
            continue
        if text[i] == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _scalar(text: str, line: int) -> Any:
    text = text.strip()
    if text.startswith("'"):
        end = _single_quoted_end(text, line)
        if text[end + 1:].strip():
            raise YAMLError(f"line {line}: text after a quoted scalar: {text!r}")
        return text[1:end].replace("''", "'")
    if text in ("[]", "{}"):
        return [] if text == "[]" else {}
    return _resolve(text, line)


def _split_key(text: str, line: int):
    """(key, rest) of a ``key: rest`` or ``key:`` line, or None."""
    if text.startswith("'"):
        end = _single_quoted_end(text, line)
        rest = text[end + 1:].lstrip(" ")
        if rest == ":" or rest.startswith(": "):
            return text[1:end].replace("''", "'"), rest[1:].strip()
        return None
    m = re.search(r":(?: |$)", text)
    if m is None:
        return None
    return _resolve(text[:m.start()].strip(), line), text[m.end():].strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Parser:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str, int]] = []  # (indent, content, line number)
        for no, raw in enumerate(text.splitlines(), start=1):
            stripped = _strip_comment(raw, no)
            body = stripped.lstrip(" ")
            if not body:
                continue
            if body.startswith(("\t", "%", "---", "...")):
                raise YAMLError(f"line {no}: tabs, directives and document markers are outside "
                                "the supported YAML subset")
            self.lines.append((len(stripped) - len(body), body, no))
        self.i = 0

    def parse(self):
        if not self.lines:
            return None
        value = self.block(self.lines[0][0])
        if self.i < len(self.lines):
            raise YAMLError(f"line {self.lines[self.i][2]}: unexpected indentation")
        return value

    def _no_continuation(self, indent: int) -> None:
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YAMLError(f"line {self.lines[self.i][2]}: multi-line scalars are outside "
                            "the supported YAML subset")

    def block(self, indent: int):
        _, content, no = self.lines[self.i]
        if _is_item(content):
            return self.sequence(indent)
        if _split_key(content, no) is not None:
            return self.mapping(indent)
        self.i += 1
        self._no_continuation(indent)
        return _scalar(content, no)

    def _value_after(self, rest: str, indent: int, seq_at_indent: bool, no: int):
        """The value of a ``key:`` or ``-`` whose inline text is ``rest``."""
        if rest:
            value = _scalar(rest, no)
            self._no_continuation(indent)
            return value
        if self.i < len(self.lines):
            ind, content, _ = self.lines[self.i]
            if ind > indent:
                return self.block(ind)
            if seq_at_indent and ind == indent and _is_item(content):
                return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            ind, content, no = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError(f"line {no}: unexpected indentation")
            split = _split_key(content, no)
            if split is None:
                break
            key, rest = split
            self.i += 1
            if key in out:
                raise YAMLError(f"line {no}: duplicate key {key!r}")
            out[key] = self._value_after(rest, indent, True, no)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            ind, content, no = self.lines[self.i]
            if ind != indent or not _is_item(content):
                if ind > indent:
                    raise YAMLError(f"line {no}: unexpected indentation")
                break
            rest = content[1:].lstrip(" ")
            if rest and (_is_item(rest) or _split_key(rest, no) is not None):
                # a compact nested block: the item's text becomes a line of
                # its own at its column
                col = ind + len(content) - len(rest)
                self.lines[self.i] = (col, rest, no)
                out.append(self.block(col))
            else:
                self.i += 1
                out.append(self._value_after(rest, indent, False, no))
        return out


def load(text: str) -> Any:
    """The value ``yaml.safe_load(text)`` gives, for the supported subset."""
    return _Parser(text).parse()


# ----------------------------------------------------------------- writer


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if _PLAIN_SAFE.match(v) and not _OTHER_IMPLICIT.match(v) and _resolve(v, 0) == v:
            return v
        if v.isprintable():
            return "'" + v.replace("'", "''") + "'"
        raise YAMLError(f"cannot write {v!r}: unprintable characters are outside the subset")
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _dump(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k in sorted(v):
            val = v[k]
            key = _scalar_text(k)
            if isinstance(val, dict) and val:
                out.append(f"{pad}{key}:")
                _dump(val, indent + 2, out)
            elif isinstance(val, (list, tuple)) and val:
                out.append(f"{pad}{key}:")
                _dump(list(val), indent, out)
            else:
                out.append(f"{pad}{key}: {_inline(val)}")
    else:
        for item in v:
            if isinstance(item, (dict, list, tuple)) and item:
                sub: List[str] = []
                _dump(item if isinstance(item, dict) else list(item), indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(item)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar_text(v)


def dump(data: dict) -> str:
    """Block-style YAML for a dict of dicts, lists, tuples and scalars,
    keys sorted (the layout of ``yaml.safe_dump(data, sort_keys=True)``)."""
    out: List[str] = []
    _dump(data, 0, out)
    return "\n".join(out) + "\n"
