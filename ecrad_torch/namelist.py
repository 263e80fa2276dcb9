"""Fortran namelist parser.

Reads the same ``&radiation`` / ``&radiation_driver`` namelist files the
reference CLI consumes (e.g. ecRad's test/ifs/configCY49R1.nam), so
the reference test configurations run unchanged against this framework.

Supports the subset of the namelist grammar the ecRad configs use:
  * groups:        &name ... /
  * comments:      ! to end of line
  * scalars:       key = value
  * arrays:        key = v1, v2, v3      and    key(1:5) = v1, ..., v5
  * indexed sets:  key(3) = v
  * booleans:      true/false/.true./.false./T/F
  * strings:       'single' or "double" quoted
"""

from __future__ import annotations

import re
from typing import Any, Dict


_GROUP_RE = re.compile(r"&(\w+)")
_ASSIGN_RE = re.compile(
    r"^\s*([A-Za-z]\w*)\s*(\(([^)]*)\))?\s*=\s*(.*)$", re.S
)


def _strip_comments(text: str) -> str:
    out_lines = []
    for line in text.splitlines():
        # A '!' outside of quotes starts a comment
        in_sq = in_dq = False
        cut = len(line)
        for i, ch in enumerate(line):
            if ch == "'" and not in_dq:
                in_sq = not in_sq
            elif ch == '"' and not in_sq:
                in_dq = not in_dq
            elif ch == "!" and not in_sq and not in_dq:
                cut = i
                break
        out_lines.append(line[:cut])
    return "\n".join(out_lines)


def _parse_value_token(tok: str) -> Any:
    t = tok.strip()
    if not t:
        return None
    if (t[0] == "'" and t[-1] == "'") or (t[0] == '"' and t[-1] == '"'):
        return t[1:-1]
    tl = t.lower().rstrip(",")
    if tl in ("true", ".true.", "t", ".t."):
        return True
    if tl in ("false", ".false.", "f", ".f."):
        return False
    # Fortran floats may use d/D exponent
    tnum = tl.replace("d", "e").replace("D", "e")
    try:
        if re.fullmatch(r"[+-]?\d+", tnum):
            return int(tnum)
        return float(tnum)
    except ValueError:
        return t  # bare string (rare but appears in hand-written namelists)


def _split_values(rhs: str) -> list:
    """Split a right-hand side on commas/whitespace, respecting quotes."""
    vals = []
    buf = ""
    in_sq = in_dq = False
    for ch in rhs:
        if ch == "'" and not in_dq:
            in_sq = not in_sq
            buf += ch
        elif ch == '"' and not in_sq:
            in_dq = not in_dq
            buf += ch
        elif ch in ", \t\n" and not in_sq and not in_dq:
            if buf:
                vals.append(buf)
                buf = ""
        else:
            buf += ch
    if buf:
        vals.append(buf)
    return [_parse_value_token(v) for v in vals if v.strip()]


def parse_namelist(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse namelist text into {group_name: {key: value}} (keys lowercase).

    Array assignments yield Python lists; `key(i) =` and `key(i:j) =` merge
    into a dict {index: value} stored under the bare key as a list padded with
    None where unset (1-based Fortran indices mapped to 0-based positions).
    """
    text = _strip_comments(text)
    groups: Dict[str, Dict[str, Any]] = {}
    cur: Dict[str, Any] | None = None

    # Split into statements: groups open with &name, close with / on its own
    i = 0
    lines = text.splitlines()
    # Re-join continued assignments: a line that doesn't contain '=' and
    # doesn't open/close a group continues the previous assignment.
    stmts: list[str] = []
    for line in lines:
        s = line.strip()
        if not s:
            continue
        if s.startswith("&"):
            stmts.append(s)
        elif s == "/":
            stmts.append(s)
        elif "=" in s and _ASSIGN_RE.match(s):
            stmts.append(s)
        else:
            if stmts and stmts[-1] not in ("/",) and not stmts[-1].startswith("&"):
                stmts[-1] += " " + s
            # else stray tokens; ignore
    del i

    for s in stmts:
        if s.startswith("&"):
            m = _GROUP_RE.match(s)
            name = m.group(1).lower()
            cur = groups.setdefault(name, {})
            rest = s[m.end():].strip()
            if rest:
                stmts_inline = rest
                m2 = _ASSIGN_RE.match(stmts_inline)
                if m2:
                    _apply_assignment(cur, m2)
            continue
        if s == "/":
            cur = None
            continue
        if cur is None:
            continue
        m = _ASSIGN_RE.match(s)
        if m:
            _apply_assignment(cur, m)
    return groups


def _apply_assignment(group: Dict[str, Any], m: re.Match) -> None:
    key = m.group(1).lower()
    subscript = m.group(3)
    vals = _split_values(m.group(4))
    if subscript is None:
        group[key] = vals[0] if len(vals) == 1 else vals
        return
    # key(i) or key(i:j): merge into list under bare key
    sub = subscript.strip()
    existing = group.get(key)
    if not isinstance(existing, list):
        existing = [] if existing is None else [existing]
    if ":" in sub:
        lo, hi = sub.split(":")
        lo = int(lo)
        _grow(existing, lo - 1 + len(vals))
        for k, v in enumerate(vals):
            existing[lo - 1 + k] = v
    else:
        idx = int(sub)
        _grow(existing, idx)
        if len(vals) == 1:
            existing[idx - 1] = vals[0]
        else:
            _grow(existing, idx - 1 + len(vals))
            for k, v in enumerate(vals):
                existing[idx - 1 + k] = v
    group[key] = existing


def _grow(lst: list, n: int) -> None:
    while len(lst) < n:
        lst.append(None)


def read_namelist_file(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path, "r") as f:
        return parse_namelist(f.read())
