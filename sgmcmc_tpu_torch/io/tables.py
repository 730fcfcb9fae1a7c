"""CSV tables of rows (lists of dicts) without pandas.

The JAX package writes its experiment tables with pandas
(``pd.DataFrame(rows).to_csv(index=False)``) and aggregates them with
``pd.read_csv``, ``pd.concat`` and ``DataFrame.merge``.  The card's machine
has no pandas, so the port writes and aggregates the same tables here,
with pandas' column typing and formatting, so that its files are the ones
pandas would write:

* a column is ``int`` (integers only, none missing), ``float`` (numbers,
  some missing, or integers beside floats), ``bool`` (booleans only, none
  missing) or ``object`` (anything else; each value keeps its type);
* ints print as integers, floats by their shortest round trip (``repr``)
  and a float column's integers as floats (``3.0``), booleans as
  ``True`` / ``False``, missing values and NaN as empty fields.

Reading infers the same kinds from the text as ``pd.read_csv`` does.
"""
from __future__ import annotations

import csv
import io
import math
import numbers
import re

import numpy as np

from .checkpoint import atomic_write

# the strings pd.read_csv reads as missing by default
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|inf(inity)?)\Z",
                    re.IGNORECASE)
_BOOL = {"True": True, "TRUE": True, "true": True,
         "False": False, "FALSE": False, "false": False}


class Table:
    """Columns in order, each column's kind, and rows as dicts (a missing
    value is None, or NaN in a float column)."""

    def __init__(self, columns: list[str], kinds: dict, rows: list[dict]):
        self.columns, self.kinds, self.rows = columns, kinds, rows

    def __len__(self):
        return len(self.rows)

    def add_column(self, name: str, value) -> None:
        """A last column holding ``value`` in every row (``df[name] =
        value``)."""
        self.columns.append(name)
        self.kinds[name] = _kind([_plain(value)], False)
        for r in self.rows:
            r[name] = value


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _plain(v):
    """numpy scalars as Python ones."""
    return v.item() if isinstance(v, np.generic) else v


def _is_number(v) -> bool:
    return isinstance(v, numbers.Number) and not isinstance(v, bool)


def _kind(values: list, any_missing: bool) -> str:
    """The kind of a column holding ``values`` (its missing entries
    dropped; ``any_missing`` whether there were any)."""
    if values and all(isinstance(v, bool) for v in values):
        return "object" if any_missing else "bool"
    if values and all(_is_number(v) for v in values):
        if any_missing or any(isinstance(v, float) for v in values):
            return "float"
        return "int"
    return "object"


def _cast(v, kind: str):
    if kind == "float":
        return math.nan if _missing(v) else float(v)
    return None if _missing(v) else v


def from_rows(rows: list[dict]) -> Table:
    """The table ``pd.DataFrame(rows)`` makes: columns in order of first
    appearance, a key absent from a row a missing value."""
    rows = [{k: _plain(v) for k, v in r.items()} for r in rows]
    columns = list(dict.fromkeys(k for r in rows for k in r))
    kinds = {}
    for c in columns:
        vals = [r.get(c) for r in rows]
        present = [v for v in vals if not _missing(v)]
        kinds[c] = _kind(present, len(present) < len(vals))
        if kinds[c] == "object" and not present:
            # None throughout (pandas keeps an object column of None);
            # NaN throughout reads back as a float column
            if any(isinstance(v, float) for v in vals):
                kinds[c] = "float"
    return Table(columns, kinds, [{c: _cast(r.get(c), kinds[c])
                                   for c in columns} for r in rows])


def _format(v, kind: str) -> str:
    if _missing(v):
        return ""
    if isinstance(v, bool):
        return "True" if v else "False"
    if kind == "float" or isinstance(v, float):
        return repr(float(v))
    return str(v)


def to_csv_text(table: Table) -> str:
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(table.columns)
    for r in table.rows:
        w.writerow([_format(r[c], table.kinds[c]) for c in table.columns])
    return buf.getvalue()


def write_csv(path: str, rows_or_table) -> None:
    """Atomic CSV write of rows (a list of dicts) or a :class:`Table`, as
    ``pd.DataFrame(rows).to_csv(path, index=False)`` writes it."""
    table = (rows_or_table if isinstance(rows_or_table, Table)
             else from_rows(rows_or_table))
    atomic_write(path, lambda f: f.write(to_csv_text(table).encode()))


def _read_kind(cells: list[str]) -> str:
    present = [s for s in cells if s not in _NA]
    missing = len(present) < len(cells)
    if not present:
        return "float"
    if not missing and all(_INT.match(s) for s in present):
        return "int"
    if all(_FLOAT.match(s) for s in present):
        return "float"
    if all(s in _BOOL for s in present):
        return "object" if missing else "bool"
    return "object"


_POW10 = [float(f"1e{k}") for k in range(309)]
_PARTS = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\Z")


def _parse_float(s: str) -> float:
    """The float ``pd.read_csv`` reads from ``s``: its default parser
    (``precise_xstrtod``) keeps the first 17 digits, leading zeros
    counted, and scales them by one power of ten, which is not always
    the nearest double (``0.009986823000417644`` reads as
    ``0.0099868230004176``)."""
    m = _PARTS.match(s.strip())
    if m is None:
        return float(s)             # inf, infinity
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, int(exp or 0)
    for d in whole:
        if digits < 17:
            number = number * 10.0 + (ord(d) - 48)
            digits += 1
        else:
            exponent += 1
    for d in (frac or "")[:max(17 - digits, 0)]:
        number = number * 10.0 + (ord(d) - 48)
        digits += 1
        exponent -= 1
    if sign == "-":
        number = -number
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent >= 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 * number if exponent < -616 else \
            number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _read_value(s: str, kind: str, column_is_bool_like: bool):
    if s in _NA:
        return math.nan if kind == "float" else None
    if kind == "int":
        return int(s)
    if kind == "float":
        return _parse_float(s)
    if kind == "bool" or column_is_bool_like:
        return _BOOL[s]
    return s


def read_csv(path: str) -> Table:
    """The table ``pd.read_csv(path)`` reads: each column's kind inferred
    from its text."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        columns = next(reader)
        raw = [row for row in reader]
    kinds, rows = {}, [dict() for _ in raw]
    for j, c in enumerate(columns):
        cells = [row[j] if j < len(row) else "" for row in raw]
        kinds[c] = _read_kind(cells)
        bool_like = all(s in _BOOL for s in cells if s not in _NA) and \
            any(s not in _NA for s in cells)
        for r, s in zip(rows, cells):
            r[c] = _read_value(s, kinds[c], bool_like)
    return Table(columns, kinds, rows)


def _common_kind(kinds: list[str], missing: bool) -> str:
    ks = set(kinds)
    if ks == {"int"} and not missing:
        return "int"
    if ks <= {"int", "float"}:
        return "float"
    if ks == {"bool"} and not missing:
        return "bool"
    return "object"


def concat(tables: list[Table]) -> Table:
    """``pd.concat(frames, ignore_index=True)``: the union of the columns
    in order of first appearance, a column absent from a table missing in
    its rows."""
    columns = list(dict.fromkeys(c for t in tables for c in t.columns))
    kinds = {c: _common_kind([t.kinds[c] for t in tables if c in t.kinds],
                             any(c not in t.kinds for t in tables))
             for c in columns}
    rows = [{c: _cast(r.get(c), kinds[c]) for c in columns}
            for t in tables for r in t.rows]
    return Table(columns, kinds, rows)


def merge_left(left: Table, right: Table, on: str,
               suffixes=("", "_option")) -> Table:
    """``left.merge(right, on=on, how="left", suffixes=suffixes)`` for a
    ``right`` whose keys are unique: the left rows in order, the right
    table's other columns after the left's, names in both suffixed."""
    overlap = (set(left.columns) & set(right.columns)) - {on}

    def name(c, side):
        return c + suffixes[side] if c in overlap else c
    by_key = {r[on]: r for r in right.rows}
    matched = [by_key.get(r[on]) for r in left.rows]
    unmatched = any(m is None for m in matched)
    columns = [name(c, 0) for c in left.columns]
    kinds = {name(c, 0): left.kinds[c] for c in left.columns}
    right_cols = [c for c in right.columns if c != on]
    for c in right_cols:
        columns.append(name(c, 1))
        kinds[name(c, 1)] = _common_kind([right.kinds[c]], unmatched)
    rows = []
    for r, m in zip(left.rows, matched):
        row = {name(c, 0): r[c] for c in left.columns}
        for c in right_cols:
            row[name(c, 1)] = _cast(None if m is None else m[c],
                                    kinds[name(c, 1)])
        rows.append(row)
    return Table(columns, kinds, rows)
