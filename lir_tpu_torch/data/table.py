"""A small column table (name -> 1-D numpy array) with the few pandas
operations the analysis drivers use, each with pandas' ordering, and
pandas' CSV type inference.

The JAX package's analyses read their artifacts with ``pandas.read_csv``
and work on DataFrames; the card's machine has no pandas. Results hang on
pandas' semantics, so these follow them:

- a CSV column is ``int64`` when every cell is an integer and none is
  missing, ``float64`` when every cell present is a number (missing cells
  NaN), ``bool`` when every cell is a boolean word and none is missing,
  and otherwise an object column of the cells' text (missing cells NaN).
  "Missing" is one of pandas' default NA strings (:data:`NA_STRINGS`).
  So a confidence column of integers with one empty cell reads as floats,
  and its integers render as ``"85.0"``, as under pandas;
- :meth:`Table.unique` lists values in order of first appearance;
- :meth:`Table.groups` yields groups in sorted key order, missing keys
  dropped (``groupby``);
- :meth:`Table.pivot_table` averages duplicates, drops (index, column)
  cells whose mean is NaN, then rows and columns left empty, and sorts
  both axes (``pivot_table`` with its defaults);
- :meth:`Table.merge` is an inner join in the left table's row order,
  each left row followed by its right matches in their order.

Writing: :meth:`Table.to_csv` writes what ``DataFrame.to_csv(index=False)``
writes as far as ``read_csv`` can tell: an empty field for NaN and None,
floats in their shortest round-trip form, ``True``/``False``.
"""

from __future__ import annotations

import csv
import math
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# pandas._libs.parsers.STR_NA_VALUES (pandas 3.0): read_csv's default NA
# strings.
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT = re.compile(r"[ \t]*[+-]?[0-9]+[ \t]*")
_FLOAT = re.compile(
    r"[ \t]*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]{1,17})?"
    r"|(?i:inf|infinity))[ \t]*")
_DECIMAL = re.compile(
    r"[ \t]*([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]{1,17}))?[ \t]*")
_POW10 = [float(f"1e{k}") for k in range(309)]
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")
_INT64 = (-2**63, 2**63 - 1)


def parse_float(text: str) -> float:
    """A numeric cell's value as ``read_csv`` gives it: its C parser's
    default converter (``precise_xstrtod``), which accumulates at most 17
    digits in a double and scales by a power of ten, so it can land one
    unit in the last place from the correctly rounded ``float(text)``
    ("0.27629176373482295" reads as 0.2762917637348229)."""
    m = _DECIMAL.fullmatch(text)
    if m is None:
        return float(text)          # inf / infinity, any sign and case
    sign, whole, frac, exp = m.groups()
    number, exponent, digits = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in (frac or "")[:max(0, 17 - digits)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    if exp is not None:
        exponent += int(exp)
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def is_missing(value) -> bool:
    """pandas' ``isna`` for one cell: None or a float NaN."""
    return value is None or (isinstance(value, (float, np.floating))
                             and math.isnan(value))


def series_mean(values: np.ndarray) -> float:
    """``Series.mean()``: NaN skipped, NaN when nothing is left."""
    v = np.asarray(values, dtype=float)
    v = v[~np.isnan(v)]
    return float(v.mean()) if v.size else float("nan")


def series_std(values: np.ndarray) -> float:
    """``Series.std()``: NaN skipped, ddof 1, NaN for fewer than two
    values."""
    v = np.asarray(values, dtype=float)
    v = v[~np.isnan(v)]
    return float(np.std(v, ddof=1)) if v.size > 1 else float("nan")


def series_std0(values: np.ndarray) -> float:
    """``Series.std(ddof=0)``: NaN skipped, NaN when nothing is left."""
    v = np.asarray(values, dtype=float)
    v = v[~np.isnan(v)]
    return float(np.std(v)) if v.size else float("nan")


def to_numeric(values) -> np.ndarray:
    """``pd.to_numeric(values, errors="coerce")``: a numeric column as it
    is; text cells parsed as numbers (spaces around them allowed, pandas'
    float converter), missing and unparseable cells NaN; int64 when every
    cell is an integer, else float64."""
    arr = np.asarray(values)
    if arr.dtype.kind in "iufb":
        return arr
    if all(isinstance(v, (int, np.integer)) or (
            isinstance(v, str) and _INT.fullmatch(v)) for v in arr) and len(arr):
        return np.array([int(v) for v in arr], dtype=np.int64)
    out = np.full(len(arr), np.nan)
    for i, v in enumerate(arr):
        if is_missing(v):
            continue
        if isinstance(v, (int, float, np.integer, np.floating)):
            out[i] = v
        elif _FLOAT.fullmatch(str(v)):
            out[i] = parse_float(str(v))
    return out


def infer_column(cells: Sequence[str]) -> np.ndarray:
    """The array ``read_csv`` makes of one column's raw text cells."""
    missing = np.array([c in NA_STRINGS for c in cells], dtype=bool)
    present = [c for c, m in zip(cells, missing) if not m]
    n = len(cells)
    if not present:
        return np.full(n, np.nan)
    if not missing.any() and all(_INT.fullmatch(c) for c in present):
        ints = [int(c) for c in present]
        if _INT64[0] <= min(ints) and max(ints) <= _INT64[1]:
            return np.array(ints, dtype=np.int64)
    if all(_FLOAT.fullmatch(c) for c in present):
        out = np.full(n, np.nan)
        out[~missing] = [parse_float(c) for c in present]
        return out
    if all(c in _TRUE or c in _FALSE for c in present):
        if not missing.any():
            return np.array([c in _TRUE for c in present], dtype=bool)
        return _objects([np.nan if m else c in _TRUE
                         for c, m in zip(cells, missing)])
    return _objects([np.nan if m else c for c, m in zip(cells, missing)])


def _objects(values: Sequence[object]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def _column(values: Sequence[object]) -> np.ndarray:
    """The column ``pd.DataFrame`` makes of one key's record values: int64,
    float64 (None as NaN) or bool where every value is one, else object."""
    vals = list(values)
    present = [v for v in vals if not is_missing(v)]
    if all(isinstance(v, (bool, np.bool_)) for v in present) and present:
        if len(present) == len(vals):
            return np.array(vals, dtype=bool)
        return _objects([np.nan if v is None else v for v in vals])
    numeric = [isinstance(v, (int, float, np.integer, np.floating))
               and not isinstance(v, (bool, np.bool_)) for v in present]
    if all(numeric):
        if len(present) == len(vals) and all(
                isinstance(v, (int, np.integer)) for v in vals):
            return np.array(vals, dtype=np.int64)
        return np.array([np.nan if v is None else v for v in vals],
                        dtype=np.float64)
    return _objects([np.nan if v is None else v for v in vals])


def _key(value):
    """A hashable stand-in for a cell: every NaN is one key."""
    return _NAN_KEY if is_missing(value) else value


_NAN_KEY = ("<nan>",)


def cell_text(value) -> object:
    """A cell as ``DataFrame.to_csv`` writes it (for the csv module): an
    empty field for None and NaN, numpy scalars as Python ones (floats in
    their shortest round-trip form)."""
    if is_missing(value):
        return ""
    if isinstance(value, np.generic):
        return value.item()
    return value


def write_csv(path: Path, header: Sequence[str],
              rows: Sequence[Sequence[object]]) -> None:
    """A CSV as ``DataFrame.to_csv`` writes it: minimal quoting, ``\\n``
    line ends. With no header and no rows, a single newline."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="", encoding="utf-8") as f:
        if not header:
            f.write("\n")
            return
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([[cell_text(v) for v in row] for row in rows])


class Table:
    """Columns of one length, in insertion order."""

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None):
        self._cols: Dict[str, np.ndarray] = {}
        n = None
        for name, values in (columns or {}).items():
            arr = np.asarray(values)
            if arr.ndim != 1 or (n is not None and arr.shape[0] != n):
                raise ValueError(f"column {name!r}: shape {arr.shape}")
            n = arr.shape[0]
            self._cols[name] = arr

    @classmethod
    def from_records(cls, records: Sequence[Dict[str, object]],
                     columns: Optional[Sequence[str]] = None) -> "Table":
        """``pd.DataFrame(records[, columns])``: the keys in order of first
        appearance (or ``columns``), a key a record lacks as NaN."""
        if columns is None:
            columns = list(dict.fromkeys(k for r in records for k in r))
        return cls({c: _column([r.get(c) for r in records])
                    for c in columns})

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return next(iter(self._cols.values())).shape[0] if self._cols else 0

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def assign(self, name: str, values) -> "Table":
        """A copy with column ``name`` set (appended if new)."""
        cols = dict(self._cols)
        cols[name] = np.asarray(values)
        return Table(cols)

    def take(self, rows) -> "Table":
        """The rows selected by a boolean mask or an index array."""
        return Table({c: v[rows] for c, v in self._cols.items()})

    def where(self, name: str, value) -> "Table":
        """The rows whose ``name`` equals ``value`` (none for NaN)."""
        return self.take(np.array([not is_missing(v) and v == value
                                   for v in self._cols[name]], dtype=bool))

    def records(self) -> Iterator[Dict[str, object]]:
        cols = list(self._cols.items())
        for i in range(len(self)):
            yield {c: v[i] for c, v in cols}

    def unique(self, name: str) -> list:
        """``Series.unique()``: values in order of first appearance, NaN
        once."""
        seen = {}
        for v in self._cols[name]:
            seen.setdefault(_key(v), v)
        return list(seen.values())

    def codes(self, name: str) -> np.ndarray:
        """``pd.factorize(column)[0]``: each value's index in
        :meth:`unique` (NaN -1)."""
        index = {}
        for v in self._cols[name]:
            if not is_missing(v):
                index.setdefault(v, len(index))
        return np.array([-1 if is_missing(v) else index[v]
                         for v in self._cols[name]], dtype=np.int64)

    def groups(self, name: str) -> List[Tuple[object, "Table"]]:
        """``groupby(name)``: (key, rows) in sorted key order, rows in table
        order, missing keys dropped."""
        members: Dict[object, List[int]] = {}
        for i, v in enumerate(self._cols[name]):
            if not is_missing(v):
                members.setdefault(v, []).append(i)
        return [(k, self.take(np.array(members[k], dtype=np.int64)))
                for k in sorted(members)]

    def pivot_table(self, index: str, columns: str, values: str) -> "Pivot":
        """``pivot_table(index=, columns=, values=)`` with its defaults:
        the mean over duplicate (index, column) pairs, summed as pandas'
        grouped mean sums (compensated), NaN values skipped."""
        acc: Dict[Tuple[object, object], List[float]] = {}
        for i, c, v in zip(self._cols[index], self._cols[columns],
                           self._cols[values]):
            if is_missing(i) or is_missing(c):
                continue
            s = acc.setdefault((i, c), [0.0, 0.0, 0])
            if not is_missing(v):
                y = float(v) - s[1]
                t = s[0] + y
                s[1] = t - s[0] - y
                if math.isnan(s[1]):
                    s[1] = 0.0
                s[0] = t
                s[2] += 1
        means = {k: s[0] / s[2] for k, s in acc.items() if s[2]}
        rows = sorted({i for i, _ in means})
        cols = sorted({c for _, c in means})
        r_at = {r: n for n, r in enumerate(rows)}
        c_at = {c: n for n, c in enumerate(cols)}
        out = np.full((len(rows), len(cols)), np.nan)
        for (i, c), m in means.items():
            out[r_at[i], c_at[c]] = m
        return Pivot(rows, cols, out, index)

    def merge(self, other: "Table", on: str,
              suffixes: Tuple[str, str]) -> "Table":
        """``pd.merge(self, other, on=on, suffixes=suffixes)`` (inner),
        by pandas' own join (``libjoin.inner_join``): the matched pairs by
        key, then put back in left-row order, each left row's right
        matches in their order; except where the pairs happen to number
        the left rows, where pandas reorders them by its no-duplicates
        shortcut, as here. Missing keys match each other. Columns both
        sides have (``on`` apart) take the suffixes."""
        labels: Dict[object, int] = {}
        for v in list(self[on]) + list(other[on]):
            if not is_missing(v):
                labels.setdefault(v, len(labels))
        nan_label = len(labels)

        def label(values) -> np.ndarray:
            return np.array([nan_label if is_missing(v) else labels[v]
                             for v in values], dtype=np.int64)

        llab, rlab = label(self[on]), label(other[on])
        groups = nan_label + 1
        lsort = np.argsort(llab, kind="stable")
        rsort = np.argsort(rlab, kind="stable")
        lcount = np.bincount(llab, minlength=groups)
        rcount = np.bincount(rlab, minlength=groups)
        lstart = np.concatenate([[0], np.cumsum(lcount)[:-1]])
        rstart = np.concatenate([[0], np.cumsum(rcount)[:-1]])
        left, right = [], []
        for g in range(groups):
            for j in range(lcount[g] if rcount[g] else 0):
                left.extend([lstart[g] + j] * rcount[g])
                right.extend(range(rstart[g], rstart[g] + rcount[g]))
        li = lsort[np.array(left, dtype=np.int64)]
        ri = rsort[np.array(right, dtype=np.int64)]
        if len(li) == len(llab):
            rev = np.empty(len(llab), dtype=np.int64)
            rev[lsort] = np.arange(len(llab))
        else:
            rev = np.argsort(li, kind="stable")
        li, ri = li[rev], ri[rev]
        shared = set(self.columns) & set(other.columns) - {on}
        cols: Dict[str, np.ndarray] = {}
        for c in self.columns:
            cols[c + suffixes[0] if c in shared else c] = self[c][li]
        for c in other.columns:
            if c != on:
                cols[c + suffixes[1] if c in shared else c] = other[c][ri]
        return Table(cols)

    def to_csv(self, path: Path) -> None:
        """``DataFrame.to_csv(path, index=False)``."""
        cols = list(self._cols.values())
        write_csv(path, self.columns,
                  [[c[i] for c in cols] for i in range(len(self))])


class Pivot:
    """A ``pivot_table`` result: sorted row and column labels over a
    float matrix."""

    def __init__(self, index: list, columns: list, values: np.ndarray,
                 index_name: str):
        self.index, self.columns = list(index), list(columns)
        self.values = values
        self.index_name = index_name

    def __getitem__(self, column) -> np.ndarray:
        """One column (KeyError when the pivot dropped or never had it)."""
        if column not in self.columns:
            raise KeyError(column)
        return self.values[:, self.columns.index(column)]

    def dropna(self, thresh: Optional[int] = None) -> "Pivot":
        """The rows with no NaN, or with at least ``thresh`` values."""
        count = (~np.isnan(self.values)).sum(axis=1)
        keep = count >= (self.values.shape[1] if thresh is None else thresh)
        return Pivot([r for r, k in zip(self.index, keep) if k],
                     self.columns, self.values[keep], self.index_name)

    def to_csv(self, path: Path) -> None:
        """``DataFrame.to_csv(path)``: the index as the first column."""
        write_csv(path, [self.index_name] + [str(c) for c in self.columns],
                  [[r] + list(row) for r, row in zip(self.index,
                                                     self.values)])


def read_table(path: Path) -> Table:
    """``pd.read_csv(path)``: the header, then each column by
    :func:`infer_column`; blank lines skipped, short rows padded with
    missing cells."""
    from .schemas import _parse_csv

    header, rows = _parse_csv(Path(path))
    rows = [r for r in rows if r]
    n = len(header)
    cells = [r + [""] * (n - len(r)) for r in rows]
    return Table({name: infer_column([r[j] for r in cells])
                  for j, name in enumerate(header)})
