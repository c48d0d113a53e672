"""String functions as dictionary side tables (the port of
``materialize_tpu/expr/strings.py``).

Strings live on the host in the dictionary (``repr/schema.py``); device
columns hold order-preserving int64 codes. A string function over a
column is therefore a gather through a table: for ``upper``, ``table[code]
= encode(upper(decode(code)))``. The function runs once per distinct
string on the host, and the device does one search and one gather over
the column.

Where the reference passes the tables into its traced step as inputs
(``build_env``/``trace_scope``), the port evaluates eagerly:
``eval_expr`` asks ``table(key, device)`` for the table at the
dictionary's current version when it evaluates the call. So a nested
call (``upper(trim(x))``) finds the strings the inner call added, and
the reference's pass count (``collect_keys``'s depth) is not needed.
A gap that runs out raises ``DictExhausted``; the replica then
rebalances the dictionary and rebuilds its dataflows (tables are kept
per dictionary epoch, so none built on the old labelling is reused).

Strings are coded in ``GLOBAL_DICT`` unless ``dictionary_scope(d)`` says
the data (and the plan's string literals, ``plan_statement(...,
dictionary=d)``) are coded in ``d``: a table is built over the
dictionary in scope and its results are coded there (each dictionary
keeps its own tables).
"""

from __future__ import annotations

import contextlib
import contextvars
import re

import numpy as np
import torch

from ..repr.batch import capacity_tier
from ..repr.schema import GLOBAL_DICT


_DICTIONARY = contextvars.ContextVar("string_dictionary", default=GLOBAL_DICT)


@contextlib.contextmanager
def dictionary_scope(dictionary):
    """Evaluate string functions over data coded in ``dictionary``."""
    token = _DICTIONARY.set(dictionary)
    try:
        yield
    finally:
        _DICTIONARY.reset(token)


def current_dictionary():
    """The dictionary that codes the strings being evaluated."""
    return _DICTIONARY.get()


def env_key(func: str, *params) -> str:
    return "\x00".join([func] + [str(p) for p in params])


# -- host-side table computation ---------------------------------------------


def _like_regex(pattern: str, case_insensitive: bool) -> "re.Pattern":
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        elif ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 1
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile(
        "(?s)" + "".join(out) + r"\Z",
        re.IGNORECASE if case_insensitive else 0,
    )


def _apply(func: str, params: tuple, s: str):
    """One string through one function (the host-side scalar kernel)."""
    if func == "upper":
        return s.upper()
    if func == "lower":
        return s.lower()
    if func == "trim":
        return s.strip(params[0]) if params else s.strip()
    if func == "ltrim":
        return s.lstrip(params[0]) if params else s.lstrip()
    if func == "rtrim":
        return s.rstrip(params[0]) if params else s.rstrip()
    if func == "initcap":
        return re.sub(
            r"[a-zA-Z0-9]+", lambda m: m.group(0).capitalize(), s
        )
    if func == "reverse":
        return s[::-1]
    if func == "length":
        return len(s)
    if func == "ascii":
        return ord(s[0]) if s else 0
    if func == "bit_length":
        return 8 * len(s.encode())
    if func == "octet_length":
        return len(s.encode())
    if func == "substr":
        start = int(params[0])
        # SQL substr is 1-based; start may be <= 0 (pg semantics)
        if len(params) > 1:
            n = int(params[1])
            end = start + n
            return s[max(start - 1, 0) : max(end - 1, 0)]
        return s[max(start - 1, 0) :]
    if func == "left":
        n = int(params[0])
        return s[:n] if n >= 0 else s[: len(s) + n]
    if func == "right":
        n = int(params[0])
        if n >= 0:
            return s[max(len(s) - n, 0) :] if n else ""
        return s[-n:]
    if func == "replace":
        return s.replace(params[0], params[1])
    if func == "concat_r":  # col || literal
        return s + params[0]
    if func == "concat_l":  # literal || col
        return params[0] + s
    if func == "lpad":
        n = int(params[0])
        fill = params[1] if len(params) > 1 else " "
        if len(s) >= n:
            return s[:n]
        pad = (fill * n)[: n - len(s)]
        return pad + s
    if func == "rpad":
        n = int(params[0])
        fill = params[1] if len(params) > 1 else " "
        if len(s) >= n:
            return s[:n]
        return s + (fill * n)[: n - len(s)]
    if func == "like":
        return bool(_like_regex(params[0], False).match(s))
    if func == "ilike":
        return bool(_like_regex(params[0], True).match(s))
    if func == "regex":
        return re.search(params[0], s) is not None
    if func == "position":
        return s.find(params[0]) + 1  # 0 when absent (pg)
    if func == "split_part":
        parts = s.split(params[0])
        i = int(params[1])
        return parts[i - 1] if 1 <= i <= len(parts) else ""
    raise NotImplementedError(func)


# result kind per function: code->code ("str"), ->int64, ->bool
RESULT_KINDS = {
    "upper": "str", "lower": "str", "trim": "str", "ltrim": "str",
    "rtrim": "str", "initcap": "str", "reverse": "str", "substr": "str",
    "left": "str", "right": "str", "replace": "str", "concat_r": "str",
    "concat_l": "str", "lpad": "str", "rpad": "str", "split_part": "str",
    "length": "int", "ascii": "int", "bit_length": "int",
    "octet_length": "int", "position": "int",
    "like": "bool", "ilike": "bool", "regex": "bool",
}


class _TableCache:
    """Host cache of one dictionary: key -> (labels, values) numpy
    arrays, padded to a power-of-two tier of the dictionary size, and
    their device copies.
    Codes are sparse order-preserving labels, so a table is a sorted
    label array and a parallel value array; the lookup is a search of
    the code, then a gather. ``_apply`` runs once per (key, string)
    ever: a table rebuilt after the dictionary grew computes only the
    new strings."""

    def __init__(self, dictionary):
        self.dictionary = dictionary
        self._host: dict = {}  # key -> (version, labels, values)
        self._device: dict = {}  # (key, device) -> (version, labels, values)
        self._done: dict = {}  # key -> {code: result}

    def host_table(self, key: str) -> tuple:
        d = self.dictionary
        cached = self._host.get(key)
        if cached is not None and cached[0] == d.version:
            return cached
        parts = key.split("\x00")
        func, params = parts[0], tuple(parts[1:])
        kind = RESULT_KINDS[func]
        dtype = {"str": np.int64, "int": np.int64, "bool": np.bool_}[kind]
        done = self._done.setdefault(key, {})
        # The version before the build: encoding a 'str' function's
        # results grows the dictionary past this snapshot, and the table
        # covers the snapshot only.
        pre_version = d.version
        pairs = d.items_sorted()
        todo = [(c, s) for c, s in pairs if c not in done]
        if kind == "str":
            # Compute every result first, bulk-insert the new strings
            # (even gap division), then map.
            results = [(c, _apply(func, params, s)) for c, s in todo]
            d.encode_bulk([v for _, v in results])
            for c, v in results:
                done[c] = d.encode(v)
        else:
            for c, s in todo:
                done[c] = _apply(func, params, s)
        n = len(pairs)
        tier = capacity_tier(max(n, 1))
        labels = np.full(tier, d.MAX_LABEL, dtype=np.int64)
        labels[:n] = [c for c, _ in pairs]
        values = np.zeros(tier, dtype=dtype)
        values[:n] = [done[c] for c, _ in pairs]
        self._host[key] = (pre_version, labels, values)
        return self._host[key]

    def table(self, key: str, device) -> tuple:
        version, labels, values = self.host_table(key)
        dkey = (key, str(device))
        cached = self._device.get(dkey)
        if cached is None or cached[0] != version:
            cached = (version, torch.from_numpy(labels).to(device),
                      torch.from_numpy(values).to(device))
            self._device[dkey] = cached
        return cached[1], cached[2]


_CACHES: dict = {}  # (id(dictionary), its rebalance epoch) -> _TableCache


def table(key: str, device) -> tuple:
    """The (sorted labels, values) tensors of a string function's table
    on ``device``, over the dictionary in scope at its current state."""
    d = current_dictionary()
    # A dictionary that rebalances (the reference's) recodes every
    # string: its tables start afresh at each epoch.
    ck = (id(d), getattr(d, "epoch", 0))
    cache = _CACHES.get(ck)
    if cache is None or cache.dictionary is not d:
        cache = _CACHES[ck] = _TableCache(d)
    return cache.table(key, device)


def lookup(table: tuple, codes: torch.Tensor) -> torch.Tensor:
    """The table's value for each code: a search over the sorted labels,
    then a gather. Valid codes hit exactly (a table covers the whole
    dictionary); padding rows gather garbage that the validity masks
    drop."""
    labels, values = table
    idx = torch.searchsorted(labels, codes.to(torch.int64))
    return values[torch.clamp(idx, 0, values.shape[0] - 1)]
