"""sqllogictest-dialect runner.

Analog of the reference's SLT runner (``src/sqllogictest`` driving
``test/sqllogictest``'s 583 files): datadriven text records

    statement ok
    <sql>

    statement error <substring>
    <sql>

    query <types> [rowsort|valuesort]
    <sql>
    ----
    <expected rows, one per line, values whitespace-separated>

executed against a live Coordinator. Types (I integer, T text, R real,
B bool) are shape documentation; values compare textually with NULL for
None, true/false for booleans (SLT conventions).

The port's copy of ``materialize_tpu/testing/slt.py``: it drives the
port's coordinator and imports nothing of the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Record:
    kind: str  # "statement_ok" | "statement_error" | "query"
    sql: str
    line: int
    error_substring: str = ""
    expected: list = field(default_factory=list)
    sort: str = "nosort"  # nosort | rowsort | valuesort
    types: str = ""


class SltError(AssertionError):
    pass


def parse_slt(text: str) -> list[Record]:
    lines = text.split("\n")
    records: list[Record] = []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        start = i + 1
        if line.startswith("statement"):
            parts = line.split(None, 2)
            kind = parts[1]
            err = parts[2] if len(parts) > 2 and kind == "error" else ""
            i += 1
            sql_lines = []
            while i < len(lines) and lines[i].strip() != "":
                sql_lines.append(lines[i])
                i += 1
            records.append(
                Record(
                    kind=f"statement_{kind}",
                    sql="\n".join(sql_lines),
                    line=start,
                    error_substring=err,
                )
            )
        elif line.startswith("query"):
            parts = line.split()
            types = parts[1] if len(parts) > 1 else ""
            sort = parts[2] if len(parts) > 2 else "nosort"
            i += 1
            sql_lines = []
            while i < len(lines) and lines[i].strip() != "----":
                sql_lines.append(lines[i])
                i += 1
            i += 1  # skip ----
            expected = []
            while i < len(lines) and lines[i].strip() != "":
                expected.append(lines[i].strip())
                i += 1
            records.append(
                Record(
                    kind="query",
                    sql="\n".join(sql_lines),
                    line=start,
                    expected=expected,
                    sort=sort,
                    types=types,
                )
            )
        else:
            raise ValueError(f"slt parse error at line {i + 1}: {line!r}")
        i += 1
    return records


def _fmt(v) -> str:
    import decimal

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (float, decimal.Decimal)):
        # SLT convention: 3 decimal places for reals.
        return f"{v:.3f}"
    return str(v)


def run_slt(text: str, coordinator, name: str = "<slt>") -> int:
    """Execute every record; raises SltError with file:line context on
    the first mismatch. Returns the number of records run."""
    records = parse_slt(text)
    for rec in records:
        where = f"{name}:{rec.line}"
        if rec.kind == "statement_ok":
            try:
                coordinator.execute(rec.sql)
            except Exception as e:
                raise SltError(
                    f"{where}: statement failed: {e}\n  {rec.sql}"
                ) from e
        elif rec.kind == "statement_error":
            try:
                coordinator.execute(rec.sql)
            except Exception as e:
                if rec.error_substring and rec.error_substring not in str(
                    e
                ):
                    raise SltError(
                        f"{where}: error {e!r} does not contain "
                        f"{rec.error_substring!r}"
                    ) from e
            else:
                raise SltError(
                    f"{where}: statement succeeded but error expected"
                    f"\n  {rec.sql}"
                )
        elif rec.kind == "query":
            try:
                res = coordinator.execute(rec.sql)
            except Exception as e:
                raise SltError(
                    f"{where}: query failed: {e}\n  {rec.sql}"
                ) from e
            if getattr(res, "text", None) is not None and not res.rows:
                # EXPLAIN and other text results: one row per line
                # (the reference's sqllogictest asserts EXPLAIN output
                # the same way; indentation normalizes away below).
                got = [
                    l for l in res.text.split("\n") if l.strip()
                ]
            else:
                got = [
                    "  ".join(_fmt(v) for v in row) for row in res.rows
                ]
            expected = list(rec.expected)
            if rec.sort == "rowsort":
                got.sort()
                expected.sort()
            elif rec.sort == "valuesort":
                got = sorted(
                    v for line in got for v in line.split()
                )
                expected = sorted(
                    v for line in expected for v in line.split()
                )
            # Normalize whitespace for comparison.
            norm = lambda ls: [" ".join(l.split()) for l in ls]
            if norm(got) != norm(expected):
                raise SltError(
                    f"{where}: result mismatch\n  {rec.sql}\n"
                    f"expected:\n  " + "\n  ".join(expected)
                    + "\ngot:\n  " + "\n  ".join(got)
                )
    return len(records)


def run_slt_file(path: str, coordinator) -> int:
    with open(path) as f:
        return run_slt(f.read(), coordinator, name=path)
