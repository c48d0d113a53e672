"""Planning catalog: name -> relation schema resolution.

The in-memory side of the reference's ``Catalog``
(adapter/src/catalog.rs:139; memory layer catalog/src/memory). The
coordinator owns the authoritative catalog (coord/); this interface is
what SQL planning needs (sql/src/names.rs resolution analog).

The port's copy of ``materialize_tpu/sql/catalog.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..repr.schema import Schema
from .hir import CatalogInterface, PlanError


@dataclass
class CatalogItem:
    name: str
    kind: str  # source | view | materialized-view | index
    schema: Schema
    # views keep their definition for EXPLAIN / dependency rebuilds
    definition: object | None = None
    column_names: tuple = ()


class Catalog(CatalogInterface):
    """In-memory catalog of named relations."""

    def __init__(self):
        self.items: dict[str, CatalogItem] = {}

    def create(self, item: CatalogItem, or_replace: bool = False) -> None:
        if item.name in self.items and not or_replace:
            raise PlanError(f"catalog item {item.name!r} already exists")
        self.items[item.name] = item

    def drop(self, name: str, if_exists: bool = False) -> None:
        if name not in self.items:
            if if_exists:
                return
            raise PlanError(f"unknown catalog item {name!r}")
        del self.items[name]

    def resolve_item(self, name: str) -> Schema:
        it = self.items.get(name)
        if it is None:
            raise PlanError(f"unknown relation {name!r}")
        return it.schema

    def get(self, name: str) -> CatalogItem:
        return self.items[name]
