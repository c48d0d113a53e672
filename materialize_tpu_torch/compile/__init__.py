"""The compile plane (the port of ``materialize_tpu/compile/``).

The reference banks serialized XLA executables and warms a DDL's
specialized step program on a background thread. Eager torch compiles
no program per dataflow: what the port compiles is its two native
libraries, ``csrc/merge_path.cu`` (nvcc) and ``native/mtnative.cpp``
(g++). So:

- :mod:`bank` is a directory of those libraries that outlives the
  process, keyed by the compile ledger's ``(kind, fingerprint, tier)``:
  both build sites look it up before they build, and a recovery boot
  loads them from it instead of building;
- :mod:`worker` is the background worker behind async DDL: a fresh
  ``CREATE INDEX`` / ``CREATE MATERIALIZED VIEW`` serves at once in
  merge ingest while the worker renders the specialized layout, loads
  both libraries through the bank and steps it once on empty batches;
  the replica then swaps at a span boundary.
"""

from .bank import ProgramBank, configure_bank, get_bank  # noqa: F401
