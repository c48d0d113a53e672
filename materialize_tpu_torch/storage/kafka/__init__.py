"""Kafka-analog streaming layer.

The reference speaks to real Kafka through librdkafka
(storage/src/source/kafka.rs, storage/src/sink/kafka.rs). librdkafka is
not in this build, so the broker itself is abstracted: ``Broker`` is a
minimal partitioned-log interface with a durable file-backed
implementation (``FileBroker``: one directory per topic, one
length-prefixed segment file per partition) and an in-memory one for
tests. Everything above the broker — decoding (json/csv/text/avro with
Confluent framing), envelopes (none/upsert/debezium), reclocked source
ingestion, and the exactly-once sink — mirrors the reference's
behavior and would speak to real Kafka by implementing ``Broker`` over
librdkafka.

The port's copy of ``materialize_tpu/storage/kafka/``.
"""

from .broker import Broker, FileBroker, MemBroker, Record
from .decode import make_decoder, make_encoder

__all__ = [
    "Broker",
    "FileBroker",
    "MemBroker",
    "Record",
    "make_decoder",
    "make_encoder",
]
