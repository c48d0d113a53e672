"""Storage of the port: ``persist/`` (durable shards), ``generator/``
(the TPC-H and auction load generators) and ``kafka/`` (the broker, the
decoders, the envelopes, the source adapter and the exactly-once
sink)."""
