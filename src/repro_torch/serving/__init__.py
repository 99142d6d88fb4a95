"""Forest serving of the port: padded-dispatch bundles, the micro-batcher,
the fault harness and the fault-tolerant ``ForestServer`` (mirrors the
forest half of ``repro.serving``)."""
