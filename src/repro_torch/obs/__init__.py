"""Telemetry of the port: the pieces the serving engine uses (metrics
registry, latency histograms, spans).  The CLI flags, JSONL export and
memory probe land with the telemetry slice."""
