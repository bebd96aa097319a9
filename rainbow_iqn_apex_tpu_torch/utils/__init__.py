"""utils/ — the port's copy of the JSONL ``MetricsLogger``."""
