"""Host-side IO: wire-protocol codec, half-float decode, sensor log files."""
