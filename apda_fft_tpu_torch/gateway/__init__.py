"""Gateway orchestration: transports, state machine, egress, telemetry."""
