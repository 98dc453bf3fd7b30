"""Telemetry of the port: the shared registry and request tracing."""
