"""Utilities shared by the port's libraries: tracing and metrics."""
