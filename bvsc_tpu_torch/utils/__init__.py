"""Utilities: TensorBoard logging for the trainers (``utils.logging``); the
spans and counters of the port's layers (``utils.tracing``)."""
