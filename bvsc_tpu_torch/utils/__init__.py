"""Training utilities: TensorBoard logging (``utils.logging``)."""
