"""setup_s: seconds from the process's start to the window's start (import,
weights, inputs, the program built and warmed at the cell's shapes)."""


def read(rec):
    return rec["setup_s"]
