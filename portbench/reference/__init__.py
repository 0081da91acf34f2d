"""Plain references the benchmark holds the program's outputs against."""
