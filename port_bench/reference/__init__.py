"""The plain reference the benchmark holds the program to."""
