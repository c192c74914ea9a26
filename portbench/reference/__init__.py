"""Plain numpy and torch references of the benchmark's cells."""
