"""The benchmark's own copies of its measuring instruments (see bench/)."""
