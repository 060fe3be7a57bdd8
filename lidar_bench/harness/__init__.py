"""The harness: cells, drivers, traces and the check (see ../README.md)."""
