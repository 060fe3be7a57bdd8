"""The benchmark of tloam_torch (see README.md)."""
