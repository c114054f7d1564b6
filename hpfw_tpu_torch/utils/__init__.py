"""Framework-free helpers (profiling)."""
