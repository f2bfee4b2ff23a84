"""Architecture + workload configs (one module per assigned arch)."""
