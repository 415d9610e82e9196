"""Models of the port (the dense nanogpt path)."""
