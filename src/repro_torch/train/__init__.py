"""The single-process trainer of the port."""
