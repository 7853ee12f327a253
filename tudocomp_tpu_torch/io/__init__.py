"""Host bit-stream I/O of the port (numpy)."""
