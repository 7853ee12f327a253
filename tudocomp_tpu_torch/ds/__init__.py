"""Host text data structures of the port (numpy and the host library)."""
