"""Host-side engine plumbing: the round scheduler of the CPU engines."""
