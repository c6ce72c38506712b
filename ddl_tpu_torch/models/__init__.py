"""Model families of the port (slice 1: the Llama decoder)."""
