"""Host-side data helpers of the port (tokenizer, image constants)."""
