"""The plain reference: the SAUNet forward in float32 PyTorch, and the
comparisons that decide `correct`. It imports nothing of the port."""
