"""Plain PyTorch references; nothing here imports the port."""
