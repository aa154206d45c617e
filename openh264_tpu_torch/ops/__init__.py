"""Integer 4x4 transforms in PyTorch (int32 throughout)."""
