"""Units and the CUDA build."""
