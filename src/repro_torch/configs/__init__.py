"""Problem-size configurations of the PyTorch port."""
