"""Eval step and grid refresh of the PyTorch port (counterpart of
`pointnerf_tpu/train/`)."""
