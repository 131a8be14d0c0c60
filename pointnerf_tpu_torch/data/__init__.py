"""Scene data for the PyTorch port (counterpart of `pointnerf_tpu/data/`)."""
