"""Point cloud, aggregator, ray march and renderer of the PyTorch port
(counterpart of `pointnerf_tpu/models/`)."""
