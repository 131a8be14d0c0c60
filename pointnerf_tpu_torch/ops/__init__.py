"""Grid, query, positional encoding and the CUDA kernels of the PyTorch port
(counterpart of `pointnerf_tpu/ops/`)."""
