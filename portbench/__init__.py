"""The benchmark of the PyTorch and CUDA port (`pointnerf_tpu_torch`):
`python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once."""
