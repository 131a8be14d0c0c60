"""CPU tests of the benchmark (and one on the card, marked `cuda`):
`python -m pytest portbench/tests -q` from the root of the repo."""
