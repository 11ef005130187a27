"""The benchmark of the PyTorch port (`saunet_tpu_torch`) on one NVIDIA H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` and prints its result as
the last line of standard output. Configurations (`configs/`), traffic
mixes (`traffic/`), the limits of the correctness check (`limits/`) and
the per-layer metrics' readers (`metrics/`) are files found by the names in
`BENCHMARK.json`; `drivers/` holds the general generators that a mix names,
`reference/` the plain PyTorch reference, `counts/` the closed-form
operation and byte counts, `peaks.py` the card's published peaks.
"""
