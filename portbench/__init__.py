"""The benchmark of the PyTorch and CUDA port (nbldpc_tpu_torch) on one
H100: `python3 -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` (see run.py and README.md)."""
