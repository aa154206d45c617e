"""The benchmark of the PyTorch/CUDA port (openh264_tpu_torch).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once; see run.py.
"""
