"""The benchmark of ``repro_torch``, the PyTorch/CUDA port: one command
(``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``) runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything here is the yardstick: traffic generation,
weights from the seed, the plain float32 reference, the comparison that
decides ``correct``, the profiler reduction and the per-layer readers.
From the port it takes only the system under test (``Engine``,
``TrainWindow``) and its spans, counters and kernel names; it never
imports JAX or the JAX package."""
