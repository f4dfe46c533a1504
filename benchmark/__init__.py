"""The benchmark of neo360_tpu_torch on NVIDIA H100s.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. BENCHMARK.json names the cells; each
configuration, architecture adapter, traffic mix, per-layer metric,
roofline family and cell limit is a file of its own under this folder,
found by its name (registry.py). Nothing here imports JAX or the JAX
package, and only the adapters (architectures/) import the port."""
