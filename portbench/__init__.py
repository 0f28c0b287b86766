"""The benchmark of the PyTorch/CUDA port (``eftpipe_tpu_torch``): one cell
a run, ``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``.  Nothing here imports ``jax`` or the JAX package."""
