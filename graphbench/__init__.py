"""graphbench: the benchmark of dgraph_tpu_torch, the port's serving Node.

One run drives one cell of BENCHMARK.json (a configuration under a traffic
mix) through `dgraph_tpu_torch.api.server.Node.query` on a CUDA card:

    python3 -m graphbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: the configuration in
configs/<config>.json (its generator in datagen/<generator>.py), the traffic
mix in traffic/<traffic>.json (its request kinds in requests/<kind>.py), and
each per-layer metric's reader in metrics/<metric>.py. The plain reference
that decides `correct` is in reference/; it imports nothing of the program.
Nothing here imports jax or the JAX package.
"""
